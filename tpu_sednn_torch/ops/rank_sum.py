"""Sum of the data-parallel ranks' gradients on the card they share
(`csrc/rank_sum.cu`) — the sum of tpu_sednn/ops/resident_chunk.py:_allreduce.

The TPU kernel adds the chips' gradients inside its body, so the arithmetic
stays on the chips.  Here ranks with a card each sum with NCCL
(`parallel.all_reduce`); ranks that share one card, one process each, sum
with this module:

* `rank_sum(srcs, out)` — out = srcs[0] + srcs[1] + ... in rank order, one
  launch, float32.  On CPU tensors it runs the plain version
  `rank_sum_reference`, which adds in the same order (bit-equal).
* `CardSum` — the all-reduce of a group of ranks on one card: each rank
  copies its tensor into a staging buffer that it exported with CUDA IPC,
  the ranks meet at a barrier of their gloo group (which carries only the
  rendezvous, the IPC handles and the barriers), and every rank launches
  `rank_sum` over all the ranks' staging buffers into its own tensor.  All
  ranks add the same buffers in the same order: their sums are bit-equal.
  Two staging buffers a rank, used in turn, let a rank stage the next sum
  while a slower rank still reads the last one; `fence` waits for every
  rank's sums (before a rank may exit or free its buffer).

`rank_sum.launches` counts kernel launches.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import functools
import socket
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from tpu_sednn_torch.ops import _build

MAX_RANKS = 16  # csrc/rank_sum.cu:kMaxRanks


def _check(srcs: Sequence[torch.Tensor], out: torch.Tensor) -> int:
    if not 1 <= len(srcs) <= MAX_RANKS:
        raise ValueError(f"rank_sum adds 1 to {MAX_RANKS} tensors, got {len(srcs)}")
    n = out.numel()
    for a in list(srcs) + [out]:
        if a.dtype != torch.float32 or a.device != out.device or not a.is_contiguous():
            raise ValueError(f"rank_sum: float32 contiguous tensors on {out.device} expected, got "
                             f"{a.dtype} on {a.device}")
        if a.numel() != n:
            raise ValueError(f"rank_sum: every tensor has {n} elements, got {a.numel()}")
    return n


@torch.no_grad()
def rank_sum_reference(srcs: Sequence[torch.Tensor], out: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `rank_sum`: float32 additions in rank order."""
    _check(srcs, out)
    acc = srcs[0].clone()
    for a in srcs[1:]:
        acc += a
    return out.copy_(acc)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rank_sum")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rank_sum_f32.argtypes = [ctypes.POINTER(p), i, p, ll, p]
    lib.rank_sum_f32.restype = i
    lib.rank_sum_handle_bytes.argtypes = []
    lib.rank_sum_handle_bytes.restype = i
    lib.rank_sum_export.argtypes = [ll, ctypes.POINTER(p), ctypes.c_char_p]
    lib.rank_sum_export.restype = i
    lib.rank_sum_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(p)]
    lib.rank_sum_open.restype = i
    lib.rank_sum_close.argtypes = [p]
    lib.rank_sum_close.restype = i
    lib.rank_sum_free.argtypes = [p]
    lib.rank_sum_free.restype = i
    return lib


def rank_sum(srcs: Sequence[torch.Tensor], out: torch.Tensor) -> torch.Tensor:
    """out = ((srcs[0] + srcs[1]) + srcs[2]) + ..., float32, every tensor
    contiguous with out's size (out may be one of srcs); -> out.  On a CUDA
    `out` launches the kernel (or raises); on a CPU one runs the plain
    version."""
    n = _check(srcs, out)
    if out.device.type == "cpu":
        return rank_sum_reference(srcs, out)
    if out.device.type != "cuda":
        raise ValueError(f"rank_sum runs on cuda or cpu, got {out.device}")
    ptrs = (ctypes.c_void_p * len(srcs))(*[a.data_ptr() for a in srcs])
    with torch.cuda.device(out.device):
        rc = _lib().rank_sum_f32(ptrs, len(srcs), out.data_ptr(), n,
                                 torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rank_sum kernel launch failed: CUDA error {rc}")
    rank_sum.launches += 1
    return out


rank_sum.launches = 0


class _Raw:
    """A float32 buffer at a raw device pointer, for torch.as_tensor."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": "<f4", "data": (ptr, False),
                                         "version": 2}


class CardSum:
    """The all-reduce (sum) of float32 card tensors over a gloo group whose
    ranks all share one card.  Every rank of the group must make the same
    calls in the same order, as with any collective."""

    def __init__(self, group, device: torch.device):
        self.group, self.device = group, device
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        if self.world > MAX_RANKS:
            raise ValueError(f"{self.world} ranks on one card: at most {MAX_RANKS}")
        self._cap = 0
        self._own = None  # this rank's exported buffer: two stages of _cap floats
        self._opened: List[int] = []  # the other ranks' buffers, mapped here
        self._stages: List[List[torch.Tensor]] = []  # [rank][k]
        self._turn = 0

    def _grow(self, n: int) -> None:
        """Staging buffers of at least n floats on every rank (collective)."""
        if self._own is not None:
            self.fence()
            self._release()
        lib = _lib()
        cap = max(n, 1024)
        ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(lib.rank_sum_handle_bytes())
        with torch.cuda.device(self.device):
            rc = lib.rank_sum_export(8 * cap, ctypes.byref(ptr), handle)
        if rc != 0:
            raise RuntimeError(f"staging buffer of {8 * cap} bytes: CUDA error {rc}")
        self._own = ptr.value
        card = (socket.gethostname(), str(torch.cuda.get_device_properties(self.device).uuid))
        peers = [None] * self.world
        dist.all_gather_object(peers, (card, handle.raw), group=self.group)
        if any(c != card for c, _ in peers):
            raise RuntimeError(f"gloo ranks with card tensors must share one card: rank "
                               f"{self.rank} is on {card}, the group on {[c for c, _ in peers]}; "
                               "ranks with a card each take nccl")
        self._stages = []
        for r, (_, h) in enumerate(peers):
            if r == self.rank:
                base = self._own
            else:
                mapped = ctypes.c_void_p()
                with torch.cuda.device(self.device):
                    rc = lib.rank_sum_open(h, ctypes.byref(mapped))
                if rc != 0:
                    raise RuntimeError(f"mapping rank {r}'s staging buffer: CUDA error {rc}")
                base = mapped.value
                self._opened.append(base)
            self._stages.append([torch.as_tensor(_Raw(base + 4 * k * cap, cap), device=self.device)
                                 for k in range(2)])
        self._cap = cap

    def _release(self) -> None:
        lib = _lib()
        self._stages = []
        with torch.cuda.device(self.device):
            for p in self._opened:
                lib.rank_sum_close(p)
        self._opened = []
        dist.barrier(group=self.group)  # nobody maps this rank's buffer any more
        with torch.cuda.device(self.device):
            lib.rank_sum_free(self._own)
        self._own, self._cap = None, 0

    def fence(self) -> None:
        """Return once every rank's sums so far have ended on the card."""
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """t (float32, contiguous, on the card) = the sum of every rank's t,
        in place; the same bits on every rank."""
        if t.dtype != torch.float32 or t.device != self.device or not t.is_contiguous():
            raise ValueError(f"the card's all-reduce sums float32 contiguous tensors on "
                             f"{self.device}, got {t.dtype} on {t.device}")
        n = t.numel()
        if n > self._cap:
            self._grow(n)
        k, self._turn = self._turn, self._turn ^ 1
        self._stages[self.rank][k][:n].copy_(t.view(-1))
        # every rank's stage k is written, and every rank's sums of the last
        # turn that read stage k are done (each synchronised before this barrier)
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)
        rank_sum([s[k][:n] for s in self._stages], t.view(-1))
        return t


_CARD_SUMS: Dict[tuple, CardSum] = {}


def _key(group, device: torch.device) -> tuple:
    return (None if group is None else id(group), str(device))  # a CardSum keeps its group


def card_sum(group, device: torch.device) -> CardSum:
    """The CardSum of (group, device), made on first use (collective)."""
    key = _key(group, device)
    if key not in _CARD_SUMS:
        _CARD_SUMS[key] = CardSum(group, device)
    return _CARD_SUMS[key]


def fence(group, device: torch.device) -> None:
    """CardSum.fence of (group, device) if it exists, else nothing."""
    cs = _CARD_SUMS.get(_key(group, device))
    if cs is not None:
        cs.fence()
