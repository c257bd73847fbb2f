"""Standalone dropout masks on hand-written CUDA (`csrc/dropout_mask.cu`) —
the port of tpu_sednn/ops/dropout_pallas.py.

`dropout_mask(seed, shape, omit)` -> a (B, D) float32 0/1 mask with
P(0) = omit, from one integer seed: what `model.mlp.forward` multiplies a
layer's input by when `cfg.dropout_rng == "tpu_prng"`.  The mask has only
integer inputs, so it is outside autograd; gradients flow through the
multiply.  `dropout_masks(seeds, shapes, omits, row0s)` draws a batch of
such masks at once (a bunch's layers, a group of bunches, a rank's rows of
them): one launch writes up to MAX_MASKS of them into one buffer, each the
mask `dropout_mask` draws for its seed, or with row0 > 0 rows row0.. of it.

The TPU kernel's contract is kept, not its blocks: the threshold
min(floor(omit * 2**32), 2**32 - 1) on 32 random bits; deterministic in the
seed, another stream for another seed; one stream per block of 512 rows
keyed `seed + block`, so rows 512.. under seed s are rows 0.. under s + 1.
Any B and D (the TPU kernel pads to (8, 128) tiles and slices).  The bits
are the port's Philox4x32-10, not the TPU's: streams match that package in
distribution only.  This is not the chunk trainer's stream
(`ops.resident_chunk.sample_resident_masks`): key formula and row origin
differ.

On `device="cuda"` the wrappers launch the kernel or raise; on "cpu" they run
the plain versions `dropout_mask_reference` / `dropout_masks_reference`,
which draw the same bits in integer tensor arithmetic.
`dropout_mask.launches` counts kernel launches, of either wrapper, and
`dropout_mask.masks` the masks they wrote.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch

from tpu_sednn_torch._device import resolve_device
from tpu_sednn_torch.ops import _build
from tpu_sednn_torch.ops.philox import mask_threshold, philox_mask

_ROW_BLOCK = 512  # rows that share one stream, as in the TPU kernel
# masks a launch takes (csrc/dropout_mask.cu:kMaxMasks): their descriptors
# travel as the kernel's parameter, which holds 4 KB
MAX_MASKS = 64


def _check_shape(shape, omit: float):
    if len(shape) != 2 or min(int(s) for s in shape) < 0:
        raise ValueError(f"dropout_mask draws 2-D masks, got shape {tuple(shape)}")
    if not 0.0 <= float(omit) <= 1.0:
        raise ValueError(f"omit {omit} outside [0, 1]")
    return int(shape[0]), int(shape[1])


def dropout_mask_reference(seed: int, shape, omit: float,
                           device: str | torch.device = "cpu", row0: int = 0) -> torch.Tensor:
    """Plain torch version of `dropout_mask`, bit-equal to the kernel: row g
    (from row0) lies in block k = g // 512, the rows g % 512 of `philox_mask`
    of stream (seed + k) mod 2**32."""
    B, D = _check_shape(shape, omit)
    if int(row0) < 0:
        raise ValueError(f"row0 {row0} is negative")
    parts, g, end = [], int(row0), int(row0) + B
    while g < end:
        blk = g // _ROW_BLOCK
        stop = min(end, (blk + 1) * _ROW_BLOCK)
        parts.append(philox_mask((int(seed) + blk) & 0xFFFFFFFF, stop - g, D, float(omit),
                                 row0=g - blk * _ROW_BLOCK, device=device))
        g = stop
    if not parts:
        return torch.zeros((B, D), dtype=torch.float32, device=device)
    return torch.cat(parts, dim=0)


def _check_batch(seeds, shapes, omits, row0s):
    """-> ([(B, D)], [row0]) of a batch; unequal lengths or a negative row0 raise."""
    row0s = [0] * len(seeds) if row0s is None else [int(r) for r in row0s]
    if not len(seeds) == len(shapes) == len(omits) == len(row0s):
        raise ValueError(f"dropout_masks: {len(seeds)} seeds, {len(shapes)} shapes, "
                         f"{len(omits)} omits and {len(row0s)} row0s")
    if any(r < 0 for r in row0s):
        raise ValueError(f"dropout_masks: a negative row0 in {row0s}")
    return [_check_shape(s, o) for s, o in zip(shapes, omits)], row0s


def dropout_masks_reference(seeds: Sequence[int], shapes, omits: Sequence[float],
                            row0s: Optional[Sequence[int]] = None,
                            device: str | torch.device = "cpu") -> List[torch.Tensor]:
    """Plain version of `dropout_masks`: each mask `dropout_mask_reference`
    of its seed at its row0."""
    dims, row0s = _check_batch(seeds, shapes, omits, row0s)
    return [dropout_mask_reference(s, d, o, device=device, row0=r)
            for s, d, o, r in zip(seeds, dims, omits, row0s)]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dropout_mask")
    p, i = ctypes.c_void_p, ctypes.c_int
    pi, pu = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint)
    lib.philox_dropout_masks_f32.argtypes = [p, i, ctypes.POINTER(ctypes.c_longlong), pi, pi, pi,
                                             pu, pu, p]
    lib.philox_dropout_masks_f32.restype = ctypes.c_int
    return lib


def _c_array(ctype, values: list):
    return (ctype * len(values))(*values)


def dropout_masks(seeds: Sequence[int], shapes, omits: Sequence[float],
                  row0s: Optional[Sequence[int]] = None,
                  device: str | torch.device = "cuda") -> List[torch.Tensor]:
    """Masks i = 0..n-1: rows row0s[i].. (default 0) of the mask
    `dropout_mask(seeds[i], (row0s[i] + B, D), omits[i])` draws, of shape
    shapes[i] = (B, D); seeds any integers, taken mod 2**32.  On a CUDA device
    they are (B, D) views into one float32 buffer, each starting 16-byte
    aligned, written by one launch per MAX_MASKS masks (empty masks take
    none)."""
    dims, row0s = _check_batch(seeds, shapes, omits, row0s)
    dev = resolve_device(device)
    if dev.type == "cpu" or not dims:
        return dropout_masks_reference(seeds, dims, omits, row0s, device=dev)
    offsets, total = [], 0
    for B, D in dims:
        offsets.append(total)
        total += -(-B * D // 4) * 4
    buf = torch.empty(total, dtype=torch.float32, device=dev)
    masks = [buf[o:o + B * D].view(B, D) for o, (B, D) in zip(offsets, dims)]
    todo = [i for i, (B, D) in enumerate(dims) if B * D > 0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k in range(0, len(todo), MAX_MASKS):
            part = todo[k:k + MAX_MASKS]
            rc = _lib().philox_dropout_masks_f32(
                buf.data_ptr(), len(part), _c_array(ctypes.c_longlong, [offsets[i] for i in part]),
                _c_array(ctypes.c_int, [dims[i][0] for i in part]),
                _c_array(ctypes.c_int, [dims[i][1] for i in part]),
                _c_array(ctypes.c_int, [row0s[i] for i in part]),
                _c_array(ctypes.c_uint, [int(seeds[i]) & 0xFFFFFFFF for i in part]),
                _c_array(ctypes.c_uint, [mask_threshold(float(omits[i])) for i in part]), stream)
            if rc != 0:
                raise RuntimeError(f"dropout mask kernel launch failed: CUDA error {rc}")
            dropout_mask.launches += 1
            dropout_mask.masks += len(part)
    return masks


def dropout_mask(seed: int, shape, omit: float,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """0/1 float32 mask of `shape` (B, D) on `device`; P(zero) = omit.
    seed: any integer, taken mod 2**32 (an int32 seed and its uint32 twin
    give the same mask).  A batch of one: `dropout_masks`."""
    return dropout_masks([seed], [shape], [omit], device=device)[0]


dropout_mask.launches = 0
dropout_mask.masks = 0
