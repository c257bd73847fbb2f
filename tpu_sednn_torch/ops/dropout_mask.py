"""Standalone dropout mask on hand-written CUDA (`csrc/dropout_mask.cu`) —
the port of tpu_sednn/ops/dropout_pallas.py.

`dropout_mask(seed, shape, omit)` -> a (B, D) float32 0/1 mask with
P(0) = omit, from one integer seed: what `model.mlp.forward` multiplies a
layer's input by when `cfg.dropout_rng == "tpu_prng"`.  The mask has only
integer inputs, so it is outside autograd; gradients flow through the
multiply.

The TPU kernel's contract is kept, not its blocks: the threshold
min(floor(omit * 2**32), 2**32 - 1) on 32 random bits; deterministic in the
seed, another stream for another seed; one stream per block of 512 rows
keyed `seed + block`, so rows 512.. under seed s are rows 0.. under s + 1.
Any B and D (the TPU kernel pads to (8, 128) tiles and slices).  The bits
are the port's Philox4x32-10, not the TPU's: streams match that package in
distribution only.  This is not the chunk trainer's stream
(`ops.resident_chunk.sample_resident_masks`): key formula and row origin
differ.

On `device="cuda"` the wrapper launches the kernel or raises; on "cpu" it runs
the plain version `dropout_mask_reference`, which draws the same bits in
integer tensor arithmetic.  `dropout_mask.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_sednn_torch._device import resolve_device
from tpu_sednn_torch.ops import _build
from tpu_sednn_torch.ops.philox import mask_threshold, philox_mask

_ROW_BLOCK = 512  # rows that share one stream, as in the TPU kernel


def _check_shape(shape, omit: float):
    if len(shape) != 2 or min(int(s) for s in shape) < 0:
        raise ValueError(f"dropout_mask draws 2-D masks, got shape {tuple(shape)}")
    if not 0.0 <= float(omit) <= 1.0:
        raise ValueError(f"omit {omit} outside [0, 1]")
    return int(shape[0]), int(shape[1])


def dropout_mask_reference(seed: int, shape, omit: float,
                           device: str | torch.device = "cpu") -> torch.Tensor:
    """Plain torch version of `dropout_mask`, bit-equal to the kernel: block
    k of 512 rows is `philox_mask` of stream (seed + k) mod 2**32 with
    block-local rows."""
    B, D = _check_shape(shape, omit)
    parts = [philox_mask((int(seed) + blk) & 0xFFFFFFFF, min(_ROW_BLOCK, B - r0), D, float(omit),
                         device=device)
             for blk, r0 in enumerate(range(0, B, _ROW_BLOCK))]
    if not parts:
        return torch.zeros((B, D), dtype=torch.float32, device=device)
    return torch.cat(parts, dim=0)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dropout_mask")
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.philox_dropout_mask_f32.argtypes = [p, i, i, u, u, p]
    lib.philox_dropout_mask_f32.restype = ctypes.c_int
    return lib


def dropout_mask(seed: int, shape, omit: float,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """0/1 float32 mask of `shape` (B, D) on `device`; P(zero) = omit.
    seed: any integer, taken mod 2**32 (an int32 seed and its uint32 twin
    give the same mask)."""
    B, D = _check_shape(shape, omit)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dropout_mask_reference(seed, (B, D), omit)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = _lib().philox_dropout_mask_f32(out.data_ptr(), B, D, int(seed) & 0xFFFFFFFF,
                                            mask_threshold(float(omit)),
                                            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dropout mask kernel launch failed: CUDA error {rc}")
    dropout_mask.launches += 1
    return out


dropout_mask.launches = 0
