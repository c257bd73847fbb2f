"""Stochastic-rounding momentum update for bfloat16 weights on hand-written
CUDA (`csrc/sr_update.cu`) — the port of tpu_sednn/ops/sr_update.py.

Weights AND momentum are stored in bfloat16; plain nearest rounding would
bias the tiny per-step updates (~1e-5 of the weight scale) to zero, so the
update is computed in float32 and rounded stochastically (unbiased):

    nd = m*delta - lr*(g + wc*w);   delta' = SR(nd),  w' = SR(w + nd)

Hopper has no stochastic-rounding convert; `csrc/sr_round.cuh` builds it from
Philox bits (16 random bits added to the float32 pattern's low half, which is
then dropped).  The plain version beside the wrapper,
`sr_momentum_update_reference`, draws the same bits in integer tensor
arithmetic (ops/philox.py), so kernel and plain version agree bit for bit.
The JAX package rounds to nearest off the TPU; there the two differ by at
most one bfloat16 ulp.

On a CUDA tensor `sr_momentum_update` launches the kernel or raises; on a
CPU tensor it runs the plain version.  Clean-mode only, as in the JAX
package: parity mode stays float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tpu_sednn_torch.ops import _build
from tpu_sednn_torch.ops.philox import (SR_DELTA_SHIFT, SR_WEIGHT_SHIFT, sr_bits,
                                        sr_to_bf16_reference)

# seed spacing between layers; callers advance the step seed by small
# increments, so (layer, block, step) streams stay disjoint in practice
_LAYER_SEED_STRIDE = 1_000_003
_ROW_BLOCK = 512      # rows that share one stream, as in the TPU kernel
_BLOCK_STRIDE = 7919  # seed spacing between row blocks


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def sr_momentum_update_reference(w, delta, g, seed: int, momentum: float, lrate: float,
                                 weightcost: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of `sr_momentum_update`: one float32 operation at a
    time, in the kernel's order, then `sr_to_bf16_reference` with the bits of
    the element's stream (seed + (row // 512) * 7919, row % 512, col)."""
    shape, dev = w.shape, w.device
    w2, d2, g2 = (a.reshape(1, -1) if a.dim() == 1 else a for a in (w, delta, g))
    K, N = w2.shape
    wf, df, gf = w2.float(), d2.float(), g2.float()
    m, lr, wc = (_f32(v, dev) for v in (momentum, lrate, weightcost))
    nd = m * df - lr * (gf + wc * wf)
    nw = wf + nd
    bits_d = torch.empty((K, N), dtype=torch.int64, device=dev)
    bits_w = torch.empty((K, N), dtype=torch.int64, device=dev)
    for blk, r0 in enumerate(range(0, K, _ROW_BLOCK)):
        rows = min(_ROW_BLOCK, K - r0)
        key = (int(seed) + blk * _BLOCK_STRIDE) & 0xFFFFFFFF
        bits_d[r0:r0 + rows] = sr_bits(key, rows, N, SR_DELTA_SHIFT, dev)
        bits_w[r0:r0 + rows] = sr_bits(key, rows, N, SR_WEIGHT_SHIFT, dev)
    return (sr_to_bf16_reference(nw, bits_w).reshape(shape),
            sr_to_bf16_reference(nd, bits_d).reshape(shape))


def _c_api() -> dict:
    """csrc/sr_update.cu's entry points: name -> (argtypes, restype)."""
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    return {
        "sr_momentum_update_bf16": ([p, p, p, i, p, p, i, i, u, f, f, f, p], i),
        "sr_round_bf16": ([p, ctypes.POINTER(i), p, i, i, u, i, p], i),
    }


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return _build.load("sr_update", _c_api())


def sr_momentum_update(
    w: torch.Tensor,      # (K, N) or (N,) bfloat16
    delta: torch.Tensor,  # same shape, bfloat16
    g: torch.Tensor,      # same shape, gradient (bfloat16 or float32)
    seed: int,
    momentum: float,
    lrate: float,
    weightcost: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (w', delta') in bfloat16 with stochastic rounding, as new tensors.

    The TPU kernel's `block_rows` is a layout knob and has no counterpart;
    the stream contract it implies there (one stream per 512 rows) is fixed."""
    if w.dim() not in (1, 2) or delta.shape != w.shape or g.shape != w.shape:
        raise ValueError(f"shapes {tuple(w.shape)}, {tuple(delta.shape)}, {tuple(g.shape)} "
                         "must be equal and 1-D or 2-D")
    if w.dtype != torch.bfloat16 or delta.dtype != torch.bfloat16:
        raise TypeError(f"w and delta must be bfloat16, got {w.dtype} and {delta.dtype}")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"g must be bfloat16 or float32, got {g.dtype}")
    dev = w.device
    if delta.device != dev or g.device != dev:
        raise ValueError("w, delta and g must be on one device")
    if dev.type == "cpu":
        return sr_momentum_update_reference(w, delta, g, seed, momentum, lrate, weightcost)
    if dev.type != "cuda":
        raise ValueError(f"sr_momentum_update runs on cuda or cpu tensors, got {dev}")
    w, delta, g = w.contiguous(), delta.contiguous(), g.contiguous()
    K, N = (1, w.shape[0]) if w.dim() == 1 else w.shape
    w_out, d_out = torch.empty_like(w), torch.empty_like(delta)
    with torch.cuda.device(dev):
        rc = _lib().sr_momentum_update_bf16(
            w.data_ptr(), delta.data_ptr(), g.data_ptr(), int(g.dtype == torch.bfloat16),
            w_out.data_ptr(), d_out.data_ptr(), K, N, int(seed) & 0xFFFFFFFF, float(momentum),
            float(lrate), float(weightcost), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sr_momentum_update kernel launch failed: CUDA error {rc}")
    return w_out, d_out


def sr_round_on_device(val: torch.Tensor, bits: Optional[torch.Tensor] = None, key: int = 0,
                       shift: int = SR_DELTA_SHIFT) -> torch.Tensor:
    """The kernels' rounding device function on its own: (rows, cols) float32
    on a CUDA device -> bfloat16, rounded with the low 16 bits of `bits` (one
    integer an element) or, without `bits`, with the draws of stream `key`.
    `ops.philox.sr_to_bf16_reference` (with `sr_bits`) is the plain version."""
    if val.device.type != "cuda" or val.dtype != torch.float32 or val.dim() != 2:
        raise ValueError("sr_round_on_device needs a 2-D float32 CUDA tensor; "
                         "ops.philox.sr_to_bf16_reference is the plain version")
    dev = val.device
    val = val.contiguous()
    b32 = None
    if bits is not None:
        if bits.shape != val.shape or bits.device != dev:
            raise ValueError("bits must have val's shape and device")
        b32 = (bits.to(torch.int64) & 0xFFFF).to(torch.int32).contiguous()
    out = torch.empty(val.shape, dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().sr_round_bf16(val.data_ptr(), None if b32 is None else
                                  ctypes.cast(b32.data_ptr(), ctypes.POINTER(ctypes.c_int)),
                                  out.data_ptr(), val.shape[0], val.shape[1],
                                  int(key) & 0xFFFFFFFF, int(shift),
                                  torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sr_round kernel launch failed: CUDA error {rc}")
    return out


def sr_train_step(state, x, t, cfg, opt, generator, seed: int):
    """Clean training step with bfloat16 params and momentum and stochastic
    rounding.  state params/deltas must be bfloat16.  -> (state', loss).

    Gradients by autograd through `model.mlp.forward` with bfloat16 products
    and float32 accumulation; one `sr_momentum_update` per tensor, seeded
    seed + 1_000_003 * l for the weights of layer l and * (100 + l) for its
    bias; no weight cost on biases.
    """
    from tpu_sednn_torch.model.mlp import MLP
    from tpu_sednn_torch.train.step import TrainState, _grads

    loss, g_w, g_b = _grads(state, x, t.float(), cfg, generator, None, True, None,
                            compute_dtype=torch.bfloat16)
    new_w, new_dw, new_b, new_db = [], [], [], []
    for l, (w, d, g) in enumerate(zip(state.params.w, state.deltas.w, g_w)):
        w_, d_ = sr_momentum_update(w.data, d.data, g, seed + _LAYER_SEED_STRIDE * l,
                                    opt.momentum, opt.lrate, opt.weightcost)
        new_w.append(w_)
        new_dw.append(d_)
    for l, (b, d, g) in enumerate(zip(state.params.b, state.deltas.b, g_b)):
        b_, d_ = sr_momentum_update(b.data, d.data, g, seed + _LAYER_SEED_STRIDE * (100 + l),
                                    opt.momentum, opt.lrate, 0.0)
        new_b.append(b_)
        new_db.append(d_)
    return (TrainState(params=MLP(new_w, new_b), deltas=MLP(new_dw, new_db),
                       step=state.step + 1), loss.to(torch.float32))
