"""int8 serving quantization for the regression MLP — counterpart of
tpu_sednn/model/quant.py.

Scheme (w8a8 dynamic, the JAX package's):
* weights: per-output-channel symmetric int8, scale sw[j] = max|W[:,j]|/127,
  computed once at decoder build time, after fold_eval_params (the parity
  keep-prob is already in the weights);
* activations: per-row dynamic symmetric int8, sx[i] = max|x[i,:]|/127;
* products in int32 (`torch._int_mm`), exact: |sum| <= 127^2 * K, which
  passes 2^24 (float32's exact integers) at these widths but not 2^31;
  dequantized as int32 * (sx sw) + b;
* the output layer stays in float by default (quant_last=False): a
  bf16-operand, float32-accumulate product, as the JAX `jax.lax.dot(bf16,
  bf16, preferred_element_type=f32)`.

The int32 product has one path on both devices: x and W are zero-padded to
the shape rules of `torch._int_mm` on CUDA (more than 16 rows, K and N
multiples of 8), which is exact in integers, and the result is sliced back.
No shape switches to a float product.  W is kept column-major (strides
(1, n_in)): for a row-major W cuBLASLt on the H100 picks a slower kernel
(chip_smoke.py's [quant] phase times both layouts).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_sednn_torch.model.mlp import MLP, ModelConfig, _act, mm_operand

_QMAX = 127.0
_MIN_ROWS = 24  # torch._int_mm on CUDA takes more than 16 rows; a multiple of 8


@dataclass(frozen=True)
class QuantParams:
    """Per-layer quantized weights. `wq[l]` is int8 (n_in, n_out), stored
    column-major, with per-column scales `sw[l]` (float32); a layer kept in float has wq[l] and
    sw[l] None and its float32 weights in `w_f32[l]` (None where wq[l]
    exists, so the quantized layers hold only their int8 copy)."""

    wq: Tuple[Optional[torch.Tensor], ...]
    sw: Tuple[Optional[torch.Tensor], ...]
    w_f32: Tuple[Optional[torch.Tensor], ...]
    b: Tuple[torch.Tensor, ...]
    skip_last: bool = True


def _over_qmax(t: torch.Tensor) -> torch.Tensor:
    """t / 127 rounded once, as IEEE division: the divisor is a tensor on t's
    device, since CUDA divides by a Python scalar as a product with its
    rounded reciprocal, which can land one ulp away."""
    return t / torch.full((), _QMAX, device=t.device)


def quantize_params_int8(params: MLP, quant_last: bool = False) -> QuantParams:
    """Per-output-channel symmetric int8 quantization of the weight matrices,
    on the device the params are on.  Call on already-folded eval params
    (fold_eval_params).  clip(round(w / s)) in that order, round half to
    even, as the JAX package computes it: the int8 weights come out equal."""
    n = len(params.w)
    wq, sw, w_f32 = [], [], []
    for l, w in enumerate(params.w):
        w = w.float()
        if l == n - 1 and not quant_last:
            wq.append(None)
            sw.append(None)
            w_f32.append(w)
            continue
        s = _over_qmax(torch.clamp(w.abs().amax(dim=0), min=1e-12))
        wq.append(_col_major(torch.clamp(torch.round(w / s), -_QMAX, _QMAX).to(torch.int8)))
        sw.append(s)
        w_f32.append(None)
    return QuantParams(wq=tuple(wq), sw=tuple(sw), w_f32=tuple(w_f32),
                       b=tuple(b.float() for b in params.b), skip_last=not quant_last)


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8: (x_q int8, scale float32 (rows, 1))."""
    sx = _over_qmax(torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-12))
    xq = torch.clamp(torch.round(x / sx), -_QMAX, _QMAX).to(torch.int8)
    return xq, sx


def _col_major(w: torch.Tensor) -> torch.Tensor:
    """w with its values and shape, stored column-major (a copy only if it is not)."""
    return w.t().contiguous().t()


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (m, k) x int8 (k, n) -> int32 (m, n), exact.  Zero rows and
    columns are added up to torch._int_mm's shape rules and sliced off."""
    m, k = xq.shape
    n = wq.shape[1]
    mp, kp, np_ = max(_MIN_ROWS, _ceil8(m)), _ceil8(k), _ceil8(n)
    if (mp, kp) != (m, k):
        xq = F.pad(xq, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        wq = F.pad(wq, (0, np_ - n, 0, kp - k))
    return torch._int_mm(xq.contiguous(), _col_major(wq))[:m, :n]


def forward_eval_int8(qp: QuantParams, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Quantized inference forward: (..., n_in) -> (..., n_out).

    cfg must be the dropout-free eval config from fold_eval_params (the
    keep-prob compensation is already folded into the quantized weights)."""
    if cfg.use_dropout:
        raise ValueError("forward_eval_int8 expects folded eval params/config")
    lead = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1])
    n_layers = len(qp.b)
    for l in range(n_layers):
        if qp.wq[l] is None:
            y = torch.matmul(mm_operand(h, True), mm_operand(qp.w_f32[l], True)) + qp.b[l]
        else:
            hq, sx = _quantize_rows(h)
            acc = _int8_matmul(hq, qp.wq[l])
            y = acc.float() * (sx * qp.sw[l][None, :]) + qp.b[l]
        h = _act(cfg.hidden if l < n_layers - 1 else cfg.output, y)
    return h.reshape(*lead, h.shape[-1])
