"""Plain reference of the causal CRN (Tan & Wang, Interspeech 2018, Table 1)
for the port's tests: plain torch, no JAX, neither package.  It follows the
layer equations of tpu_sednn_torch/model/crn.py's docstring as written:
each (de)convolution a sum of products over its 2 x 3 taps, batch norm
applied as written (not folded), the LSTM an explicit step loop.  It takes
the port's tensors by name (CRN.tensors) and computes in float64, or with
precision="tf32" in float32 with every product's operands rounded to TF32's
10 mantissa bits (the lower-precision control).
"""

from __future__ import annotations

from typing import Dict

import torch


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 `a` rounded to TF32's 10 mantissa bits (ties away from zero)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, precision):
    return a @ b if precision == "f64" else tf32(a) @ tf32(b)


def _prev(x):
    """x (B, T, ...) delayed by one frame, a zero frame first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _bn(y, t, name, eps):
    if f"{name}.gamma" not in t:
        return y
    return (y - t[f"{name}.mean"]) / torch.sqrt(t[f"{name}.var"] + eps) * t[f"{name}.gamma"] \
        + t[f"{name}.beta"]


def _elu(x):
    return torch.where(x > 0, x, torch.expm1(x))


def crn_forward(t: Dict[str, torch.Tensor], mag: torch.Tensor, depth: int = 5,
                lstm_layers: int = 2, eps: float = 1e-5, precision: str = "f64") -> torch.Tensor:
    """(B, T, F) magnitude -> (B, T, F) enhanced magnitude.  Activations are
    (B, T, F, C), channels last, so that a tap is a product over channels."""
    dt = torch.float64 if precision == "f64" else torch.float32
    t = {k: v.detach().to("cpu", dt) for k, v in t.items()}
    x = mag.to("cpu", dt).unsqueeze(-1)
    B, T = x.shape[:2]
    skips = []
    for l in range(1, depth + 1):
        w = t[f"enc{l}.w"]  # (C_out, C_in, 2, 3)
        fo = (x.shape[2] - 3) // 2 + 1
        y = t[f"enc{l}.b"].expand(B, T, fo, -1)
        for k, src in enumerate((_prev(x), x)):
            for j in range(3):
                y = y + _mm(src[:, :, j:j + 2 * fo - 1:2], w[:, :, k, j].T, precision)
        x = _elu(_bn(y, t, f"enc{l}", eps))
        skips.append(x)
    c5, f5 = x.shape[3], x.shape[2]
    h = x.permute(0, 1, 3, 2).reshape(B, T, c5 * f5)  # channel-major
    for k in range(1, lstm_layers + 1):
        H = t[f"lstm{k}.w_hh"].shape[0]
        gx = _mm(h, t[f"lstm{k}.w_ih"], precision) + t[f"lstm{k}.b"]
        hs, hp, cp = [], torch.zeros(B, H, dtype=dt), torch.zeros(B, H, dtype=dt)
        for s in range(T):
            g = gx[:, s] + _mm(hp, t[f"lstm{k}.w_hh"], precision)
            i, f, gg, o = g[:, :H], g[:, H:2 * H], g[:, 2 * H:3 * H], g[:, 3 * H:]
            cp = torch.sigmoid(f) * cp + torch.sigmoid(i) * torch.tanh(gg)
            hp = torch.sigmoid(o) * torch.tanh(cp)
            hs.append(hp)
        h = torch.stack(hs, dim=1)
    d = h.view(B, T, c5, f5).permute(0, 1, 3, 2)
    for l in range(depth, 0, -1):
        x = torch.cat([d, skips[l - 1]], dim=-1)
        w = t[f"dec{l}.w"]  # (C_in, C_out, 2, 3)
        fi = x.shape[2]
        # F_{l-1} bins out: 2 F_l + 1, and one more, fed by the bias alone, where it is even
        fo = skips[l - 2].shape[2] if l > 1 else mag.shape[-1]
        y = torch.zeros(B, T, fo, w.shape[1], dtype=dt)
        for k, src in enumerate((_prev(x), x)):
            for j in range(3):
                y[:, :, j:j + 2 * fi - 1:2] += _mm(src, w[:, :, k, j], precision)
        y = _bn(y + t[f"dec{l}.b"], t, f"dec{l}", eps)
        d = _elu(y) if l > 1 else torch.logaddexp(y, torch.zeros_like(y))
    return d.squeeze(-1)
