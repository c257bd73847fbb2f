"""The recipe's training step and CV pass, written out in plain torch.

The net of Xu et al. (TASLP 2015) as the reference recipe trains it: ReLU
hidden layers, a linear head, dropout on each layer's input without a
rescale at train time ("parity" dropout), the squared error summed over the
bunch and divided by its rows, and the reference's momentum rule with its
double division by the bunch size and its (1 - m) factor:

    dedx_L = (2 / n) (out - t)
    G      = y_prev^T dedx              (raw sum over the bunch)
    delta  = m delta - (1 - m) lr (G / n + wc W)
    W      = W + delta

The CV pass scales each layer's weights by its input's keep probability.

`precision` names the products: "bf16" rounds both operands of every
product to bfloat16 (to nearest even) and sums in float64, which is the
arithmetic the configuration states; "fp8" rounds them to float8 e4m3 with
one scale a tensor (its largest magnitude at 448), the lower-precision
control; "f64" rounds nothing.  Everything else is float64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from portbench.reference.philox import keep_mask, mask_key

F64 = torch.float64
E4M3_MAX = 448.0


def operand(a: torch.Tensor, precision: str) -> torch.Tensor:
    """`a` as a product takes it, as a float64 tensor."""
    if precision == "f64":
        return a.to(F64)
    if precision == "bf16":
        return a.to(torch.float32).to(torch.bfloat16).to(F64)
    if precision == "fp8":
        a = a.to(F64)
        scale = float(a.abs().max()) / E4M3_MAX
        if scale == 0.0:
            return a
        q = (a / scale).to(torch.float32).to(torch.float8_e4m3fn)
        return q.to(F64) * scale
    raise ValueError(f"unknown precision {precision!r}")


def product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return operand(a, precision) @ operand(b, precision)


@dataclass
class Net:
    """Float64 weights, biases and their momentum."""
    w: List[torch.Tensor]
    b: List[torch.Tensor]
    dw: List[torch.Tensor]
    db: List[torch.Tensor]

    @classmethod
    def fresh(cls, w: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> "Net":
        return cls([a.to(F64).clone() for a in w], [a.to(F64).clone() for a in b],
                   [torch.zeros_like(a, dtype=F64) for a in w],
                   [torch.zeros_like(a, dtype=F64) for a in b])


def train_step(net: Net, x: torch.Tensor, t: torch.Tensor, seed: int, bunch: int,
               omits: Sequence[float], lrate: float, momentum: float, weightcost: float,
               precision: str, masks: Optional[Sequence[torch.Tensor]] = None) -> None:
    """One bunch (bunch index `bunch` of a trainer call whose integer seed is
    `seed`), `net` updated in place.  `masks`: each layer's keep mask drawn
    beforehand (keep_masks, the same streams), in place of drawing it here."""
    n, layers = x.shape[0], len(net.w)
    h = x.to(F64)
    ys = []
    for l in range(layers):
        if omits[l] > 0.0:
            mask = (masks[l][:n] if masks is not None
                    else keep_mask(mask_key(seed, bunch, l), n, h.shape[1], omits[l], h.device))
            h = h * mask
        ys.append(h)
        h = product(h, net.w[l], precision) + net.b[l]
        if l < layers - 1:
            h = torch.relu(h)
    dedx = (2.0 / n) * (h - t.to(F64))
    m, step = float(momentum), (1.0 - float(momentum)) * float(lrate)
    for l in range(layers - 1, -1, -1):
        dedy = product(dedx, net.w[l].T, precision) if l > 0 else None
        g = product(ys[l].T, dedx, precision)
        gb = dedx.sum(dim=0)
        net.dw[l] = m * net.dw[l] - step * (g / n + weightcost * net.w[l])
        net.db[l] = m * net.db[l] - step * (gb / n)
        net.w[l] = net.w[l] + net.dw[l]
        net.b[l] = net.b[l] + net.db[l]
        if l > 0:
            dedx = torch.where(ys[l] > 0, dedy, torch.zeros((), dtype=F64, device=dedy.device))


def cv_mse(w: Sequence[torch.Tensor], b: Sequence[torch.Tensor], x: torch.Tensor,
           t: torch.Tensor, keeps: Sequence[float], precision: str = "f64",
           block: int = 8192) -> float:
    """Mean over rows of the squared error summed over a row's outputs, the
    weights scaled by their inputs' keep probabilities; in blocks of rows."""
    ws = [a.to(F64) * k for a, k in zip(w, keeps)]
    total = 0.0
    for i in range(0, x.shape[0], block):
        h = x[i:i + block].to(F64)
        for l, (wl, bl) in enumerate(zip(ws, b)):
            h = product(h, wl, precision) + bl.to(F64)
            if l < len(ws) - 1:
                h = torch.relu(h)
        total += float(((h - t[i:i + block].to(F64)) ** 2).sum())
    return total / x.shape[0]
