"""Operations, bytes and the chip's peaks, computed from shapes for the work
a cell asks for, whatever kernel does it.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit.
"""

from __future__ import annotations

from typing import Sequence

BF16_FLOPS = 989e12   # tensor cores, bfloat16 operands
F32_FLOPS = 67e12     # float32 outside the tensor cores
HBM_BYTES_S = 3.35e12
F32 = 4


def _pairs(sizes: Sequence[int]):
    return list(zip(sizes[:-1], sizes[1:]))


def forward_flop_per_row(sizes: Sequence[int]) -> float:
    """2 K N a layer: one row through the net's products."""
    return float(sum(2 * k * n for k, n in _pairs(sizes)))


def train_flop_per_bunch(sizes: Sequence[int], bunch: int) -> float:
    """A bunch's products: the forward, every layer's weight gradient, and
    the input gradient of every layer but the first (nothing asks for the
    gradient of the net's input)."""
    pairs = _pairs(sizes)
    fwd = sum(2 * k * n for k, n in pairs)
    dgrad = sum(2 * k * n for k, n in pairs[1:])
    return float(bunch * (2 * fwd + dgrad))


def state_floats(sizes: Sequence[int]) -> int:
    """Weights and biases of the net."""
    return sum(k * n + n for k, n in _pairs(sizes))


def train_bytes_per_bunch(sizes: Sequence[int], bunch: int) -> float:
    """Parameters and momentum read once and written once in float32, and
    the bunch's input and target rows read once."""
    return float(4 * F32 * state_floats(sizes) + bunch * (sizes[0] + sizes[-1]) * F32)


def train_bound_s_per_bunch(sizes: Sequence[int], bunch: int) -> float:
    """The least time a bunch could take: the larger of its operations at
    the bfloat16 tensor-core peak and its bytes at HBM bandwidth."""
    return max(train_flop_per_bunch(sizes, bunch) / BF16_FLOPS,
               train_bytes_per_bunch(sizes, bunch) / HBM_BYTES_S)
