"""Philox4x32-10 and the chunk trainer's dropout key and counter layout, in
plain torch integer arithmetic.

A frozen copy, kept with the benchmark so that the reference draws the
trainer's masks without importing the program: a mask element of the
trainer's bunch `bunch`, layer `layer`, under the integer seed of a call is

    key  = (seed + 7919 * bunch + 104729 * layer) mod 2**32
    bits = philox4x32_10(counter=(col // 4, row, 0, 0), key=(key, 0))[col % 4]
    keep = bits >= floor(omit * 2**32)

(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011).
int64 tensors hold the 32-bit words; each 32x32-bit product is formed from
16-bit halves so that nothing overflows.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
BUNCH_STRIDE = 7919
LAYER_STRIDE = 104729


def _mulhilo(a: int, b: torch.Tensor):
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    low = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (low >> 32), low & _MASK32


def philox4x32_10(counter, key):
    """4 counter words and 2 key words (int64 tensors or ints) -> 4 words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & _MASK32 for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) & _MASK32 for k in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def mask_key(seed: int, bunch: int, layer: int) -> int:
    return (int(seed) + int(bunch) * BUNCH_STRIDE + int(layer) * LAYER_STRIDE) & _MASK32


def keep_masks(keys, rows: int, cols: int, omit: float, device) -> torch.Tensor:
    """(len(keys), rows, cols) float64 0/1 keep masks, one a stream of
    `keys`, P(0) = omit."""
    c4 = (cols + 3) // 4
    col = torch.arange(c4, dtype=torch.int64, device=device).view(1, 1, c4)
    row = torch.arange(rows, dtype=torch.int64, device=device).view(1, rows, 1)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    k = torch.tensor([int(key) & _MASK32 for key in keys], dtype=torch.int64,
                     device=device).view(-1, 1, 1)
    words = philox4x32_10((col, row, zero, zero), (k, zero))
    words = [w.expand(len(keys), rows, c4) for w in words]
    bits = torch.stack(words, dim=-1).reshape(len(keys), rows, c4 * 4)[:, :, :cols]
    threshold = min(int(omit * 4294967296.0), 4294967295)
    return (bits >= threshold).to(torch.float64)


def keep_mask(key: int, rows: int, cols: int, omit: float, device) -> torch.Tensor:
    """(rows, cols) float64 0/1 keep mask of stream `key`, P(0) = omit."""
    return keep_masks([key], rows, cols, omit, device)[0]
