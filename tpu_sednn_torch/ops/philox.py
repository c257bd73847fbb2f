"""Philox4x32-10 in torch integer arithmetic — the plain version of the
counter-based generator that `csrc/philox.cuh` runs on the card.

The dropout stream of the chunk trainer (kernel 4): the mask of element
(row, col) of the GLOBAL bunch under a 32-bit key is

    bits = philox4x32_10(counter=(col // 4, row, 0, 0), key=(key, 0))[col % 4]
    mask = 1.0 if bits >= floor(omit * 2**32) else 0.0

so it depends on nothing but (key, row, col): not on tiling, launch geometry
or the number of devices.  This file is bit-equal to the device function
(int64 tensors hold the 32-bit words; 32x32-bit products are formed from
16-bit halves so nothing overflows), which makes a chunk trained WITH
dropout comparable between the kernel and its plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * b; a < 2**32 a constant, b int64 in [0, 2**32)."""
    p_lo = a * (b & 0xFFFF)  # < 2**48
    p_hi = a * (b >> 16)     # < 2**48
    low = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (p_hi >> 16) + (low >> 32), low & _MASK32


def philox4x32_10(counter, key) -> Tuple[torch.Tensor, ...]:
    """counter: 4 int64 tensors (or ints) of 32-bit words, key: 2 -> 4 int64
    tensors of 32-bit words (Salmon et al., "Parallel random numbers: as easy
    as 1, 2, 3", 2011; the Random123 known-answer vectors hold)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & _MASK32 for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) & _MASK32 for k in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def mask_threshold(omit: float) -> int:
    """floor(omit * 2**32), capped at 2**32 - 1: P(bits < threshold) = omit."""
    return min(int(omit * 4294967296.0), 4294967295)


def philox_bits(key: int, rows: int, cols: int, row0: int = 0,
                device: str | torch.device = "cpu") -> torch.Tensor:
    """(rows, cols) int64 tensor of the 32-bit words of rows row0..row0+rows
    of the stream `key`."""
    c4 = (cols + 3) // 4
    col = torch.arange(c4, dtype=torch.int64, device=device)[None, :].expand(rows, c4)
    row = (row0 + torch.arange(rows, dtype=torch.int64, device=device))[:, None].expand(rows, c4)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    k = torch.as_tensor(key & _MASK32, dtype=torch.int64, device=device)
    words = philox4x32_10((col, row, zero, zero), (k, zero))
    return torch.stack(words, dim=-1).reshape(rows, c4 * 4)[:, :cols]


def philox_mask(key: int, rows: int, cols: int, omit: float, row0: int = 0,
                device: str | torch.device = "cpu") -> torch.Tensor:
    """(rows, cols) float32 0/1 mask, P(0) = omit."""
    bits = philox_bits(key, rows, cols, row0, device)
    return (bits >= mask_threshold(omit)).to(torch.float32)
