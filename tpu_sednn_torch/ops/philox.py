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
`philox_mask_words` packs a mask 32 columns to a 32-bit word, as the chunk
trainer's draw kernel stores its input masks.

Stochastic rounding to bfloat16 (`csrc/sr_round.cuh`): `sr_to_bf16_reference`
adds 16 random bits to the low half of the float32 bit pattern and drops the
low half; `sr_bits` gives the words a kernel draws for element (row, col)
of a stream (second key word SR_TAG; the low half rounds a momentum, the
high half a weight), so a bfloat16 update is comparable element by element
too.
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
                device: str | torch.device = "cpu", key1: int = 0) -> torch.Tensor:
    """(rows, cols) int64 tensor of the 32-bit words of rows row0..row0+rows
    of the stream `key` (second key word `key1`: 0 for the dropout streams)."""
    c4 = (cols + 3) // 4
    col = torch.arange(c4, dtype=torch.int64, device=device)[None, :].expand(rows, c4)
    row = (row0 + torch.arange(rows, dtype=torch.int64, device=device))[:, None].expand(rows, c4)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    k = torch.as_tensor(key & _MASK32, dtype=torch.int64, device=device)
    k1 = torch.as_tensor(key1 & _MASK32, dtype=torch.int64, device=device)
    words = philox4x32_10((col, row, zero, zero), (k, k1))
    return torch.stack(words, dim=-1).reshape(rows, c4 * 4)[:, :cols]


def philox_mask(key: int, rows: int, cols: int, omit: float, row0: int = 0,
                device: str | torch.device = "cpu") -> torch.Tensor:
    """(rows, cols) float32 0/1 mask, P(0) = omit."""
    bits = philox_bits(key, rows, cols, row0, device)
    return (bits >= mask_threshold(omit)).to(torch.float32)


def mask_words(cols: int) -> int:
    """Words a row of a packed keep-bit table of `cols` columns holds:
    ceil(cols / 32) (csrc/philox.cuh:mask_words)."""
    return (int(cols) + 31) // 32


def pack_mask_words(keep: torch.Tensor) -> torch.Tensor:
    """(rows, cols) 0/1 or bool -> (rows, mask_words(cols)) int32 table: bit b
    of word w of a row is element 32 w + b (0 past cols), the 32-bit word
    held in an int32 as its bit pattern."""
    rows, cols = keep.shape
    words = mask_words(cols)
    bits = torch.zeros((rows, words * 32), dtype=torch.int64, device=keep.device)
    bits[:, :cols] = keep.to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=keep.device) << torch.arange(
        32, dtype=torch.int64, device=keep.device)
    packed = (bits.reshape(rows, words, 32) * weights).sum(dim=-1)
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(torch.int32)


def unpack_mask_words(table: torch.Tensor, cols: int) -> torch.Tensor:
    """The (rows, cols) float32 0/1 mask of a packed table (pack_mask_words)."""
    shifts = torch.arange(32, dtype=torch.int64, device=table.device)
    bits = (table.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.reshape(table.shape[0], -1)[:, :cols].to(torch.float32)


def philox_mask_words(key: int, rows: int, cols: int, omit: float, row0: int = 0,
                      device: str | torch.device = "cpu") -> torch.Tensor:
    """`philox_mask` packed: (rows, mask_words(cols)) int32, bit b of word w
    of row r the keep of column 32 w + b (0 past cols) — the table the chunk
    trainer's draw kernel writes for a tile and the layer-0 kernels read
    (csrc/philox.cuh, mode 3)."""
    bits = philox_bits(key, rows, cols, row0, device)
    return pack_mask_words(bits >= mask_threshold(omit))


SR_TAG = 0x53524E44  # second key word of every stochastic-rounding stream
SR_DELTA_SHIFT, SR_WEIGHT_SHIFT = 0, 16


def sr_bits(key: int, rows: int, cols: int, shift: int = SR_DELTA_SHIFT,
            device: str | torch.device = "cpu") -> torch.Tensor:
    """(rows, cols) int64 tensor of the 16-bit draws the kernels round
    element (row, col) with under stream `key`: bits shift..shift+15 of the
    element's word (SR_DELTA_SHIFT for a momentum, SR_WEIGHT_SHIFT for a
    weight)."""
    return (philox_bits(key, rows, cols, 0, device, key1=SR_TAG) >> shift) & 0xFFFF


def sr_to_bf16_reference(val: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16 with stochastic rounding, in integer tensor
    arithmetic, bit-equal to the device function `sr_bf16`.

    bits: integers of val's shape; their low 16 bits are added to the
    float32 bit pattern, whose low half is then dropped.  The result moves
    away from zero with probability (dropped fraction): unbiased.  A value
    bfloat16 holds exactly comes back unchanged whatever the bits.  Inf and
    NaN pass through (a NaN stays a NaN: the quiet bit is set).
    """
    if val.dtype != torch.float32:
        raise TypeError(f"sr_to_bf16_reference rounds float32, got {val.dtype}")
    u = val.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    top = ((u + (bits.to(torch.int64) & 0xFFFF)) >> 16) & 0xFFFF
    non_finite = (u & 0x7F800000) == 0x7F800000
    is_nan = non_finite & ((u & 0x007FFFFF) != 0)
    kept = (u >> 16) | torch.where(is_nan, 0x40, 0)
    top = torch.where(non_finite, kept, top)
    signed = torch.where(top >= 0x8000, top - 0x10000, top).to(torch.int16)
    return signed.view(torch.bfloat16)
