"""Offline enhancement of a batch of noisy waveforms, written out in plain
torch (Xu et al., TASLP 2015, with the reference recipe's features):

    periodic Hamming window, frames of win_len every hop (the tail that
    fills no frame is dropped), real DFT of n_fft points, LPS = ln(max(|X|^2,
    1e-12)), normalised by the given mean and inverse deviation, spliced
    over `context` frames (offset frames before, the rest after, the
    utterance's first and last frames repeated at its edges), followed by
    the noise estimate (the mean of the first nat_frames normalised frames);
    the net (ReLU hidden layers, linear head) with each layer's weights
    scaled by its input's keep probability; the enhanced LPS given the noisy
    phase, inverse real DFT, the window again, overlap-add divided by the
    overlapped window's square (at least 1e-8), zeros past the last frame.

The transforms are written as products with the DFT's matrices, so that
every product of the decode is one: `precision` "f64" computes in float64;
"tf32" in float32 with the operands of every product (the transforms' and
the net's) rounded to TF32 (10 mantissa bits, to nearest), the
lower-precision control of a float32 program, alike on every device.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

LPS_FLOOR = 1e-12


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 `a` rounded to TF32's 10 mantissa bits (ties away from zero)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def hamming(n: int, dtype, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.54 - 0.46 * torch.cos(2 * math.pi * k / n)).to(dtype)


def enhance(wavs: torch.Tensor, w: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
            keeps: Sequence[float], mean: torch.Tensor, inv_std: torch.Tensor, win_len: int,
            hop: int, n_fft: int, context: int, offset: int, nat_frames: int,
            precision: str = "f64") -> torch.Tensor:
    """(batch, n) noisy waveforms -> (batch, n) enhanced waveforms."""
    if precision not in ("f64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    if win_len % hop:
        raise ValueError(f"overlap-add here needs hop {hop} to divide win_len {win_len}")
    dt = torch.float64 if precision == "f64" else torch.float32

    def mm(a, b):
        return a @ b if precision == "f64" else tf32(a) @ tf32(b)

    dev = wavs.device
    x = wavs.to(dt)
    n = x.shape[-1]
    window = hamming(win_len, torch.float64, dev)
    bins = n_fft // 2 + 1
    ang = (2 * math.pi / n_fft) * torch.outer(
        torch.arange(win_len, dtype=torch.float64, device=dev),
        torch.arange(bins, dtype=torch.float64, device=dev))
    fwd_cos = (torch.cos(ang) * window[:, None]).to(dt)
    fwd_sin = (-torch.sin(ang) * window[:, None]).to(dt)
    scale = torch.full((bins, 1), 2.0 / n_fft, dtype=torch.float64, device=dev)
    scale[0] = scale[-1] = 1.0 / n_fft
    inv_cos, inv_sin = (torch.cos(ang.T) * scale).to(dt), (-torch.sin(ang.T) * scale).to(dt)
    window = window.to(dt)
    frames = x.unfold(-1, win_len, hop)
    re, im = mm(frames, fwd_cos), mm(frames, fwd_sin)
    power = re ** 2 + im ** 2
    lps = torch.log(torch.clamp(power, min=LPS_FLOOR))
    normed = (lps - mean.to(dt)) * inv_std.to(dt)
    n_frames = normed.shape[-2]
    pos = torch.arange(n_frames, device=dev)[:, None] + torch.arange(context, device=dev) - offset
    spliced = normed[..., pos.clamp(0, n_frames - 1), :].flatten(-2)
    nat = normed[..., :nat_frames, :].mean(dim=-2, keepdim=True).expand_as(normed)
    h = torch.cat([spliced, nat], dim=-1)
    for l, (wl, bl, k) in enumerate(zip(w, b, keeps)):
        h = mm(h, wl.to(dt) * k) + bl.to(dt)
        if l < len(w) - 1:
            h = torch.relu(h)
    gain = torch.exp(0.5 * h) / torch.sqrt(torch.clamp(power, min=LPS_FLOOR))
    out_frames = (mm(re * gain, inv_cos) + mm(im * gain, inv_sin)) * window
    total = (n_frames - 1) * hop + win_len
    sig = torch.zeros(*x.shape[:-1], total, dtype=dt, device=dev)
    wsum = torch.zeros(total, dtype=dt, device=dev)
    for f in range(0, win_len, hop):
        # frames whose samples f .. f + hop - 1 land in hop-aligned blocks
        sig[..., f:f + n_frames * hop].view(*x.shape[:-1], n_frames, hop).add_(
            out_frames[..., f:f + hop])
        wsum[f:f + n_frames * hop].view(n_frames, hop).add_(window[f:f + hop] ** 2)
    sig = sig / torch.clamp(wsum, min=1e-8)
    if n > total:
        sig = torch.nn.functional.pad(sig, (0, n - total))
    return sig[..., :n]
