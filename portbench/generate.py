"""The traffic's inputs, made on the device from the seed in a few large
calls: a training corpus of normalised-LPS-like samples, and noisy
speech-like utterances for enhancement."""

from __future__ import annotations

import math
from typing import Tuple

import torch


def training_corpus(gen: torch.Generator, rows: int, n_bins: int, context: int, offset: int,
                    nat_frames: int, utt_frames: int, target_gain: float, target_noise: float,
                    device: torch.device, block: int = 131072) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X, T): rows spliced as the recipe's features are.  Utterances of
    `utt_frames` frames of N(0, 1) values (normalised LPS frames); row r is
    its utterance's frames r - offset .. r - offset + context - 1, edge
    replicated, then the utterance's noise estimate (the mean of its first
    `nat_frames` frames); its target is target_gain * frame r plus
    target_noise * N(0, 1)."""
    n_utt = -(-rows // utt_frames)
    frames = torch.randn(n_utt * utt_frames, n_bins, generator=gen, device=device)
    nat = frames.view(n_utt, utt_frames, n_bins)[:, :nat_frames].mean(dim=1)
    x = torch.empty(rows, (context + 1) * n_bins, device=device)
    shift = torch.arange(context, device=device) - offset
    for r0 in range(0, rows, block):
        r = torch.arange(r0, min(r0 + block, rows), device=device)
        utt, pos = r // utt_frames, r % utt_frames
        src = utt[:, None] * utt_frames + (pos[:, None] + shift).clamp(0, utt_frames - 1)
        x[r0:r0 + r.numel(), :context * n_bins] = frames[src].view(r.numel(), -1)
        x[r0:r0 + r.numel(), context * n_bins:] = nat[utt]
    t = torch.randn(rows, n_bins, generator=gen, device=device).mul_(target_noise)
    t.add_(frames[:rows], alpha=target_gain)
    return x, t


def noisy_speech(gen: torch.Generator, n_utt: int, n_samples: int, sample_rate: int,
                 snr_db: Tuple[float, float], device: torch.device) -> torch.Tensor:
    """(n_utt, n_samples) float32: voiced, amplitude-modulated harmonic
    signals with pauses (11 harmonics of a vibrato f0 of 90-250 Hz under a
    squared-sine envelope), plus noise coloured by a random 9-tap filter at
    an SNR drawn uniformly from `snr_db`, clipped to [-1, 1]."""
    def u(lo, hi, *shape, dtype=torch.float64):
        return torch.rand(*shape, generator=gen, device=device, dtype=dtype) * (hi - lo) + lo

    t = torch.arange(n_samples, device=device, dtype=torch.float64) / sample_rate
    f0 = u(90, 250, n_utt, 1) * (1 + 0.1 * torch.sin(2 * math.pi * u(0.5, 3, n_utt, 1) * t))
    phase = 2 * math.pi * torch.cumsum(f0, dim=1) / sample_rate
    amp, shift = u(0.2, 1.0, n_utt, 11), u(0.0, 6.28, n_utt, 11)
    sig = torch.zeros(n_utt, n_samples, device=device, dtype=torch.float64)
    for h in range(1, 12):
        sig += amp[:, h - 1:h] / h * torch.sin(h * phase + shift[:, h - 1:h])
    env = torch.clamp(torch.sin(2 * math.pi * u(1.5, 4, n_utt, 1) * t + u(0, 6.28, n_utt, 1)),
                      min=0) ** 2
    speech = (0.25 * sig * env / sig.abs().amax(dim=1, keepdim=True).clamp(min=1e-9)).float()
    white = torch.randn(n_utt, n_samples + 8, generator=gen, device=device)
    taps = u(-1, 1, n_utt, 9, dtype=torch.float32)
    noise = torch.zeros(n_utt, n_samples, device=device)
    for k in range(9):
        noise += white[:, k:k + n_samples] * taps[:, k:k + 1]
    snr = u(snr_db[0], snr_db[1], n_utt, 1, dtype=torch.float32)
    p_s = speech.pow(2).mean(dim=1, keepdim=True)
    p_n = noise.pow(2).mean(dim=1, keepdim=True).clamp(min=1e-20)
    noise *= torch.sqrt(p_s / (p_n * 10 ** (snr / 10)))
    return torch.clamp(speech + noise, -1.0, 1.0)
