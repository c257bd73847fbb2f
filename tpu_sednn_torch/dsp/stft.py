"""STFT / log-power spectrum / inverse STFT in PyTorch.

Counterpart of `tpu_sednn/dsp/stft.py`.  The forward transform is a real DFT
written as two matmuls against (win_len, n_bins) cos/sin matrices with the
window folded in; the inverse is the matching irDFT matmul plus windowed
overlap-add divided by the window-square overlap sum.  Decode keeps the noisy
phase by rescaling the noisy (re, im) pair to the enhanced magnitude.

Every function takes an optional leading batch dimension: signals are
(..., n_samples), spectra (..., n_frames, n_bins).  The DFT matrices are built
once in numpy (float64, cast to float32, exactly as the JAX package builds
them) and their device copies are cached per (config, device).

The log-power spectrum of a signal also has a hand-written CUDA kernel,
`tpu_sednn_torch.ops.stft_lps`; the functions here stay plain torch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

LPS_FLOOR = 1e-12  # power floor before log


@dataclass(frozen=True)
class StftConfig:
    sample_rate: int = 8000
    win_len: int = 256
    hop: int = 128
    n_fft: int = 256
    window: str = "hamming"

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def frame_shift_s(self) -> float:
        return self.hop / self.sample_rate

    @classmethod
    def for_rate(cls, sample_rate: int) -> "StftConfig":
        if sample_rate == 8000:
            return cls(8000, 256, 128, 256)
        if sample_rate == 16000:
            return cls(16000, 512, 256, 512)
        # generic: 32 ms window, 16 ms shift, next pow2 n_fft
        win = int(round(0.032 * sample_rate))
        n_fft = 1 << (win - 1).bit_length()
        return cls(sample_rate, win, int(round(0.016 * sample_rate)), n_fft)

    def n_frames(self, n_samples: int) -> int:
        """Frames of a signal of n_samples, tail truncated; raises if < 1."""
        if n_samples < self.win_len:
            raise ValueError(
                f"signal of {n_samples} samples is shorter than one window "
                f"({self.win_len} samples)")
        return 1 + (n_samples - self.win_len) // self.hop


def _window_np(cfg: StftConfig) -> np.ndarray:
    n = cfg.win_len
    if cfg.window == "hamming":
        # periodic hamming (better OLA properties than symmetric)
        return (0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)
    if cfg.window == "hann":
        return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)
    if cfg.window == "rect":
        return np.ones(n, dtype=np.float32)
    raise ValueError(f"unknown window {cfg.window}")


@functools.lru_cache(maxsize=8)
def _rdft_matrices(win_len: int, n_fft: int, window: str) -> tuple[np.ndarray, np.ndarray]:
    """(cos_mtx, sin_mtx) of shape (win_len, n_bins), window folded in.

    frames_raw @ cos_mtx == Re(rfft(frames_raw * window, n_fft))
    frames_raw @ sin_mtx == Im(rfft(frames_raw * window, n_fft))
    """
    w = _window_np(StftConfig(0, win_len, 0, n_fft, window)).astype(np.float64)
    n_bins = n_fft // 2 + 1
    t = np.arange(win_len)[:, None]  # zero-padding to n_fft only adds zero rows
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    cos_m = (np.cos(ang) * w[:, None]).astype(np.float32)
    sin_m = (-np.sin(ang) * w[:, None]).astype(np.float32)
    return cos_m, sin_m


@functools.lru_cache(maxsize=8)
def _irdft_matrices(win_len: int, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(icos_mtx, isin_mtx) of shape (n_bins, win_len): inverse real DFT.

    frames = re @ icos_mtx + im @ isin_mtx  reproduces irfft(re + i*im)[:win_len].
    """
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[:, None]
    t = np.arange(win_len)[None, :]
    ang = 2.0 * np.pi * k * t / n_fft
    # irfft coefficient weights: 1/n_fft for DC and Nyquist, 2/n_fft otherwise
    scale = np.full((n_bins, 1), 2.0 / n_fft)
    scale[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        scale[-1] = 1.0 / n_fft
    icos = (np.cos(ang) * scale).astype(np.float32)
    isin = (-np.sin(ang) * scale).astype(np.float32)
    return icos, isin


@functools.lru_cache(maxsize=16)
def rdft_on(cfg: StftConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Device copies of _rdft_matrices for cfg, cached per (cfg, device)."""
    cos_m, sin_m = _rdft_matrices(cfg.win_len, cfg.n_fft, cfg.window)
    return torch.from_numpy(cos_m).to(device), torch.from_numpy(sin_m).to(device)


@functools.lru_cache(maxsize=16)
def _irdft_on(cfg: StftConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(icos, isin, window) on device, cached per (cfg, device)."""
    icos, isin = _irdft_matrices(cfg.win_len, cfg.n_fft)
    w = _window_np(cfg)
    return tuple(torch.from_numpy(a).to(device) for a in (icos, isin, w))


@functools.lru_cache(maxsize=16)
def _inv_wsum_on(cfg: StftConfig, n_frames: int, device: torch.device) -> torch.Tensor:
    """1 / window-square overlap sum, (total,) on device, cached per
    (cfg, n_frames, device): built once on the host instead of per call."""
    total = (n_frames - 1) * cfg.hop + cfg.win_len
    idx = np.arange(n_frames)[:, None] * cfg.hop + np.arange(cfg.win_len)[None, :]
    wsum = np.zeros(total, np.float32)
    np.add.at(wsum, idx.ravel(), np.tile(_window_np(cfg) ** 2, n_frames))
    return torch.from_numpy(1.0 / np.maximum(wsum, 1e-8)).to(device)


def frame_signal(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """(..., n_samples) -> (..., n_frames, win_len), hop-strided, truncating
    the tail.  A strided view of x (Tensor.unfold), no copy."""
    cfg.n_frames(x.shape[-1])
    return x.unfold(-1, cfg.win_len, cfg.hop)


def stft_real_imag(x: torch.Tensor, cfg: StftConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Signal -> (re, im) each (..., n_frames, n_bins). Windowing folded into the matmul."""
    frames = frame_signal(x, cfg)
    cos_m, sin_m = rdft_on(cfg, x.device)
    return frames @ cos_m, frames @ sin_m


def stft_logpower(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Signal -> log-power spectrum (..., n_frames, n_bins); LPS = ln(|X|^2)."""
    re, im = stft_real_imag(x, cfg)
    return torch.log(torch.clamp(re * re + im * im, min=LPS_FLOOR))


def istft_overlap_add(
    re: torch.Tensor, im: torch.Tensor, cfg: StftConfig, n_samples: int | None = None
) -> torch.Tensor:
    """(re, im) (..., n_frames, n_bins) -> signal (..., n) via windowed overlap-add.

    Uses the analysis window also as synthesis window and divides by the
    window-square overlap sum (standard weighted OLA; exact reconstruction up
    to edge frames for any window/hop with nonzero overlap sum).
    """
    icos, isin, w = _irdft_on(cfg, re.device)
    frames = (re @ icos + im @ isin) * w  # (..., n_frames, win_len)
    lead, n_frames = frames.shape[:-2], frames.shape[-2]
    total = (n_frames - 1) * cfg.hop + cfg.win_len
    cols = frames.reshape(-1, n_frames, cfg.win_len).transpose(1, 2)
    sig = torch.nn.functional.fold(
        cols, output_size=(1, total), kernel_size=(1, cfg.win_len), stride=(1, cfg.hop)
    ).reshape(*lead, total)
    sig = sig * _inv_wsum_on(cfg, n_frames, re.device)
    if n_samples is not None:
        if n_samples > total:  # framing truncated the tail; zero-pad back
            sig = torch.nn.functional.pad(sig, (0, n_samples - total))
        else:
            sig = sig[..., :n_samples]
    return sig


def reconstruct_from_lps(
    enhanced_lps: torch.Tensor,
    noisy_re: torch.Tensor,
    noisy_im: torch.Tensor,
    cfg: StftConfig,
    n_samples: int | None = None,
) -> torch.Tensor:
    """Enhanced LPS + noisy phase -> waveform (the reference decode semantics).

    The noisy (re, im) pair carries the phase; it is rescaled to the enhanced
    magnitude: X_enh = X_noisy * (mag_enh / mag_noisy).
    """
    noisy_mag = torch.sqrt(torch.clamp(noisy_re**2 + noisy_im**2, min=LPS_FLOOR))
    gain = torch.exp(0.5 * enhanced_lps) / noisy_mag
    return istft_overlap_add(noisy_re * gain, noisy_im * gain, cfg, n_samples)
