"""Log-power spectrum of signals on the hand-written CUDA kernel
`csrc/stft_lps.cu` — the port of tpu_sednn/ops/stft_pallas.py:_stft_kernel.

`stft_lps(x, cfg)` takes a float32 signal (n_samples,) or batch
(B, n_samples) and returns the LPS (..., n_frames, n_bins), n_frames =
1 + (n_samples - win_len) // hop as in dsp/stft.py.  On a CUDA tensor it
launches the kernel (or raises); on a CPU tensor it runs the plain version
`stft_lps_reference`.  The kernel is an FFT in each warp's registers (four
steps: each lane's radix-2 FFT, twiddles, 32-point FFTs across the warp by
shuffles, the real split step) fused with the window, the power and the log
(its source says how it is laid out); `fft_tables` builds the float32 window
and twiddle tables it reads.

`stft_lps.launches` counts kernel launches; nothing else changes it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpu_sednn_torch.dsp.stft import LPS_FLOOR, StftConfig, _window_np, frame_signal, rdft_on
from tpu_sednn_torch.ops import _build


def stft_lps_reference(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Plain torch version of the kernel: unfold, matmul with C/S, log-power,
    summed in float64 and returned as float32.

    float64 makes it the exact function up to the output's rounding.  Two
    float32 sums of win_len products in different orders (the kernel's, a
    BLAS's) differ in bins where a strong tone's leakage cancels, and ln
    magnifies that: at win_len 706 (22050 Hz) by more than atol 1e-4 +
    rtol 1e-4, so a float32 plain version could not tell a wrong kernel from
    another summation order."""
    frames = frame_signal(x, cfg).double()
    cos_m, sin_m = (m.double() for m in rdft_on(cfg, x.device))
    re, im = frames @ cos_m, frames @ sin_m
    return torch.log(torch.clamp(re * re + im * im, min=LPS_FLOOR)).float()


def _brev(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def fft_tables(cfg: StftConfig) -> tuple[np.ndarray, np.ndarray]:
    """(window (win_len,), twiddle (n, 2)) float32: the tables the kernel
    reads.  With T[j] = exp(-2*pi*i*j / n_fft), m = n_fft // 2 = 32 r and
    brev(x, b) the b-bit reversal of x, twiddle holds, as (cos, sin) pairs
    computed in float64 and rounded: T[q*n_fft/r] for q < r/2 (the lanes'
    r-point FFTs); T[2*l*k] for k = 1..r-1, lane l < 32 (W_m^(l k)); for h =
    16, 8, 4, 2, 1, T[2*r*(l mod h)*16/h] (the 32-point FFTs across a warp);
    T[brev(s, log2 r) + r*brev(l, 5)] for slot s < r, lane l (the split
    step); T[m].  The window is dsp/stft.py's.  The kernel's FFT needs n_fft a
    power of two from 256 to 2048 (StftConfig.for_rate's 8 to 48 kHz) and
    win_len <= n_fft: anything else raises ValueError."""
    n = cfg.n_fft
    if n < 256 or n > 2048 or n & (n - 1):
        raise ValueError(f"the STFT kernel needs n_fft a power of two from 256 to 2048, got {n}")
    if cfg.win_len > n:
        raise ValueError(f"the STFT kernel needs win_len <= n_fft, got {cfg.win_len} > {n}")
    m = n // 2
    r = m // 32
    rb = r.bit_length() - 1
    lanes = np.arange(32)
    idx = [np.arange(r // 2) * (n // r)]
    idx += [2 * lanes * k for k in range(1, r)]
    idx += [2 * r * (lanes & (h - 1)) * (16 // h) for h in (16, 8, 4, 2, 1)]
    idx += [np.array([_brev(s, rb) + r * _brev(l, 5) for l in range(32)]) for s in range(r)]
    idx.append(np.array([m]))
    ang = -2.0 * np.pi * np.concatenate(idx).astype(np.float64) / n
    twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return _window_np(cfg), twiddle


@functools.lru_cache(maxsize=16)
def _fft_tables_on(cfg: StftConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Device copies of fft_tables(cfg), cached per (cfg, device)."""
    return tuple(torch.from_numpy(a).to(device) for a in fft_tables(cfg))


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("stft_lps")
    lib.stft_lps_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.stft_lps_f32.restype = ctypes.c_int
    return lib


def stft_lps(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Signal (n_samples,) or (B, n_samples) float32 -> LPS (..., n_frames, n_bins)."""
    if x.dtype != torch.float32:
        raise TypeError(f"stft_lps takes float32 signals, got {x.dtype}")
    if x.dim() not in (1, 2):
        raise ValueError(f"stft_lps takes (n_samples,) or (B, n_samples), got {tuple(x.shape)}")
    n_frames = cfg.n_frames(x.shape[-1])
    if x.device.type == "cpu":
        return stft_lps_reference(x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"stft_lps runs on cuda or cpu tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("stft_lps needs a contiguous signal")
    window, twiddle = _fft_tables_on(cfg, x.device)
    xb = x.reshape(-1, x.shape[-1])
    out = torch.empty((xb.shape[0], n_frames, cfg.n_bins), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().stft_lps_f32(
            xb.data_ptr(), out.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
            xb.shape[0], xb.shape[1], n_frames, cfg.n_bins, cfg.win_len, cfg.hop, cfg.n_fft,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"stft_lps kernel launch failed: CUDA error {rc}")
    stft_lps.launches += 1
    return out if x.dim() == 2 else out[0]


stft_lps.launches = 0
