"""Log-power spectrum of signals on the hand-written CUDA kernel
`csrc/stft_lps.cu` — the port of tpu_sednn/ops/stft_pallas.py:_stft_kernel.

`stft_lps(x, cfg)` takes a float32 signal (n_samples,) or batch
(B, n_samples) and returns the LPS (..., n_frames, n_bins), n_frames =
1 + (n_samples - win_len) // hop as in dsp/stft.py.  On a CUDA tensor it
launches the kernel (or raises); on a CPU tensor it runs the plain version
`stft_lps_reference`.  The kernel is fp32-FMA-bound at the serving shapes
(its source says why and how it is laid out).

`stft_lps.launches` counts kernel launches; nothing else changes it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_sednn_torch.dsp.stft import LPS_FLOOR, StftConfig, frame_signal, rdft_on
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


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("stft_lps")
    lib.stft_lps_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
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
    xb = x.reshape(-1, x.shape[-1])
    cos_m, sin_m = rdft_on(cfg, x.device)
    out = torch.empty((xb.shape[0], n_frames, cfg.n_bins), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().stft_lps_f32(
            xb.data_ptr(), out.data_ptr(), cos_m.data_ptr(), sin_m.data_ptr(),
            xb.shape[0], xb.shape[1], n_frames, cfg.n_bins, cfg.win_len, cfg.hop,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"stft_lps kernel launch failed: CUDA error {rc}")
    stft_lps.launches += 1
    return out if x.dim() == 2 else out[0]


stft_lps.launches = 0
