"""PESQ-style objective quality estimator (ITU-T P.862-inspired).

The reference's papers report PESQ gains (README.md:61-71) but the repo ships
no evaluator and this image has no `pesq` package, so the framework provides a
self-contained P.862-*style* estimator: level alignment, cross-correlation
time alignment, Bark-band loudness transform, asymmetric + symmetric
disturbance aggregation (L6/L2 over frames), and the P.862 MOS mapping
4.5 - 0.1*d_sym - 0.0309*d_asym.

IMPORTANT: this follows the structure of P.862 but is NOT the validated ITU
implementation (no utterance re-segmentation, simplified filtering); treat
scores as a consistent relative metric, not certified PESQ-MOS.  Sanity
properties tested: clean==clean scores ~4.5, monotonic in SNR, sensitive to
spectral distortion.

Own copy of tpu_sednn/metrics/pesq.py (host numpy + scipy; the same bits from the
same inputs).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly

_FS = 8000  # narrowband model
_WIN = 256  # 32 ms
_HOP = 128
_NBARK = 49


def _to_fs(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == _FS:
        return x.astype(np.float64)
    g = np.gcd(fs, _FS)
    return resample_poly(x.astype(np.float64), _FS // g, fs // g)


def _level_align(x: np.ndarray, target_p: float = 1e4) -> np.ndarray:
    # align active speech power to a fixed level (P.862 aligns to 79 dB SPL
    # through an IRS filter; we use band-limited power 300-3400 Hz)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / _FS)
    band = (f >= 300) & (f <= 3400)
    p = (np.abs(spec[band]) ** 2).sum() / (len(x) ** 2) + 1e-20
    return x * np.sqrt(target_p / p)


def _time_align(ref: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """Sample-exact global alignment via FFT cross-correlation (the P.862
    crude+fine alignment collapsed into one whole-utterance estimate)."""
    from scipy.signal import fftconvolve

    n = min(len(ref), len(deg))
    if n < _WIN * 4:
        return deg
    c = fftconvolve(deg[:n], ref[:n][::-1], mode="full")
    lag = int(np.argmax(np.abs(c))) - (n - 1)
    if lag > 0:
        deg = deg[lag:]
    elif lag < 0:
        deg = np.concatenate([np.zeros(-lag), deg])
    return deg


def _frames(x: np.ndarray) -> np.ndarray:
    from tpu_sednn_torch.metrics.quality import _frames as _qframes

    return _qframes(x, _WIN, _HOP, np.hanning(_WIN))


def _bark_matrix() -> np.ndarray:
    f = np.fft.rfftfreq(_WIN, 1.0 / _FS)
    bark = 6.0 * np.arcsinh(f / 600.0)  # Schroeder approximation
    edges = np.linspace(bark[1], bark[-1], _NBARK + 1)
    m = np.zeros((_NBARK, len(f)))
    for i in range(_NBARK):
        sel = (bark >= edges[i]) & (bark < edges[i + 1])
        if sel.any():
            m[i, sel] = 1.0 / sel.sum()
    return m


_BARK = None


def _bark_loudness(frames: np.ndarray) -> np.ndarray:
    global _BARK
    if _BARK is None:
        _BARK = _bark_matrix()
    power = np.abs(np.fft.rfft(frames, _WIN)) ** 2  # (n_frames, bins)
    pitch = power @ _BARK.T  # (n_frames, bark)
    # Zwicker-style loudness with a fixed hearing threshold per band
    p0 = 1e4 * (0.4 + 0.6 * np.linspace(1.0, 0.3, _NBARK))  # rough threshold shape
    sl = 0.25
    loud = (p0 / 0.5) ** 0.23 * ((0.5 + 0.5 * pitch / p0) ** 0.23 - 1.0) / sl
    return np.maximum(loud, 0.0)


def pesq(ref: np.ndarray, deg: np.ndarray, fs: int) -> float:
    """P.862-style MOS estimate in roughly [1, 4.6]."""
    x = _level_align(_to_fs(ref, fs))
    y = _level_align(_to_fs(deg, fs))
    y = _time_align(x, y)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]

    lx = _bark_loudness(_frames(x))
    ly = _bark_loudness(_frames(y))
    m = min(len(lx), len(ly))
    if m == 0:
        raise ValueError("signals too short for PESQ estimate")
    lx, ly = lx[:m], ly[:m]

    # symmetric disturbance with masking deadzone
    dead = 0.25 * np.minimum(lx, ly)
    d = np.abs(ly - lx)
    d_sym_f = np.linalg.norm(np.maximum(d - dead, 0.0), axis=1) / np.sqrt(_NBARK)

    # asymmetric disturbance: additive (degraded louder) weighted heavier
    ratio = (ly + 50.0) / (lx + 50.0)
    asym_w = np.clip(ratio**1.2, 0.0, 12.0)
    asym_w[ratio < 1.0] = 0.0
    d_asym_f = np.maximum(ly - lx, 0.0) * asym_w
    d_asym_f = d_asym_f.sum(axis=1) / _NBARK

    # frame energy weighting (silent frames count less), L6/L2 aggregation
    e = lx.sum(axis=1)
    w = ((e + 1e5) / 1e7) ** 0.04
    d_sym_f = np.minimum(d_sym_f / np.maximum(w, 1e-2), 45.0)
    d_asym_f = np.minimum(d_asym_f / np.maximum(w, 1e-2), 45.0)

    def lp(v, p, chunk=20):
        # split-second (chunked) Lp aggregation as in P.862
        pads = (-len(v)) % chunk
        vv = np.pad(v, (0, pads)).reshape(-1, chunk)
        per = (vv**p).mean(axis=1) ** (1.0 / p)
        return (per**2).mean() ** 0.5

    d_sym = lp(d_sym_f, 6.0)
    d_asym = lp(d_asym_f, 2.0)
    # P.862's linear MOS map assumes its exact loudness calibration; ours
    # differs by a scale, so the raw disturbance is passed through a fitted
    # compressive map (calibrated on white-noise mixtures so that clean->4.5,
    # 20 dB -> ~3.0, 0 dB -> ~1.5, matching typical published P.862 behavior).
    raw = 0.1 * d_sym + 0.0309 * d_asym
    mos = 4.5 - 1.65 * raw**0.38 if raw > 0 else 4.5
    return float(np.clip(mos, 1.0, 4.6))
