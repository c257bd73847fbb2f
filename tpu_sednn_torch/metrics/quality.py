"""Speech-quality metrics, implemented in-repo (no pystoi/pesq in the image).

The reference's evaluation story is PESQ/STOI/SegSNR reported in its papers
(README.md:61-71) plus listening to enh_wav_example clips; this module gives
the framework a quantitative gate: STOI (Taal et al. 2011, full short-time
one-third-octave implementation), segmental SNR, log-spectral distance, and
SI-SDR.

Own copy of tpu_sednn/metrics/quality.py (host numpy + scipy; the same bits from the
same inputs).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _frames(x: np.ndarray, win: int, hop: int, window: np.ndarray | None = None) -> np.ndarray:
    n = 1 + (len(x) - win) // hop if len(x) >= win else 0
    idx = np.arange(n)[:, None] * hop + np.arange(win)[None, :]
    f = x[idx]
    return f * window if window is not None else f


def _align(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    n = min(len(a), len(b))
    return a[:n].astype(np.float64), b[:n].astype(np.float64)


# ---------------------------------------------------------------------------
# STOI (Taal, Hendriks, Heusdens, Jensen 2011)
# ---------------------------------------------------------------------------

_STOI_FS = 10000
_STOI_WIN = 256
_STOI_HOP = 128
_STOI_NFFT = 512
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_SEG = 30  # frames per short-time segment (384 ms)
_STOI_BETA = -15.0  # lower SDR bound, dB
_STOI_DYN = 40.0  # silent-frame removal threshold, dB


def _third_octave_matrix(fs: int, nfft: int, n_bands: int, min_freq: float) -> np.ndarray:
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(n_bands, dtype=np.float64)
    cf = min_freq * 2.0 ** (k / 3.0)
    lo = min_freq * 2.0 ** ((2 * k - 1) / 6.0)
    hi = min_freq * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((n_bands, len(f)))
    for i in range(n_bands):
        lo_i = int(np.argmin((f - lo[i]) ** 2))
        hi_i = int(np.argmin((f - hi[i]) ** 2))
        obm[i, lo_i:hi_i] = 1.0
    return obm


def _remove_silent_frames(x: np.ndarray, y: np.ndarray, dyn_db: float, win: int, hop: int):
    w = np.hanning(win + 2)[1:-1]
    xf = _frames(x, win, hop, w)
    yf = _frames(y, win, hop, w)
    if len(xf) == 0:
        return x, y
    energy = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-20)
    keep = energy > energy.max() - dyn_db
    xf, yf = xf[keep], yf[keep]
    # overlap-add back (windows sum to ~constant at 50% overlap)
    n = (len(xf) - 1) * hop + win if len(xf) else 0
    xs = np.zeros(n)
    ys = np.zeros(n)
    ws = np.zeros(n)
    for i in range(len(xf)):
        sl = slice(i * hop, i * hop + win)
        xs[sl] += xf[i]
        ys[sl] += yf[i]
        ws[sl] += w * w
    ws = np.maximum(ws, 1e-12)
    return xs / ws * w.mean(), ys / ws * w.mean()


def stoi(clean: np.ndarray, processed: np.ndarray, fs: int) -> float:
    """Short-Time Objective Intelligibility, in [~0, 1]."""
    x, y = _align(clean, processed)
    if fs != _STOI_FS:
        g = np.gcd(fs, _STOI_FS)
        x = resample_poly(x, _STOI_FS // g, fs // g)
        y = resample_poly(y, _STOI_FS // g, fs // g)
    x, y = _remove_silent_frames(x, y, _STOI_DYN, _STOI_WIN, _STOI_HOP)
    w = np.hanning(_STOI_WIN + 2)[1:-1]
    X = np.fft.rfft(_frames(x, _STOI_WIN, _STOI_HOP, w), _STOI_NFFT)
    Y = np.fft.rfft(_frames(y, _STOI_WIN, _STOI_HOP, w), _STOI_NFFT)
    if len(X) < _STOI_SEG:
        raise ValueError("signal too short for STOI (needs >= ~0.5 s of speech)")
    obm = _third_octave_matrix(_STOI_FS, _STOI_NFFT, _STOI_NBANDS, _STOI_MINFREQ)
    Xb = np.sqrt(obm @ (np.abs(X.T) ** 2))  # (bands, frames)
    Yb = np.sqrt(obm @ (np.abs(Y.T) ** 2))

    clip = 10.0 ** (-_STOI_BETA / 20.0)
    scores = []
    for m in range(_STOI_SEG, Xb.shape[1] + 1):
        Xs = Xb[:, m - _STOI_SEG : m]  # (bands, 30)
        Ys = Yb[:, m - _STOI_SEG : m]
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
            np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-20
        )
        Ysn = np.minimum(Ys * alpha, Xs * (1 + clip))
        xm = Xs - Xs.mean(axis=1, keepdims=True)
        ym = Ysn - Ysn.mean(axis=1, keepdims=True)
        num = (xm * ym).sum(axis=1)
        den = np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-20
        scores.append(num / den)
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# SNR family
# ---------------------------------------------------------------------------

def snr(clean: np.ndarray, processed: np.ndarray) -> float:
    x, y = _align(clean, processed)
    e = y - x
    return float(10 * np.log10((x**2).sum() / max((e**2).sum(), 1e-20)))


def seg_snr(clean: np.ndarray, processed: np.ndarray, fs: int,
            frame_ms: float = 32.0, lo: float = -10.0, hi: float = 35.0) -> float:
    """Segmental SNR, clamped per segment to [lo, hi] dB (standard practice)."""
    x, y = _align(clean, processed)
    win = int(fs * frame_ms / 1000)
    xf = _frames(x, win, win)
    yf = _frames(y, win, win)
    e = yf - xf
    seg = 10 * np.log10((xf**2).sum(axis=1) / np.maximum((e**2).sum(axis=1), 1e-20) + 1e-20)
    # skip silent segments
    active = (xf**2).sum(axis=1) > 1e-8 * max((x**2).sum(), 1e-12)
    if not active.any():
        return float(np.clip(seg, lo, hi).mean())
    return float(np.clip(seg[active], lo, hi).mean())


def si_sdr(clean: np.ndarray, processed: np.ndarray) -> float:
    x, y = _align(clean, processed)
    x = x - x.mean()
    y = y - y.mean()
    s = (y @ x) / max(x @ x, 1e-20) * x
    e = y - s
    return float(10 * np.log10(max((s**2).sum(), 1e-20) / max((e**2).sum(), 1e-20)))


def lsd(clean_lps: np.ndarray, processed_lps: np.ndarray) -> float:
    """Log-spectral distance in dB between two (frames, bins) LPS arrays.

    LPS here is ln(|X|^2); convert to dB log-magnitude: 10*log10(e)*lps/2... we
    use the standard dB power form: L = (10/ln10) * lps.
    """
    a = np.asarray(clean_lps, np.float64) * (10.0 / np.log(10.0))
    b = np.asarray(processed_lps, np.float64) * (10.0 / np.log(10.0))
    n = min(len(a), len(b))
    d = np.sqrt(np.mean((a[:n] - b[:n]) ** 2, axis=1))
    return float(d.mean())
