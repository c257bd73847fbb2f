"""Composite objective quality measures (Hu & Loizou 2008): CSIG/CBAK/COVL.

The standard evaluation trio reported by speech-enhancement papers next to
PESQ/STOI/SegSNR (including the line of work the reference README cites at
README.md:61-71). Each composite is a published linear regression onto MOS
ratings over three base measures:

  LLR   log-likelihood ratio (LPC-based spectral match, Quackenbush 1988)
  WSS   weighted spectral slope distance (Klatt 1982)
  PESQ  here the in-repo P.862-style ESTIMATOR (metrics/pesq.py) — composite
        values carry the same "(est.)" qualifier; never quote against
        published certified-PESQ composites.

  CSIG = 3.093 - 1.029*LLR + 0.603*PESQ - 0.009*WSS   (signal distortion)
  CBAK = 1.634 + 0.478*PESQ - 0.007*WSS + 0.063*segSNR (background intrusiveness)
  COVL = 1.594 + 0.805*PESQ - 0.512*LLR - 0.007*WSS    (overall quality)

all clipped to the 1..5 MOS range. Frame policy follows Loizou's reference
implementation: 30 ms Hanning windows, 75% overlap, per-frame scores, and
trimmed means (LLR: best 95% of frames; WSS: best 95% after sorting).

Own copy of tpu_sednn/metrics/composite.py (host numpy + scipy; the same bits from the
same inputs).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

from tpu_sednn_torch.metrics.quality import _align, _frames, seg_snr


# ---------------------------------------------------------------------------
# LPC machinery (numpy Levinson-Durbin)
# ---------------------------------------------------------------------------

def _autocorr(frame: np.ndarray, order: int) -> np.ndarray:
    n = len(frame)
    r = np.empty(order + 1)
    for k in range(order + 1):
        r[k] = float(frame[: n - k] @ frame[k:])
    return r


def _levinson(r: np.ndarray, order: int) -> np.ndarray:
    """Autocorrelation -> LPC coefficients a = [1, a1..ap] (Levinson-Durbin)."""
    a = np.zeros(order + 1)
    a[0] = 1.0
    err = r[0]
    if err <= 0.0:
        return a
    for i in range(1, order + 1):
        acc = r[i] + a[1:i] @ r[1:i][::-1]
        k = -acc / err
        a[1:i] = a[1:i] + k * a[1:i][::-1]
        a[i] = k
        err *= 1.0 - k * k
        if err <= 0.0:
            break
    return a


def _lpc_frame(frame: np.ndarray, order: int) -> tuple[np.ndarray, np.ndarray]:
    r = _autocorr(frame, order)
    if r[0] <= 1e-10:
        return np.r_[1.0, np.zeros(order)], np.r_[1e-10, np.zeros(order)]
    return _levinson(r, order), r


def llr(clean: np.ndarray, processed: np.ndarray, fs: int) -> float:
    """Mean log-likelihood ratio over the best 95% of frames (lower=better).

    llr_frame = ln( a_p R_c a_p' / a_c R_c a_c' ) with R_c the clean-frame
    autocorrelation (Toeplitz) and a_* the LPC coefficient rows.
    """
    x, y = _align(clean, processed)
    win = int(round(0.030 * fs))
    hop = win // 4
    order = 10 if fs <= 10000 else 16
    w = np.hanning(win)
    fx = _frames(x, win, hop, w)
    fy = _frames(y, win, hop, w)
    vals = []
    for i in range(min(len(fx), len(fy))):
        a_c, r_c = _lpc_frame(fx[i], order)
        a_p, _ = _lpc_frame(fy[i], order)
        # quadratic form a R a' over the clean-frame autocorrelation Toeplitz
        R = sla.toeplitz(r_c)
        num = float(a_p @ R @ a_p)
        den = float(a_c @ R @ a_c)
        if den <= 1e-12 or num <= 1e-12:
            continue
        vals.append(np.log(num / den))
    if not vals:
        return 0.0
    vals = np.sort(np.asarray(vals))
    keep = max(1, int(round(len(vals) * 0.95)))
    # no clip on the trimmed mean — matching Hu & Loizou's composite.m (the
    # final CSIG/CBAK/COVL values are range-clipped instead); clipping here
    # shifted composites upward on badly degraded signals (ADVICE r3)
    return float(vals[:keep].mean())


# ---------------------------------------------------------------------------
# WSS (Klatt 1982 spectral-slope distance, Loizou's parameterization)
# ---------------------------------------------------------------------------

_N_CRIT = 25
# critical band center frequencies / bandwidths (Hz), Loizou Table
_CENT = np.array([
    50.0, 120.0, 190.0, 260.0, 330.0, 400.0, 470.0, 540.0, 617.372,
    703.378, 798.717, 904.128, 1020.38, 1148.30, 1288.72, 1442.54,
    1610.70, 1794.16, 1993.93, 2211.08, 2446.71, 2701.97, 2978.04,
    3276.17, 3597.63])
_BW = np.array([
    70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 77.3724, 86.0056,
    95.3398, 105.411, 116.256, 127.914, 140.423, 153.823, 168.154,
    183.457, 199.776, 217.153, 235.631, 255.255, 276.072, 298.126,
    321.465, 346.136])


def _crit_filters(fs: int, nfft: int) -> np.ndarray:
    """Gaussian-shaped critical-band filters on the rfft grid (n_crit, bins)."""
    max_freq = fs / 2.0
    n_bins = nfft // 2 + 1
    f = np.linspace(0, max_freq, n_bins)
    filt = np.zeros((_N_CRIT, n_bins))
    min_factor = np.exp(-30.0 / (2 * 2.303))
    for i in range(_N_CRIT):
        f0 = _CENT[i]
        bw = _BW[i]
        norm_factor = np.log(bw) - np.log(_BW[0])
        g = np.exp(-11.0 * (((f - f0) / bw) ** 2) + norm_factor)
        filt[i] = np.where(g > min_factor, g, 0.0)
    return filt


def wss(clean: np.ndarray, processed: np.ndarray, fs: int) -> float:
    """Weighted spectral-slope distance, mean of the best 95% frames
    (lower = better)."""
    x, y = _align(clean, processed)
    win = int(round(0.030 * fs))
    hop = win // 4
    nfft = 1 << (win - 1).bit_length()
    w = np.hanning(win)
    fx = _frames(x, win, hop, w)
    fy = _frames(y, win, hop, w)
    n = min(len(fx), len(fy))
    if n == 0:
        return 0.0
    filt = _crit_filters(fs, nfft)
    Kmax, Klocmax = 20.0, 1.0
    vals = []
    for i in range(n):
        px = np.abs(np.fft.rfft(fx[i], nfft)) ** 2
        py = np.abs(np.fft.rfft(fy[i], nfft)) ** 2
        ex = 10 * np.log10(np.maximum(filt @ px, 1e-10))
        ey = 10 * np.log10(np.maximum(filt @ py, 1e-10))
        sx = np.diff(ex)
        sy = np.diff(ey)
        # weights from peak proximity (Klatt's Wmax * Wlocmax)
        def weights(e, s):
            n_s = len(s)
            wvec = np.empty(n_s)
            dbmax = e.max()
            for k in range(n_s):
                # nearest local peak upward in slope direction
                if s[k] > 0:
                    j = k
                    while j < n_s and s[j] > 0:
                        j += 1
                    peak = e[j]
                else:
                    j = k
                    while j >= 0 and s[j] <= 0:
                        j -= 1
                    peak = e[j + 1]
                wmax = Kmax / (Kmax + dbmax - e[k])
                wlocmax = Klocmax / (Klocmax + peak - e[k])
                wvec[k] = wmax * wlocmax
            return wvec
        wx = weights(ex, sx)
        wy = weights(ey, sy)
        ww = (wx + wy) / 2.0
        vals.append(float((ww * (sx - sy) ** 2).sum() / max(ww.sum(), 1e-10)))
    vals = np.sort(np.asarray(vals))
    keep = max(1, int(round(len(vals) * 0.95)))
    return float(vals[:keep].mean())


# ---------------------------------------------------------------------------
# composites
# ---------------------------------------------------------------------------

def composite(clean: np.ndarray, processed: np.ndarray, fs: int) -> dict:
    """-> {"csig", "cbak", "covl", "pesq_est", "llr", "wss", "segsnr"}.

    PESQ inside is the in-repo estimator — treat all three composites as
    estimates for relative comparison, not certified MOS values.
    """
    from tpu_sednn_torch.metrics.pesq import pesq

    p = pesq(clean, processed, fs)
    l = llr(clean, processed, fs)
    ws = wss(clean, processed, fs)
    ss = seg_snr(clean, processed, fs)
    csig = np.clip(3.093 - 1.029 * l + 0.603 * p - 0.009 * ws, 1.0, 5.0)
    cbak = np.clip(1.634 + 0.478 * p - 0.007 * ws + 0.063 * ss, 1.0, 5.0)
    covl = np.clip(1.594 + 0.805 * p - 0.512 * l - 0.007 * ws, 1.0, 5.0)
    return {"csig": float(csig), "cbak": float(cbak), "covl": float(covl),
            "pesq_est": float(p), "llr": float(l), "wss": float(ws),
            "segsnr": float(ss)}
