"""Ideal-mask target computation for mask-estimation training.

The reference's recipe variant trains on estimated-IBM targets
("estIBM_refCLEAN_LC5dB" pfiles, finetune_...NAT.pl:50) with the same
trainer; masks are just a different target pfile.  These helpers build the
standard targets from aligned clean/noise (or clean/noisy) spectra:

* IRM  — ideal ratio mask sqrt(S / (S + N)) in the power domain
* IBM  — ideal binary mask 1[SNR_local > threshold], the reference's
  "LC5dB" = local criterion 5 dB
* from_noisy variants use N ~= max(noisy - clean, 0) when only the mixture is
  available.

Own copy of tpu_sednn/data/masks.py (host numpy; the same bits from the
same inputs).
"""

from __future__ import annotations

import numpy as np


def irm_from_clean_noise(clean_power: np.ndarray, noise_power: np.ndarray,
                         eps: float = 1e-12) -> np.ndarray:
    s = np.maximum(clean_power, 0.0)
    n = np.maximum(noise_power, 0.0)
    return np.sqrt(s / (s + n + eps)).astype(np.float32)


def ibm_from_clean_noise(clean_power: np.ndarray, noise_power: np.ndarray,
                         lc_db: float = 5.0, eps: float = 1e-12) -> np.ndarray:
    snr_db = 10.0 * np.log10((clean_power + eps) / (noise_power + eps))
    return (snr_db > lc_db).astype(np.float32)


def irm_from_lps(clean_lps: np.ndarray, noisy_lps: np.ndarray) -> np.ndarray:
    """IRM from log-power spectra of clean and mixture: N ~= max(Y - S, 0)."""
    s = np.exp(np.asarray(clean_lps, np.float64))
    y = np.exp(np.asarray(noisy_lps, np.float64))
    n = np.maximum(y - s, 0.0)
    return irm_from_clean_noise(s, n)


def ibm_from_lps(clean_lps: np.ndarray, noisy_lps: np.ndarray,
                 lc_db: float = 5.0) -> np.ndarray:
    s = np.exp(np.asarray(clean_lps, np.float64))
    y = np.exp(np.asarray(noisy_lps, np.float64))
    n = np.maximum(y - s, 1e-12)
    return ibm_from_clean_noise(s, n, lc_db)


def psm_from_stft(clean_re: np.ndarray, clean_im: np.ndarray,
                  noisy_re: np.ndarray, noisy_im: np.ndarray,
                  eps: float = 1e-12) -> np.ndarray:
    """Phase-sensitive mask (Erdogan et al., ICASSP 2015): the mask that
    minimizes the SE error when applied to the NOISY-PHASE spectrum,

        PSM = |S|/|Y| * cos(theta_S - theta_Y) = Re(S * conj(Y)) / |Y|^2,

    clipped to [0, 1] so a sigmoid head can estimate it and decode is
    identical to the IRM path (mask x noisy magnitude, noisy phase).  Where
    clean and noisy phases disagree the optimal magnitude credit shrinks —
    PSM targets dominate IRM targets in SDR at equal network capacity.
    """
    s_re = np.asarray(clean_re, np.float64)
    s_im = np.asarray(clean_im, np.float64)
    y_re = np.asarray(noisy_re, np.float64)
    y_im = np.asarray(noisy_im, np.float64)
    num = s_re * y_re + s_im * y_im  # Re(S Y*)
    den = y_re * y_re + y_im * y_im
    return np.clip(num / (den + eps), 0.0, 1.0).astype(np.float32)
