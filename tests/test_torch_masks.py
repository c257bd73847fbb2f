"""Port's mask targets (tpu_sednn_torch/data/masks.py) against
tpu_sednn/data/masks.py on the same seeded spectra: IRM, IBM (from powers
and from LPS) and PSM agree to atol 1e-7."""

import numpy as np
import pytest

import tpu_sednn.data.masks as jm
import tpu_sednn_torch.data.masks as tm

ATOL = 1e-7


@pytest.fixture(scope="module")
def spectra():
    rng = np.random.default_rng(0)
    shape = (40, 129)
    c_re, c_im, n_re, n_im = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    y_re, y_im = c_re + n_re, c_im + n_im
    c_pow = c_re ** 2 + c_im ** 2
    n_pow = n_re ** 2 + n_im ** 2
    c_pow[0, :5] = 0.0  # silent bins
    return dict(c_re=c_re, c_im=c_im, y_re=y_re, y_im=y_im, c_pow=c_pow, n_pow=n_pow,
                c_lps=np.log(np.maximum(c_pow, 1e-12)),
                y_lps=np.log(np.maximum(y_re ** 2 + y_im ** 2, 1e-12)))


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_irm_ibm_from_clean_noise(spectra):
    s = spectra
    _close(tm.irm_from_clean_noise(s["c_pow"], s["n_pow"]),
           jm.irm_from_clean_noise(s["c_pow"], s["n_pow"]))
    for lc in (0.0, 5.0, -3.0):
        _close(tm.ibm_from_clean_noise(s["c_pow"], s["n_pow"], lc),
               jm.ibm_from_clean_noise(s["c_pow"], s["n_pow"], lc))


def test_irm_ibm_from_lps(spectra):
    s = spectra
    _close(tm.irm_from_lps(s["c_lps"], s["y_lps"]), jm.irm_from_lps(s["c_lps"], s["y_lps"]))
    for lc in (0.0, 5.0):
        _close(tm.ibm_from_lps(s["c_lps"], s["y_lps"], lc),
               jm.ibm_from_lps(s["c_lps"], s["y_lps"], lc))


def test_psm_from_stft(spectra):
    s = spectra
    _close(tm.psm_from_stft(s["c_re"], s["c_im"], s["y_re"], s["y_im"]),
           jm.psm_from_stft(s["c_re"], s["c_im"], s["y_re"], s["y_im"]))
