"""Port's quality metrics (tpu_sednn_torch/metrics) against tpu_sednn/metrics
on the same clean / degraded pairs at 8 and 16 kHz: STOI, SNR, SegSNR,
SI-SDR, LSD, PESQ (estimator), LLR, WSS and the CSIG/CBAK/COVL composite
agree to rtol 1e-9."""

import importlib

import numpy as np
import pytest

import tpu_sednn.metrics as jmet
import tpu_sednn_torch.metrics as tmet
from tpu_sednn.data.mixing import mix_at_snr, synth_noise, synth_speech

RTOL = 1e-9
# the packages export a function named `composite`, which hides the module
jcomp = importlib.import_module("tpu_sednn.metrics.composite")
tcomp = importlib.import_module("tpu_sednn_torch.metrics.composite")


@pytest.fixture(scope="module", params=[8000, 16000])
def pair(request):
    sr = request.param
    rng = np.random.default_rng(sr)
    clean = synth_speech(rng, 2 * sr, sr)
    noisy = mix_at_snr(clean, synth_noise(rng, 2 * sr, "babble"), 5.0, rng)
    # a "processed" clip: delayed, rescaled and partly denoised
    proc = (0.8 * np.roll(0.5 * (clean + noisy), 3)).astype(np.float32)
    return sr, clean, noisy, proc


def _lps(x, sr):
    win = 256 if sr == 8000 else 512
    fr = np.lib.stride_tricks.sliding_window_view(x, win)[:: win // 2] * np.hamming(win)
    return np.log(np.maximum(np.abs(np.fft.rfft(fr, axis=1)) ** 2, 1e-12))


@pytest.mark.parametrize("name", ["stoi", "seg_snr", "pesq", "llr", "wss"])
def test_metric_with_rate(pair, name):
    sr, clean, noisy, proc = pair
    fj = getattr(jmet, name, None) or getattr(jcomp, name)
    ft = getattr(tmet, name, None) or getattr(tcomp, name)
    for deg in (noisy, proc):
        a, b = ft(clean, deg, sr), fj(clean, deg, sr)
        assert np.isfinite(a)
        np.testing.assert_allclose(a, b, rtol=RTOL)


@pytest.mark.parametrize("name", ["snr", "si_sdr"])
def test_metric_without_rate(pair, name):
    _, clean, noisy, proc = pair
    for deg in (noisy, proc):
        np.testing.assert_allclose(getattr(tmet, name)(clean, deg),
                                   getattr(jmet, name)(clean, deg), rtol=RTOL)


def test_lsd(pair):
    sr, clean, noisy, proc = pair
    c = _lps(clean, sr)
    for deg in (noisy, proc):
        np.testing.assert_allclose(tmet.lsd(c, _lps(deg, sr)), jmet.lsd(c, _lps(deg, sr)),
                                   rtol=RTOL)


def test_composite(pair):
    sr, clean, noisy, proc = pair
    for deg in (noisy, proc):
        a, b = tcomp.composite(clean, deg, sr), jcomp.composite(clean, deg, sr)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, err_msg=k)


def test_throughput():
    assert tmet.audio_seconds_per_second(1000.0, 128, 8000, 2) == \
        jmet.audio_seconds_per_second(1000.0, 128, 8000, 2)


def test_exports_match_the_jax_package():
    import tpu_sednn.data as jdata
    import tpu_sednn.recipes as jrec
    import tpu_sednn_torch.data as tdata
    import tpu_sednn_torch.recipes as trec

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_") and callable(getattr(mod, n))}

    assert public(jmet) <= public(tmet)
    assert public(jdata) <= public(tdata)
    assert public(jrec) <= public(trec)
