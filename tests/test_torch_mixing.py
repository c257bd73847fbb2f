"""Port's corpus generators (tpu_sednn_torch/data/mixing.py) against
tpu_sednn/data/mixing.py: every noise family, speech, RIR, reverb, mixing and
the whole corpus are bit-equal from the same numpy seeds."""

import numpy as np
import pytest

import tpu_sednn.data.mixing as jm
import tpu_sednn_torch.data.mixing as tm

SR = 8000


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_noise_family_lists():
    for name in ("NOISE_KINDS", "EXTRA_UNSEEN_NOISE_KINDS", "SEEN_NOISE_KINDS",
                 "UNSEEN_NOISE_KINDS", "ALL_NOISE_KINDS"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert len(tm.ALL_NOISE_KINDS) == 15


@pytest.mark.parametrize("kind", jm.ALL_NOISE_KINDS)
@pytest.mark.parametrize("n", [2 * SR + 37, 1000])
def test_synth_noise_bit_equal(kind, n):
    _equal(tm.synth_noise(np.random.default_rng(11), n, kind),
           jm.synth_noise(np.random.default_rng(11), n, kind))


@pytest.mark.parametrize("style", ["rich", "simple"])
@pytest.mark.parametrize("sr", [8000, 16000])
def test_synth_speech_bit_equal(style, sr):
    _equal(tm.synth_speech(np.random.default_rng(5), 2 * sr, sr, style=style),
           jm.synth_speech(np.random.default_rng(5), 2 * sr, sr, style=style))


@pytest.mark.parametrize("rt60", [0.1, 0.45])
def test_synth_rir_and_reverb_bit_equal(rt60):
    h_t = tm.synth_rir(np.random.default_rng(2), SR, rt60_s=rt60)
    h_j = jm.synth_rir(np.random.default_rng(2), SR, rt60_s=rt60)
    _equal(h_t, h_j)
    x = jm.synth_speech(np.random.default_rng(3), SR, SR)
    _equal(tm.apply_reverb(x, h_t, wet=0.7), jm.apply_reverb(x, h_j, wet=0.7))


@pytest.mark.parametrize("snr", [-5.0, 0.0, 12.5])
def test_mix_at_snr_bit_equal(snr):
    rng = np.random.default_rng(8)
    c = jm.synth_speech(rng, SR, SR)
    nz = jm.synth_noise(rng, SR // 2, "babble")  # shorter noise: tiled from a random offset
    _equal(tm.mix_at_snr(c, nz, snr, np.random.default_rng(9)),
           jm.mix_at_snr(c, nz, snr, np.random.default_rng(9)))


@pytest.mark.parametrize("sr", [8000, 16000])
def test_synth_corpus_bit_equal(sr):
    kw = dict(sr=sr, snrs=(0.0, 5.0, 10.0), noise_kinds=("white", "pink", "factory"),
              variants=2, reverb_prob=0.3)
    ct, nt = tm.synth_corpus(4, 6, **kw)
    cj, nj = jm.synth_corpus(4, 6, **kw)
    assert len(ct) == len(cj) == 12 and len(nt) == len(nj) == 12
    for a, b in zip(ct + nt, cj + nj):
        _equal(a, b)
    # variants share one clean array, as the recipe's dedup by identity expects
    assert ct[0] is ct[1] and ct[2] is ct[3]
