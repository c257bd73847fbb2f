"""Port's on-device sample builder (tpu_sednn_torch/data/device_pipeline.py)
on the CPU, where the STFT is the kernel's plain version, against the JAX
functions of tpu_sednn/data/device_pipeline.py on the same seeded wavs, at
tests/test_device_pipeline.py's limits: X rtol/atol 1e-4, T rtol 1e-4 and
atol 2e-2 (near the power floor the log magnifies summation-order
differences)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.data.device_pipeline as jdp
import tpu_sednn_torch.data.device_pipeline as tdp
from tpu_sednn.data.mixing import mix_at_snr, synth_noise, synth_speech
from tpu_sednn.dsp import StftConfig as JStft
from tpu_sednn.dsp import stft_logpower
from tpu_sednn.io import compute_norm
from tpu_sednn_torch.dsp import StftConfig as TStft

X_TOL = dict(rtol=1e-4, atol=1e-4)
T_TOL = dict(rtol=1e-4, atol=2e-2)


def _pairs(sr, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ln = int(rng.uniform(1.0, 2.5) * sr)
        c = synth_speech(rng, ln, sr)
        out.append((mix_at_snr(c, synth_noise(rng, ln, "white"), 5.0, rng), c))
    return out


def _norms(pairs, cfg, targ=False):
    lps = [np.asarray(stft_logpower(jnp.asarray(w[1 if targ else 0]), cfg)) for w in pairs]
    return compute_norm(np.concatenate(lps))


@pytest.mark.parametrize("sr", [8000, 16000])
@pytest.mark.parametrize("nat,targ_norm", [(True, False), (False, True)])
def test_streaming_batches_match_jax(sr, nat, targ_norm):
    jcfg, tcfg = JStft.for_rate(sr), TStft.for_rate(sr)
    pairs = _pairs(sr, 3, seed=sr)
    pairs.append((pairs[0][0][: jcfg.win_len + 3], pairs[0][1][: jcfg.win_len + 3]))  # no sample
    mean, istd = _norms(pairs, jcfg)
    tm, ts = _norms(pairs, jcfg, targ=True) if targ_norm else (None, None)
    got = list(tdp.streaming_sample_batches(pairs, mean, istd, tcfg, 5, 2, nat=nat,
                                            targ_mean=tm, targ_inv_std=ts, device="cpu"))
    want = list(jdp.streaming_sample_batches(pairs, mean, istd, jcfg, 5, 2, nat=nat,
                                             targ_mean=tm, targ_inv_std=ts))
    assert len(got) == len(want) == 3
    for (xg, tg), (xw, tw) in zip(got, want):
        assert xg.device.type == "cpu" and xg.dtype == torch.float32
        assert tuple(xg.shape) == np.asarray(xw).shape and tuple(tg.shape) == np.asarray(tw).shape
        np.testing.assert_allclose(xg.numpy(), np.asarray(xw), **X_TOL)
        np.testing.assert_allclose(tg.numpy(), np.asarray(tw), **T_TOL)


def test_wav_pair_to_samples_matches_jax():
    sr = 8000
    jcfg, tcfg = JStft.for_rate(sr), TStft.for_rate(sr)
    (nz, c), = _pairs(sr, 1, seed=3)
    mean, istd = _norms([(nz, c)], jcfg)
    x, t = tdp.wav_pair_to_samples(torch.from_numpy(nz), torch.from_numpy(c),
                                   torch.from_numpy(mean), torch.from_numpy(istd), tcfg, 11, 5)
    xj, tj = jdp.wav_pair_to_samples(jnp.asarray(nz), jnp.asarray(c), jnp.asarray(mean),
                                     jnp.asarray(istd), jcfg, 11, 5)
    n_frames = 1 + (len(nz) - jcfg.win_len) // jcfg.hop
    assert tuple(x.shape) == (n_frames - 10, 12 * jcfg.n_bins)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **X_TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), **T_TOL)


def test_splice_device_matches_jax():
    a = np.random.default_rng(1).standard_normal((17, 6)).astype(np.float32)
    np.testing.assert_array_equal(tdp.splice_device(torch.from_numpy(a), 5).numpy(),
                                  np.asarray(jdp.splice_device(jnp.asarray(a), 5)))


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(tdp.streaming_sample_batches([(np.zeros(4000, np.float32),) * 2], np.zeros(129),
                                          np.ones(129), TStft.for_rate(8000)))
