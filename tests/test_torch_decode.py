"""Port decode against tpu_sednn.enhance.decode on the CPU: the same weights,
norm and noisy wavs through both packages give the same enhanced wavs, for
every head and post-processing option.  Wav atol 2e-4 (about 7 int16 LSB
below the 16-bit quantum the CLI writes; the decodes differ only in fp32
summation order)."""

import jax
import numpy as np
import pytest
import torch

import tpu_sednn.enhance.decode as jd
import tpu_sednn.model as jm
from tpu_sednn.dsp import StftConfig as JStft
from tpu_sednn.dsp import stft_logpower as j_logpower
import tpu_sednn_torch.enhance.decode as td
import tpu_sednn_torch.model as tm
from tpu_sednn_torch.dsp import StftConfig as TStft

SR = 8000
D = 129
CONTEXT, TO = 3, 1
WAV_ATOL = 2e-4


def _tone_noise(rng, shape):
    n = shape[-1]
    return (0.1 * rng.standard_normal(shape)
            + 0.3 * np.sin(2 * np.pi * 440 * np.arange(n) / SR)).astype(np.float32)


def _setup(head="lps", seed=0, gv=False, nat=True):
    out = "sigmoid" if head != "lps" else "linear"
    sizes = (D * CONTEXT + (D if nat else 0), 48, D)
    jcfg = jm.ModelConfig(layersizes=sizes, output=out, dropout_vis=0.1, dropout_hid=0.2)
    tcfg = tm.ModelConfig(layersizes=sizes, output=out, dropout_vis=0.1, dropout_hid=0.2)
    p = jm.init_params(jax.random.key(seed), jcfg, scheme="glorot")
    p_np = {"w": tuple(np.asarray(w) for w in p["w"]), "b": tuple(np.asarray(b) for b in p["b"])}
    rng = np.random.default_rng(seed + 10)
    wavs = _tone_noise(rng, (3, SR))
    lps = np.asarray(j_logpower(jax.numpy.asarray(wavs[0]), JStft.for_rate(SR)))
    mean, istd = lps.mean(0).astype(np.float32), (1.0 / lps.std(0)).astype(np.float32)
    gv_ref = (lps.var(0) * 1.5).astype(np.float32) if gv else None
    return p, tm.params_from_jax(p_np, device="cpu"), jcfg, tcfg, wavs, mean, istd, gv_ref


def _ecfgs(**kw):
    return (jd.EnhanceConfig(stft=JStft.for_rate(SR), fea_context=CONTEXT, targ_offset=TO, **kw),
            td.EnhanceConfig(stft=TStft.for_rate(SR), fea_context=CONTEXT, targ_offset=TO, **kw))


CASES = [
    dict(head="lps"),
    dict(head="lps", min_gain_db=-12.0, max_gain_db=3.0),
    dict(head="lps", gv_mode="global"),
    dict(head="lps", gv_mode="per-dim", nat=False),
    dict(head="irm", mask_floor=0.05),
    dict(head="irm", mask_smooth=3),
    dict(head="psm", mask_smooth=4, min_gain_db=-10.0),
    dict(head="ibm", mask_smooth=3),
    dict(head="ibm", mask_floor=0.1),
]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_enhance_waveform_and_serving_decoder_match_jax(kw):
    gv = kw.get("gv_mode", "off") != "off"
    p, mlp, jcfg, tcfg, wavs, mean, istd, gv_ref = _setup(kw["head"], gv=gv,
                                                          nat=kw.get("nat", True))
    je, te = _ecfgs(**kw)
    want = [jd.enhance_waveform(p, jcfg, je, w, mean, istd, gv_ref=gv_ref) for w in wavs]
    for w, y in zip(wavs, want):
        got = td.enhance_waveform(mlp, tcfg, te, w, mean, istd, gv_ref=gv_ref, device="cpu")
        assert got.shape == w.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, y, atol=WAV_ATOL)
    dec = td.make_serving_decoder(mlp, tcfg, te, mean, istd, gv_ref=gv_ref, device="cpu")
    batch = dec(wavs)
    assert isinstance(batch, torch.Tensor) and batch.shape == wavs.shape
    np.testing.assert_allclose(batch.numpy(), np.stack(want), atol=WAV_ATOL)
    jdec = jd.make_serving_decoder(p, jcfg, je, mean, istd, gv_ref=gv_ref)
    np.testing.assert_allclose(batch.numpy(), np.asarray(jdec(wavs)), atol=WAV_ATOL)


def test_target_norm_matches_jax():
    p, mlp, jcfg, tcfg, wavs, mean, istd, _ = _setup()
    je, te = _ecfgs()
    tn = (np.full(D, -3.0, np.float32), np.full(D, 0.7, np.float32))
    want = jd.enhance_waveform(p, jcfg, je, wavs[1], mean, istd, target_norm=tn)
    got = td.enhance_waveform(mlp, tcfg, te, wavs[1], mean, istd, target_norm=tn, device="cpu")
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)


def test_bucketed_decoder_matches_jax():
    p, mlp, jcfg, tcfg, _, mean, istd, _ = _setup(seed=2)
    je, te = _ecfgs()
    rng = np.random.default_rng(2)
    lengths = [3000, 15500, 7900, 3000, 20000]  # two buckets + one oversize
    wavs = [_tone_noise(rng, (n,)) for n in lengths]
    kw = dict(bucket_seconds=(0.5, 2.0), batch=2)
    want = jd.make_bucketed_decoder(p, jcfg, je, mean, istd, **kw)(wavs)
    got = td.make_bucketed_decoder(mlp, tcfg, te, mean, istd, device="cpu", **kw)(wavs)
    assert [g.size for g in got] == lengths
    # the trailing edge (last window + splice lookahead) sees the zero padding
    # at the LPS floor, ln(1e-12), where outputs reach ~1e3: relative there
    stft = te.stft
    edge = stft.win_len + (CONTEXT - TO) * stft.hop
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g[: g.size - edge], w[: g.size - edge], atol=WAV_ATOL)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=WAV_ATOL)


def test_decode_helpers_match_jax():
    rng = np.random.default_rng(7)
    lps = rng.standard_normal((2, 20, 6)).astype(np.float32)
    for f in range(2):
        np.testing.assert_allclose(td._splice(torch.from_numpy(lps), 5, 2)[f].numpy(),
                                   np.asarray(jd._splice_jnp(lps[f], 5, 2)), atol=0)
        np.testing.assert_allclose(td.compute_gv(torch.from_numpy(lps))[f].numpy(),
                                   np.asarray(jd.compute_gv(lps[f])), rtol=1e-5, atol=1e-6)
    ref = rng.random(6).astype(np.float32) * 3
    for mode in ("global", "per-dim"):
        got = td.equalize_gv(torch.from_numpy(lps), torch.from_numpy(ref), mode).numpy()
        for f in range(2):
            np.testing.assert_allclose(got[f], np.asarray(jd.equalize_gv(lps[f], ref, mode)),
                                       rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        td.equalize_gv(torch.from_numpy(lps), torch.from_numpy(ref), "bogus")
    _, te = _ecfgs(head="lps", gv_mode="global")
    with pytest.raises(ValueError, match="gv_ref"):
        td.finalize_lps(torch.from_numpy(lps), torch.from_numpy(lps), te)
