"""The port's int8 serving (tpu_sednn_torch/model/quant.py) against the JAX
package's (tpu_sednn/model/quant.py) on the CPU: quantized weights and
scales bit-equal, the int32 product exact (sums past 2^24, beyond float32's
exact integers) and equal to JAX's `_int8_matmul` at
the padded shapes of a serving batch, a streaming block and the 8 / 16 kHz
input widths; the int8 forward within rtol 1e-6 (atol 1e-6 of the output's
peak: the float head sums in another order); and the gates of
tests/test_quant.py: under 2% relative forward error and under 0.5 dB LSD
from the float32 decode."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
from tpu_sednn.data.mixing import mix_at_snr, synth_noise, synth_speech
from tpu_sednn.model import quant as jq
import tpu_sednn_torch.model as tm
from tpu_sednn_torch.model import quant as tq

CFG_SIZES = (264, 512, 512, 65)


def _nets(sizes=CFG_SIZES, seed=0):
    """(JAX params, folded JAX params, JAX eval cfg, port folded MLP, port eval cfg)."""
    jcfg = jm.ModelConfig(layersizes=sizes, dropout_vis=0.1, dropout_hid=0.2)
    tcfg = tm.ModelConfig(layersizes=sizes, dropout_vis=0.1, dropout_hid=0.2)
    p = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    jf, jec = jm.fold_eval_params(p, jcfg)
    mlp = tm.params_from_jax({"w": [np.asarray(w) for w in p["w"]],
                              "b": [np.asarray(b) for b in p["b"]]}, device="cpu")
    tf, tec = tm.fold_eval_params(mlp, tcfg)
    return p, jf, jec, mlp, tf, tec, jcfg, tcfg


@pytest.mark.parametrize("quant_last", [False, True])
def test_quantized_weights_and_scales_bit_equal(quant_last):
    _, jf, _, _, tf, _, _, _ = _nets()
    qj = jq.quantize_params_int8(jf, quant_last=quant_last)
    qt = tq.quantize_params_int8(tf, quant_last=quant_last)
    assert qt.skip_last == qj.skip_last == (not quant_last)
    for group in ("wq", "sw", "w_f32", "b"):
        for a, b in zip(getattr(qj, group), getattr(qt, group)):
            assert (a is None) == (b is None), group
            if a is not None:
                a = np.asarray(a)
                assert b.dtype == (torch.int8 if group == "wq" else torch.float32)
                np.testing.assert_array_equal(b.numpy(), a)
                if group == "wq":  # column-major: the layout cuBLASLt runs fast
                    assert b.stride() == (1, b.shape[0])


@pytest.mark.parametrize("m,k,n", [(128, 1548, 2048), (1, 1548, 2048), (8, 3084, 2048),
                                   (17, 2048, 129), (300, 2048, 257), (5, 13, 3)])
def test_int8_matmul_exact_and_equal_to_jax(m, k, n):
    rng = np.random.default_rng(m * 7 + k + n)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xq[0] = 127  # one row and column at the extreme: |sum| = 127^2 * k
    wq[:, 0] = 127
    want = xq.astype(np.int64) @ wq.astype(np.int64)
    got = tq._int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq._int8_matmul(jnp.asarray(xq),
                                                                          jnp.asarray(wq))))
    if k >= 1548:
        assert want[0, 0] == 127 * 127 * k > 2 ** 24


def test_quantize_rows_bit_equal():
    x = np.random.default_rng(3).standard_normal((37, 1548)).astype(np.float32) * 3
    x[5] = 0.0  # an all-zero row takes the 1e-12 floor
    xj, sj = jq._quantize_rows(jnp.asarray(x))
    xt, st = tq._quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("quant_last", [False, True])
@pytest.mark.parametrize("rows", [128, 1, 8])
def test_forward_int8_matches_jax(quant_last, rows):
    _, jf, jec, _, tf, tec, _, _ = _nets(seed=1)
    x = np.random.default_rng(rows).standard_normal((rows, CFG_SIZES[0])).astype(np.float32)
    want = np.asarray(jq.forward_eval_int8(jq.quantize_params_int8(jf, quant_last=quant_last),
                                           jnp.asarray(x), jec))
    got = tq.forward_eval_int8(tq.quantize_params_int8(tf, quant_last=quant_last),
                               torch.from_numpy(x), tec).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))


def test_quant_params_from_jax_round_trip():
    _, jf, jec, _, tf, tec, _, _ = _nets(seed=2)
    qj = jq.quantize_params_int8(jf)
    qt = tm.quant_params_from_jax([None if a is None else np.asarray(a) for a in qj.wq],
                                  [None if a is None else np.asarray(a) for a in qj.sw],
                                  [None if a is None else np.asarray(a) for a in qj.w_f32],
                                  [np.asarray(a) for a in qj.b], qj.skip_last, device="cpu")
    mine = tq.quantize_params_int8(tf)
    for a, b in zip(qt.wq + qt.sw + qt.w_f32 + qt.b, mine.wq + mine.sw + mine.w_f32 + mine.b):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
    x = torch.randn(16, CFG_SIZES[0], generator=torch.Generator().manual_seed(0))
    assert torch.equal(tq.forward_eval_int8(qt, x, tec), tq.forward_eval_int8(mine, x, tec))


def test_forward_int8_close_to_f32():
    p, _, _, mlp, tf, tec, _, tcfg = _nets(seed=0)
    x = torch.randn(128, CFG_SIZES[0], generator=torch.Generator().manual_seed(1))
    ref = tm.forward_eval(mlp, x, tcfg)
    out = tq.forward_eval_int8(tq.quantize_params_int8(tf), x, tec)
    rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
    assert rel < 0.02, rel
    full = tq.forward_eval_int8(tq.quantize_params_int8(tf, quant_last=True), x, tec)
    rel_last = float(torch.linalg.norm(full - out) / torch.linalg.norm(out))
    assert 0.0 < rel_last < 0.05, rel_last


def test_forward_int8_refuses_unfolded_config():
    _, _, _, mlp, tf, _, _, tcfg = _nets()
    with pytest.raises(ValueError, match="folded"):
        tq.forward_eval_int8(tq.quantize_params_int8(tf), torch.zeros(2, CFG_SIZES[0]), tcfg)


def _clip(sr, seconds=2.0, seed=5):
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    return mix_at_snr(synth_speech(rng, n, sr), synth_noise(rng, n, "pink"), 5, rng)


def _lsd_int8_vs_f32(wav, sr):
    from tpu_sednn_torch.dsp import StftConfig, stft_logpower
    from tpu_sednn_torch.enhance.decode import EnhanceConfig, make_serving_decoder
    from tpu_sednn_torch.metrics.quality import lsd

    stft = StftConfig.for_rate(sr)
    d = stft.n_bins
    cfg = tm.ModelConfig(layersizes=(d * 12, 512, 512, d), dropout_vis=0.1,
                         dropout_hid=0.2, dropout_mode="parity")
    params = tm.init_params(torch.Generator().manual_seed(7), cfg, device="cpu")
    ecfg = EnhanceConfig(stft=stft, head="lps")
    mean, istd = np.zeros(d, np.float32), np.full(d, 0.1, np.float32)
    batch = np.stack([wav, wav])
    ref = make_serving_decoder(params, cfg, ecfg, mean, istd, device="cpu")(batch).numpy()
    q = make_serving_decoder(params, cfg, ecfg, mean, istd, quant="int8", device="cpu")(batch)
    assert q.shape == ref.shape
    return lsd(stft_logpower(torch.from_numpy(ref[0]), stft).numpy(),
               stft_logpower(q[0], stft).numpy())


@pytest.mark.parametrize("sr", [8000, 16000])
def test_int8_decoder_end_to_end_quality(sr):
    """The serving gate of tests/test_quant.py on a synthesized 2 s clip."""
    d_lsd = _lsd_int8_vs_f32(_clip(sr), sr)
    assert d_lsd < 0.5, f"int8 decode diverges from f32: LSD {d_lsd:.3f} dB"


def test_int8_decoder_quality_on_reference_clip():
    """The same gate on the reference's demo clip, where it exists."""
    from tpu_sednn_torch.io import read_wav
    from tpu_sednn_torch.recipes.demo_gate import DEMO_DIR

    clip = os.path.join(DEMO_DIR, "test1_org_noisy.wav")
    if not os.path.exists(clip):
        pytest.skip("reference demo clips unavailable")
    wav, sr = read_wav(clip)
    assert _lsd_int8_vs_f32(np.asarray(wav, np.float32)[: sr * 2], sr) < 0.5


def test_int8_serving_decoder_matches_jax():
    """The int8 serving decoders of both packages on the same weights and
    wavs: the int32 products are exact in both, so they differ only where
    float32 summation order moves a row's quantization across a rounding
    boundary; held at 1e-3 of the peak."""
    from tpu_sednn.dsp import StftConfig as JS
    from tpu_sednn.enhance.decode import EnhanceConfig as JE
    from tpu_sednn.enhance.decode import make_serving_decoder as j_dec
    from tpu_sednn_torch.dsp import StftConfig
    from tpu_sednn_torch.enhance.decode import EnhanceConfig, make_serving_decoder

    sr, d = 8000, 129
    p, _, _, mlp, _, _, jcfg, tcfg = _nets(sizes=(d * 12, 256, 256, d), seed=4)
    mean, istd = np.zeros(d, np.float32), np.full(d, 0.2, np.float32)
    wavs = np.stack([_clip(sr, 1.0, seed=s) for s in (1, 2)])
    want = np.asarray(j_dec(p, jcfg, JE(stft=JS.for_rate(sr)), mean, istd, quant="int8")(wavs))
    got = make_serving_decoder(mlp, tcfg, EnhanceConfig(stft=StftConfig.for_rate(sr)), mean,
                               istd, quant="int8", device="cpu")(wavs).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * float(np.abs(want).max()))


def test_int8_bucketed_decoder_matches_jax():
    """make_bucketed_decoder(quant="int8") of both packages on ragged
    utterances, held as the int8 serving decoders are."""
    from tpu_sednn.dsp import StftConfig as JS
    from tpu_sednn.enhance.decode import EnhanceConfig as JE
    from tpu_sednn.enhance.decode import make_bucketed_decoder as j_dec
    from tpu_sednn_torch.dsp import StftConfig
    from tpu_sednn_torch.enhance.decode import EnhanceConfig, make_bucketed_decoder

    sr, d = 8000, 129
    p, _, _, mlp, _, _, jcfg, tcfg = _nets(sizes=(d * 12, 64, d), seed=5)
    mean, istd = np.zeros(d, np.float32), np.full(d, 0.2, np.float32)
    wavs = [_clip(sr, s, seed=i) for i, s in enumerate((0.4, 0.7, 1.3))]
    kw = dict(quant="int8", bucket_seconds=(0.5, 1.0), batch=2)
    want = j_dec(p, jcfg, JE(stft=JS.for_rate(sr)), mean, istd, **kw)(wavs)
    got = make_bucketed_decoder(mlp, tcfg, EnhanceConfig(stft=StftConfig.for_rate(sr)), mean,
                                istd, device="cpu", **kw)(wavs)
    for g, w, x in zip(got, want, wavs):
        assert g.shape == np.asarray(w).shape == x.shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=1e-3 * float(np.abs(np.asarray(w)).max()))


def test_unknown_quant_mode_raises():
    from tpu_sednn_torch.dsp import StftConfig
    from tpu_sednn_torch.enhance.decode import EnhanceConfig, make_serving_decoder

    _, _, _, mlp, _, _, _, tcfg = _nets(sizes=(129 * 12, 16, 129))
    with pytest.raises(ValueError, match="quant mode"):
        make_serving_decoder(mlp, tcfg, EnhanceConfig(stft=StftConfig.for_rate(8000)),
                             np.zeros(129), np.ones(129), quant="int4", device="cpu")
