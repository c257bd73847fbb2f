"""The port's head fusion (tpu_sednn_torch/enhance/fusion.py and
recipes/fusion_sweep.py) against the JAX package's on the CPU:
enhance_lps_multi and enhance_waveform_fused at rtol 1e-5 / atol 1e-5 on the
same weights and inputs; the endpoint weights give the single-model decode;
the validations; the fused serving decoder against the eager form (rtol
1e-4 / atol 1e-5, as tests/test_fusion.py) and against JAX's; sweep_fusion
and its command on tiny run dirs."""

import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.enhance.fusion as jf
from tpu_sednn.dsp import StftConfig as JStft
from tpu_sednn.dsp.stft import stft_real_imag as j_stft
from tpu_sednn.enhance.decode import EnhanceConfig as JEnh
from tpu_sednn.io import save_norm, save_wts
from tpu_sednn.model import ModelConfig as JModel
from tpu_sednn.model import init_params, params_to_wts
import tpu_sednn_torch.enhance.fusion as tf
from tpu_sednn_torch.dsp import LPS_FLOOR, StftConfig
from tpu_sednn_torch.enhance.decode import (EnhanceConfig, enhance_lps, enhance_waveform,
                                            make_serving_decoder)
from tpu_sednn_torch.model import ModelConfig, params_from_jax

SR = 8000
D = 129
CTX = 3


def _models(seed: int, head: str, sr: int = SR):
    """(JAX model tuple, port model tuple) with the same weights."""
    d = StftConfig.for_rate(sr).n_bins
    kw = dict(layersizes=(CTX * d, 64, d), dropout_vis=0.1, dropout_hid=0.2,
              output="sigmoid" if head != "lps" else "linear")
    ekw = dict(fea_context=CTX, targ_offset=1, nat=False, head=head,
               mask_floor=0.05 if head != "lps" else 0.0,
               min_gain_db=-12.0 if head == "lps" else None)
    p = init_params(jax.random.key(seed), JModel(**kw), scheme="glorot")
    mlp = params_from_jax({"w": [np.asarray(w) for w in p["w"]],
                           "b": [np.asarray(b) for b in p["b"]]}, device="cpu")
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=d).astype(np.float32)
    istd = rng.uniform(0.5, 1.5, d).astype(np.float32)
    tn = ((np.full(d, 0.3, np.float32), np.full(d, 0.7, np.float32)) if head == "lps"
          else None)
    return ((p, JModel(**kw), JEnh(stft=JStft.for_rate(sr), **ekw), mean, istd, tn, None),
            (mlp, ModelConfig(**kw), EnhanceConfig(stft=StftConfig.for_rate(sr), **ekw), mean,
             istd, tn, None))


@pytest.fixture(scope="module")
def pair():
    (ja, ta), (jb, tb) = _models(0, "psm"), _models(1, "lps")
    return (ja, jb), (ta, tb)


@pytest.fixture(scope="module")
def noisy():
    rng = np.random.default_rng(3)
    t = np.arange(SR) / SR
    return (rng.standard_normal(SR) * 0.1 + 0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)


def _noisy_lps(noisy):
    re, im = j_stft(jnp.asarray(noisy), JStft.for_rate(SR))
    return np.array(jnp.log(jnp.maximum(re * re + im * im, LPS_FLOOR)))


@pytest.mark.parametrize("w", [(0.5, 0.5), (0.65, 0.35), (0.2, 0.8)])
def test_enhance_lps_multi_matches_jax(pair, noisy, w):
    jm, tm_ = pair
    nl = _noisy_lps(noisy)
    want = np.asarray(jf.enhance_lps_multi(jm, jnp.asarray(nl), w))
    got = tf.enhance_lps_multi(tm_, torch.from_numpy(nl), w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("w", [(0.5, 0.5), (0.65, 0.35), (1.0, 0.0)])
def test_enhance_waveform_fused_matches_jax(pair, noisy, w):
    jm, tm_ = pair
    want = jf.enhance_waveform_fused(jm, noisy, w)
    got = tf.enhance_waveform_fused(tm_, noisy, w, device="cpu")
    assert got.shape == want.shape == noisy.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_endpoint_weights_match_single_models(pair, noisy):
    """alpha 0 / 1 give the single-model decode bit for bit: the sweep's
    endpoint rows are the single-model baselines."""
    _, (a, b) = pair
    nl = torch.from_numpy(_noisy_lps(noisy))
    for w, m in (((1.0, 0.0), a), ((0.0, 1.0), b)):
        fused = tf.enhance_lps_multi((a, b), nl, w)
        params, mcfg, ecfg, mean, istd, tn, _ = m
        single = enhance_lps(params, mcfg, ecfg, nl, torch.from_numpy(mean),
                             torch.from_numpy(istd),
                             target_norm=None if tn is None else tuple(map(torch.from_numpy, tn)))
        assert torch.equal(fused, single)
    params, mcfg, ecfg, mean, istd, tn, _ = b
    np.testing.assert_allclose(tf.enhance_waveform_fused((a, b), noisy, (0.0, 1.0), device="cpu"),
                               enhance_waveform(params, mcfg, ecfg, noisy, mean, istd,
                                                target_norm=tn, device="cpu"), atol=1e-6)


def test_blend_interpolates(pair, noisy):
    _, (a, b) = pair
    nl = torch.from_numpy(_noisy_lps(noisy))
    la, lb = (tf.enhance_lps_multi((a, b), nl, w) for w in ((1.0, 0.0), (0.0, 1.0)))
    lf = tf.enhance_lps_multi((a, b), nl, (0.5, 0.5))
    torch.testing.assert_close(lf, 0.5 * la + 0.5 * lb, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn", ["lps", "waveform", "serving"])
def test_fusion_validations(pair, noisy, fn):
    _, (a, b) = pair
    c = list(_models(2, "lps")[1])
    c[2] = replace(c[2], stft=StftConfig.for_rate(16000))
    call = {"lps": lambda ms, w: tf.enhance_lps_multi(ms, torch.from_numpy(_noisy_lps(noisy)), w),
            "waveform": lambda ms, w: tf.enhance_waveform_fused(ms, noisy, w, device="cpu"),
            "serving": lambda ms, w: tf.make_fused_serving_decoder(ms, w, device="cpu")}[fn]
    with pytest.raises(ValueError, match="sum to 1"):
        call((a, b), (0.7, 0.7))
    with pytest.raises(ValueError, match="models vs"):
        call((a, b), (1.0,))
    with pytest.raises(ValueError, match="STFT geometry"):
        call((a, tuple(c)), (0.5, 0.5))


def test_fused_serving_decoder(pair, noisy):
    """The batched fused decoder reproduces the eager fused decode and JAX's
    fused serving decoder; a zero-weight model is left out, giving the
    single-model serving decoder."""
    jm, (a, b) = pair
    w = (0.65, 0.35)
    eager = tf.enhance_waveform_fused((a, b), noisy, w, device="cpu")
    batch = np.stack([noisy, noisy * 0.5])
    out = tf.make_fused_serving_decoder((a, b), w, device="cpu")(batch).numpy()
    assert out.shape == batch.shape
    np.testing.assert_allclose(out[0], eager, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jf.make_fused_serving_decoder(jm, w)(batch)),
                               rtol=1e-5, atol=1e-5)
    params, mcfg, ecfg, mean, istd, tn, _ = b
    single = make_serving_decoder(params, mcfg, ecfg, mean, istd, target_norm=tn, device="cpu")
    np.testing.assert_allclose(
        tf.make_fused_serving_decoder((a, b), (0.0, 1.0), device="cpu")(batch).numpy(),
        single(batch).numpy(), atol=1e-6)


def _write_run_dir(path, head, seed):
    os.makedirs(path, exist_ok=True)
    sizes = (CTX * D, 32, D)
    params = init_params(jax.random.key(seed), JModel(layersizes=sizes), scheme="glorot")
    save_wts(os.path.join(path, "mlp.final.wts"), *params_to_wts(params))
    rng = np.random.default_rng(seed)
    save_norm(os.path.join(path, "fea.norm"), rng.normal(size=D).astype(np.float32),
              rng.uniform(0.5, 2.0, D).astype(np.float32))
    with open(os.path.join(path, "run.json"), "w") as f:
        json.dump({"head": head, "sample_rate": SR, "fea_context": CTX, "targ_offset": 1,
                   "dropout": [0.1, 0.2], "nat": False, "mask_floor": 0.05}, f)
    return path


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    return (_write_run_dir(str(root / "a"), "psm", 0), _write_run_dir(str(root / "b"), "lps", 1))


def test_sweep_fusion_matches_jax(run_dirs):
    from tpu_sednn.recipes.artifact import load_run_dir as j_load
    from tpu_sednn.recipes.fusion_sweep import sweep_fusion as j_sweep
    from tpu_sednn_torch.recipes.artifact import load_run_dir as t_load
    from tpu_sednn_torch.recipes.fusion_sweep import sweep_fusion as t_sweep

    alphas = (0.0, 0.5, 1.0)
    want = j_sweep(*(j_load(d) for d in run_dirs), SR, alphas=alphas, n_clips=2)
    got = t_sweep(*(t_load(d, device="cpu") for d in run_dirs), SR, alphas=alphas, n_clips=2,
                  device="cpu")
    assert [r["alpha"] for r in got["table"]] == list(alphas)
    assert got["best"] in got["table"] and got["objective"] == want["objective"]
    for g, w in zip(got["table"], want["table"]):
        for k in ("lsd_gain", "stoi_gain", "segsnr_gain", "score"):
            assert np.isfinite(g[k])
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4, err_msg=k)
    assert got["best"]["alpha"] == want["best"]["alpha"]


def test_fusion_sweep_command(run_dirs, tmp_path):
    from tpu_sednn_torch.recipes.fusion_sweep import main

    out = str(tmp_path / "fs.json")
    assert main(list(run_dirs) + ["--out", out, "--alphas", "0,1", "--device", "cpu"]) == 0
    res = json.load(open(out))
    assert [r["alpha"] for r in res["table"]] == [0.0, 1.0]
    assert res["run_a"] == run_dirs[0] and res["run_b"] == run_dirs[1]
    assert main([run_dirs[0]]) == 1  # one run dir: usage
