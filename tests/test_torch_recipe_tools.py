"""The port's run-dir tools against the JAX package's: load_run_dir
(recipes/artifact.py) on run dirs the JAX package wrote, make_val_clips and
the decode sweep (recipes/val_sweep.py) on converted params, and the demo
gate (recipes/demo_gate.py) on clips synthesized into a directory of the
reference's layout.  The reference's own demo clips are read only where they
exist."""

import json
import os

import jax
import numpy as np
import pytest

import tpu_sednn.recipes.demo_gate as jdg
import tpu_sednn.recipes.val_sweep as jvs
from tpu_sednn.dsp import StftConfig as JStft
from tpu_sednn.enhance.decode import EnhanceConfig as JEnh
from tpu_sednn.io import save_norm, save_wts, write_wav
from tpu_sednn.model import ModelConfig as JModel
from tpu_sednn.model import init_params, params_to_wts
from tpu_sednn.recipes.artifact import load_run_dir as j_load
import tpu_sednn_torch.recipes.demo_gate as tdg
import tpu_sednn_torch.recipes.val_sweep as tvs
from tpu_sednn_torch.dsp import StftConfig as TStft
from tpu_sednn_torch.enhance import EnhanceConfig as TEnh
from tpu_sednn_torch.model import ModelConfig as TModel
from tpu_sednn_torch.model import params_from_jax
from tpu_sednn_torch.recipes import load_run_dir as t_load

SR = 8000
D = 129


def _np_params(p):
    return {"w": [np.asarray(w) for w in p["w"]], "b": [np.asarray(b) for b in p["b"]]}


def _write_run_dir(path, manifest, gv=False, targ_norm=False, sizes=(4 * D, 32, D), seed=0):
    os.makedirs(path, exist_ok=True)
    params = init_params(jax.random.key(seed), JModel(layersizes=sizes), scheme="glorot")
    save_wts(os.path.join(path, "mlp.final.wts"), *params_to_wts(params))
    rng = np.random.default_rng(seed)
    save_norm(os.path.join(path, "fea.norm"), rng.normal(size=D).astype(np.float32),
              rng.uniform(0.5, 2.0, D).astype(np.float32))
    if targ_norm:
        save_norm(os.path.join(path, "targ.norm"), np.full(D, 0.5, np.float32),
                  np.full(D, 2.0, np.float32))
    if gv:
        np.savetxt(os.path.join(path, "gv.txt"), rng.uniform(1, 3, D).astype(np.float32))
    if manifest is not None:
        with open(os.path.join(path, "run.json"), "w") as f:
            json.dump(manifest, f)
    return params


MANIFESTS = {
    "psm_targ_norm": ({"head": "psm", "sample_rate": 8000, "fea_context": 3, "targ_offset": 1,
                       "dropout": [0.1, 0.2], "gv_mode": "off", "nat": True, "mask_floor": 0.03,
                       "min_gain_db": -10.0, "max_gain_db": 0.0}, True, True),
    "lps_gv": ({"head": "lps", "sample_rate": 8000, "fea_context": 3, "targ_offset": 1,
                "dropout": [0.0, 0.2], "gv_mode": "global", "nat": True, "mask_floor": 0.0},
               True, False),
    "legacy": (None, True, False),
}


@pytest.mark.parametrize("case", sorted(MANIFESTS))
def test_load_run_dir_matches_jax(tmp_path, case):
    manifest, gv, tn = MANIFESTS[case]
    p0 = _write_run_dir(str(tmp_path), manifest, gv=gv, targ_norm=tn)
    jp, jm, je, jmean, jistd, jtn, jgv = j_load(str(tmp_path), quiet=True)
    tp, tm, te, tmean, tistd, ttn, tgv = t_load(str(tmp_path), quiet=True, device="cpu")
    assert tm == TModel(**{k: getattr(jm, k) for k in TModel.__dataclass_fields__})
    assert te == TEnh(**{k: getattr(je, k) for k in JEnh.__dataclass_fields__ if k != "stft"},
                      stft=TStft(**vars(je.stft)))
    for a, b in zip(list(tp.w) + list(tp.b), list(p0["w"]) + list(p0["b"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tmean, jmean)
    np.testing.assert_array_equal(tistd, jistd)
    assert (ttn is None) == (jtn is None) and (tgv is None) == (jgv is None)
    if jtn is not None:
        for a, b in zip(ttn, jtn):
            np.testing.assert_array_equal(a, b)
    if jgv is not None:
        np.testing.assert_array_equal(tgv, jgv)


@pytest.mark.parametrize("sr", [8000, 16000])
def test_make_val_clips_bit_equal(sr):
    for (tc, tn), (jc, jn) in zip(tvs.make_val_clips(sr, n_clips=5, seconds=1.0),
                                  jvs.make_val_clips(sr, n_clips=5, seconds=1.0)):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tn, jn)


def _sweep_inputs(head):
    stft = JStft.for_rate(SR)
    jcfg = JModel(layersizes=(4 * D, 32, D), output="sigmoid" if head != "lps" else "linear",
                  dropout_vis=0.1, dropout_hid=0.2)
    tcfg = TModel(**{k: getattr(jcfg, k) for k in TModel.__dataclass_fields__})
    jp = init_params(jax.random.key(3), jcfg, scheme="glorot")
    ecfg = dict(fea_context=3, targ_offset=1, nat=True, head=head)
    rng = np.random.default_rng(4)
    mean, istd = rng.normal(size=D).astype(np.float32), rng.uniform(0.5, 2, D).astype(np.float32)
    return (jp, jcfg, JEnh(stft=stft, **ecfg)), \
        (params_from_jax(_np_params(jp), device="cpu"), tcfg, TEnh(stft=TStft.for_rate(SR), **ecfg)), \
        mean, istd


@pytest.mark.parametrize("head", ["irm", "lps"])
def test_sweep_picks_the_jax_candidate(head):
    (jp, jcfg, je), (tp, tcfg, te), mean, istd = _sweep_inputs(head)
    clips = jvs.make_val_clips(SR, n_clips=2, seconds=1.0)
    jr = jvs.sweep_decode_params(jp, jcfg, je, clips, mean, istd, grid="small")
    tr = tvs.sweep_decode_params(tp, tcfg, te, clips, mean, istd, grid="small", device="cpu")
    assert len(tr["table"]) == len(jr["table"])
    for a, b in zip(tr["table"], jr["table"]):
        assert {k: a[k] for k in ("min_gain_db", "max_gain_db", "mask_floor", "gv_mode")} == \
            {k: b[k] for k in ("min_gain_db", "max_gain_db", "mask_floor", "gv_mode")}
        for k in ("lsd_gain", "stoi_gain", "segsnr_gain", "score"):
            np.testing.assert_allclose(a[k], b[k], atol=2e-3, err_msg=k)
    assert tr["best"] == jr["best"]
    assert tr["constraint"] == jr["constraint"] and tr["seed"] == jr["seed"]


def test_sweep_run_dir_freezes_the_jax_choice(tmp_path, monkeypatch):
    manifest = MANIFESTS["psm_targ_norm"][0]
    for d in ("jax", "port"):
        _write_run_dir(str(tmp_path / d), dict(manifest), gv=True, targ_norm=True)

    make = jvs.make_val_clips

    def two_clips(sr):
        return make(sr, n_clips=2, seconds=1.0)

    monkeypatch.setattr(jvs, "make_val_clips", two_clips)
    monkeypatch.setattr(tvs, "make_val_clips", two_clips)
    jvs.sweep_run_dir(str(tmp_path / "jax"))
    assert tvs.main([str(tmp_path / "port"), "--device", "cpu"]) == 0
    jm, tm = (json.load(open(tmp_path / d / "run.json")) for d in ("jax", "port"))
    assert tm == jm
    assert os.path.exists(tmp_path / "port" / "val_sweep.json")


def _demo_dir(path):
    """Noisy / "shipped" pairs under the reference's file names: two 8 kHz
    pairs and one at 16 kHz (resampled by the gate)."""
    from tpu_sednn.data.mixing import mix_at_snr, synth_noise, synth_speech

    rng = np.random.default_rng(21)
    for i, (name, noisy_f, shipped_f) in enumerate(jdg.PAIRS):
        sr = 16000 if i == 2 else SR
        clean = synth_speech(rng, int(1.5 * sr), sr)
        noisy = mix_at_snr(clean, synth_noise(rng, len(clean), "pink"), 5.0, rng)
        write_wav(os.path.join(path, noisy_f), noisy, sr)
        write_wav(os.path.join(path, shipped_f), 0.8 * clean + 0.2 * noisy, sr)


def test_demo_gate_matches_jax_on_synthesized_clips(tmp_path):
    _demo_dir(str(tmp_path))
    (jp, jcfg, je), (tp, tcfg, te), mean, istd = _sweep_inputs("psm")
    jr = jdg.evaluate_demo_clips(jp, jcfg, je, mean, istd, demo_dir=str(tmp_path))
    tr = tdg.evaluate_demo_clips(tp, tcfg, te, mean, istd, demo_dir=str(tmp_path),
                                 out_dir=str(tmp_path), device="cpu")
    assert set(tr) == set(jr) == {"test1", "test2", "test3", "pass"}
    assert tr["pass"] == jr["pass"]
    for name in ("test1", "test2", "test3"):
        assert set(tr[name]) == set(jr[name])
        assert tr[name]["finite"]
        for k, v in jr[name].items():
            if isinstance(v, bool):
                assert tr[name][k] == v
            elif k.startswith("pesq"):
                np.testing.assert_allclose(tr[name][k], v, atol=0.02, err_msg=f"{name} {k}")
            else:
                np.testing.assert_allclose(tr[name][k], v, rtol=1e-3, atol=2e-4,
                                           err_msg=f"{name} {k}")
        assert os.path.exists(tmp_path / f"{name}_tpu_sednn_enh.wav")


def test_demo_gate_without_clips_does_not_pass(tmp_path):
    (_, _, _), (tp, tcfg, te), mean, istd = _sweep_inputs("psm")
    res = tdg.evaluate_demo_clips(tp, tcfg, te, mean, istd, demo_dir=str(tmp_path / "none"),
                                  device="cpu")
    assert res == {"missing": ["test1", "test2", "test3"], "pass": False}


def test_demo_gate_cli_on_a_run_dir(tmp_path, monkeypatch):
    run = tmp_path / "run"
    _write_run_dir(str(run), MANIFESTS["psm_targ_norm"][0], targ_norm=True)
    demo = tmp_path / "demo"
    demo.mkdir()
    _demo_dir(str(demo))
    monkeypatch.setattr(tdg, "DEMO_DIR", str(demo))
    assert tdg.main([str(run), "--out", "g.json", "--device", "cpu"]) == 0
    res = json.load(open(run / "g.json"))
    assert {"test1", "test2", "test3"} <= set(res) and "missing" not in res


def test_reference_demo_clips_where_present():
    if not os.path.isdir(tdg.DEMO_DIR):
        pytest.skip("reference demo clips unavailable")
    (_, _, _), (tp, tcfg, te), mean, istd = _sweep_inputs("psm")
    res = tdg.evaluate_demo_clips(tp, tcfg, te, mean, istd, device="cpu")
    for name in ("test1", "test2", "test3"):
        assert res[name]["finite"] and np.isfinite(res[name]["lsd_gain"])
