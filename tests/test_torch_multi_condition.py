"""The port's multi-condition recipe (tpu_sednn_torch/recipes/multi_condition.py)
on the CPU, against tpu_sednn/recipes/multi_condition.py.

(a) the mini config of tests/test_multi_condition.py runs, its CV falls, and
    it writes the JAX recipe's files and results.json keys (the demo clips
    only where the reference's demo directory, demo_gate.DEMO_DIR, exists);
(b) parity: the same mini config with dropout off, single-device, the JAX
    recipe on its plain "xla" engine, and the port's init and epoch
    permutations replaced by the JAX package's draws: cv_hist to rtol 1e-4,
    mlp.final.wts to 1e-4 relative Frobenius, SNR / SegSNR / STOI / LSD to
    rtol 1e-3, PESQ and CSIG/CBAK/COVL to atol 0.02 (their time alignment
    takes an argmax);
(c) a run killed after 2 epochs (ckpt_every=1) and resumed gives the
    uninterrupted run's cv_hist bit for bit;
(d) the chunk trainer's padded last chunk with n_real (its plain version on
    the CPU) trains as the plain trainer's trimmed chunks;
(e) under a process group (simulated on rank 0) the recipe takes the JAX
    recipe's data-parallel branch where the group's size divides the bunch.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import tpu_sednn.model as jmodel
import tpu_sednn.recipes.multi_condition as jmc
from tpu_sednn.data.mixing import synth_corpus
from tpu_sednn.dsp import StftConfig as JStft
from tpu_sednn.recipes.multi_condition import MultiConditionConfig as JConfig
from tpu_sednn.recipes.multi_condition import run_multi_condition as j_run
from tpu_sednn.utils.logging import Logger as JLogger
import tpu_sednn_torch.recipes.multi_condition as tmc
from tpu_sednn_torch.dsp import StftConfig as TStft
from tpu_sednn_torch.io import load_wts
from tpu_sednn_torch.model import params_from_jax
from tpu_sednn_torch.recipes.demo_gate import DEMO_DIR
from tpu_sednn_torch.utils.logging import Logger

DEMO = os.path.isdir(DEMO_DIR)

MINI = dict(n_utts=16, snrs=(0.0, 5.0), noise_kinds=("white",), fea_context=3, targ_offset=1,
            hidden=(128, 128), n_epochs=5, bunchsize=64, head="lps", reverb_prob=0.3,
            eval_noise_kinds=("pink",))
GEN_KEYS = ("stoi_gain", "segsnr_gain", "pesq_gain", "lsd_gain")


def _run(tmp_path, name, logger=None, **kw):
    mc = tmc.MultiConditionConfig(out_dir=str(tmp_path / name), device="cpu", **kw)
    return tmc.run_multi_condition(mc, logger=logger or Logger(stream=None))


def test_mini_runs_and_writes_the_recipe_files(tmp_path):
    res = _run(tmp_path, "mc", **MINI, use_dp_mesh=True)
    out = tmp_path / "mc"
    assert res["cv_hist"][-1] < res["cv_hist"][0]
    assert len(res["cv_hist"]) == MINI["n_epochs"]
    gen = res["eval"]["noise_generalization"]
    assert set(gen["per_kind"]) == {"white", "pink"}
    assert gen["per_kind"]["white"]["seen"] is True
    assert gen["per_kind"]["pink"]["seen"] is False
    for grp in ("seen", "unseen"):
        for k in GEN_KEYS:
            assert np.isfinite(gen[grp][k])
    assert set(gen["gap"]) == set(GEN_KEYS)
    for snr in ("0", "5"):
        ev = res["eval"][f"synthetic_{snr}dB"]
        assert set(ev) == {"snr_noisy", "snr_enh", "segsnr_noisy", "segsnr_enh", "stoi_noisy",
                           "stoi_enh", "pesq_noisy", "pesq_enh", "csig_enh", "cbak_enh",
                           "covl_enh"}
        assert all(np.isfinite(v) for v in ev.values())
    assert res["eval"]["synthetic_0dB"]["snr_enh"] > res["eval"]["synthetic_0dB"]["snr_noisy"]
    files = {"mlp.final.wts", "fea.norm", "targ.norm", "gv.txt", "run.json", "results.json",
             "ckpt"}
    if DEMO:
        files |= {"demo_gate.json"}
        assert {"test1", "test2", "test3"} <= set(res["eval"]["demo_clips"])
    else:
        assert "demo_clips" not in res["eval"]
    assert files <= set(os.listdir(out))
    saved = json.load(open(out / "results.json"))
    assert set(saved) == {"cv_hist", "train_samples_per_sec", "audio_seconds", "eval",
                          "total_seconds"}
    assert saved["cv_hist"] == res["cv_hist"]
    man = json.load(open(out / "run.json"))
    assert man["head"] == "lps" and man["layersizes"] == [129 * 4, 128, 128, 129]


def _jax_init(mcfg, seed, device):
    p = jmodel.init_params(jax.random.key(seed), jmodel.ModelConfig(layersizes=mcfg.layersizes),
                           scheme="glorot")
    return params_from_jax({"w": [np.asarray(w) for w in p["w"]],
                            "b": [np.asarray(b) for b in p["b"]]}, device=device)


def _jax_permutation(seed, epoch, n, device):
    kperm, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed + 1), epoch))
    return torch.from_numpy(np.asarray(jax.random.permutation(kperm, n)).astype(np.int64)).to(device)


def _rel_fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jax_mini(tmp_path_factory):
    """The JAX recipe's mini run, dropout off, single-device, "xla" engine."""
    out = tmp_path_factory.mktemp("jax_mini")
    kw = dict(MINI, dropout=(0.0, 0.0), use_dp_mesh=False)
    res = j_run(JConfig(out_dir=str(out), engine="xla", **kw), logger=JLogger(stream=None))
    return out, res, kw


def _jax_featurize(wavs, cfg_stft, device, batch=64):
    return jmc._featurize(wavs, JStft.for_rate(cfg_stft.sample_rate))


def test_featurize_matches_jax(jax_mini):
    """The port's features (dsp.stft_logpower) against the JAX recipe's on
    the mini corpus, at tests/test_device_pipeline.py's limits: near the
    power floor (clean LPS about -22) the log magnifies float32
    summation-order differences to about 0.02 nats."""
    cleans, noisys = synth_corpus(0, MINI["n_utts"], sr=8000, snrs=MINI["snrs"],
                                  noise_kinds=MINI["noise_kinds"], reverb_prob=MINI["reverb_prob"])
    for wavs in (cleans, noisys):
        got = tmc._featurize(wavs, TStft.for_rate(8000), "cpu")
        want = _jax_featurize(wavs, TStft.for_rate(8000), "cpu")
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-2)


def _hold_parity(tres, jres, tdir, jdir, cv_rtol):
    np.testing.assert_allclose(tres["cv_hist"], jres["cv_hist"], rtol=cv_rtol)
    (tw, tb), (jw, jb) = (load_wts(str(d / "mlp.final.wts")) for d in (tdir, jdir))
    for a, b in zip(tw + tb, jw + jb):
        assert _rel_fro(a, b) < 1e-4
    assert json.load(open(tdir / "run.json")) == json.load(open(jdir / "run.json"))
    assert tres["audio_seconds"] == jres["audio_seconds"]
    for blk in ("synthetic_0dB", "synthetic_5dB"):
        t, j = tres["eval"][blk], jres["eval"][blk]
        assert set(t) == set(j)
        for k in j:
            if k.split("_")[0] in ("pesq", "csig", "cbak", "covl"):
                np.testing.assert_allclose(t[k], j[k], atol=0.02, err_msg=f"{blk} {k}")
            else:
                np.testing.assert_allclose(t[k], j[k], rtol=1e-3, err_msg=f"{blk} {k}")
    tg, jg = tres["eval"]["noise_generalization"], jres["eval"]["noise_generalization"]
    assert set(tg["per_kind"]) == set(jg["per_kind"])
    for kind, jm in jg["per_kind"].items():
        tm = tg["per_kind"][kind]
        assert tm["seen"] == jm["seen"]
        np.testing.assert_allclose(tm["pesq_gain"], jm["pesq_gain"], atol=0.02)
        for k in ("stoi_gain", "segsnr_gain", "lsd_gain"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, err_msg=f"{kind} {k}")


def test_parity_with_the_jax_recipe(tmp_path, monkeypatch, jax_mini):
    """The port's init, epoch permutations and features replaced by the JAX
    recipe's: everything else (norms, targets, chunking, the trainer, CV,
    export, decode, scores) is the port's."""
    jdir, jres, kw = jax_mini
    monkeypatch.setattr(tmc, "_init_params", _jax_init)
    monkeypatch.setattr(tmc, "_epoch_permutation", _jax_permutation)
    monkeypatch.setattr(tmc, "_featurize", _jax_featurize)
    tres = _run(tmp_path, "port", **kw)
    _hold_parity(tres, jres, tmp_path / "port", jdir, cv_rtol=1e-4)
    for name in ("fea.norm", "targ.norm"):
        assert (tmp_path / "port" / name).read_text() == (jdir / name).read_text()
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "port" / "gv.txt"),
                                  np.loadtxt(jdir / "gv.txt"))


def test_own_features_track_the_jax_recipe(tmp_path, monkeypatch, jax_mini):
    """The same with the port's own features: their 0.02-nat differences
    near the power floor (test_featurize_matches_jax) reach the clean-LPS
    targets of this lps head, and the mini config's lrate 1.0 amplifies them
    from epoch to epoch (relative CV differences 6e-7, 1e-7, 2e-7, 3e-5 and
    4.8e-3 on an x86 CPU).  With the JAX features the runs agree to 5e-7
    (test_parity_with_the_jax_recipe), so the difference is the
    features'."""
    jdir, jres, kw = jax_mini
    monkeypatch.setattr(tmc, "_init_params", _jax_init)
    monkeypatch.setattr(tmc, "_epoch_permutation", _jax_permutation)
    tres = _run(tmp_path, "port", **kw)
    np.testing.assert_allclose(tres["cv_hist"][:3], jres["cv_hist"][:3], rtol=1e-5)
    np.testing.assert_allclose(tres["cv_hist"], jres["cv_hist"], rtol=1e-2)
    assert tres["eval"]["synthetic_0dB"]["snr_enh"] > tres["eval"]["synthetic_0dB"]["snr_noisy"]


class _Killed(Exception):
    pass


def test_kill_and_resume_is_exact(tmp_path, monkeypatch):
    kw = dict(n_utts=12, snrs=(0.0, 5.0), noise_kinds=("white", "pink"), fea_context=3,
              targ_offset=1, hidden=(64,), n_epochs=4, bunchsize=32, traincache=256,
              ckpt_every=1, head="irm", eval_noise_kinds=())
    straight = _run(tmp_path, "straight", **kw)

    real = tmc._epoch_permutation

    def dies_at_epoch_2(seed, epoch, n, device):
        if epoch == 2:
            raise _Killed()
        return real(seed, epoch, n, device)

    monkeypatch.setattr(tmc, "_epoch_permutation", dies_at_epoch_2)
    with pytest.raises(_Killed):
        _run(tmp_path, "resumed", **kw)
    assert sorted(os.listdir(tmp_path / "resumed" / "ckpt")) == ["step_1.pt", "step_2.pt"]
    monkeypatch.setattr(tmc, "_epoch_permutation", real)
    lines = []
    resumed = _run(tmp_path, "resumed", logger=_Lines(lines), **kw)
    assert any("resumed from" in l and "at epoch 2" in l for l in lines)
    assert resumed["cv_hist"] == straight["cv_hist"]
    assert resumed["eval"] == straight["eval"]
    (rw, rb), (sw, sb) = (load_wts(str(tmp_path / d / "mlp.final.wts"))
                          for d in ("resumed", "straight"))
    for a, b in zip(rw + rb, sw + sb):
        np.testing.assert_array_equal(a, b)


class _Lines(Logger):
    def __init__(self, lines):
        super().__init__(stream=None)
        self.lines = lines

    def info(self, msg):
        self.lines.append(msg)


def test_padded_last_chunk_matches_the_plain_trainer(tmp_path):
    kw = dict(n_utts=12, snrs=(0.0,), noise_kinds=("white",), fea_context=3, targ_offset=1,
              hidden=(64,), n_epochs=2, bunchsize=32, head="lps", dropout=(0.0, 0.0),
              traincache=64, eval_noise_kinds=())
    r_xla = _run(tmp_path, "xla", engine="xla", **kw)
    r_res = _run(tmp_path, "res", engine="resident", engine_kwargs={"bf16": False}, **kw)
    np.testing.assert_allclose(r_res["cv_hist"], r_xla["cv_hist"], rtol=1e-4)


def test_stage_times_go_to_the_metrics_stream(tmp_path):
    path = tmp_path / "m.jsonl"
    _run(tmp_path, "st", logger=Logger(stream=None, metrics_path=str(path)),
         n_utts=4, snrs=(0.0,), noise_kinds=("white",), fea_context=3, targ_offset=1,
         hidden=(16,), n_epochs=1, bunchsize=32, head="ibm")
    recs = [json.loads(l) for l in path.read_text().splitlines()]
    assert [r["stage"] for r in recs if r.get("event") == "stage"] == \
        ["corpus", "featurize", "targets", "train", "eval"]


@pytest.mark.parametrize("world,taken", [(2, True), (3, False)])
def test_data_parallel_group_takes_the_dp_branch(tmp_path, monkeypatch, world, taken):
    """Under a process group whose size divides the bunch the recipe trains
    with parallel.make_dp_train_chunk on the samples trimmed to whole
    bunches (the JAX recipe's branch); otherwise on the single-device
    trainer.  The group is simulated on rank 0 (the 2-rank runs are in
    tests/test_torch_recipe_dp.py)."""
    import torch.distributed as dist

    import tpu_sednn_torch.parallel as tpar

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "barrier", lambda group=None: None)
    monkeypatch.setattr(tpar, "make_mesh", lambda n_data, devices: tpar.Mesh(n_data, 0, devices[0]))
    monkeypatch.setattr(tpar, "replicate", lambda tree, mesh: tree)
    chunks = []

    def dp_trainer(cfg, opt, mesh):
        assert mesh.n_data == world and opt.bunchsize == 32

        def run(state, x, t, rng, lrate, momentum, weightcost):
            chunks.append(x.shape[0])
            return state
        return run

    monkeypatch.setattr(tpar, "make_dp_train_chunk", dp_trainer)
    lines = []
    _run(tmp_path, "dp", logger=_Lines(lines), n_utts=4, snrs=(0.0,), noise_kinds=("white",),
         fea_context=3, targ_offset=1, hidden=(16,), n_epochs=2, bunchsize=32, head="ibm",
         traincache=64)
    n = int(next(l for l in lines if " train / " in l).split()[1])
    assert any(f"data-parallel over {world} ranks" in l for l in lines) == taken
    if taken:  # every chunk whole bunches, the epoch the trimmed samples
        assert all(c % 32 == 0 for c in chunks) and sum(chunks) == 2 * (n - n % 32)
    else:
        assert chunks == []


def test_default_device_is_the_card(tmp_path):
    assert tmc.MultiConditionConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmc.main(["--small"])
