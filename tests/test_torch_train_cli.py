"""The same tiny pfiles through `tpu_sednn.cli` and `tpu_sednn_torch.cli
device=cpu`, dropout off: the same log lines, the CV MSE within 1e-4 relative
and the `.wts` within rtol 2e-5 / atol 2e-6 (float32 sums in another order
over a few dozen bunches; the JAX command trains with float32 products on
the CPU, so the port's resident engine is pinned to them, bf16=False); then
the recipe's schedule and epoch loop, the train_epochs_arrays loop and the
launch report."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_sednn.cli import run_epoch as j_run_epoch
from tpu_sednn.config import TrainFlags as JFlags
from tpu_sednn.recipes import recipe_opt_schedule as j_schedule
from tpu_sednn_torch.cli import main, run_epoch
from tpu_sednn_torch.config import TrainFlags
from tpu_sednn_torch.io import compute_norm, load_wts, save_norm, write_pfile
from tpu_sednn_torch.recipes import RecipeConfig, recipe_opt_schedule, run_recipe
from tpu_sednn_torch.utils.logging import Logger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, D_OUT, CONTEXT, TO = 5, 5, 3, 1
LAYERS = (D * CONTEXT + D, 32, D_OUT)


@pytest.fixture()
def corpus(tmp_path):
    rng = np.random.default_rng(0)
    proj = rng.standard_normal((D, D_OUT)).astype(np.float32) * 0.5
    utts, targs = [], []
    for _ in range(10):
        n = int(rng.integers(20, 60))
        u = rng.standard_normal((n, D)).astype(np.float32)
        utts.append(u)
        targs.append(np.tanh(u @ proj))
    fp, tp, npth = str(tmp_path / "f.pfile"), str(tmp_path / "t.pfile"), str(tmp_path / "a.norm")
    write_pfile(fp, utts)
    write_pfile(tp, targs)
    save_norm(npth, *compute_norm(np.concatenate(utts)))
    return fp, tp, npth, tmp_path


def _argv(corpus, out, extra=()):
    fp, tp, npth, tmp = corpus
    return [f"fea_file={fp}", f"targ_file={tp}", f"norm_file={npth}",
            f"outwts_file={tmp}/{out}.wts", f"log_file={tmp}/{out}.log",
            "train_sent_range=0-7", "cv_sent_range=8-9",
            f"fea_dim={D}", f"fea_context={CONTEXT}", "targ_offset=1",
            "traincache=100", "bunchsize=16", "init_randem_seed=7", "momentum=0.5", "lrate=0.3",
            "init_randem_weight_min=-0.1", "init_randem_weight_max=0.1",
            f"layersizes={','.join(str(s) for s in LAYERS)}"] + list(extra)


def _log_lines(path, drop=("Total cost time", "device:", "outwts_file", "log_file", "initwts_file")):
    return [l for l in open(path).read().splitlines() if not l.startswith(drop)]


@pytest.mark.parametrize("extra", [
    (), ("device_splice=1",), ("engine=resident",), ("engine=resident", "device_splice=1"),
], ids=["default", "device_splice", "resident", "resident+device_splice"])
def test_both_clis_give_the_same_epoch(corpus, extra):
    tmp = corpus[3]
    cv_j = j_run_epoch(JFlags.from_argv(_argv(corpus, "jax.1")))
    f32 = {"bf16": False}
    cv_t = run_epoch(TrainFlags.from_argv(_argv(corpus, "torch.1", ("device=cpu",) + extra)),
                     engine_kwargs=f32)
    assert np.isfinite(cv_t) and cv_t == pytest.approx(cv_j, rel=1e-4)
    (wj, bj), (wt, bt) = load_wts(f"{tmp}/jax.1.wts"), load_wts(f"{tmp}/torch.1.wts", layersizes=LAYERS)
    for a, b in zip(wt + bt, wj + bj):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)
    lj, lt = _log_lines(f"{tmp}/jax.1.log"), _log_lines(f"{tmp}/torch.1.log")
    if not extra:  # same flags: the same lines, but for the CV error's last digits
        assert len(lj) == len(lt)
        for a, b in zip(lj, lt):
            if a.startswith("CV over. squared error:"):
                assert b.startswith("CV over. squared error:")
            else:
                assert a == b
    assert sum(l.startswith("Starting chunk") for l in lt) == sum(l.startswith("Starting chunk") for l in lj) >= 2
    assert "Getting Randemed initial weights..." in lt and "Saving over." in lt

    # warm-started second epoch with the recipe's next momentum: again the same, and better
    warm = ("momentum=0.54", "init_randem_seed=352")
    cv_j2 = j_run_epoch(JFlags.from_argv(_argv(corpus, "jax.2", warm + (f"initwts_file={tmp}/jax.1.wts",))))
    cv_t2 = run_epoch(TrainFlags.from_argv(_argv(
        corpus, "torch.2", warm + (f"initwts_file={tmp}/torch.1.wts", "device=cpu") + extra)),
        engine_kwargs=f32)
    assert cv_t2 == pytest.approx(cv_j2, rel=1e-4) and cv_t2 < cv_t
    assert "Init weight file loaded." in _log_lines(f"{tmp}/torch.2.log")


def test_cli_dropout_epoch_cv_dump_and_weights_txt(corpus):
    tmp = corpus[3]
    extra = ("device=cpu", "dropoutflag=1", "visible_omit=0.1", "hid_omit=0.2",
             f"cv_out_file={tmp}/cv.txt", f"weights_txt={tmp}/w.txt")
    cv_x = run_epoch(TrainFlags.from_argv(_argv(corpus, "x", extra + ("engine=xla",))))
    cv_r = run_epoch(TrainFlags.from_argv(_argv(corpus, "r", extra + ("engine=resident",))),
                     engine_kwargs={"bf16": False})
    # two dropout streams (torch.Generator, Philox): same distribution, not the same bits
    assert np.isfinite(cv_x) and np.isfinite(cv_r) and cv_r == pytest.approx(cv_x, rel=0.2)
    rows = np.loadtxt(f"{tmp}/cv.txt")
    assert rows.shape[1] == D_OUT and rows.shape[0] > 10 and os.path.getsize(f"{tmp}/w.txt") > 0


def test_cli_main_prints_all_finish_and_writes_the_launch_report(corpus, monkeypatch, capsys):
    tmp = corpus[3]
    monkeypatch.setenv("TPU_SEDNN_TORCH_LAUNCH_REPORT", f"{tmp}/launches.json")
    assert main(_argv(corpus, "m", ("device=cpu",))) == 0
    assert capsys.readouterr().out.strip().endswith("all finish!")
    counts = json.load(open(f"{tmp}/launches.json"))
    assert counts["plain_train_chunk"] >= 2 and counts["resident_chunk"] == 0  # CPU: plain trainer
    assert set(counts["resident_chunk_kernels"]) == {"fused_linear_act", "fused_bwd_update",
                                                     "philox_mask", "sr_bwd_update",
                                                     "tiled_bwd_update", "bf16_linear_act",
                                                     "tc_linear_act", "tc_bwd_update", "pdl",
                                                     "input_mask_table", "input_mask_philox"}
    assert counts["dropout_mask"] == 0 and counts["sr_momentum_update"] == 0


def test_cli_module_runs_as_a_command(corpus):
    proc = subprocess.run([sys.executable, "-m", "tpu_sednn_torch.cli"] + _argv(corpus, "s", ("device=cpu",)),
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("all finish!")
    assert re.search(r"CV over\. squared error: \d+\.\d+", proc.stderr)


def test_cli_defaults_to_the_card_and_rejects_bad_flags(corpus):
    with pytest.raises(ValueError, match="layersizes"):
        run_epoch(TrainFlags.from_argv(["layersizes=10,4,3", "fea_dim=5", "fea_context=3"]))
    with pytest.raises(ValueError, match="processes"):  # gpu_used=4 in one process
        run_epoch(TrainFlags.from_argv(_argv(corpus, "g", ("device=cpu", "gpu_used=4"))))
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the call would not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_epoch(TrainFlags.from_argv(_argv(corpus, "c")))  # no device= key: cuda


def test_recipe_schedule_equals_jax():
    for e in range(13):
        a, b = recipe_opt_schedule(e, 0.7, 64, 1e-4), j_schedule(e, 0.7, 64, 1e-4)
        assert (a.lrate, a.momentum, a.weightcost, a.bunchsize) == \
            (b.lrate, b.momentum, b.weightcost, b.bunchsize)
    ms = [recipe_opt_schedule(e).momentum for e in range(13)]
    assert ms[0] == 0.5 and abs(ms[1] - 0.54) < 1e-9 and ms[10] == ms[12] == 0.9


def test_run_recipe_epoch_loop(corpus):
    fp, tp, npth, tmp = corpus
    rc = RecipeConfig(
        mlp_dir=str(tmp / "models"), fea_file=fp, targ_file=tp, norm_file=npth,
        train_sent_range="0-7", cv_sent_range="8-9",
        layersizes=LAYERS, fea_dim=D, fea_context=CONTEXT, targ_offset=TO,
        bunchsize=16, lrate=0.3, traincache=200, init_randem_seed=7,
        n_epochs=3, dropoutflag=0, device="cpu",
    )
    hist = run_recipe(rc, logger=Logger(stream=None))
    assert len(hist) == 3 and hist[-1] < hist[0]
    assert os.path.exists(str(tmp / "models" / "mlp.3.wts"))
    assert "momentum: 0.58" in open(str(tmp / "models" / "mlp.3.log")).read()


@pytest.mark.parametrize("engine", ["xla", "resident", "auto"])
def test_train_epochs_arrays(engine, tmp_path):
    from tpu_sednn_torch.model.mlp import ModelConfig, init_params
    from tpu_sednn_torch.train.loop import train_epochs_arrays
    from tpu_sednn_torch.train.step import OptConfig, init_train_state

    sizes = (32, 64, 16)
    cfg = ModelConfig(layersizes=sizes)
    opt = OptConfig(lrate=0.1, momentum=0.5, weightcost=0.0, bunchsize=16)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((96, sizes[0])).astype(np.float32)
    t = (x @ rng.standard_normal((sizes[0], sizes[-1])).astype(np.float32) * 0.1)
    mlp = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    seen = []
    f32 = {"bf16": False}  # float32 products, as the plain engine's
    st, res = train_epochs_arrays(init_train_state(mlp), cfg, lambda e: opt, x, t, x[:32], t[:32],
                                  n_epochs=3, seed=3, traincache=48, engine=engine,
                                  engine_kwargs=f32, logger=Logger(stream=None),
                                  on_epoch=lambda e, s, r: seen.append(e))
    assert seen == [0, 1, 2] and st.step == 18 and res[-1].cv_mse < res[0].cv_mse
    ref, res_x = train_epochs_arrays(init_train_state(mlp), cfg, lambda e: opt, x, t, x[:32], t[:32],
                                     n_epochs=3, seed=3, traincache=48, engine="xla",
                                     logger=Logger(stream=None))
    np.testing.assert_allclose(st.params.w[0].numpy(), ref.params.w[0].numpy(), rtol=2e-5, atol=2e-6)
    assert res[-1].cv_mse == pytest.approx(res_x[-1].cv_mse, rel=1e-4)
    # ckpt_dir and profile_dir are served (tests/test_torch_checkpoint.py holds resume)
    st_c, res_c = train_epochs_arrays(init_train_state(mlp), cfg, lambda e: opt, x, t, x[:32],
                                      t[:32], n_epochs=3, seed=3, traincache=48, engine=engine,
                                      engine_kwargs=f32, logger=Logger(stream=None),
                                      ckpt_dir=str(tmp_path / "ck"),
                                      profile_dir=str(tmp_path / "prof"))
    assert torch.equal(st_c.params.w[0], st.params.w[0]) and res_c[-1].cv_mse == res[-1].cv_mse
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_1.pt", "step_2.pt", "step_3.pt"]
