"""The multi-condition recipe's data-parallel branch in the port
(tpu_sednn_torch/recipes/multi_condition.py under a process group) on 2
ranks spawned on the CPU over gloo (tests/_torch_dp_worker.py, "recipe"
cases), against the JAX recipe's data-parallel branch (use_dp_mesh on the 8
virtual CPU devices) and against one rank of the port.

(a) the mini config of tests/test_torch_multi_condition.py, dropout off, the
    port's init, epoch permutations and features replaced inside the ranks
    by the JAX recipe's draws (the three substitutes of
    test_parity_with_the_jax_recipe, read from a file the JAX side writes
    here): _hold_parity's limits against the JAX recipe;
(b) the same run and a dropout-on one against one rank of the port on the
    plain trainer with the same draws, the tail beyond the last whole bunch
    put last in each epoch's order, so that both train the same bunches:
    CV history to rtol 1e-5 and mlp.final.wts to 1e-5 relative Frobenius
    (float32 gradient sums in another order);
(c) rank 0 alone writes the run dir; the other rank opens no file for
    writing and returns the CV history without scores;
(d) a 2-rank run killed after 2 epochs (ckpt_every=1) and resumed gives the
    uninterrupted 2-rank run's CV history, scores and weights bit for bit.
"""

import io
import json

import jax
import numpy as np
import pytest
import torch

import tpu_sednn.model as jmodel
import tpu_sednn.recipes.multi_condition as jmc
from tpu_sednn.dsp import StftConfig as JStft
from tpu_sednn.recipes.multi_condition import MultiConditionConfig as JConfig
from tpu_sednn.recipes.multi_condition import run_multi_condition as j_run
from tpu_sednn.utils.logging import Logger as JLogger
import tpu_sednn_torch.recipes.multi_condition as tmc
from tpu_sednn_torch.data.mixing import synth_corpus
from tpu_sednn_torch.io import load_wts
from tpu_sednn_torch.utils.logging import Logger

from _torch_dp_worker import _fingerprint, spawn_ranks
from test_torch_multi_condition import MINI, _hold_parity, _jax_featurize, _jax_init, _rel_fro

WORLD = 2
PARITY = dict(MINI, dropout=(0.0, 0.0), use_dp_mesh=True)
RESUME = dict(n_utts=12, snrs=(0.0, 5.0), noise_kinds=("white", "pink"), fea_context=3,
              targ_offset=1, hidden=(64,), n_epochs=4, bunchsize=32, traincache=256,
              ckpt_every=1, head="irm", eval_noise_kinds=())
ONE_RANK_TOL = 1e-5  # CV rtol and the weights' relative Frobenius error


def _jax_permutation(seed, epoch, n):
    kperm, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed + 1), epoch))
    return np.asarray(jax.random.permutation(kperm, n)).astype(np.int64)


def _tail_last(perm_of):
    """The one-rank run's epoch order: the data-parallel branch's order of
    the samples trimmed to whole bunches, then the tail (a partial bunch,
    which the trainer drops)."""
    def perm(seed, epoch, n, device):
        bunch = perm.bunch
        whole = n - n % bunch
        return torch.cat([torch.as_tensor(perm_of(seed, epoch, whole)),
                          torch.arange(whole, n)]).to(device)
    return perm


@pytest.fixture(scope="module")
def jax_dp(tmp_path_factory):
    """The JAX recipe's mini run, dropout off, its data-parallel branch on
    the 8 virtual devices; -> (dir, results, training samples)."""
    out = tmp_path_factory.mktemp("jax_dp")
    log = io.StringIO()
    res = j_run(JConfig(out_dir=str(out), **PARITY), logger=JLogger(stream=log))
    lines = log.getvalue().splitlines()
    assert any("data-parallel over 8 devices" in l for l in lines)
    n_train = int(next(l for l in lines if " train / " in l).split()[1])
    return out, res, n_train


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_dp):
    """The recipe cases on 2 ranks, one spawn: {case: [each rank's
    {"results", "written"}]}."""
    tmp = tmp_path_factory.mktemp("recipe_dp")
    _, _, n_train = jax_dp
    whole = n_train - n_train % PARITY["bunchsize"]
    sizes = (129 * (PARITY["fea_context"] + 1), *PARITY["hidden"], 129)
    p = jmodel.init_params(jax.random.key(0), jmodel.ModelConfig(layersizes=sizes),
                           scheme="glorot")
    subs = {f"{k}{l}": np.asarray(a) for k in ("w", "b") for l, a in enumerate(p[k])}
    subs.update({f"perm{e}": _jax_permutation(0, e, whole) for e in range(PARITY["n_epochs"])})
    cleans, noisys = synth_corpus(0, PARITY["n_utts"], sr=8000, snrs=PARITY["snrs"],
                                  noise_kinds=PARITY["noise_kinds"],
                                  reverb_prob=PARITY["reverb_prob"])
    for kind, wavs in (("clean", cleans), ("noisy", noisys)):
        subs[f"fp_{kind}"] = np.array(_fingerprint(wavs))
        subs.update({f"{kind}{i}": f for i, f in
                     enumerate(jmc._featurize(wavs, JStft.for_rate(8000)))})
    np.savez(tmp / "subs.npz", **subs)
    cases = [dict(name="parity", kind="recipe", mc=PARITY, subs=str(tmp / "subs.npz")),
             dict(name="straight", kind="recipe", mc=RESUME),
             dict(name="resumed", kind="recipe", mc=RESUME, kill_at=2)]
    return tmp, spawn_ranks(cases, WORLD, tmp, timeout=300.0)


def test_dp_branch_holds_the_jax_recipe_parity(ranks, jax_dp):
    jdir, jres, _ = jax_dp
    tmp, states = ranks
    _hold_parity(states["parity"][0]["results"], jres, tmp / "parity", jdir, cv_rtol=1e-4)


def _one_rank(tmp_path, monkeypatch, name, kw, perm_of, jax_draws):
    if jax_draws:
        monkeypatch.setattr(tmc, "_init_params", _jax_init)
        monkeypatch.setattr(tmc, "_featurize", _jax_featurize)
    perm = _tail_last(perm_of)
    perm.bunch = kw["bunchsize"]
    monkeypatch.setattr(tmc, "_epoch_permutation", perm)
    mc = tmc.MultiConditionConfig(out_dir=str(tmp_path / name), device="cpu", engine="xla", **kw)
    return tmc.run_multi_condition(mc, logger=Logger(stream=None))


@pytest.mark.parametrize("case", ["parity", "straight"])
def test_dp_branch_matches_one_rank_of_the_port(ranks, tmp_path, monkeypatch, case):
    """The 2-rank run against one rank on the plain trainer over the same
    bunches: dropout off with the JAX draws, and dropout on (the irm head)
    with the port's own, whose masks the data-parallel trainer draws for the
    global bunch and slices to each rank's rows."""
    tmp, states = ranks
    real_perm = tmc._epoch_permutation
    if case == "parity":
        one = _one_rank(tmp_path, monkeypatch, "one", PARITY, lambda s, e, n: _jax_permutation(s, e, n),
                        jax_draws=True)
    else:
        one = _one_rank(tmp_path, monkeypatch, "one", RESUME,
                        lambda s, e, n: real_perm(s, e, n, "cpu"), jax_draws=False)
    two = states[case][0]["results"]
    np.testing.assert_allclose(two["cv_hist"], one["cv_hist"], rtol=ONE_RANK_TOL)
    (tw, tb), (ow, ob) = (load_wts(str(d / "mlp.final.wts")) for d in (tmp / case, tmp_path / "one"))
    for a, b in zip(tw + tb, ow + ob):
        assert _rel_fro(a, b) < ONE_RANK_TOL
    assert two["eval"].keys() == one["eval"].keys()


def test_rank_0_alone_writes_the_run_dir(ranks):
    tmp, states = ranks
    for name, (r0, r1) in states.items():
        assert r1["written"] == [], (name, r1["written"])
        assert r1["results"]["eval"] == {} and r1["results"]["cv_hist"] == r0["results"]["cv_hist"]
        assert {"fea.norm", "gv.txt", "mlp.final.wts", "run.json", "results.json"} \
            <= set(r0["written"]), (name, r0["written"])
        assert any(w.startswith("ckpt/") for w in r0["written"])
    assert json.load(open(tmp / "parity" / "results.json"))["cv_hist"] == \
        states["parity"][0]["results"]["cv_hist"]


def test_two_rank_kill_and_resume_is_exact(ranks):
    tmp, states = ranks
    straight, resumed = states["straight"][0]["results"], states["resumed"][0]["results"]
    assert len(straight["cv_hist"]) == RESUME["n_epochs"]
    assert resumed["cv_hist"] == straight["cv_hist"]
    assert resumed["eval"] == straight["eval"]
    (rw, rb), (sw, sb) = (load_wts(str(tmp / d / "mlp.final.wts")) for d in ("resumed", "straight"))
    for a, b in zip(rw + rb, sw + sb):
        np.testing.assert_array_equal(a, b)
