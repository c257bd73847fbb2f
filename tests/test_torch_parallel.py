"""The port's data parallelism (tpu_sednn_torch/parallel, the pfile epoch with
n_data_shards > 1 and the command with gpu_used > 1) on 2 and 4 ranks
spawned on the CPU over gloo (tests/_torch_dp_worker.py, torchrun), against
tpu_sednn's DP trainers on the 8 virtual CPU devices on the same
numpy-seeded inputs.  Mirrors tests/test_parallel.py, tests/test_multihost.py
and the pfile test of tests/test_resident_chunk.py.

Tolerances, the JAX tests' own: a DP trainer against a single-device one
rtol 1e-5 / atol 1e-6 (float32 sums in another order), an epoch's weights
rtol 2e-5 / atol 2e-6 and its CV 1e-5 relative.  With dropout on, the port's
DP trainers draw the global bunch's masks and slice the rank's rows, so a DP
run equals the port's single-process run with the same seed to reduction
order (the JAX package's masks come from another generator, so there the
comparison is between the port's own runs).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
from tpu_sednn.data.rand48 import Rand48 as JRand48
from tpu_sednn.parallel import (bunch_part_regroup_host as j_regroup, make_dp_train_chunk as j_dp,
                                make_mesh as j_make_mesh, replicate as j_replicate,
                                shard_batch as j_shard)
from tpu_sednn.train import init_train_state as j_init
from tpu_sednn.train.loop import train_epoch_pfile as j_epoch
from tpu_sednn.train.step import OptConfig as JOpt
import tpu_sednn_torch.model as tm
from tpu_sednn_torch.cli import run_epoch
from tpu_sednn_torch.config import TrainFlags
from tpu_sednn_torch.io import compute_norm, load_wts, save_norm, write_pfile
from tpu_sednn_torch.parallel import (Mesh, bunch_part_regroup_host, initialize_distributed,
                                      local_rows, make_global_chunk, make_mesh, replicate,
                                      shard_batch)
from tpu_sednn_torch.train.loop import make_chunk_runner
from tpu_sednn_torch.train.step import OptConfig, cv_squared_error, init_train_state, \
    make_jit_train_chunk

from _torch_dp_worker import save_inputs, spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
SIZES = (40, 64, 64, 16)
D, CONTEXT, TO = 5, 3, 1
EPOCH_SIZES = (D * CONTEXT + D, 64, D)
OPT = dict(lrate=0.5, momentum=0.7, weightcost=1e-4, bunchsize=32)
DROP_CFG = dict(dropout_vis=0.1, dropout_hid=0.2)
LEARN_OPT = dict(lrate=1.0, momentum=0.5, weightcost=0.0, bunchsize=64)


def _params(sizes):
    p = jm.init_params(jax.random.key(0), jm.ModelConfig(layersizes=sizes), scheme="glorot")
    return p, [np.asarray(w) for w in p["w"]], [np.asarray(b) for b in p["b"]]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, SIZES[0])).astype(np.float32),
            rng.standard_normal((n, SIZES[-1])).astype(np.float32))


def _learn_data():
    rng = np.random.default_rng(3)
    proj = rng.standard_normal((SIZES[0], SIZES[-1])).astype(np.float32) * 0.3
    x = rng.standard_normal((1024, SIZES[0])).astype(np.float32)
    return x, np.tanh(x @ proj).astype(np.float32)


def _mlp(ws, bs):
    return tm.MLP([torch.from_numpy(w.copy()) for w in ws], [torch.from_numpy(b.copy()) for b in bs])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_corpus")
    rng = np.random.default_rng(0)
    utts = [rng.standard_normal((int(rng.integers(30, 60)), D)).astype(np.float32)
            for _ in range(8)]
    targs = [np.tanh(u @ rng.standard_normal((D, D)).astype(np.float32) * 0.4) for u in utts]
    paths = {k: str(tmp / f"{k}") for k in ("f.pfile", "t.pfile", "a.norm")}
    write_pfile(paths["f.pfile"], utts)
    write_pfile(paths["t.pfile"], targs)
    save_norm(paths["a.norm"], *compute_norm(np.concatenate(utts)))
    return dict(fea_file=paths["f.pfile"], targ_file=paths["t.pfile"], norm_file=paths["a.norm"],
                fea_dim=D, fea_context=CONTEXT, targ_offset=TO, train_sent_range=(0, 5),
                cv_sent_range=(6, 7), seed=3)


EPOCHS = {  # name: (OptConfig kwargs, traincache, engine, engine_kwargs)
    "epoch_xla": (dict(lrate=0.3, momentum=0.5, weightcost=1e-4, bunchsize=16), 96, "xla", None),
    "epoch_resident": (dict(lrate=0.3, momentum=0.5, weightcost=0.0, bunchsize=32), 128,
                       "resident", {"bf16": False}),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, corpus):
    """Every case on 2 ranks and on 4, one spawn each: {world: {case: [rank states]}}."""
    tmp = tmp_path_factory.mktemp("dp_parallel")
    _, ws, bs = _params(SIZES)
    x, t = _data(96)
    chunk = save_inputs(tmp / "chunk.npz", ws, bs, x, t)
    learn = save_inputs(tmp / "learn.npz", ws, bs, *_learn_data())
    common = [
        dict(name="match", kind="xla", inputs=chunk, cfg=dict(layersizes=SIZES), opt=OPT, kw={},
             calls=[dict(seed=1)]),
        dict(name="drop", kind="xla", inputs=chunk, cfg=dict(layersizes=SIZES, **DROP_CFG),
             opt=dict(OPT, momentum=0.5, weightcost=0.0), kw={}, calls=[dict(seed=1)]),
        dict(name="drop_pg", kind="xla", inputs=chunk, cfg=dict(layersizes=SIZES, **DROP_CFG),
             opt=dict(OPT, momentum=0.5, weightcost=0.0), kw={}, calls=[dict(seed=1)],
             pre_grouped=True),
    ]
    _, ews, ebs = _params(EPOCH_SIZES)
    epoch_in = save_inputs(tmp / "epoch.npz", ews, ebs)
    epochs = [dict(name=name, kind="pfile", inputs=epoch_in, cfg=dict(layersizes=EPOCH_SIZES),
                   opt=opt, perturb=True,
                   kw=dict(corpus, traincache=cache, engine=engine, engine_kwargs=ekw,
                           rand_seed=3), calls=[])
              for name, (opt, cache, engine, ekw) in EPOCHS.items()]
    four = common + [dict(name="learn", kind="xla", inputs=learn,
                          cfg=dict(layersizes=SIZES, **DROP_CFG), opt=LEARN_OPT, kw={},
                          calls=[dict(seed=i) for i in range(10)])]
    return {2: spawn_ranks(common + epochs, 2, tmp), 4: spawn_ranks(four, 4, tmp)}


def _assert_state(port, jst, tol=TOL, keys=("w", "b", "dw", "db")):
    src = {"w": ("params", "w"), "b": ("params", "b"), "dw": ("deltas", "w"),
           "db": ("deltas", "b")}
    for key in keys:
        kind, k = src[key]
        for l, want in enumerate(getattr(jst, kind)[k] if hasattr(jst, kind) else []):
            np.testing.assert_allclose(port[f"{key}{l}"], np.asarray(want), err_msg=f"{key}{l}",
                                       **tol)


def test_mesh_shapes_and_guards():
    mesh = make_mesh(devices=["cpu"])
    assert mesh.shape == {"data": 1, "model": 1} and mesh.index == 0
    assert mesh.device == torch.device("cpu")
    one = make_mesh(n_data=1, n_model=1, devices=["cpu"])  # a 1 x 1 mesh of one rank
    assert one.shape == {"data": 1, "model": 1} and (one.index, one.model_index) == (0, 0)
    with pytest.raises(ValueError, match="world size"):
        make_mesh(n_data=2, devices=["cpu"])
    with pytest.raises(ValueError, match="1 x 2 must hold the world size 1"):
        make_mesh(n_data=1, n_model=2, devices=["cpu"])
    # a single process joins no group; asking nccl for ranks on the CPU raises before joining
    assert initialize_distributed(device="cpu") is None
    with pytest.raises(ValueError, match="nccl"):
        initialize_distributed(device="cpu", backend="nccl", world_size=2, rank=0)


def test_make_mesh_defaults_to_the_card():
    """With no devices the mesh takes the current card, and raises where
    there is none (no fall back to the CPU)."""
    if torch.cuda.is_available():
        assert make_mesh().device == torch.device("cuda", torch.cuda.current_device())
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


@pytest.mark.parametrize("world", [2, 4])
def test_dp_matches_jax_dp_and_single_device(ranks, world):
    cfg, opt = jm.ModelConfig(layersizes=SIZES), JOpt(**OPT)
    p, _, _ = _params(SIZES)
    x, t = _data(96)
    mesh = j_make_mesh(n_data=world, n_model=1)
    jst = j_dp(cfg, opt, mesh)(j_init(j_replicate(p, mesh)), j_shard(jnp.asarray(x), mesh),
                               j_shard(jnp.asarray(t), mesh), jax.random.key(1))
    port = ranks[world]["match"][0]
    assert int(port["step"]) == int(jst.step) == 3
    _assert_state(port, jst)
    # and the port's own single-device plain trainer
    _, ws, bs = _params(SIZES)
    st = make_jit_train_chunk(tm.ModelConfig(layersizes=SIZES), OptConfig(**OPT))(
        init_train_state(_mlp(ws, bs)), torch.from_numpy(x), torch.from_numpy(t),
        torch.Generator().manual_seed(1))
    for l in range(3):
        np.testing.assert_allclose(port[f"w{l}"], st.params.w[l].numpy(), **TOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["drop", "drop_pg"])
def test_dp_dropout_equals_the_single_process_trainer(ranks, world, case):
    """The global bunch's masks, drawn from the generator in the single
    trainer's order and sliced per rank: DP training with dropout is the
    single-process run, for any number of ranks (and from host-regrouped
    input the same)."""
    _, ws, bs = _params(SIZES)
    x, t = _data(96)
    opt = OptConfig(**dict(OPT, momentum=0.5, weightcost=0.0))
    cfg = tm.ModelConfig(layersizes=SIZES, **DROP_CFG)
    st = make_jit_train_chunk(cfg, opt)(init_train_state(_mlp(ws, bs)), torch.from_numpy(x),
                                        torch.from_numpy(t), torch.Generator().manual_seed(1))
    port = ranks[world][case][0]
    assert int(port["step"]) == st.step == 3
    for l in range(3):
        for key, want in (("w", st.params.w[l]), ("db", st.deltas.b[l])):
            np.testing.assert_allclose(port[f"{key}{l}"], want.numpy(), **TOL)
    nodrop = make_jit_train_chunk(tm.ModelConfig(layersizes=SIZES), opt)(
        init_train_state(_mlp(ws, bs)), torch.from_numpy(x), torch.from_numpy(t),
        torch.Generator().manual_seed(1))
    assert not np.allclose(port["w0"], nodrop.params.w[0].numpy(), rtol=1e-3, atol=1e-4)


def test_dp_with_dropout_runs_and_learns(ranks):
    cfg = tm.ModelConfig(layersizes=SIZES, **DROP_CFG)
    x, t = (torch.from_numpy(a) for a in _learn_data())
    _, ws, bs = _params(SIZES)
    port = ranks[4]["learn"][0]
    e0 = float(cv_squared_error(_mlp(ws, bs), x, t, cfg)) / len(x)
    e1 = float(cv_squared_error(_mlp([port[f"w{l}"] for l in range(3)],
                                     [port[f"b{l}"] for l in range(3)]), x, t, cfg)) / len(x)
    assert int(port["step"]) == 10 * 16
    assert e1 < 0.8 * e0, (e0, e1)


def test_replicas_are_bit_equal(ranks):
    for world, cases in ranks.items():
        for name, states in cases.items():
            for r in range(1, world):
                for k in states[0]:
                    assert np.array_equal(states[0][k], states[r][k]), (world, name, r, k)


@pytest.mark.parametrize("name", list(EPOCHS))
def test_two_process_pfile_epoch_matches_the_jax_single_process_epoch(ranks, corpus, name):
    """The production pfile driver on 2 ranks (each reads the pfiles with the
    same Rand48 stream, regroups on the host and ships its own rows; rank 1
    starts from other weights, which the broadcast from rank 0 replaces)
    against the JAX package's single-process epoch (engine "xla", float32):
    the engine "xla" (plain DP) and "resident" (the chunk trainer's DP form,
    here its plain version, float32 products)."""
    opt, cache, _, _ = EPOCHS[name]
    p, _, _ = _params(EPOCH_SIZES)
    kw = dict(corpus)
    jst, jres = j_epoch(j_init(p), jm.ModelConfig(layersizes=EPOCH_SIZES), JOpt(**opt),
                        traincache=cache, rand=JRand48(3), n_data_shards=1, engine="xla", **kw)
    port = ranks[2][name][0]
    assert float(port["cv"]) == pytest.approx(jres.cv_mse, rel=1e-5)
    assert float(ranks[2][name][1]["cv"]) == float(port["cv"])  # rank 0's CV on every rank
    _assert_state(port, jst, dict(rtol=2e-5, atol=2e-6), keys=("w", "b"))


def test_bunch_part_regroup_host_and_local_rows():
    bunch, n_dev = 16, 4
    a = np.arange(5 * bunch * 3, dtype=np.float32).reshape(-1, 3)
    out = bunch_part_regroup_host(a, bunch, n_dev)
    np.testing.assert_array_equal(out, j_regroup(a, bunch, n_dev))
    a2 = np.arange((5 * bunch + 7) * 3, dtype=np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(bunch_part_regroup_host(a2, bunch, n_dev), j_regroup(a2, bunch, n_dev))
    for d in range(n_dev):
        mesh = Mesh(n_dev, d, torch.device("cpu"))
        mine = make_global_chunk(out, mesh).numpy()
        np.testing.assert_array_equal(mine, out[d * 20:(d + 1) * 20])
        np.testing.assert_array_equal(local_rows(torch.from_numpy(a2), bunch, mesh).numpy(), mine)
        np.testing.assert_array_equal(shard_batch(torch.from_numpy(a), mesh).numpy(),
                                      a[d * 20:(d + 1) * 20])


def test_replicate_and_runner_guards_on_one_rank():
    cfg, opt = tm.ModelConfig(layersizes=SIZES), OptConfig(**OPT)
    _, ws, bs = _params(SIZES)
    st = init_train_state(_mlp(ws, bs))
    assert replicate(st, make_mesh(devices=["cpu"])) is st  # one rank: nothing to send
    with pytest.raises(ValueError, match="world size"):
        make_chunk_runner(cfg, opt, "resident", n_data_shards=2, device="cpu")
    with pytest.raises(ValueError, match="pre_grouped"):
        make_chunk_runner(cfg, opt, "xla", pre_grouped=True, device="cpu")


def test_gpu_used_needs_as_many_processes(tmp_path, corpus):
    argv = [f"fea_file={corpus['fea_file']}", f"targ_file={corpus['targ_file']}",
            f"norm_file={corpus['norm_file']}", "train_sent_range=0-5", "cv_sent_range=6-7",
            f"fea_dim={D}", f"fea_context={CONTEXT}", f"targ_offset={TO}", "bunchsize=16",
            f"layersizes={','.join(str(s) for s in EPOCH_SIZES)}", "device=cpu", "gpu_used=2"]
    with pytest.raises(ValueError, match="processes"):
        run_epoch(TrainFlags.from_argv(argv))


def test_torchrun_command_gpu_used_2_equals_gpu_used_1(tmp_path, corpus):
    """`python -m torch.distributed.run --nproc_per_node=2 -m
    tpu_sednn_torch.cli ... gpu_used=2` (gloo on the CPU, engine=resident,
    dropout on) against the same command's gpu_used=1 epoch in process: the
    same CV and .wts to reduction order; rank 0 alone writes the log and the
    .wts and prints "all finish!"."""
    argv = [f"fea_file={corpus['fea_file']}", f"targ_file={corpus['targ_file']}",
            f"norm_file={corpus['norm_file']}", "train_sent_range=0-5", "cv_sent_range=6-7",
            f"fea_dim={D}", f"fea_context={CONTEXT}", f"targ_offset={TO}", "traincache=96",
            "bunchsize=16", "init_randem_seed=7", "momentum=0.5", "lrate=0.3", "dropoutflag=1",
            "visible_omit=0.1", "hid_omit=0.2", "engine=resident", "device=cpu",
            f"layersizes={','.join(str(s) for s in EPOCH_SIZES)}"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "tpu_sednn_torch.cli"] + argv
        + [f"outwts_file={tmp_path}/dp.wts", f"log_file={tmp_path}/dp.log", "gpu_used=2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert proc.stdout.count("all finish!") == 1
    assert "backend gloo" in proc.stderr
    cv1 = run_epoch(TrainFlags.from_argv(argv + [f"outwts_file={tmp_path}/one.wts",
                                                 f"log_file={tmp_path}/one.log"]))
    log = open(tmp_path / "dp.log").read()
    cv2 = [float(l.rsplit(":", 1)[1]) for l in log.splitlines() if l.startswith("CV over")]
    assert len(cv2) == 1 and cv2[0] == pytest.approx(cv1, rel=1e-5)
    (w2, b2), (w1, b1) = (load_wts(f"{tmp_path}/{n}.wts", layersizes=EPOCH_SIZES)
                          for n in ("dp", "one"))
    for a, b in zip(w2 + b2, w1 + b1):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)
    assert sorted(os.listdir(tmp_path)) == ["dp.log", "dp.wts", "one.log", "one.wts"]
