"""The port's tensor-parallel trainer (parallel.make_auto_sharded_train_chunk
and state_shardings over a ("data", "model") mesh) on 2 ranks as 1 x 2 and
on 4 ranks as 2 x 2, spawned on the CPU over gloo (tests/_torch_dp_worker.py,
"tp" cases), against tpu_sednn's make_auto_sharded_train_chunk on a 4 x 2
mesh of the 8 virtual CPU devices and against the port's single-process
reference_train_chunk, on the same numpy-seeded inputs.  Mirrors
tests/test_parallel.py:test_auto_sharded_2d_mesh.

Tolerance, the JAX test's own: rtol 1e-5 / atol 1e-6 (float32 sums in
another order: the gradients over "data", dedy over "model").  With dropout
on, the trainer draws the global bunch's masks at full width from the
generator in the single-process trainer's order, so it equals the port's
single-process trainer with the same seed (the JAX package's masks come from
another generator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
from tpu_sednn.parallel import make_auto_sharded_train_chunk as j_auto, make_mesh as j_make_mesh
from tpu_sednn.train import init_train_state as j_init
from tpu_sednn.train.step import OptConfig as JOpt
import tpu_sednn_torch.model as tm
from tpu_sednn_torch.parallel import Mesh, make_auto_sharded_train_chunk, state_shardings
from tpu_sednn_torch.train.step import OptConfig, init_train_state, reference_train_chunk

from _torch_dp_worker import save_inputs, spawn_ranks

TOL = dict(rtol=1e-5, atol=1e-6)
SIZES = (40, 64, 64, 16)
OPT = dict(lrate=0.5, momentum=0.7, weightcost=1e-4, bunchsize=32)
DROP_CFG = dict(dropout_vis=0.1, dropout_hid=0.2)
N_ROWS = 2 * 32 + 8  # two bunches and a partial one, which is dropped
MESHES = {2: [1, 2], 4: [2, 2]}
KEYS = ("w", "b", "dw", "db")


def _params(sizes):
    p = jm.init_params(jax.random.key(0), jm.ModelConfig(layersizes=sizes), scheme="glorot")
    return p, [np.asarray(w) for w in p["w"]], [np.asarray(b) for b in p["b"]]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, SIZES[0])).astype(np.float32),
            rng.standard_normal((n, SIZES[-1])).astype(np.float32))


def _mlp(ws, bs):
    return tm.MLP([torch.from_numpy(w.copy()) for w in ws], [torch.from_numpy(b.copy()) for b in bs])


def _single(cfg_kw, seed=1):
    """The port's single-process trainer on the same chunk, weights and seed."""
    _, ws, bs = _params(SIZES)
    x, t = _data(N_ROWS)
    return reference_train_chunk(init_train_state(_mlp(ws, bs)), torch.from_numpy(x),
                                 torch.from_numpy(t), tm.ModelConfig(layersizes=SIZES, **cfg_kw),
                                 OptConfig(**OPT), generator=torch.Generator().manual_seed(seed))


def _tensors(st) -> dict:
    return {f"{k}{l}": a.numpy() for k, mlp, attr in (("w", st.params, "w"), ("b", st.params, "b"),
                                                      ("dw", st.deltas, "w"), ("db", st.deltas, "b"))
            for l, a in enumerate(getattr(mlp, attr))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on 2 ranks (1 x 2) and on 4 (2 x 2), one spawn each:
    {world: {case: [rank states]}}."""
    tmp = tmp_path_factory.mktemp("tp")
    _, ws, bs = _params(SIZES)
    chunk = save_inputs(tmp / "chunk.npz", ws, bs, *_data(N_ROWS))
    out = {}
    for world, mesh in MESHES.items():
        cases = [dict(name=f"{name}", kind="tp", inputs=chunk, mesh=mesh, shard=shard,
                      cfg=dict(layersizes=SIZES, **cfg), opt=OPT, kw={}, calls=[dict(seed=1)],
                      **extra)
                 for name, shard, cfg, extra in (("shard", True, {}, {}),
                                                 ("whole", False, {}, {}),
                                                 ("drop", True, DROP_CFG, {}),
                                                 ("drop_whole", False, DROP_CFG, {}),
                                                 ("no_model_sum", True, {},
                                                  dict(fault="no_model_sum")))]
        out[world] = spawn_ranks(cases, world, tmp)
    return out


@pytest.fixture(scope="module")
def jax_states():
    """tpu_sednn's make_auto_sharded_train_chunk on a 4 x 2 mesh, with and
    without the model axis sharded, dropout off."""
    p, _, _ = _params(SIZES)
    x, t = _data(N_ROWS)
    mesh = j_make_mesh(n_data=4, n_model=2)
    return {shard: j_auto(jm.ModelConfig(layersizes=SIZES), JOpt(**OPT), mesh,
                          shard_model_axis=shard)(j_init(p), jnp.asarray(x), jnp.asarray(t),
                                                  jax.random.key(1))
            for shard in (True, False)}


def _assert_close(port: dict, want: dict, tol=TOL):
    for k, v in want.items():
        np.testing.assert_allclose(port[k], np.asarray(v), err_msg=k, **tol)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["shard", "whole"])
def test_tp_matches_jax_and_the_single_process_trainer(ranks, jax_states, world, case):
    jst = jax_states[case == "shard"]
    port = ranks[world][case][0]
    assert int(port["step"]) == int(jst.step) == 2
    _assert_close(port, {f"{k}{l}": a for k, tree in (("w", jst.params["w"]), ("b", jst.params["b"]),
                                                      ("dw", jst.deltas["w"]), ("db", jst.deltas["b"]))
                         for l, a in enumerate(tree)})
    _assert_close(port, _tensors(_single({})))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["drop", "drop_whole"])
def test_tp_dropout_equals_the_single_process_trainer(ranks, world, case):
    """The global bunch's masks at full width, drawn in the single trainer's
    order and sliced to the rank's rows: tensor-parallel training with
    parity dropout is the single-process run with the same seed."""
    port = ranks[world][case][0]
    single = _single(DROP_CFG)
    assert int(port["step"]) == single.step == 2
    _assert_close(port, _tensors(single))
    nodrop = _tensors(_single({}))
    assert not np.allclose(port["w0"], nodrop["w0"], rtol=1e-3, atol=1e-4)


def test_every_rank_ends_with_the_same_state(ranks):
    for world, cases in ranks.items():
        for name, states in cases.items():
            for r in range(1, world):
                for k in states[0]:
                    if k not in ("mesh_index", "mesh_model_index"):
                        assert np.array_equal(states[0][k], states[r][k]), (world, name, r, k)


@pytest.mark.parametrize("world", [2, 4])
def test_rank_positions_follow_the_jax_device_order(ranks, world):
    """Rank r sits at (r // n_model, r % n_model), as the JAX package's
    devices.reshape(n_data, n_model)."""
    n_model = MESHES[world][1]
    for r, st in enumerate(ranks[world]["shard"]):
        assert (int(st["mesh_index"]), int(st["mesh_model_index"])) == divmod(r, n_model)


@pytest.mark.parametrize("world", [2, 4])
def test_a_skipped_model_sum_is_seen(ranks, world):
    """The deliberately broken run (dedy not summed over "model") misses
    the hold the real one keeps."""
    port = ranks[world]["no_model_sum"][0]
    single = _tensors(_single({}))
    with pytest.raises(AssertionError):
        _assert_close(port, single)


def test_indivisible_width_raises_as_in_jax():
    sizes = SIZES[:-1] + (17,)
    _, ws, bs = _params(sizes)
    x, t = np.zeros((64, 40), np.float32), np.zeros((64, 17), np.float32)
    mesh = Mesh(1, 0, torch.device("cpu"), n_model=2, model_index=1)
    run = make_auto_sharded_train_chunk(tm.ModelConfig(layersizes=sizes), OptConfig(**OPT), mesh)
    with pytest.raises(ValueError, match=r"w\[2\].* width 17 is not divisible by mesh model=2"):
        run(init_train_state(_mlp(ws, bs)), torch.from_numpy(x), torch.from_numpy(t),
            torch.Generator().manual_seed(1))
    p, _, _ = _params(sizes)
    j_run = j_auto(jm.ModelConfig(layersizes=sizes), JOpt(**OPT), j_make_mesh(n_data=4, n_model=2))
    with pytest.raises(ValueError, match="divisible by 2"):
        j_run(j_init(p), jnp.asarray(x), jnp.asarray(t), jax.random.key(1))
    with pytest.raises(ValueError, match="bunchsize"):
        make_auto_sharded_train_chunk(tm.ModelConfig(layersizes=SIZES), OptConfig(bunchsize=30),
                                      Mesh(4, 0, torch.device("cpu")))


def test_state_shardings_are_views_of_the_columns():
    _, ws, bs = _params(SIZES)
    st = init_train_state(_mlp(ws, bs))
    for m in range(2):
        part = state_shardings(st, Mesh(1, 0, torch.device("cpu"), n_model=2, model_index=m), True)
        for l, (w, b) in enumerate(zip(ws, bs)):
            k = w.shape[1] // 2
            assert np.array_equal(part.params.w[l].numpy(), w[:, m * k:(m + 1) * k])
            assert np.array_equal(part.params.b[l].numpy(), b[m * k:(m + 1) * k])
            assert part.deltas.w[l].shape == (w.shape[0], k)
        part.params.w[0].add_(1.0)  # a view: the state's own columns move
        assert np.array_equal(st.params.w[0][:, m * 32:(m + 1) * 32].numpy(),
                              ws[0][:, m * 32:(m + 1) * 32] + 1.0)
    whole = state_shardings(st, Mesh(1, 0, torch.device("cpu"), n_model=2), False)
    assert whole.params.w[1] is st.params.w[1]
