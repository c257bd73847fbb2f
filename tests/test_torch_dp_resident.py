"""The port's data-parallel chunk trainer (make_dp_resident_train_chunk) on 2
and 4 ranks spawned on the CPU (gloo; tests/_torch_dp_worker.py), against
tpu_sednn's DP resident kernel in interpret mode on the 8 virtual CPU devices,
on the same numpy-seeded inputs.  Mirrors tests/test_resident_chunk.py's DP
tests.

Tolerances, as the JAX tests hold their DP kernel: float32 products
(bf16=False) rtol 1e-5 / atol 1e-6 (the gradient summed per rank, then over
the ranks: float32 sums in another order); row tiles the same; sr_delta
rtol 2e-2 / atol 2e-4 against the JAX package (its interpret-mode bits are
not the port's) and against the port's single-process sr_delta trainer (the
same bits) all but a 1e-3 share of the elements to 1e-6; tensor-core products
(bf16=True) 3e-4 of each state tensor's update by relative Frobenius error
(tests/test_torch_tensor_core.py says why).

Beyond the JAX tests: the ranks' replicas are bit-equal after every run, and
with dropout on the port's DP equals the port's single-process trainer with
the same seed (to reduction order, for 2 and 4 ranks), because every mask is
a function of the element's global row; the JAX test can only show its DP
result independent of the device count, since its interpret-mode bits are
degenerate.  The two deliberately broken runs (no all-reduce; every rank's
masks at row 0) are refused by the same holds.  The gradient-out backward and
the update kernel's plain versions are held against the JAX fused backward.
The card's loop, in which each rank's layer-0 forward and gradient-out
backward read its rows of a call's input-mask table, is stepped through the
wrappers' plain versions for 2 and 4 ranks in one process and held to the
single-process trainer at the same limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
import tpu_sednn.ops.fused_mlp as jfm
from tpu_sednn.ops.resident_chunk import (make_dp_resident_train_chunk as j_make_dp,
                                          make_resident_train_chunk as j_make_resident)
from tpu_sednn.parallel import make_mesh as j_make_mesh, replicate as j_replicate
from tpu_sednn.train.step import OptConfig as JOpt, init_train_state as j_init
import tpu_sednn_torch.model as tm
import tpu_sednn_torch.ops.fused_mlp as tfm
import tpu_sednn_torch.ops.resident_chunk as rc
from tpu_sednn_torch.ops.philox import philox_mask
from tpu_sednn_torch.parallel import Mesh, make_mesh
from tpu_sednn_torch.train.step import OptConfig, init_train_state

from _torch_dp_worker import save_inputs, spawn_ranks

TOL = dict(rtol=1e-5, atol=1e-6)
TOL_SR = dict(rtol=2e-2, atol=2e-4)
TOL_UPD = 3e-4
CPU = torch.device("cpu")

MATCH = dict(sizes=(128, 256, 128), opt=dict(lrate=0.5, momentum=0.6, weightcost=1e-4,
                                             bunchsize=32), n=96, data_seed=4, seed=7)
SIGMOID = dict(MATCH, cfg=dict(hidden="sigmoid", output="sigmoid"))
DROP = dict(sizes=(128, 128, 128), cfg=dict(dropout_vis=0.1, dropout_hid=0.2),
            opt=dict(lrate=0.5, momentum=0.5, weightcost=0.0, bunchsize=32), n=64, data_seed=11,
            seed=5)
PAD = dict(sizes=(128, 128), opt=dict(lrate=0.4, momentum=0.5, weightcost=0.0, bunchsize=32),
           n=96, data_seed=3, seed=9)
TILED = dict(sizes=(128, 128, 128), opt=dict(lrate=0.2, momentum=0.7, weightcost=1e-3,
                                             bunchsize=64), n=128, data_seed=9, seed=0)
BUTTERFLY = dict(sizes=(128, 128), opt=dict(lrate=0.5, momentum=0.6, weightcost=1e-4,
                                            bunchsize=64), n=128, data_seed=4, seed=7)
SR = dict(sizes=(128, 128, 128), opt=dict(lrate=0.2, momentum=0.7, weightcost=1e-3,
                                          bunchsize=32), n=64, data_seed=10, seed=5)


def _data(spec):
    p = jm.init_params(jax.random.key(0), jm.ModelConfig(layersizes=spec["sizes"]), "glorot")
    rng = np.random.default_rng(spec["data_seed"])
    x = rng.standard_normal((spec["n"], spec["sizes"][0])).astype(np.float32)
    t = rng.standard_normal((spec["n"], spec["sizes"][-1])).astype(np.float32)
    return p, x, t


def _case(tmp, name, spec, kw=None, calls=None, x=None, t=None, **more):
    p, x0, t0 = _data(spec)
    path = save_inputs(tmp / f"{name}.npz", p["w"], p["b"], x0 if x is None else x,
                       t0 if t is None else t)
    return dict(name=name, kind="resident", inputs=path,
                cfg=dict(layersizes=spec["sizes"], **spec.get("cfg", {})), opt=spec["opt"],
                kw=dict(bf16=False) if kw is None else kw,
                calls=calls or [dict(seed=spec["seed"])], **more)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on 2 ranks and on 4, one spawn each: {world: {case: [rank states]}}."""
    tmp = tmp_path_factory.mktemp("dp_resident")
    x_pad, t_pad = (np.concatenate([a[:64], np.full((32, a.shape[1]), np.nan, np.float32)])
                    for a in _data(PAD)[1:])
    common = [
        _case(tmp, "match", MATCH), _case(tmp, "sigmoid", SIGMOID), _case(tmp, "drop", DROP),
        _case(tmp, "bf16", MATCH, kw=dict(bf16=True)),
        _case(tmp, "tiled32", TILED, kw=dict(bf16=False, rule="clean", tile_rows=32)),
        _case(tmp, "sr_delta", SR, kw=dict(bf16=False, sr_delta=True)),
        _case(tmp, "no_allreduce", DROP, fault="no_allreduce"),
        _case(tmp, "row0", DROP, fault="row0"),
    ]
    two = common + [
        _case(tmp, "pad", PAD, x=x_pad, t=t_pad, calls=[dict(seed=9, n_real=2)]),
        _case(tmp, "trim", PAD, x=x_pad[:64], t=t_pad[:64]),
        _case(tmp, "tiled16", TILED, kw=dict(bf16=False, rule="clean", tile_rows=16)),
        _case(tmp, "spill", MATCH, kw=dict(bf16=False, hbm_spill=1, dedy_full=True)),
        _case(tmp, "pre_grouped", MATCH, pre_grouped=True),
        _case(tmp, "momentum_ramp", MATCH,
              calls=[dict(seed=7, momentum=0.5), dict(seed=8, momentum=0.9, lrate=0.3)]),
    ]
    four = common + [_case(tmp, "butterfly", BUTTERFLY)]
    return {2: spawn_ranks(two, 2, tmp), 4: spawn_ranks(four, 4, tmp)}


def _jax_dp(spec, n_dev, x=None, t=None, **kw):
    p, x0, t0 = _data(spec)
    cfg = jm.ModelConfig(layersizes=spec["sizes"], **spec.get("cfg", {}))
    run = j_make_dp(cfg, JOpt(**spec["opt"]), j_make_mesh(n_data=n_dev, n_model=1),
                    interpret=True, **{"bf16": False, **kw})
    mesh = j_make_mesh(n_data=n_dev, n_model=1)
    return run(j_init(j_replicate(p, mesh)), jnp.asarray(x0 if x is None else x),
               jnp.asarray(t0 if t is None else t), jnp.int32(spec["seed"]), **(
                   {"n_real": jnp.int32(2)} if x is not None else {})), p


def _port_single(spec, **kw):
    p, x, t = _data(spec)
    mlp = tm.params_from_jax({"w": tuple(np.asarray(w) for w in p["w"]),
                              "b": tuple(np.asarray(b) for b in p["b"])}, device="cpu")
    cfg = tm.ModelConfig(layersizes=spec["sizes"], **spec.get("cfg", {}))
    return rc.make_resident_train_chunk(cfg, OptConfig(**spec["opt"]), **{"bf16": False, **kw})(
        init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t), spec["seed"])


def _pairs(port, jst):
    """(port array, JAX array) of every state tensor."""
    L = len(jst.params["w"])
    for l in range(L):
        for key, want in (("w", jst.params["w"][l]), ("b", jst.params["b"][l]),
                          ("dw", jst.deltas["w"][l]), ("db", jst.deltas["b"][l])):
            yield f"{key}{l}", port[f"{key}{l}"], np.asarray(want, np.float32)


def _assert_close(port, jst, tol=TOL):
    assert int(port["step"]) == int(jst.step)
    for name, got, want in _pairs(port, jst):
        np.testing.assert_allclose(got, want, err_msg=name, **tol)


def _port_pairs(port, st):
    for l in range(len(st.params.w)):
        for key, want in (("w", st.params.w[l]), ("b", st.params.b[l]), ("dw", st.deltas.w[l]),
                          ("db", st.deltas.b[l])):
            yield f"{key}{l}", port[f"{key}{l}"], want.float().numpy()


def _update_err(port, jst, p0) -> float:
    """Worst relative Frobenius error of a state tensor's update."""
    worst = 0.0
    for name, got, want in _pairs(port, jst):
        key, l = name.rstrip("0123456789"), int(name[-1])
        start = np.asarray(p0[key][l], np.float64) if key in ("w", "b") else 0.0
        d = np.linalg.norm(want.astype(np.float64) - start)
        worst = max(worst, float(np.linalg.norm(got.astype(np.float64) - want) / d))
    return worst


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case,spec", [("match", MATCH), ("sigmoid", SIGMOID)])
def test_dp_resident_matches_jax_dp_and_single_chip(ranks, world, case, spec):
    jst, _ = _jax_dp(spec, world)
    port = ranks[world][case][0]
    assert int(port["step"]) == 3
    _assert_close(port, jst)
    j1 = j_make_resident(jm.ModelConfig(layersizes=spec["sizes"], **spec.get("cfg", {})),
                         JOpt(**spec["opt"]), interpret=True, bf16=False)(
        j_init(_data(spec)[0]), *(jnp.asarray(a) for a in _data(spec)[1:]), jnp.int32(spec["seed"]))
    _assert_close(port, j1)


def test_dp_resident_4_ranks_match_the_jax_8way_butterfly(ranks):
    """The JAX test runs all three butterfly steps on 8 devices; the port's
    4 ranks sum through gloo: both hold to the single-chip kernel, and to
    each other."""
    jst, _ = _jax_dp(BUTTERFLY, 8)
    port = ranks[4]["butterfly"][0]
    assert int(port["step"]) == 2
    _assert_close(port, jst)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_resident_dropout_equals_the_single_process_trainer(ranks, world):
    st = _port_single(DROP)
    port = ranks[world]["drop"][0]
    assert int(port["step"]) == st.step == 2
    for name, got, want in _port_pairs(port, st):
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    # and the masks took effect: without dropout the result moves
    nodrop = _port_single(dict(DROP, cfg={}))
    assert not np.allclose(port["w0"], nodrop.params.w[0].numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fault", ["no_allreduce", "row0"])
def test_dp_resident_faults_are_refused(ranks, world, fault):
    st = _port_single(DROP)
    port = ranks[world][fault][0]
    worst = max(float(np.abs(got - want).max() - TOL["rtol"] * np.abs(want).max())
                for _, got, want in _port_pairs(port, st))
    assert worst > 100 * TOL["atol"], f"{fault}: within {worst:.3g} of the single-process run"


def test_dp_resident_n_real_padding(ranks):
    """NaN rows past n_real bunches are never trained: equal to the trimmed
    chunk bit for bit, and to the JAX DP kernel's n_real run."""
    x, t = _data(PAD)[1:]
    x_pad, t_pad = (np.concatenate([a[:64], np.full((32, a.shape[1]), np.nan, np.float32)])
                    for a in (x, t))
    jst, _ = _jax_dp(PAD, 2, x=x_pad, t=t_pad)
    pad, trim = ranks[2]["pad"][0], ranks[2]["trim"][0]
    assert int(pad["step"]) == int(trim["step"]) == 2
    for k in pad:
        np.testing.assert_array_equal(pad[k], trim[k], err_msg=k)
    _assert_close(pad, jst)


@pytest.mark.parametrize("world,tile", [(2, 32), (4, 32), (2, 16)])
def test_dp_resident_row_tiled_matches_jax(ranks, world, tile):
    jst, _ = _jax_dp(TILED, world, rule="clean", tile_rows=tile)
    port = ranks[world][f"tiled{tile}"][0]
    assert int(port["step"]) == 2  # 2 updates of 64 rows each
    _assert_close(port, jst)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_resident_sr_delta_matches_jax_and_the_single_process_bits(ranks, world):
    jst, _ = _jax_dp(SR, world, sr_delta=True)
    port = ranks[world]["sr_delta"][0]
    assert int(port["step"]) == 2
    for name, got, want in _pairs(port, jst):
        np.testing.assert_allclose(got, want, err_msg=name, **TOL_SR)
    st = _port_single(SR, sr_delta=True)
    assert st.deltas.w[0].dtype == torch.bfloat16
    for name, got, want in _port_pairs(port, st):
        off = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
        assert off.mean() <= 1e-3, f"{name}: {off.mean():.3g} of the elements differ"


@pytest.mark.parametrize("world", [2, 4])
def test_dp_resident_bf16_matches_jax_dp_bf16(ranks, world):
    jst, p0 = _jax_dp(MATCH, world, bf16=True)
    err = _update_err(ranks[world]["bf16"][0], jst, p0)
    assert err <= TOL_UPD, f"bf16=True off the JAX DP kernel by {err:.3g} (tol {TOL_UPD})"
    err32 = _update_err(ranks[world]["match"][0], jst, p0)
    assert err32 >= 10 * TOL_UPD, f"bf16=False only {err32:.3g} off: the tolerance sees no rounding"


def test_dp_resident_replicas_are_bit_equal(ranks):
    for world, cases in ranks.items():
        for name, states in cases.items():
            if name == "no_allreduce":  # each rank applied its own gradient: the replicas part
                assert not np.array_equal(states[0]["w0"], states[1]["w0"])
                continue
            for r in range(1, world):
                for k in states[0]:
                    assert np.array_equal(states[0][k], states[r][k], equal_nan=True), \
                        f"{name} on {world} ranks: rank {r}'s {k} differs from rank 0's"


def test_dp_resident_options_that_change_nothing(ranks):
    """hbm_spill, dedy_full (choices of the TPU kernel's on-chip memory) and
    host-regrouped input (pre_grouped) give the plain run bit for bit."""
    base = ranks[2]["match"][0]
    for name in ("spill", "pre_grouped"):
        for k in base:
            np.testing.assert_array_equal(ranks[2][name][0][k], base[k], err_msg=f"{name} {k}")


def test_dp_resident_dynamic_hyperparameters_match_jax(ranks):
    p, x, t = _data(MATCH)
    mesh = j_make_mesh(n_data=2, n_model=1)
    run = j_make_dp(jm.ModelConfig(layersizes=MATCH["sizes"]), JOpt(**MATCH["opt"]), mesh,
                    interpret=True, bf16=False)
    st = run(j_init(j_replicate(p, mesh)), jnp.asarray(x), jnp.asarray(t), jnp.int32(7),
             momentum=0.5)
    st = run(st, jnp.asarray(x), jnp.asarray(t), jnp.int32(8), momentum=0.9, lrate=0.3)
    _assert_close(ranks[2]["momentum_ramp"][0], st)


def test_dp_resident_validates_as_the_jax_factory():
    cfg, jcfg = tm.ModelConfig(layersizes=(128, 128)), jm.ModelConfig(layersizes=(128, 128))
    bad = [(3, dict(bunchsize=48), {}, "power of two"),
           (2, dict(bunchsize=24), {}, "local bunch"),
           (2, dict(bunchsize=64), dict(rule="parity", tile_rows=32), "clean-rule"),
           (2, dict(bunchsize=64), dict(rule="clean", tile_rows=24), "divide"),
           (2, dict(bunchsize=64), dict(rule="clean", tile_rows=32, sr_delta=True),
            "momentum buffer"),
           (2, dict(bunchsize=64), dict(rule="clean", tile_rows=32, pre_grouped=True),
            "pre_grouped"),
           (2, dict(bunchsize=32), dict(hbm_spill=1, sr_delta=True), "hybrid")]
    for n_dev, opt, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            rc.make_dp_resident_train_chunk(cfg, OptConfig(**opt), Mesh(n_dev, 0, CPU), **kw)
        with pytest.raises(ValueError, match=match):
            j_make_dp(jcfg, JOpt(**opt), j_make_mesh(n_data=n_dev, n_model=1), **kw)


@pytest.mark.parametrize("bf16", [False, True])
def test_one_rank_dp_is_the_single_device_trainer(bf16):
    """On a one-rank mesh (no process group) the sum over the ranks is the
    rank's own gradient: the DP plain version equals the single-device one
    bit for bit, dropout and stochastic rounding included, and a CPU state
    launches no kernel."""
    mesh = make_mesh(devices=["cpu"])
    assert mesh.shape == {"data": 1, "model": 1} and mesh.index == 0
    p, x, t = _data(DROP)
    mlp = tm.params_from_jax({"w": tuple(np.asarray(w) for w in p["w"]),
                              "b": tuple(np.asarray(b) for b in p["b"])}, device="cpu")
    cfg = tm.ModelConfig(layersizes=DROP["sizes"], **DROP["cfg"])
    before = (rc.make_dp_resident_train_chunk.launches, tfm.fused_bwd_grad_out.launches,
              tfm.dp_update.launches, dict(rc.kernel_launches))
    for kw in (dict(), dict(sr_delta=True)):
        a = rc.make_dp_resident_train_chunk(cfg, OptConfig(**DROP["opt"]), mesh, bf16=bf16, **kw)(
            init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t), 5)
        b = rc.make_resident_train_chunk(cfg, OptConfig(**DROP["opt"]), bf16=bf16, **kw)(
            init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t), 5)
        assert a.step == b.step == 2
        for ta, tb in zip(list(a.params.w) + list(a.deltas.w) + list(a.params.b),
                          list(b.params.w) + list(b.deltas.w) + list(b.params.b)):
            assert ta.dtype == tb.dtype and torch.equal(ta, tb)
    assert (rc.make_dp_resident_train_chunk.launches, tfm.fused_bwd_grad_out.launches,
            tfm.dp_update.launches, dict(rc.kernel_launches)) == before


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("deriv", [None, "relu"])
def test_grad_out_and_update_equal_the_jax_fused_backward(bf16, deriv):
    """The two halves the DP trainer splits kernel 2 into (their plain
    versions, what the wrappers run on CPU tensors): the gradient-out
    backward then dp_update with [m, A, B] give the JAX fused_bwd_update's
    W', delta', b', delta_b' and dedy (interpret mode), to 2e-5."""
    B, K, N = 32, 256, 128
    rng = np.random.default_rng(3)
    y = np.abs(rng.standard_normal((B, K))).astype(np.float32) * (rng.random((B, K)) > 0.3)
    dedx = (rng.standard_normal((B, N)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    d = (rng.standard_normal((K, N)) * 1e-3).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) * 0.1
    db = rng.standard_normal(N).astype(np.float32) * 1e-3
    m, lr, wc = 0.6, 0.5, 1e-4
    j = jfm.fused_bwd_update(*(jnp.asarray(a) for a in (dedx, y, w, d, b, db)), m, lr, 1.0 / B,
                             wc, interpret=True, bf16=bf16)
    T = [torch.from_numpy(a.copy()) for a in (dedx, y, w, d, b, db)]
    grad, dedy = tfm.fused_bwd_grad_out(T[0], T[1], T[2], deriv=deriv, bf16=bf16)
    assert grad.shape == (K * N + N,)
    coefs = rc._scal_coefs("parity", B, N, lr, m, wc)
    tfm.dp_update(T[2], T[3], T[4], T[5], grad, *coefs)
    for got, want in ((T[2], j[0]), (T[3], j[1]), (T[4], j[3]), (T[5], j[4])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5 * np.abs(want).max())
    want = np.asarray(j[2]) * ((y > 0) if deriv == "relu" else 1.0)
    np.testing.assert_allclose(dedy.numpy(), want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


def test_dp_update_plain_version_is_one_float32_operation_at_a_time():
    """dp_update_reference computes m*d - (A*g + B*w) in float32 step by step
    (the kernel's order, no fused multiply-add), accumulates without the
    decay when not `first`, leaves W when not `apply`, and rounds a bfloat16
    delta with the stream's bits."""
    rng = np.random.default_rng(0)
    K, N = 24, 13
    w, d, g = (torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)) for _ in range(3))
    b, db, gb = (torch.from_numpy(rng.standard_normal(N).astype(np.float32)) for _ in range(3))
    grad = torch.cat([g.reshape(-1), gb])
    f = np.float32
    m, a, c = f(0.6), f(0.02), f(3e-5)
    w2, d2, b2, db2 = tfm.dp_update_reference(w, d, b, db, grad, m, a, c)
    wn, dn, gn = w.numpy(), d.numpy(), g.numpy()
    nd = (m * dn) - ((a * gn) + (c * wn))
    assert np.array_equal(d2.numpy(), nd) and np.array_equal(w2.numpy(), wn + nd)
    assert np.array_equal(db2.numpy(), (m * db.numpy()) - (a * gb.numpy()))
    w3, d3, b3, _ = tfm.dp_update_reference(w, d, b, db, grad, m, a, c, first=False, apply=False)
    assert torch.equal(w3, w) and torch.equal(b3, b)
    assert np.array_equal(d3.numpy(), dn - (a * gn))
    _, d4, _, _ = tfm.dp_update_reference(w, d.to(torch.bfloat16), b, db, grad, m, a, c,
                                          sr_seed=77)
    assert d4.dtype == torch.bfloat16
    assert (d4.float() - torch.from_numpy(nd)).abs().max() <= torch.from_numpy(nd).abs().max() / 64
    with pytest.raises(ValueError, match="sr_seed"):
        tfm.dp_update(w.clone(), d.to(torch.bfloat16), b.clone(), db.clone(), grad, m, a, c)


def _dp_loop_through_the_tables(cfg, opt, mlp, x, t, seed, n_dev):
    """The card's loop of the data-parallel trainer (ops/resident_chunk.py:
    make_dp_resident_train_chunk) stepped through the wrappers on the CPU,
    every rank in this process: rank d draws its rows of the call's input-mask
    table (input_mask_bits at row0 = d * tile, one draw a call), its layer-0
    forward and gradient-out backward read tile gi's rows of it, each hidden
    layer's mask is drawn at its rows of the global tile, dedx carries
    2/bunch, and the ranks' gradients are summed in rank order before
    dp_update applies them to the one state."""
    sizes, L, n = cfg.layersizes, len(cfg.layersizes) - 1, opt.bunchsize
    tile = n // n_dev
    ws, bs = [w.clone() for w in mlp.w], [b.clone() for b in mlp.b]
    ds, dbs = [torch.zeros_like(w) for w in ws], [torch.zeros_like(b) for b in bs]
    n_b = x.shape[0] // n
    tables = [rc.input_mask_bits(seed, n_b, tile, sizes[0], cfg.dropout_vis, device="cpu",
                                 row0=d * tile) for d in range(n_dev)]
    coef = float(np.float32(2.0) / np.float32(n))
    coefs = rc._scal_coefs("parity", n, sizes[-1], opt.lrate, opt.momentum, opt.weightcost)
    for gi in range(n_b):
        grads = [[None] * L for _ in range(n_dev)]
        for d in range(n_dev):
            rows = slice(gi * n + d * tile, gi * n + (d + 1) * tile)
            ys, h = [], torch.from_numpy(x[rows])
            for l in range(L):
                ys.append(h)
                hid = l < L - 1
                out_mask = (philox_mask(rc.mask_key(seed, gi, l + 1), tile, sizes[l + 1],
                                        cfg.dropout_hid, row0=d * tile) if hid else None)
                h = tfm.fused_linear_act(h, ws[l], bs[l], cfg.hidden if hid else cfg.output,
                                         in_mask=tables[d][gi] if l == 0 else None,
                                         out_mask=out_mask, bf16=False)
            dedx = coef * (h - torch.from_numpy(t[rows]))
            for l in range(L - 1, -1, -1):
                grads[d][l], dedx = tfm.fused_bwd_grad_out(
                    dedx, ys[l], ws[l], in_mask=tables[d][gi] if l == 0 else None,
                    deriv=cfg.hidden if l > 0 else None, with_dedy=l > 0, bf16=False)
        for l in range(L):
            g = grads[0][l].clone()
            for d in range(1, n_dev):
                g += grads[d][l]
            tfm.dp_update(ws[l], ds[l], bs[l], dbs[l], g, *coefs)
    return ws, bs, ds, dbs


@pytest.mark.parametrize("n_dev", [2, 4])
def test_the_card_loop_with_the_ranks_tables_equals_the_single_process_trainer(n_dev):
    """The DP trainer's path on the card, with dropout on, run through the
    layer wrappers' plain versions: each rank's table holds its rows of the
    single-device masks, so the ranks together train the single-process
    trainer's chunk to reduction order (TOL), as the spawned ranks do
    (test_dp_resident_dropout_equals_the_single_process_trainer)."""
    p, x, t = _data(DROP)
    mlp = tm.params_from_jax({"w": tuple(np.asarray(w) for w in p["w"]),
                              "b": tuple(np.asarray(b) for b in p["b"])}, device="cpu")
    cfg = tm.ModelConfig(layersizes=DROP["sizes"], **DROP["cfg"])
    got = _dp_loop_through_the_tables(cfg, OptConfig(**DROP["opt"]), mlp, x, t, DROP["seed"],
                                      n_dev)
    st = _port_single(DROP)
    for name, g_group, s_group in zip(("w", "b", "dw", "db"), got,
                                      (st.params.w, st.params.b, st.deltas.w, st.deltas.b)):
        for l, (g, s) in enumerate(zip(g_group, s_group)):
            np.testing.assert_allclose(g.numpy(), s.numpy(), err_msg=f"{name}{l}", **TOL)
    # a rank that drew its table at row 0 (every rank the same rows) is refused by the hold
    draw = rc.input_mask_bits
    try:
        rc.input_mask_bits = lambda *a, row0=0, **k: draw(*a, row0=0, **k)
        bad = _dp_loop_through_the_tables(cfg, OptConfig(**DROP["opt"]), mlp, x, t,
                                          DROP["seed"], n_dev)
    finally:
        rc.input_mask_bits = draw
    assert not np.allclose(bad[0][0].numpy(), st.params.w[0].numpy(), **TOL)
