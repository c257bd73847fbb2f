"""bf16=True, the JAX kernels' default (tpu_sednn/ops/fused_mlp.py:_dot):
both operands of every product rounded to bfloat16, the products summed in
float32.  The port's plain versions (what its wrappers run on CPU tensors)
against the JAX functions in interpret mode with bf16=True, on the same
numpy-seeded inputs.

Tolerances.  A product of two bfloat16 values is exact in float32, so both
packages multiply the same operands and differ only in the order of their
float32 sums: a single kernel holds to TOL_ONE of the largest value (read:
3e-7).  A multi-layer step or chunk also moves an activation across a
bfloat16 rounding boundary now and then (one ulp, 2^-8 relative, in the
next product's operand), so trainers are held on the update of every state
tensor (W - W0, b - b0, delta_w, delta_b) by relative Frobenius error,
TOL_UPD (read: at most 1.5e-4, a row-tiled chunk).  The tensors of a
stochastic-rounding trainer that no rounding has touched after ONE bunch
hold to TOL_BUNCH (read: at most 5e-7).  Every comparison also runs the same
call with bf16=False and requires that it miss the tolerance by at least
MISS times: float32 products differ from bfloat16 ones by about 2^-9
relative a product (read: 1.3e-3 to 3e-3 for one kernel, 9.7e-4 to 0.07 of
a trainer's update).  The JAX
kernels are called at 128-aligned shapes: their fallback for other shapes
(fused_mlp.py:84-87) is a plain float32 product on the CPU."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
import tpu_sednn.ops.fused_mlp as jfm
import tpu_sednn.ops.train_step as jts
from tpu_sednn.ops.resident_chunk import make_resident_train_chunk as j_make_resident
from tpu_sednn.train.step import OptConfig as JOpt, init_train_state as j_init
import tpu_sednn_torch.model as tm
import tpu_sednn_torch.ops.fused_mlp as tfm
import tpu_sednn_torch.ops.resident_chunk as rc
import tpu_sednn_torch.ops.train_step as tts
from tpu_sednn_torch.model.mlp import mm_operand
from tpu_sednn_torch.ops.philox import philox_mask
from tpu_sednn_torch.train.loop import make_chunk_runner
from tpu_sednn_torch.train.step import OptConfig, init_train_state

TOL_ONE = 1e-5   # max |port - jax| / max |jax| of one kernel's output
TOL_UPD = 3e-4   # relative Frobenius error of a trainer's update, per state tensor
TOL_BUNCH = 2e-5  # the same, one bunch, tensors no stochastic rounding has touched
MISS = 10.0      # bf16=False must miss the tolerance by this factor at least


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _params(sizes, seed=0):
    p = jm.init_params(jax.random.key(seed), jm.ModelConfig(layersizes=sizes), "glorot")
    return p, {"w": tuple(np.asarray(w) for w in p["w"]), "b": tuple(np.asarray(b) for b in p["b"])}


def _inputs(sizes, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, sizes[0])).astype(np.float32),
            rng.standard_normal((n, sizes[-1])).astype(np.float32))


def _update_errors(st, jst, p0, groups=("w", "b", "delta_w", "delta_b")) -> dict:
    """{group: worst relative Frobenius error of the update over the layers}."""
    out = {}
    for grp in groups:
        kind, k = ("deltas", grp[6:]) if grp.startswith("delta") else ("params", grp)
        errs = []
        for l, got in enumerate(getattr(getattr(st, kind), k)):
            want = np.asarray(jst.__getattribute__(kind)[k][l], np.float64)
            start = np.asarray(p0[k][l], np.float64) if kind == "params" else 0.0
            got = got.double().numpy()
            errs.append(float(np.linalg.norm(got - want) / np.linalg.norm(want - start)))
        out[grp] = max(errs)
    return out


def _hold(err_bf16: float, err_f32: float, tol: float, label: str) -> None:
    assert err_bf16 <= tol, f"{label}: bf16=True off by {err_bf16:.3g} (tol {tol})"
    assert err_f32 >= MISS * tol, (f"{label}: bf16=False off by only {err_f32:.3g}: the tolerance "
                                   f"{tol} does not tell the two products apart")


def test_bf16_defaults_equal_jax():
    pairs = [(tfm.fused_linear_act, jfm.fused_linear_act), (tfm.fused_bwd_update, jfm.fused_bwd_update),
             (tts.fused_train_step, jts.pallas_train_step),
             (tts.make_fused_train_chunk, jts.make_pallas_train_chunk),
             (rc.make_resident_train_chunk, j_make_resident)]
    for port, jax_fn in pairs:
        want = inspect.signature(jax_fn).parameters["bf16"].default
        assert want is True
        assert inspect.signature(port).parameters["bf16"].default is want, port.__name__
    assert tts.pallas_train_step is tts.fused_train_step
    for plain in (tfm.fused_linear_act_reference, tfm.fused_bwd_update_reference,
                  rc.resident_train_chunk_reference):
        assert inspect.signature(plain).parameters["bf16"].default is True, plain.__name__


@pytest.mark.parametrize("act", ["linear", "relu", "sigmoid"])
@pytest.mark.parametrize("shape", [(16, 256, 384), (8, 128, 128)])
def test_fused_linear_act_matches_pallas_bf16(act, shape):
    B, K, N = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    want = jfm.fused_linear_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act,
                                block_n=128, interpret=True, bf16=True)
    args = [torch.from_numpy(a) for a in (x, w, b)]
    got = tfm.fused_linear_act(*args, act=act)
    _hold(_rel(got, want), _rel(tfm.fused_linear_act(*args, act=act, bf16=False), want), TOL_ONE,
          f"fused_linear_act {shape} {act}")
    # the float64 plain version is the same function, free of float32 summation order
    assert _rel(tfm.fused_linear_act_reference(*args, act=act, dtype=torch.float64), want) <= TOL_ONE


@pytest.mark.parametrize("shape", [(16, 256, 384), (8, 128, 256)])
def test_fused_bwd_update_matches_pallas_bf16(shape):
    """delta' and dedy carry the products; W' is held on its update W' - W
    (W itself dwarfs it); b' and delta_b' have none and agree either way."""
    B, K, N = shape
    rng = np.random.default_rng(2)
    arrs = dict(dedx=rng.standard_normal((B, N)), yprev=rng.standard_normal((B, K)),
                w=rng.standard_normal((K, N)) * 0.05, delta=rng.standard_normal((K, N)) * 0.01,
                b=rng.standard_normal(N) * 0.1, db=rng.standard_normal(N) * 0.01)
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    hyp = (0.7, 0.4, 1.0 / B, 1e-3)
    want = jfm.fused_bwd_update(*(jnp.asarray(arrs[k]) for k in ("dedx", "yprev", "w", "delta", "b", "db")),
                                *(jnp.float32(h) for h in hyp), block_k=128, block_n=128,
                                interpret=True, bf16=True)

    def errs(bf16):
        t = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
        got = tfm.fused_bwd_update(t["dedx"], t["yprev"], t["w"], t["delta"], t["b"], t["db"], *hyp,
                                   bf16=bf16)
        return [_rel(got[0].numpy() - arrs["w"], np.asarray(want[0]) - arrs["w"])] + \
            [_rel(g, wnt) for g, wnt in zip(got[1:], want[1:])]

    e16, e32 = errs(True), errs(False)
    for name, a, b in zip(("W' - W", "delta'", "dedy"), e16, e32):
        _hold(a, b, TOL_ONE, f"fused_bwd_update {shape} {name}")
    assert max(e16[3:] + e32[3:]) <= TOL_ONE  # b', delta_b': no product


def test_bf16_rounds_the_masked_scaled_operands_and_updates_the_unrounded_w():
    """By hand, in float64: the inverted-dropout input is multiplied by
    1/(1-omit) in float32 and THEN rounded; dedy and G take rounded
    operands; the update's wc*W and W + delta' take the unrounded W."""
    rng = np.random.default_rng(7)
    B, K, N = 16, 40, 24
    x = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.1).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(N) * 0.1).astype(np.float32))
    mask = philox_mask(3, B, K, 0.1)
    r = lambda a: a.float().to(torch.bfloat16).double()  # noqa: E731
    h = x * mask * np.float32(1 / 0.9)  # float32, as the kernel scales it
    want = torch.relu(r(h) @ r(w) + b.double())
    got = tfm.fused_linear_act(x, w, b, "relu", in_mask=(3, 0.1), in_scale=1 / 0.9)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert not torch.allclose(got, torch.relu(r(x * mask) * (1 / 0.9) @ r(w) + b.double()).float(),
                              rtol=1e-6, atol=1e-6)  # rounding before the scale is another function
    dedx = torch.from_numpy((rng.standard_normal((B, N)) * 0.1).astype(np.float32))
    delta = torch.from_numpy((rng.standard_normal((K, N)) * 0.01).astype(np.float32))
    m, lr, wc = 0.6, 0.5, 1e-2
    c = (1 - m) * lr
    w2, d2, dedy, b2, db2 = tfm.fused_bwd_update(dedx, h, w.clone(), delta.clone(), b.clone(),
                                                 torch.zeros(N), m, lr, 1 / B, wc)
    nd = m * delta.double() - c * ((r(h).T @ r(dedx)) / B + wc * w.double())
    for got_, want_ in ((d2, nd), (w2, w.double() + nd), (dedy, r(dedx) @ r(w).T),
                        (db2, -c * dedx.double().sum(0) / B)):
        np.testing.assert_allclose(got_.numpy(), want_.numpy(), rtol=1e-5, atol=1e-7)
    w_r = r(w)  # a fault: the update on the rounded W
    assert not torch.allclose(w2.double(), w_r + m * delta.double()
                              - c * ((r(h).T @ r(dedx)) / B + wc * w_r), rtol=1e-5, atol=1e-7)
    assert torch.equal(mm_operand(h, True), r(h).float())


@pytest.mark.parametrize("hidden,output", [("relu", "linear"), ("sigmoid", "sigmoid")])
def test_fused_step_matches_pallas_step_bf16(hidden, output):
    sizes = (128, 256, 256, 128)
    jcfg = jm.ModelConfig(layersizes=sizes, hidden=hidden, output=output)
    tcfg = tm.ModelConfig(layersizes=sizes, hidden=hidden, output=output)
    opt = dict(lrate=0.5, momentum=0.6, weightcost=1e-4, bunchsize=16)
    p, pn = _params(sizes)
    x, t = _inputs(sizes, 16, 3)
    jst = jts.pallas_train_step(j_init(p), jnp.asarray(x), jnp.asarray(t), jcfg, JOpt(**opt),
                                interpret=True, bf16=True)

    def err(bf16):
        st = tts.pallas_train_step(init_train_state(tm.params_from_jax(pn, device="cpu")),
                                   torch.from_numpy(x), torch.from_numpy(t), tcfg, OptConfig(**opt),
                                   bf16=bf16)
        return max(_update_errors(st, jst, pn).values())

    _hold(err(True), err(False), TOL_UPD, f"fused_train_step {hidden}/{output}")


@pytest.mark.parametrize("hidden,output", [("relu", "linear"), ("sigmoid", "linear"),
                                           ("relu", "sigmoid")])
def test_fused_chunk_matches_pallas_chunk_bf16(hidden, output):
    sizes = (132, 256, 60)  # the JAX chunk pads to 128-multiples, so its kernels run
    jcfg = jm.ModelConfig(layersizes=sizes, hidden=hidden, output=output)
    tcfg = tm.ModelConfig(layersizes=sizes, hidden=hidden, output=output)
    opt = dict(lrate=0.5, momentum=0.5, weightcost=0.0, bunchsize=16)
    p, pn = _params(sizes)
    x, t = _inputs(sizes, 52, 4)
    jst = jts.make_pallas_train_chunk(jcfg, JOpt(**opt), interpret=True, bf16=True)(
        j_init(p), jnp.asarray(x), jnp.asarray(t), jax.random.key(1))

    def err(bf16):
        st = tts.make_pallas_train_chunk(tcfg, OptConfig(**opt), bf16=bf16)(
            init_train_state(tm.params_from_jax(pn, device="cpu")), torch.from_numpy(x),
            torch.from_numpy(t), None)
        assert st.step == int(jst.step) == 3
        return max(_update_errors(st, jst, pn).values())

    _hold(err(True), err(False), TOL_UPD, f"make_fused_train_chunk {hidden}/{output}")


def _resident_pair(sizes, opt, jkw, tkw, n=52, seed=4, hidden="relu", output="linear",
                   jax_seed=7):
    """-> (JAX state, port runner factory(bf16), initial numpy params, x, t)."""
    kw = dict(layersizes=sizes, hidden=hidden, output=output)
    p, pn = _params(sizes)
    x, t = _inputs(sizes, n, seed)
    jst = j_make_resident(jm.ModelConfig(**kw), JOpt(**opt), interpret=True, bf16=True, **jkw)(
        j_init(p), jnp.asarray(x), jnp.asarray(t), jnp.int32(jax_seed))

    def run(bf16, **more):
        return rc.make_resident_train_chunk(tm.ModelConfig(**kw), OptConfig(**opt), bf16=bf16,
                                            **tkw, **more)(
            init_train_state(tm.params_from_jax(pn, device="cpu")), torch.from_numpy(x),
            torch.from_numpy(t), jax_seed)

    return jst, run, pn


@pytest.mark.parametrize("rule", ["parity", "clean"])
@pytest.mark.parametrize("hidden,output,sizes", [
    ("relu", "linear", (128, 256, 256, 128)),
    ("sigmoid", "sigmoid", (128, 256, 256, 128)),
    ("relu", "linear", (132, 256, 60)),   # ragged: the JAX kernel pads inside, the port does not
    ("sigmoid", "linear", (132, 256, 60)),
    ("relu", "sigmoid", (132, 256, 60)),
])
def test_resident_matches_jax_resident_kernel_bf16(rule, hidden, output, sizes):
    opt = dict(lrate=0.5, momentum=0.6, weightcost=1e-4, bunchsize=16)
    jst, run, pn = _resident_pair(sizes, opt, dict(rule=rule), dict(rule=rule), hidden=hidden,
                                  output=output)
    st = run(True)
    assert st.step == 3
    _hold(max(_update_errors(st, jst, pn).values()), max(_update_errors(run(False), jst, pn).values()),
          TOL_UPD, f"resident {rule} {hidden}/{output} {sizes}")


@pytest.mark.parametrize("sizes,spill,hidden,output", [((128, 128, 72), 1, "relu", "linear"),
                                                       ((128, 256, 128, 64), 2, "relu", "sigmoid")])
def test_resident_hbm_spill_bf16_equals_the_unspilled_run_and_jax(sizes, spill, hidden, output):
    opt = dict(lrate=0.2, momentum=0.7, weightcost=1e-3, bunchsize=32)
    jst, run, pn = _resident_pair(sizes, opt, dict(hbm_spill=spill), {}, n=96, seed=11,
                                  hidden=hidden, output=output, jax_seed=3)
    sp, full = run(True, hbm_spill=spill), run(True)
    for a, b in zip(list(sp.params.w) + list(sp.params.b) + list(sp.deltas.w) + list(sp.deltas.b),
                    list(full.params.w) + list(full.params.b) + list(full.deltas.w)
                    + list(full.deltas.b)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    _hold(max(_update_errors(sp, jst, pn).values()),
          max(_update_errors(run(False, hbm_spill=spill), jst, pn).values()), TOL_UPD,
          f"hbm_spill={spill} {sizes}")


@pytest.mark.parametrize("tile", [16, 32])
def test_resident_tile_rows_bf16_match_jax_row_tiles(tile):
    sizes = (128, 128, 128)
    opt = dict(lrate=0.2, momentum=0.7, weightcost=1e-3, bunchsize=64)
    kw = dict(rule="clean", tile_rows=tile)
    jst, run, pn = _resident_pair(sizes, opt, kw, kw, n=128 + 24, seed=9, jax_seed=0)
    st = run(True)
    assert st.step == 2
    _hold(max(_update_errors(st, jst, pn).values()), max(_update_errors(run(False), jst, pn).values()),
          TOL_UPD, f"tile_rows {tile}")


def _noise_band(st, jst, tol, flips):
    """tests/test_torch_resident_variants.py:_close: every element of W and b
    within `tol`, but for a share `flips` of a tensor's elements (ReLU flips
    under bfloat16 rounding noise), none further than 2 x atol."""
    for k in ("w", "b"):
        for got, want in zip(getattr(st.params, k), jst.params[k]):
            got, want = got.float().numpy(), np.asarray(want, np.float32)
            off = np.abs(got - want) - (tol["atol"] + tol["rtol"] * np.abs(want))
            assert (off > 0).mean() <= flips and off.max() <= 2 * tol["atol"]


@pytest.mark.parametrize("rule", ["parity", "clean"])
@pytest.mark.parametrize("hidden", ["relu", "sigmoid"])
@pytest.mark.parametrize("mode,tol,exact", [
    ("sr_delta", dict(rtol=2e-2, atol=2e-4), ("w", "b", "delta_b")),
    ("sr_state", dict(rtol=3e-2, atol=3e-3), ("b", "delta_b")),
])
def test_sr_variants_bf16_against_jax(rule, hidden, mode, tol, exact):
    """After ONE bunch the tensors no stochastic rounding has touched yet (W,
    b, delta_b under sr_delta, whose W takes the unrounded step; b and
    delta_b under sr_state) are the float32-state trainer's, and held to
    TOL_BUNCH against the JAX kernel with bf16=True; bf16=False misses.  After
    three bunches W and b are held in the bfloat16 noise band of
    tests/test_torch_resident_variants.py against the JAX kernel with bf16=True,
    float32 state and the same variant: the two packages round with other
    random bits."""
    sizes = (128, 128, 128)
    opt = dict(lrate=0.3, momentum=0.6, weightcost=1e-4, bunchsize=16)
    flips = 5e-3 if hidden == "relu" else 0.0
    one_j, one_run, pn = _resident_pair(sizes, opt, dict(rule=rule, **{mode: True}),
                                        dict(rule=rule, **{mode: True}), n=16, seed=12,
                                        hidden=hidden, jax_seed=3)
    _hold(max(_update_errors(one_run(True), one_j, pn, exact).values()),
          max(_update_errors(one_run(False), one_j, pn, exact).values()), TOL_BUNCH,
          f"{mode} {rule} {hidden}, one bunch, {exact}")
    j_f32, _, _ = _resident_pair(sizes, opt, dict(rule=rule), {}, n=48, seed=12, hidden=hidden,
                                 jax_seed=3)
    j_sr, run, _ = _resident_pair(sizes, opt, dict(rule=rule, **{mode: True}),
                                  dict(rule=rule, **{mode: True}), n=48, seed=12, hidden=hidden,
                                  jax_seed=3)
    st = run(True)
    assert st.step == 3 and st.deltas.w[0].dtype == torch.bfloat16
    _noise_band(st, j_f32, tol, flips)
    _noise_band(st, j_sr, tol, flips)


def test_chunk_runner_passes_bf16_and_auto_stays_plain_on_the_cpu():
    sizes = (32, 64, 16)
    cfg = tm.ModelConfig(layersizes=sizes)
    opt = OptConfig(lrate=0.1, momentum=0.5, weightcost=0.0, bunchsize=16)
    _, pn = _params(sizes)
    x, t = (torch.from_numpy(a) for a in _inputs(sizes, 32, 8))
    hyp = (opt.lrate, opt.momentum, opt.weightcost)
    runs = {bf16: make_chunk_runner(cfg, opt, "resident", device="cpu", bf16=bf16)
            for bf16 in (True, False)}
    assert make_chunk_runner(cfg, opt, "resident", device="cpu") is not runs[False]
    st = {bf16: run(init_train_state(tm.params_from_jax(pn, device="cpu")), x, t,
                    torch.Generator().manual_seed(0), *hyp) for bf16, run in runs.items()}
    default = make_chunk_runner(cfg, opt, "resident", device="cpu")(
        init_train_state(tm.params_from_jax(pn, device="cpu")), x, t,
        torch.Generator().manual_seed(0), *hyp)
    assert torch.equal(default.params.w[0], st[True].params.w[0])  # the factory's default: bf16
    assert not torch.equal(st[True].params.w[0], st[False].params.w[0])
    assert make_chunk_runner(cfg, opt, "auto", device="cpu") is make_chunk_runner(cfg, opt, "xla",
                                                                                  device="cpu")


# The tensor-core backward's decomposition (csrc/fused_mlp.cuh:stripe_bwd_kernel<true>),
# emulated in float32: N in chunks of TC_BWD_BN columns, split into `split`
# ranges of whole chunks (the blocks of a cluster); G's chunk summed over the
# rows in two chains, the even and the odd 16-row steps of every 128 rows,
# added at the end; each range's dedy summed over its chunks in order; the
# ranges' partials summed in rank order; then the derivative; gb summed row by
# row.  The kernel may pick any split from 1 to 8 (bwd_split: the card's
# occupancy), so every one is held.
TC_BWD_BN = 64
TC_BWD_SPLITS = (1, 2, 3, 4, 5, 8)


def _tc_bwd_emulation(dedx, y_prev, w, split, deriv=None):
    """-> (G, gb, dedy) as the kernel sums them, float32."""
    r = lambda a: a.float().to(torch.bfloat16).float()  # noqa: E731
    dx, yr, wr = r(dedx), r(y_prev), r(w)
    (M, N), K = dedx.shape, y_prev.shape[1]
    n_chunks = -(-N // TC_BWD_BN)
    per = -(-n_chunks // split)
    chains = [[m0 for m0 in range(0, M, 16) if (m0 % 128) // 16 % 2 == p] for p in (0, 1)]
    g = torch.zeros(K, N)
    parts = []
    for rank in range(split):
        part = torch.zeros(M, K)
        for c in range(rank * per, min(n_chunks, (rank + 1) * per)):
            cols = slice(c * TC_BWD_BN, min(N, (c + 1) * TC_BWD_BN))
            acc = [torch.zeros(K, cols.stop - cols.start) for _ in chains]
            for a, rows in zip(acc, chains):
                for m0 in rows:
                    a += yr[m0:m0 + 16].T @ dx[m0:m0 + 16, cols]
            g[:, cols] = acc[0] + acc[1]
            part = part + dx[:, cols] @ wr[:, cols].T
        parts.append(part)
    dedy = torch.zeros(M, K)
    for part in parts:
        dedy = dedy + part
    if deriv == "relu":
        dedy = torch.where(y_prev > 0, dedy, torch.zeros(()))
    elif deriv == "sigmoid":
        dedy = y_prev * (1.0 - y_prev) * dedy
    gb = torch.zeros(N)
    for m in range(M):
        gb = gb + dedx[m]
    return g, gb, dedy


@pytest.fixture(scope="module")
def _bwd_jax_cases():
    """The inputs and JAX outputs of test_fused_bwd_update_matches_pallas_bf16's
    shapes, computed once for every split."""
    cases = {}
    for B, K, N in [(16, 256, 384), (8, 128, 256)]:
        rng = np.random.default_rng(2)
        arrs = dict(dedx=rng.standard_normal((B, N)), yprev=rng.standard_normal((B, K)),
                    w=rng.standard_normal((K, N)) * 0.05, delta=rng.standard_normal((K, N)) * 0.01,
                    b=rng.standard_normal(N) * 0.1, db=rng.standard_normal(N) * 0.01)
        arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
        hyp = (0.7, 0.4, 1.0 / B, 1e-3)
        want = jfm.fused_bwd_update(
            *(jnp.asarray(arrs[k]) for k in ("dedx", "yprev", "w", "delta", "b", "db")),
            *(jnp.float32(h) for h in hyp), block_k=128, block_n=128, interpret=True, bf16=True)
        cases[(B, K, N)] = (arrs, hyp, [np.asarray(a) for a in want])
    return cases


@pytest.mark.parametrize("split", TC_BWD_SPLITS)
@pytest.mark.parametrize("shape", [(16, 256, 384), (8, 128, 256)])
def test_tc_bwd_sum_order_matches_pallas_bf16(_bwd_jax_cases, shape, split):
    """The kernel's order of sums, with its update arithmetic (A = c/n, Bc =
    c*wc, one float32 operation at a time), against the JAX kernel."""
    arrs, (m, lr, inv_n, wc), want = _bwd_jax_cases[shape]
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    g, gb, dedy = _tc_bwd_emulation(t["dedx"], t["yprev"], t["w"], split)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    c = (1.0 - m) * lr
    a_c, b_c, mom = f32(c * inv_n), f32(c * wc), f32(m)
    nd = mom * t["delta"] - (a_c * g + b_c * t["w"])
    ndb = mom * t["db"] - a_c * gb
    got = (t["w"] + nd, nd, dedy, t["b"] + ndb, ndb)
    errs = [_rel(got[0].numpy() - arrs["w"], want[0] - arrs["w"])]
    errs += [_rel(a.numpy(), b) for a, b in zip(got[1:], want[1:])]
    assert max(errs) <= TOL_ONE, f"split {split} {shape}: {errs}"


@pytest.mark.parametrize("split", (1, 4, 8))
@pytest.mark.parametrize("M,K,N,deriv", [(128, 2048, 2048, "relu"), (136, 1548, 129, "sigmoid")])
def test_tc_bwd_sum_order_matches_float64_plain(M, K, N, deriv, split):
    """One full 2048-wide layer (and a ragged one, rows past 128): the
    emulation against the port's float64 plain version of the same rounded
    operands; the float32-product function misses it."""
    rng = np.random.default_rng(5)
    dedx = torch.from_numpy((rng.standard_normal((M, N)) * 0.02).astype(np.float32))
    y_prev = torch.from_numpy(np.maximum(rng.standard_normal((M, K)), 0).astype(np.float32))
    if deriv == "sigmoid":
        y_prev = torch.sigmoid(y_prev)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.03).astype(np.float32))
    grad, dy = tfm.fused_bwd_grad_out_reference(dedx, y_prev, w, deriv=deriv, dtype=torch.float64)
    g, gb, dedy = _tc_bwd_emulation(dedx, y_prev, w, split, deriv)
    for name, got, want in (("G", g.reshape(-1), grad[:K * N]), ("gb", gb, grad[K * N:]),
                            ("dedy", dedy, dy)):
        assert _rel(got.numpy(), want.numpy()) <= TOL_ONE, name
    _, dy32 = tfm.fused_bwd_grad_out_reference(dedx, y_prev, w, deriv=deriv, bf16=False)
    assert _rel(dy32.numpy(), dy.numpy()) >= MISS * TOL_ONE
