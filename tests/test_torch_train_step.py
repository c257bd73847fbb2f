"""Port's plain train / CV steps against the numpy oracle tests/ref_numpy.py
and tpu_sednn.train.step on the same numpy-seeded inputs.  Tolerance rtol 2e-5
/ atol 2e-6 (the JAX package's own for these comparisons: float32 sums in
another order); the rand48 parity init is bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ref_numpy
import tpu_sednn.model as jm
import tpu_sednn.train.step as jstep
from tpu_sednn.data.rand48 import Rand48 as JRand48
import tpu_sednn_torch.model as tm
import tpu_sednn_torch.train.step as tstep
from tpu_sednn_torch.data.rand48 import Rand48
from tpu_sednn_torch.model.convert import train_state_from_jax, train_state_to_numpy

SIZES = (39, 64, 64, 13)
TOL = dict(rtol=2e-5, atol=2e-6)


def _setup(hidden="relu", output="linear", dropout=(0.0, 0.0), mode="parity", n=16, seed=0):
    kw = dict(layersizes=SIZES, hidden=hidden, output=output, dropout_vis=dropout[0],
              dropout_hid=dropout[1], dropout_mode=mode)
    jcfg, tcfg = jm.ModelConfig(precision="highest", **kw), tm.ModelConfig(**kw)
    rng = np.random.default_rng(seed)
    p = jm.init_params(jax.random.key(seed), jcfg, "glorot")
    params = {"w": tuple(np.asarray(w) for w in p["w"]),
              "b": tuple(rng.standard_normal(b.shape).astype(np.float32) * 0.1 for b in p["b"])}
    deltas = {k: tuple(rng.standard_normal(a.shape).astype(np.float32) * 0.01 for a in v)
              for k, v in params.items()}
    x = rng.standard_normal((n, SIZES[0])).astype(np.float32)
    t = rng.standard_normal((n, SIZES[-1])).astype(np.float32)
    masks = [(rng.random((n, SIZES[l])) >= (dropout[0] if l == 0 else dropout[1])).astype(np.float32)
             for l in range(3)]
    return jcfg, tcfg, params, deltas, x, t, masks


def _jstate(params, deltas, step=3):
    return jstep.TrainState(params=jax.tree.map(jnp.asarray, params),
                            deltas=jax.tree.map(jnp.asarray, deltas), step=jnp.int32(step))


def _assert_state(tstate, want_params, want_deltas, want_step, tol=TOL):
    p, d, step = train_state_to_numpy(tstate)
    assert step == int(want_step)
    for k in ("w", "b"):
        for a, b in zip(p[k], want_params[k]):
            np.testing.assert_allclose(a, np.asarray(b), **tol)
        for a, b in zip(d[k], want_deltas[k]):
            np.testing.assert_allclose(a, np.asarray(b), **tol)


@pytest.mark.parametrize("hidden", ["relu", "sigmoid"])
@pytest.mark.parametrize("dropout", [(0.0, 0.0), (0.1, 0.2)])
def test_reference_step_matches_numpy_oracle_and_jax(hidden, dropout):
    jcfg, tcfg, params, deltas, x, t, masks = _setup(hidden=hidden, dropout=dropout)
    use = masks if dropout[0] > 0 else None
    opt = dict(lrate=0.5, momentum=0.6, weightcost=1e-4, bunchsize=16)
    st0 = train_state_from_jax(params, deltas, 3, device="cpu")
    st = tstep.reference_train_step(st0, torch.from_numpy(x), torch.from_numpy(t), tcfg,
                                    tstep.OptConfig(**opt),
                                    dropout_masks=[torch.from_numpy(m) for m in use] if use else None)
    ws, bs, dws, dbs = ref_numpy.train_bunch(
        list(params["w"]), list(params["b"]), list(deltas["w"]), list(deltas["b"]), x, t,
        0.5, 0.6, 1e-4, hidden=hidden, masks=use)
    _assert_state(st, {"w": ws, "b": bs}, {"w": dws, "b": dbs}, 4)
    jst = jstep.reference_train_step(_jstate(params, deltas), jnp.asarray(x), jnp.asarray(t), jcfg,
                                     jstep.OptConfig(**opt),
                                     dropout_masks=[jnp.asarray(m) for m in use] if use else None)
    _assert_state(st, jst.params, jst.deltas, jst.step)
    # a single step is functional: the input state is untouched
    _assert_state(st0, params, deltas, 3, tol=dict(rtol=0, atol=0))


def test_reference_step_sigmoid_head_and_inverted_dropout_match_jax():
    jcfg, tcfg, params, deltas, x, t, masks = _setup(output="sigmoid", dropout=(0.1, 0.2),
                                                     mode="inverted")
    opt = dict(lrate=0.3, momentum=0.5, weightcost=0.0, bunchsize=16)
    st = tstep.reference_train_step(train_state_from_jax(params, deltas, 0, device="cpu"),
                                    torch.from_numpy(x), torch.from_numpy(t), tcfg,
                                    tstep.OptConfig(**opt),
                                    dropout_masks=[torch.from_numpy(m) for m in masks])
    jst = jstep.reference_train_step(_jstate(params, deltas, 0), jnp.asarray(x), jnp.asarray(t),
                                     jcfg, jstep.OptConfig(**opt),
                                     dropout_masks=[jnp.asarray(m) for m in masks])
    _assert_state(st, jst.params, jst.deltas, 1)


@pytest.mark.parametrize("n", [48, 52, 8])  # whole bunches; a partial bunch dropped; none at all
def test_reference_chunk_matches_jax(n):
    jcfg, tcfg, params, deltas, x, t, _ = _setup(n=n, seed=1)
    opt = dict(lrate=0.5, momentum=0.6, weightcost=1e-4, bunchsize=16)
    st = tstep.reference_train_chunk(train_state_from_jax(params, deltas, 0, device="cpu"),
                                     torch.from_numpy(x), torch.from_numpy(t), tcfg,
                                     tstep.OptConfig(**opt))
    jst = jstep.make_jit_train_chunk(jcfg, jstep.OptConfig(**opt))(
        _jstate(params, deltas, 0), jnp.asarray(x), jnp.asarray(t), jax.random.key(1))
    _assert_state(st, jst.params, jst.deltas, n // 16)


def test_chunk_runner_is_in_place_and_takes_new_hyperparameters():
    jcfg, tcfg, params, deltas, x, t, _ = _setup(n=32, seed=2)
    opt = tstep.OptConfig(lrate=0.5, momentum=0.5, weightcost=0.0, bunchsize=16)
    run = tstep.make_jit_train_chunk(tcfg, opt)
    jrun = jstep.make_jit_train_chunk(jcfg, jstep.OptConfig(lrate=0.5, momentum=0.5, bunchsize=16))
    for mom in (0.5, 0.9):
        st0 = train_state_from_jax(params, deltas, 0, device="cpu")
        st = run(st0, torch.from_numpy(x), torch.from_numpy(t), None, momentum=mom)
        assert st is st0  # chunk trainers write into the state they are given
        jst = jrun(_jstate(params, deltas, 0), jnp.asarray(x), jnp.asarray(t), jax.random.key(0),
                   momentum=mom)
        _assert_state(st, jst.params, jst.deltas, 2)


def test_chunk_with_generator_dropout_trains_and_is_seeded():
    _, tcfg, params, deltas, x, t, _ = _setup(n=32, dropout=(0.1, 0.2))
    opt = tstep.OptConfig(lrate=0.2, bunchsize=16)
    outs = []
    for seed in (5, 5, 6):
        st = tstep.reference_train_chunk(train_state_from_jax(params, deltas, 0, device="cpu"),
                                         torch.from_numpy(x), torch.from_numpy(t), tcfg, opt,
                                         generator=torch.Generator().manual_seed(seed))
        outs.append(st.params.w[0].clone())
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="generator or explicit masks"):
        tstep.reference_train_step(train_state_from_jax(params, deltas, 0, device="cpu"),
                                   torch.from_numpy(x[:16]), torch.from_numpy(t[:16]), tcfg, opt)


@pytest.mark.parametrize("hidden,output", [("relu", "linear"), ("sigmoid", "sigmoid")])
def test_clean_step_matches_jax(hidden, output):
    jcfg, tcfg, params, deltas, x, t, _ = _setup(hidden=hidden, output=output, seed=3)
    opt = dict(lrate=0.2, momentum=0.7, weightcost=1e-3, bunchsize=16)
    st, loss = tstep.clean_train_step(train_state_from_jax(params, deltas, 0, device="cpu"),
                                      torch.from_numpy(x), torch.from_numpy(t), tcfg,
                                      tstep.OptConfig(**opt), compute_dtype=None)
    jst, jloss = jstep.clean_train_step(_jstate(params, deltas, 0), jnp.asarray(x), jnp.asarray(t),
                                        jcfg, jstep.OptConfig(**opt), compute_dtype=None)
    _assert_state(st, jst.params, jst.deltas, 1)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_float64_gradient_stays_within_float32_rounding():
    _, tcfg, params, deltas, x, t, _ = _setup(seed=4)
    opt = tstep.OptConfig(lrate=0.5, momentum=0.6, weightcost=1e-4, bunchsize=16)
    args = (torch.from_numpy(x), torch.from_numpy(t), tcfg, opt)
    a = tstep.reference_train_step(train_state_from_jax(params, deltas, 0, device="cpu"), *args)
    b = tstep.reference_train_step(train_state_from_jax(params, deltas, 0, device="cpu"), *args,
                                   dtype=torch.float64)
    assert b.params.w[0].dtype == torch.float32
    _assert_state(a, *train_state_to_numpy(b)[:2], 1)


@pytest.mark.parametrize("dropout", [(0.0, 0.0), (0.1, 0.2)])
def test_cv_functions_match_jax(dropout):
    jcfg, tcfg, params, _, x, t, _ = _setup(dropout=dropout, n=24, seed=5)
    mlp = tm.params_from_jax(params, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    want = float(jstep.cv_squared_error(jp, jnp.asarray(x), jnp.asarray(t), jcfg))
    np.testing.assert_allclose(float(tstep.cv_squared_error(mlp, xt, tt, tcfg)), want, rtol=1e-5)
    out, se = tstep.cv_forward_and_sqerr(mlp, xt, tt, tcfg)
    jout, jse = jstep.cv_forward_and_sqerr(jp, jnp.asarray(x), jnp.asarray(t), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(se), float(jse), rtol=1e-5)
    # capacity-padded chunk: garbage rows past n_valid are masked out
    xp = np.concatenate([x, np.full((8, SIZES[0]), 1e3, np.float32)])
    tp = np.concatenate([t, np.zeros((8, SIZES[-1]), np.float32)])
    got = float(tstep.cv_squared_error_masked(mlp, torch.from_numpy(xp), torch.from_numpy(tp), 24,
                                              tcfg))
    jgot = float(jstep.cv_squared_error_masked(jp, jnp.asarray(xp), jnp.asarray(tp), jnp.int32(24),
                                               jcfg))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, jgot, rtol=1e-5)


def test_init_params_parity_bit_exact_and_stream_continues():
    jcfg, tcfg = jm.ModelConfig(layersizes=SIZES), tm.ModelConfig(layersizes=SIZES)
    ra, rb = Rand48(27863875), JRand48(27863875)
    mlp = tm.init_params_parity(ra, tcfg, -0.1, 0.1, -0.02, 0.03, device="cpu")
    jp = jm.init_params_parity(rb, jcfg, -0.1, 0.1, -0.02, 0.03)
    for a, b in zip(list(mlp.w) + list(mlp.b), list(jp["w"]) + list(jp["b"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert mlp.layersizes == SIZES
    assert ra.x == rb.x  # the shuffles that follow see the same stream


@pytest.mark.parametrize("mode", ["parity", "inverted"])
def test_train_forward_with_masks_matches_jax(mode):
    jcfg, tcfg, params, _, x, _, masks = _setup(dropout=(0.1, 0.2), mode=mode, seed=6)
    got = tm.forward(tm.params_from_jax(params, device="cpu"), torch.from_numpy(x), tcfg, train=True,
                     dropout_masks=[torch.from_numpy(m) for m in masks])
    want = jm.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg, train=True,
                      dropout_masks=[jnp.asarray(m) for m in masks])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # train=False is the eval forward; generator masks have the right rate
    mlp = tm.params_from_jax(params, device="cpu")
    assert torch.equal(tm.forward(mlp, torch.from_numpy(x), tcfg), tm.forward_eval(mlp, torch.from_numpy(x), tcfg))
    from tpu_sednn_torch.model.mlp import _dropout_mask

    m = _dropout_mask(torch.Generator().manual_seed(0), (400, 500), 0.2, torch.device("cpu"))
    assert set(m.unique().tolist()) == {0.0, 1.0} and abs(1 - float(m.mean()) - 0.2) < 0.01


def test_train_state_conversion_round_trip_and_init_copies():
    _, _, params, deltas, _, _, _ = _setup(seed=7)
    st = train_state_from_jax(params, deltas, 5, device="cpu")
    p, d, step = train_state_to_numpy(st)
    assert step == 5
    for k in ("w", "b"):
        for a, b in zip(p[k] + d[k], params[k] + deltas[k]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    mlp = tm.params_from_jax(params, device="cpu")
    st2 = tstep.init_train_state(mlp)
    assert st2.step == 0 and not any(bool(dl.any()) for dl in list(st2.deltas.w) + list(st2.deltas.b))
    st2.params.w[0].data.add_(1.0)  # the state owns a copy: the caller's MLP is untouched
    np.testing.assert_array_equal(mlp.w[0].numpy(), params["w"][0])


@pytest.mark.parametrize("one_hot", [False, True])
def test_softmax_xent_step_matches_jax(one_hot):
    kw = dict(layersizes=(16, 32, 4), output="softmax")
    jcfg, tcfg = jm.ModelConfig(precision="highest", **kw), tm.ModelConfig(**kw)
    rng = np.random.default_rng(0)
    p = jm.init_params(jax.random.key(0), jcfg, "glorot")
    params = jax.tree.map(np.asarray, p)
    deltas = {k: tuple(rng.standard_normal(a.shape).astype(np.float32) * 0.01 for a in v)
              for k, v in params.items()}
    labels = rng.integers(0, 4, 64).astype(np.int32)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[labels] if one_hot else labels
    opt = dict(lrate=0.5, momentum=0.5, weightcost=1e-3, bunchsize=64)
    jst, jloss = jstep.softmax_xent_train_step(_jstate(params, deltas), jnp.asarray(x),
                                               jnp.asarray(y), jcfg, jstep.OptConfig(**opt),
                                               compute_dtype=None)
    st0 = train_state_from_jax(params, deltas, 3, device="cpu")
    st, loss = tstep.softmax_xent_train_step(st0, torch.from_numpy(x), torch.from_numpy(y), tcfg,
                                             tstep.OptConfig(**opt), compute_dtype=None)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _assert_state(st, jst.params, jst.deltas, 4)
    assert st0.step == 3  # a single step leaves its input untouched
    probs = tm.forward_eval(st.params, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(probs.sum(dim=-1).numpy(), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="softmax"):
        tstep.softmax_xent_train_step(st0, torch.from_numpy(x), torch.from_numpy(y),
                                      tm.ModelConfig(layersizes=(16, 32, 4)), tstep.OptConfig(**opt))


def test_softmax_head_trains():
    sizes = (16, 32, 4)
    cfg = tm.ModelConfig(layersizes=sizes, output="softmax")
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((4, sizes[0])).astype(np.float32) * 2
    labels = rng.integers(0, 4, 256)
    x = torch.from_numpy((centers[labels] + rng.standard_normal((256, sizes[0])) * 0.3)
                         .astype(np.float32))
    y = torch.from_numpy(labels)
    state = tstep.init_train_state(tm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"))
    opt = tstep.OptConfig(lrate=0.5, momentum=0.5, weightcost=0.0, bunchsize=256)
    losses = []
    for _ in range(30):
        state, loss = tstep.softmax_xent_train_step(state, x, y, cfg, opt, compute_dtype=None)
        losses.append(float(loss))
    assert losses[-1] < 0.3 * losses[0], losses[::10]
    acc = float((tm.forward_eval(state.params, x, cfg).argmax(-1) == y).float().mean())
    assert acc > 0.9, acc


def test_clean_step_with_bf16_products_matches_jax():
    """compute_dtype=bfloat16 in both packages: operands and cotangents pass
    through bfloat16 roundings at the same places, the sums are float32.  A
    float32 sum in another order can land on the other side of a bfloat16
    rounding boundary, one bfloat16 ulp (2^-8 relative) on that gradient
    element: rtol 8e-3 on the update, atol 1e-6."""
    jcfg, tcfg, params, deltas, x, t, _ = _setup(mode="inverted", n=32)
    opt = dict(lrate=0.1, momentum=0.9, weightcost=1e-4, bunchsize=32)
    jst, jloss = jstep.clean_train_step(_jstate(params, deltas), jnp.asarray(x), jnp.asarray(t),
                                        jcfg, jstep.OptConfig(**opt), compute_dtype=jnp.bfloat16)
    st, loss = tstep.clean_train_step(train_state_from_jax(params, deltas, 3, device="cpu"),
                                      torch.from_numpy(x), torch.from_numpy(t), tcfg,
                                      tstep.OptConfig(**opt), compute_dtype=torch.bfloat16)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    _assert_state(st, jst.params, jst.deltas, 4, tol=dict(rtol=8e-3, atol=1e-6))
    st32, _ = tstep.clean_train_step(train_state_from_jax(params, deltas, 3, device="cpu"),
                                     torch.from_numpy(x), torch.from_numpy(t), tcfg,
                                     tstep.OptConfig(**opt), compute_dtype=None)
    assert not torch.allclose(st.deltas.w[0], st32.deltas.w[0], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("step", ["clean", "softmax_xent"])
def test_steps_called_with_their_defaults_match_jax_defaults(step):
    """Neither package told its products: both default to bfloat16 operands
    with float32 sums, so a call with the defaults is the same function.
    Held as test_clean_step_with_bf16_products_matches_jax (rtol 8e-3 on the
    update, atol 1e-6; the loss 1e-4), and apart from the float32 step."""
    if step == "clean":
        jcfg, tcfg, params, deltas, x, t, _ = _setup(mode="inverted", n=32)
        y = t
    else:
        kw = dict(layersizes=(16, 32, 4), output="softmax")
        jcfg, tcfg = jm.ModelConfig(precision="highest", **kw), tm.ModelConfig(**kw)
        rng = np.random.default_rng(5)
        params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(5), jcfg, "glorot"))
        deltas = {k: tuple(rng.standard_normal(a.shape).astype(np.float32) * 0.01 for a in v)
                  for k, v in params.items()}
        x = rng.standard_normal((64, 16)).astype(np.float32)
        y = rng.integers(0, 4, 64).astype(np.int32)
    opt = dict(lrate=0.1, momentum=0.9, weightcost=1e-4, bunchsize=x.shape[0])
    j_step, t_step = (getattr(m, f"{step}_train_step") for m in (jstep, tstep))
    jst, jloss = j_step(_jstate(params, deltas), jnp.asarray(x), jnp.asarray(y), jcfg,
                        jstep.OptConfig(**opt))
    args = (torch.from_numpy(x), torch.from_numpy(y), tcfg, tstep.OptConfig(**opt))
    st, loss = t_step(train_state_from_jax(params, deltas, 3, device="cpu"), *args)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    _assert_state(st, jst.params, jst.deltas, 4, tol=dict(rtol=8e-3, atol=1e-6))
    st32, _ = t_step(train_state_from_jax(params, deltas, 3, device="cpu"), *args,
                     compute_dtype=None)
    assert not torch.allclose(st.deltas.w[0], st32.deltas.w[0], rtol=1e-4, atol=1e-7)
