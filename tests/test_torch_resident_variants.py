"""The chunk trainer's single-device variants on CPU tensors (the plain
version) against tpu_sednn.ops.resident_chunk.make_resident_train_chunk in
interpret mode, both pinned to float32 products (bf16=False;
tests/test_torch_tensor_core.py holds bf16=True), on the same numpy-seeded inputs, at the JAX
tests' own tolerances (tests/test_resident_chunk.py): row tiles rtol 2e-5 /
atol 2e-6; sr_state rtol 3e-2 / atol 3e-3 and sr_delta rtol 2e-2 / atol 2e-4
against the float32 kernel (bfloat16 rounding noise; the two packages draw
other random bits), with the storage types of the returned state; hbm_spill
equal to the unspilled run.  Every guard of the factory raises as the JAX
factory's does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
from tpu_sednn.ops.resident_chunk import (make_resident_train_chunk as j_make_resident,
                                          spill_layer_order as j_spill_layer_order)
from tpu_sednn.train.step import OptConfig as JOpt, clean_train_step as j_clean_step
from tpu_sednn.train.step import init_train_state as j_init
import tpu_sednn_torch.model as tm
import tpu_sednn_torch.ops.resident_chunk as rc
from tpu_sednn_torch.model.convert import train_state_from_jax, train_state_to_numpy
from tpu_sednn_torch.ops.philox import SR_DELTA_SHIFT, sr_bits, sr_to_bf16_reference
from tpu_sednn_torch.train.loop import _auto_engine, make_chunk_runner
from tpu_sednn_torch.train.step import OptConfig, init_train_state

TOL = dict(rtol=2e-5, atol=2e-6)
BF16, F32 = torch.bfloat16, torch.float32


def _inputs(sizes, n, seed=4):
    p = jm.init_params(jax.random.key(0), jm.ModelConfig(layersizes=sizes), "glorot")
    pn = {"w": tuple(np.asarray(w) for w in p["w"]), "b": tuple(np.asarray(b) for b in p["b"])}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, sizes[0])).astype(np.float32)
    t = rng.standard_normal((n, sizes[-1])).astype(np.float32)
    return p, tm.params_from_jax(pn, device="cpu"), x, t


def _close(st, jst, tol, tensors=("w", "b"), flips=0.0):
    """flips: the share of a tensor's elements that may lie outside `tol`,
    none further than 3 x its atol + rtol.  bfloat16 weights differ from the
    float32 run's by 4e-3 relative, so a few hidden pre-activations within
    that of 0 are on the other side of the ReLU; one such flip switches a
    whole dedy element on or off and moves one column of the layer below by
    a sample's share of the update, which is no rounding noise.  (The JAX
    package's interpret mode rounds with degenerate bits and does not flip.)"""
    assert st.step == int(jst.step)
    for k in tensors:
        for got, want in zip(getattr(st.params, k), jst.params[k]):
            got, want = got.float().numpy(), np.asarray(want, np.float32)
            if not flips:
                np.testing.assert_allclose(got, want, **tol)
                continue
            off = np.abs(got - want) - (tol["atol"] + tol["rtol"] * np.abs(want))
            assert (off > 0).mean() <= flips and off.max() <= 2 * tol["atol"]


@pytest.mark.parametrize("tile", [16, 32])
def test_row_tiles_match_jax_row_tiles_and_the_clean_step(tile):
    sizes = (128, 128, 128)
    opt = dict(lrate=0.2, momentum=0.7, weightcost=1e-3, bunchsize=64)
    p, mlp, x, t = _inputs(sizes, 128 + 24, seed=9)  # two bunches and a partial one
    jcfg = jm.ModelConfig(layersizes=sizes)
    jst = j_make_resident(jcfg, JOpt(**opt), interpret=True, bf16=False, rule="clean",
                          tile_rows=tile)(j_init(p), jnp.asarray(x), jnp.asarray(t), jnp.int32(0))
    st = rc.make_resident_train_chunk(tm.ModelConfig(layersizes=sizes), OptConfig(**opt),
                                      bf16=False, rule="clean", tile_rows=tile)(
        init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t), 0)
    assert st.step == 2  # 2 updates of 64 rows each
    _close(st, jst, TOL)
    for got, want in zip(st.deltas.b, jst.deltas["b"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = j_init(p)
    for i in range(2):
        ref, _ = j_clean_step(ref, jnp.asarray(x[64 * i:64 * i + 64]),
                              jnp.asarray(t[64 * i:64 * i + 64]), jcfg, JOpt(**opt),
                              compute_dtype=None)
    _close(st, ref, TOL)


def test_row_tiles_key_their_masks_on_the_global_tile_index():
    sizes = (39, 64, 13)
    cfg = tm.ModelConfig(layersizes=sizes, dropout_vis=0.1, dropout_hid=0.2, dropout_mode="inverted")
    opt = OptConfig(lrate=0.2, momentum=0.5, weightcost=0.0, bunchsize=32)
    _, mlp, x, t = _inputs(sizes, 64, seed=3)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    st = rc.make_resident_train_chunk(cfg, opt, bf16=False, rule="clean", tile_rows=16)(
        init_train_state(mlp), xt, tt, 21)
    # by hand: bunch i = tiles 2i and 2i + 1, each a 16-row bunch's gradient at 2/32,
    # masks of (seed, tile index): accumulate, then one step
    ws = [w.data.double() for w in mlp.w]
    bs = [b.data.double() for b in mlp.b]
    dws, dbs = [torch.zeros_like(w) for w in ws], [torch.zeros_like(b) for b in bs]
    m, a_coef, b_coef = rc._scal_coefs("clean", 32, 13, 0.2, 0.5, 0.0)
    for i in range(2):
        gw, gb = [0, 0], [0, 0]
        for j in range(2):
            gi = 2 * i + j
            h0 = xt[16 * gi:16 * gi + 16].double() * rc.sample_resident_masks_reference(
                21, gi, 0, (16, 39), 0.1).double() / 0.9
            h1 = torch.relu(h0 @ ws[0] + bs[0]) * rc.sample_resident_masks_reference(
                21, gi, 1, (16, 64), 0.2).double() / 0.8
            dedx = (2.0 / 32) * (h1 @ ws[1] + bs[1] - tt[16 * gi:16 * gi + 16].double())
            dedy = torch.where(h1 > 0, dedx @ ws[1].T, torch.zeros((), dtype=torch.float64))
            gw = [gw[0] + h0.T @ dedy, gw[1] + h1.T @ dedx]
            gb = [gb[0] + dedy.sum(0), gb[1] + dedx.sum(0)]
        for l in range(2):
            dws[l] = m * dws[l] - (a_coef * gw[l] + b_coef * ws[l])
            dbs[l] = m * dbs[l] - a_coef * gb[l]
            ws[l], bs[l] = ws[l] + dws[l], bs[l] + dbs[l]
    for l in range(2):
        np.testing.assert_allclose(st.params.w[l].numpy(), ws[l].numpy(), **TOL)
        np.testing.assert_allclose(st.deltas.b[l].numpy(), dbs[l].numpy(), **TOL)


@pytest.mark.parametrize("rule", ["parity", "clean"])
@pytest.mark.parametrize("hidden", ["relu", "sigmoid"])
@pytest.mark.parametrize("mode,tol", [("sr_state", dict(rtol=3e-2, atol=3e-3)),
                                      ("sr_delta", dict(rtol=2e-2, atol=2e-4))])
def test_sr_variants_close_to_the_float32_jax_kernel(rule, hidden, mode, tol):
    """Every element within the JAX tests' tolerance with a sigmoid hidden
    layer; with ReLU (the JAX test's net) all but the columns a ReLU flip
    moved, at most 0.5% of a tensor (see _close)."""
    sizes = (128, 128, 128)
    opt = dict(lrate=0.3, momentum=0.6, weightcost=1e-4, bunchsize=16)
    p, mlp, x, t = _inputs(sizes, 48, seed=12)
    jcfg = jm.ModelConfig(layersizes=sizes, hidden=hidden)
    flips = 5e-3 if hidden == "relu" else 0.0
    jx, jt = jnp.asarray(x), jnp.asarray(t)
    j_f32 = j_make_resident(jcfg, JOpt(**opt), interpret=True, bf16=False, rule=rule)(
        j_init(p), jx, jt, jnp.int32(3))
    j_sr = j_make_resident(jcfg, JOpt(**opt), interpret=True, bf16=False, rule=rule,
                           **{mode: True})(j_init(p), jx, jt, jnp.int32(3))
    run = rc.make_resident_train_chunk(tm.ModelConfig(layersizes=sizes, hidden=hidden),
                                       OptConfig(**opt), bf16=False, rule=rule, **{mode: True})
    st = run(init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t), 3)
    assert st.step == 3
    w_dtype = BF16 if mode == "sr_state" else F32
    for l in range(2):  # the storage types of the returned state, as the JAX kernel's
        assert st.params.w[l].dtype == w_dtype and st.deltas.w[l].dtype == BF16
        assert st.params.b[l].dtype == st.deltas.b[l].dtype == F32
        assert str(j_sr.params["w"][l].dtype) == str(w_dtype)[6:]
        assert str(j_sr.deltas["w"][l].dtype) == "bfloat16"
    _close(st, j_f32, tol, flips=flips)
    _close(st, j_sr, tol, flips=flips)  # the JAX variant, with its own bits: the same noise band
    first = st.deltas.w[0]
    st2 = run(st, torch.from_numpy(x), torch.from_numpy(t), 4)  # the bfloat16 state goes back in
    assert st2 is st and st2.step == 6 and st2.deltas.w[0] is first


def test_sr_state_carried_across_from_jax_and_back():
    """A bfloat16 state made by the JAX kernel crosses to the port exactly,
    trains there, and crosses back exactly (model/convert.py)."""
    sizes = (128, 128, 128)
    opt = dict(lrate=0.3, momentum=0.6, weightcost=1e-4, bunchsize=16)
    p, _, x, t = _inputs(sizes, 32, seed=5)
    jrun = j_make_resident(jm.ModelConfig(layersizes=sizes), JOpt(**opt), interpret=True, bf16=False,
                           sr_state=True)
    jst = jrun(j_init(p), jnp.asarray(x), jnp.asarray(t), jnp.int32(1))
    st = train_state_from_jax(jax.tree.map(np.asarray, jst.params),
                              jax.tree.map(np.asarray, jst.deltas), int(jst.step), device="cpu")
    assert st.params.w[0].dtype == st.deltas.w[1].dtype == BF16 and st.params.b[0].dtype == F32
    pw, dw, step = train_state_to_numpy(st)  # float32: the exact widening
    assert step == 2
    for a, b in zip(pw["w"] + dw["w"], jst.params["w"] + jst.deltas["w"]):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    back = tuple(jnp.asarray(a, jnp.bfloat16) for a in pw["w"])  # float32 holds bfloat16 exactly
    assert all(np.array_equal(np.asarray(a).view(np.uint16), np.asarray(b).view(np.uint16))
               for a, b in zip(back, jst.params["w"]))
    again = tm.params_from_jax({"w": tuple(np.asarray(a) for a in back), "b": pw["b"]},
                               device="cpu")
    assert all(a.dtype == BF16 and torch.equal(a, b) for a, b in zip(again.w, st.params.w))
    # both packages train the carried state on; they stay in the same noise band
    run = rc.make_resident_train_chunk(tm.ModelConfig(layersizes=sizes), OptConfig(**opt),
                                       bf16=False, sr_state=True)
    st = run(st, torch.from_numpy(x), torch.from_numpy(t), 2)
    jst2 = jrun(jst, jnp.asarray(x), jnp.asarray(t), jnp.int32(2))
    _close(st, jst2, dict(rtol=3e-2, atol=3e-3), flips=5e-3)


def test_sr_delta_stores_the_kernels_rounding_and_steps_unrounded():
    """One bunch by hand: delta' is SR(nd) with the bits of stream
    (seed, bunch, layer) + 1, W takes the unrounded nd."""
    sizes = (24, 32, 8)
    cfg = tm.ModelConfig(layersizes=sizes)
    opt = OptConfig(lrate=0.3, momentum=0.6, weightcost=1e-4, bunchsize=16)
    _, mlp, x, t = _inputs(sizes, 16, seed=2)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    f32 = rc.make_resident_train_chunk(cfg, opt, bf16=False)(init_train_state(mlp), xt, tt, 9)
    sr = rc.make_resident_train_chunk(cfg, opt, bf16=False, sr_delta=True)(init_train_state(mlp),
                                                                           xt, tt, 9)
    for l in range(2):
        assert torch.equal(sr.params.w[l], f32.params.w[l])  # zero momentum in: W' = W + nd, unrounded
        nd = f32.deltas.w[l]
        want = sr_to_bf16_reference(nd, sr_bits(rc.sr_key(9, 0, l), *nd.shape, SR_DELTA_SHIFT))
        assert torch.equal(sr.deltas.w[l], want)
        assert torch.equal(sr.deltas.b[l], f32.deltas.b[l])
    assert rc.sr_key(9, 0, 1) == rc.mask_key(9, 0, 1) + 1


@pytest.mark.parametrize("sizes,spill,hidden,output", [((128, 128, 72), 1, "relu", "linear"),
                                                       ((96, 640, 64), 1, "relu", "linear"),
                                                       ((128, 256, 128, 64), 2, "sigmoid", "sigmoid")])
def test_hbm_spill_equals_the_unspilled_run(sizes, spill, hidden, output):
    kw = dict(layersizes=sizes, hidden=hidden, output=output)
    opt = dict(lrate=0.2, momentum=0.7, weightcost=1e-3, bunchsize=32)
    p, mlp, x, t = _inputs(sizes, 96, seed=11)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    full = rc.make_resident_train_chunk(tm.ModelConfig(**kw), OptConfig(**opt), bf16=False)(
        init_train_state(mlp), xt, tt, 3)
    sp = rc.make_resident_train_chunk(tm.ModelConfig(**kw), OptConfig(**opt), bf16=False,
                                      hbm_spill=spill)(
        init_train_state(mlp), xt, tt, 3)
    for a, b in zip(list(sp.params.w) + list(sp.params.b) + list(sp.deltas.w) + list(sp.deltas.b),
                    list(full.params.w) + list(full.params.b) + list(full.deltas.w)
                    + list(full.deltas.b)):
        assert a.dtype == F32 and torch.equal(a, b)
    jst = j_make_resident(jm.ModelConfig(**kw), JOpt(**opt), interpret=True, bf16=False,
                          hbm_spill=spill)(j_init(p), jnp.asarray(x), jnp.asarray(t), jnp.int32(3))
    _close(sp, jst, TOL)


def test_hbm_spill_padded_capacity_and_clean_rule():
    sizes = (128, 128, 64)
    cfg, opt = tm.ModelConfig(layersizes=sizes), OptConfig(lrate=0.2, momentum=0.5, bunchsize=32)
    _, mlp, x, t = _inputs(sizes, 96, seed=12)
    run = rc.make_resident_train_chunk(cfg, opt, bf16=False, rule="clean", hbm_spill=1)
    a = run(init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t), 5)
    xp = torch.cat([torch.from_numpy(x), torch.full((64, 128), float("nan"))])
    tp = torch.cat([torch.from_numpy(t), torch.full((64, 64), float("nan"))])
    b = run(init_train_state(mlp), xp, tp, 5, n_real=3)
    assert a.step == b.step == 3 and torch.equal(a.params.w[1], b.params.w[1])
    assert torch.equal(a.deltas.w[0], b.deltas.w[0])


def test_spill_layer_order_matches_jax():
    for padded in ([128, 640, 128], [3200, 2048, 2048, 2048, 384], [1664, 2048, 2048, 2048, 256],
                   [128, 128], [256, 128, 512, 128]):
        assert rc.spill_layer_order(padded) == j_spill_layer_order(padded)
    assert rc.spill_layer_order([128, 640, 128])[0] == 1  # a tie: the later layer first


def _raises_like_jax(match, cfg_sizes, bunch, **kw):
    with pytest.raises(ValueError, match=match):
        j_make_resident(jm.ModelConfig(layersizes=cfg_sizes), JOpt(bunchsize=bunch), **kw)
    with pytest.raises(ValueError, match=match):
        rc.make_resident_train_chunk(tm.ModelConfig(layersizes=cfg_sizes), OptConfig(bunchsize=bunch),
                                     **kw)


@pytest.mark.parametrize("match,bunch,kw", [
    ("mutually exclusive", 16, dict(rule="clean", sr_state=True, sr_delta=True)),
    ("momentum buffer", 64, dict(rule="clean", tile_rows=16, sr_delta=True)),
    ("momentum buffer", 64, dict(rule="clean", tile_rows=16, sr_state=True)),
    ("clean-rule", 64, dict(rule="parity", tile_rows=16)),
    ("divide", 64, dict(rule="clean", tile_rows=24)),
    ("multiple of 8", 64, dict(rule="clean", tile_rows=4)),
    ("out of range", 16, dict(hbm_spill=3)),
    ("out of range", 16, dict(hbm_spill=-1)),
    ("hybrid-residency", 16, dict(hbm_spill=1, sr_delta=True)),
    ("hybrid-residency", 16, dict(hbm_spill=1, sr_state=True)),
    ("once per TILE", 64, dict(rule="clean", tile_rows=16, hbm_spill=1)),
    ("multiple of 8", 12, dict()),
    ("unknown rule", 16, dict(rule="nope")),
])
def test_factory_guards_raise_as_the_jax_factory_does(match, bunch, kw):
    _raises_like_jax(match, (128, 128, 128), bunch, **kw)


def test_still_unported_and_state_checks():
    """Nothing raises "not yet ported" any more: bf16=True (every storage
    form) and the data-parallel trainer with sr_delta (on one rank) build
    runners that train on the CPU."""
    cfg, opt = tm.ModelConfig(layersizes=(16, 16, 16)), OptConfig(bunchsize=16)
    mlp = tm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    for kw in (dict(), dict(sr_delta=True), dict(sr_state=True), dict(hbm_spill=1)):
        st = rc.make_resident_train_chunk(cfg, opt, bf16=True, **kw)(
            init_train_state(mlp), torch.zeros(16, 16), torch.zeros(16, 16), 0)
        assert st.step == 1
    from tpu_sednn_torch.parallel import make_mesh

    st = rc.make_dp_resident_train_chunk(cfg, opt, make_mesh(devices=["cpu"]), sr_delta=True)(
        init_train_state(mlp), torch.zeros(16, 16), torch.zeros(16, 16), 0)
    assert st.step == 1 and st.deltas.w[0].dtype == torch.bfloat16


def test_float64_plain_version_keeps_the_rounding_decisions():
    sizes = (39, 64, 13)
    cfg = tm.ModelConfig(layersizes=sizes, dropout_vis=0.1, dropout_hid=0.2)
    opt = OptConfig(lrate=0.5, momentum=0.6, weightcost=1e-4, bunchsize=16)
    _, mlp, x, t = _inputs(sizes, 48, seed=8)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    coefs = rc._scal_coefs("parity", 16, 13, 0.5, 0.6, 1e-4)
    for kw, w_dtype in ((dict(sr_delta=True), F32), (dict(sr_state=True), BF16)):
        st32 = rc.make_resident_train_chunk(cfg, opt, bf16=False, **kw)(init_train_state(mlp), xt,
                                                                         tt, 7)
        st64 = init_train_state(mlp)
        rc._cast_state(st64, w_dtype, BF16)
        rc.resident_train_chunk_reference(st64, xt, tt, cfg, 16, coefs, 7, dtype=torch.float64,
                                          bf16=False, **kw)
        assert st64.params.w[0].dtype == w_dtype and st64.deltas.w[0].dtype == BF16
        for a, b in zip(st32.deltas.w, st64.deltas.w):
            share = float((a.view(torch.int16) != b.view(torch.int16)).float().mean())
            assert share < 0.02  # the same bits: only decisions at a rounding boundary differ
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=2e-2, atol=1e-5)


def test_chunk_runner_forwards_the_variants_and_auto_keeps_no_ladder():
    sizes = (32, 64, 16)
    cfg = tm.ModelConfig(layersizes=sizes)
    opt = OptConfig(lrate=0.1, momentum=0.5, weightcost=0.0, bunchsize=16)
    _, mlp, x, t = _inputs(sizes, 32, seed=8)
    run = make_chunk_runner(cfg, opt, "resident", device="cpu", sr_delta=True)
    assert run is make_chunk_runner(cfg, opt, "resident", device="cpu", sr_delta=True)
    assert run is not make_chunk_runner(cfg, opt, "resident", device="cpu")
    st = run(init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t),
             torch.Generator().manual_seed(0), 0.1, 0.5, 0.0)
    assert st.step == 2 and st.deltas.w[0].dtype == BF16 and st.params.w[0].dtype == F32
    wide = tm.ModelConfig(layersizes=(3084, 2048, 2048, 2048, 257))
    assert _auto_engine(wide, OptConfig(bunchsize=128), {}, "cpu") == ("xla", {})
    assert not hasattr(rc, "resident_fits_vmem") and not hasattr(rc, "resident_vmem_bytes")
