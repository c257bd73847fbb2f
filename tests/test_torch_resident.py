"""The port's whole-chunk trainer on CPU tensors (its plain version) against
tpu_sednn's resident kernel in interpret mode, both pinned to float32
products (bf16=False; tests/test_torch_tensor_core.py holds bf16=True), dropout off:
rtol 2e-5 / atol 2e-6, the JAX package's own tolerance for this kernel
(tests/test_resident_chunk.py).  With dropout on, against the plain parity
chunk trainer fed the same Philox masks.  Also the Philox known-answer
vectors and the mask stream's rate, distinctness and rank-slice identity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
from tpu_sednn.ops.resident_chunk import (_mask_threshold as j_mask_threshold,
                                          _scal_coefs as j_scal_coefs,
                                          make_resident_train_chunk as j_make_resident)
from tpu_sednn.train.step import OptConfig as JOpt, init_train_state as j_init
import tpu_sednn_torch.model as tm
import tpu_sednn_torch.ops.resident_chunk as rc
from tpu_sednn_torch.ops.philox import mask_threshold, philox4x32_10, philox_bits
from tpu_sednn_torch.train.loop import make_chunk_runner
from tpu_sednn_torch.train.step import (OptConfig, clean_train_step, init_train_state,
                                        reference_train_chunk)

TOL = dict(rtol=2e-5, atol=2e-6)


def _inputs(sizes, n, seed=4):
    p = jm.init_params(jax.random.key(0), jm.ModelConfig(layersizes=sizes), "glorot")
    pn = {"w": tuple(np.asarray(w) for w in p["w"]), "b": tuple(np.asarray(b) for b in p["b"])}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, sizes[0])).astype(np.float32)
    t = rng.standard_normal((n, sizes[-1])).astype(np.float32)
    return p, tm.params_from_jax(pn, device="cpu"), x, t


def _assert_state(st, jst):
    assert st.step == int(jst.step)
    for l in range(len(st.params.w)):
        for got, want in ((st.params.w[l], jst.params["w"][l]), (st.params.b[l], jst.params["b"][l]),
                          (st.deltas.w[l], jst.deltas["w"][l]), (st.deltas.b[l], jst.deltas["b"][l])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rule", ["parity", "clean"])
@pytest.mark.parametrize("hidden,output,sizes", [
    ("relu", "linear", (128, 256, 256, 128)),
    ("sigmoid", "sigmoid", (128, 256, 256, 128)),
    ("relu", "linear", (132, 256, 60)),   # unaligned: the JAX kernel pads, the port does not
    ("sigmoid", "linear", (132, 256, 60)),
    ("relu", "sigmoid", (132, 256, 60)),
])
def test_resident_matches_jax_resident_kernel(rule, hidden, output, sizes):
    kw = dict(layersizes=sizes, hidden=hidden, output=output)
    opt = dict(lrate=0.5, momentum=0.6, weightcost=1e-4, bunchsize=16)
    p, mlp, x, t = _inputs(sizes, 52)  # three bunches and a partial one, which is dropped
    jst = j_make_resident(jm.ModelConfig(**kw), JOpt(**opt), interpret=True, bf16=False, rule=rule)(
        j_init(p), jnp.asarray(x), jnp.asarray(t), jnp.int32(7))
    st0 = init_train_state(mlp)
    st = rc.make_resident_train_chunk(tm.ModelConfig(**kw), OptConfig(**opt), bf16=False, rule=rule)(
        st0, torch.from_numpy(x), torch.from_numpy(t), 7)
    assert st is st0 and st.step == 3  # in place, partial bunch dropped
    _assert_state(st, jst)


def test_resident_n_real_padding_and_dynamic_hyperparameters_match_jax():
    sizes = (128, 128, 128)
    p, mlp, x, t = _inputs(sizes, 64, seed=6)
    opt = dict(lrate=0.5, momentum=0.5, weightcost=0.0, bunchsize=16)
    jrun = j_make_resident(jm.ModelConfig(layersizes=sizes), JOpt(**opt), interpret=True, bf16=False)
    run = rc.make_resident_train_chunk(tm.ModelConfig(layersizes=sizes), OptConfig(**opt), bf16=False)
    xg, tg = x.copy(), t.copy()
    xg[32:], tg[32:] = np.nan, np.nan  # rows past n_real * bunch are never read
    for mom in (0.5, 0.9):
        jst = jrun(j_init(p), jnp.asarray(x), jnp.asarray(t), jnp.int32(1), momentum=mom,
                   n_real=jnp.int32(2))
        st = run(init_train_state(mlp), torch.from_numpy(xg), torch.from_numpy(tg), 1, momentum=mom,
                 n_real=2)
        trimmed = run(init_train_state(mlp), torch.from_numpy(x[:32]), torch.from_numpy(t[:32]), 1,
                      momentum=mom)
        _assert_state(st, jst)
        assert st.step == 2 and torch.equal(st.params.w[0], trimmed.params.w[0])
    st = run(init_train_state(mlp), torch.from_numpy(x[:8]), torch.from_numpy(t[:8]), 1)
    assert st.step == 0  # less than a bunch: nothing trained
    with pytest.raises(ValueError, match="n_real"):
        run(init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t), 1, n_real=5)


def test_resident_clean_rule_matches_clean_step():
    sizes = (39, 64, 13)
    cfg = tm.ModelConfig(layersizes=sizes)
    opt = OptConfig(lrate=0.2, momentum=0.7, weightcost=1e-3, bunchsize=16)
    _, mlp, x, t = _inputs(sizes, 32, seed=9)
    ref = init_train_state(mlp)
    for i in range(2):
        ref, _ = clean_train_step(ref, torch.from_numpy(x[16 * i:16 * i + 16]),
                                  torch.from_numpy(t[16 * i:16 * i + 16]), cfg, opt,
                                  compute_dtype=None)
    st = rc.make_resident_train_chunk(cfg, opt, bf16=False, rule="clean")(
        init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t), 0)
    for a, b in zip(list(st.params.w) + list(st.deltas.b), list(ref.params.w) + list(ref.deltas.b)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("hidden", ["relu", "sigmoid"])
def test_resident_with_dropout_matches_plain_chunk_fed_the_philox_masks(hidden):
    sizes = (39, 64, 64, 13)
    cfg = tm.ModelConfig(layersizes=sizes, hidden=hidden, dropout_vis=0.1, dropout_hid=0.2)
    opt = OptConfig(lrate=0.5, momentum=0.6, weightcost=1e-4, bunchsize=16)
    _, mlp, x, t = _inputs(sizes, 48, seed=8)
    seed = 2**31 - 5  # seed + bunch*7919 + layer*104729 wraps past 2**31: the key is the sum mod 2**32
    masks = [[rc.sample_resident_masks_reference(seed, i, l, (16, sizes[l]), 0.1 if l == 0 else 0.2)
              for l in range(3)] for i in range(3)]
    st = rc.make_resident_train_chunk(cfg, opt, bf16=False)(init_train_state(mlp), torch.from_numpy(x),
                                                            torch.from_numpy(t), seed)
    ref = reference_train_chunk(init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t), cfg,
                                opt, dropout_masks=masks)
    nodrop = rc.make_resident_train_chunk(tm.ModelConfig(layersizes=sizes, hidden=hidden), opt,
                                          bf16=False)(
        init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t), seed)
    for l in range(3):
        np.testing.assert_allclose(st.params.w[l].numpy(), ref.params.w[l].numpy(), **TOL)
        np.testing.assert_allclose(st.deltas.b[l].numpy(), ref.deltas.b[l].numpy(), **TOL)
    assert not torch.allclose(st.params.w[0], nodrop.params.w[0], rtol=1e-3, atol=1e-4)
    # float64 plain version: same function, state rounded to float32 at the end
    st64 = rc.resident_train_chunk_reference(
        init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t), cfg, 16,
        rc._scal_coefs("parity", 16, 13, 0.5, 0.6, 1e-4), seed, dtype=torch.float64, bf16=False)
    assert st64.params.w[0].dtype == torch.float32
    np.testing.assert_allclose(st64.params.w[1].numpy(), st.params.w[1].numpy(), **TOL)


def test_scal_coefs_and_threshold_match_jax():
    for rule in ("parity", "clean"):
        got = rc._scal_coefs(rule, 128, 129, 0.3, 0.54, 1e-4)
        want = np.asarray(j_scal_coefs(rule, 128, 129, 0.3, 0.54, 1e-4))
        np.testing.assert_array_equal(np.float32(got), want)
    for omit in (0.0, 0.1, 0.2, 0.5, 1.0):
        assert mask_threshold(omit) == rc._mask_threshold(omit) == j_mask_threshold(omit)
    assert (rc._BUNCH_STRIDE, rc._LAYER_STRIDE) == (7919, 104729)
    assert rc.mask_key(2**31 - 1, 799, 3) == (2**31 - 1 + 799 * 7919 + 3 * 104729) % 2**32


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answer_vectors(counter, key, want):
    assert tuple(int(v) for v in philox4x32_10(counter, key)) == want


def test_philox_bits_layout():
    bits = philox_bits(77, 6, 10, row0=3)
    assert bits.shape == (6, 10) and int(bits.min()) >= 0 and int(bits.max()) < 2**32
    # element (row, col) is word col % 4 of counter (col // 4, row0 + row, 0, 0), key (key, 0)
    for r, c in ((0, 0), (2, 5), (5, 9)):
        assert int(bits[r, c]) == int(philox4x32_10((c // 4, 3 + r, 0, 0), (77, 0))[c % 4])


@pytest.mark.parametrize("layer,omit,width", [(0, 0.1, 1548), (1, 0.2, 2048)])
def test_mask_rate_streams_and_rank_slices(layer, omit, width):
    shape = (128, width)
    full = rc.sample_resident_masks(12345, 7, layer, shape, omit, device="cpu")
    assert full.shape == shape and set(full.unique().tolist()) == {0.0, 1.0}
    zr = 1.0 - float(full.mean())
    assert abs(zr - omit) <= 4.0 * np.sqrt(omit * (1 - omit) / full.numel())
    assert torch.equal(full, rc.sample_resident_masks_reference(12345, 7, layer, shape, omit))
    # distinct (bunch, layer) streams differ
    assert not torch.equal(full, rc.sample_resident_masks(12345, 8, layer, shape, omit, device="cpu"))
    assert not torch.equal(full[:, :1548], rc.sample_resident_masks(12345, 7, layer + 1, (128, 1548),
                                                                  omit, device="cpu"))
    # a rank's mask is its rows of the global bunch's mask, whatever the device count
    for n_dev in (2, 4):
        rows = 128 // n_dev
        parts = [rc.sample_resident_masks(12345, 7, layer, shape, omit, device_idx=d, n_dev=n_dev,
                                          device="cpu") for d in range(n_dev)]
        for d, part in enumerate(parts):
            assert torch.equal(part, full[d * rows:(d + 1) * rows])
        assert len({p.numpy().tobytes() for p in parts}) == n_dev
    with pytest.raises(ValueError):
        rc.sample_resident_masks(1, 0, 0, (10, 4), 0.1, n_dev=4, device="cpu")


@pytest.mark.parametrize("kwargs", [dict(sr_state=True), dict(sr_delta=True), dict(tile_rows=8),
                                    dict(hbm_spill=1), dict(bf16=True)])
def test_unported_variants_raise(kwargs):
    """Of the TPU kernel's variants only the data-parallel trainer still
    raises; every single-device one builds a runner, the tensor-core products
    (bf16=True) included, and each trains a CPU state
    (tests/test_torch_resident_variants.py and tests/test_torch_tensor_core.py
    hold what they compute)."""
    cfg, opt = tm.ModelConfig(layersizes=(16, 16, 16)), OptConfig(bunchsize=16)
    rule = "clean" if "tile_rows" in kwargs else "parity"
    run = rc.make_resident_train_chunk(cfg, opt, rule=rule, **kwargs)
    assert callable(run)
    if "bf16" in kwargs:
        st = run(init_train_state(tm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")),
                 torch.zeros(32, 16), torch.zeros(32, 16), 0)
        assert st.step == 2


def test_factory_guards():
    cfg, opt = tm.ModelConfig(layersizes=(16, 16, 16)), OptConfig(bunchsize=16)
    from tpu_sednn_torch.parallel import Mesh, make_mesh

    with pytest.raises(ValueError, match="power of two"):
        rc.make_dp_resident_train_chunk(cfg, opt, Mesh(3, 0, torch.device("cpu")))
    assert rc.make_dp_resident_train_chunk(cfg, opt, make_mesh(devices=["cpu"]))  # one rank, no process group
    with pytest.raises(ValueError):
        rc.make_resident_train_chunk(cfg, opt, rule="nope")
    with pytest.raises(ValueError):
        rc.make_resident_train_chunk(cfg, OptConfig(bunchsize=12))
    assert rc.make_resident_train_chunk(cfg, opt, tile_rows=16)  # tile_rows == bunchsize: the default
    # the TPU kernel's interpret mode has no counterpart: a CPU state takes the plain version
    with pytest.raises(TypeError):
        rc.make_resident_train_chunk(cfg, opt, interpret=True)
    with pytest.raises(ValueError, match="widths"):
        rc.make_resident_train_chunk(cfg, opt)(
            init_train_state(tm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")),
            torch.zeros(16, 5), torch.zeros(16, 16), 0)


def test_chunk_runner_engines_and_required_hyperparameters():
    sizes = (32, 64, 16)
    cfg = tm.ModelConfig(layersizes=sizes)
    opt = OptConfig(lrate=0.1, momentum=0.5, weightcost=0.0, bunchsize=16)
    _, mlp, x, t = _inputs(sizes, 32, seed=8)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    gen = torch.Generator().manual_seed(0)
    hyp = (opt.lrate, opt.momentum, opt.weightcost)
    runs = {e: make_chunk_runner(cfg, opt, e, device="cpu", bf16=False)  # float32 products
            for e in ("auto", "xla", "resident")}
    assert runs["auto"] is runs["xla"]  # on the CPU "auto" is the plain trainer
    assert make_chunk_runner(cfg, opt, "resident", device="cpu", bf16=False) is runs["resident"]
    a = runs["xla"](init_train_state(mlp), xt, tt, gen, *hyp)
    b = runs["resident"](init_train_state(mlp), xt, tt, gen, *hyp)
    assert a.step == b.step == 2
    np.testing.assert_allclose(a.params.w[0].numpy(), b.params.w[0].numpy(), **TOL)
    with pytest.raises(TypeError):  # hyperparameters are required: the memo ignores opt's
        runs["auto"](init_train_state(mlp), xt, tt, gen)
    with pytest.raises(ValueError):
        make_chunk_runner(cfg, opt, "nope", device="cpu")
    with pytest.raises(ValueError, match="world size"):  # 2 shards need a group of 2 processes
        make_chunk_runner(cfg, opt, "xla", n_data_shards=2, device="cpu")


def test_wrappers_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the call would not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rc.sample_resident_masks(1, 0, 0, (16, 8), 0.1)  # device defaults to the card
    with pytest.raises(ValueError, match="CUDA tensor"):
        rc.philox_words_on_device(torch.zeros((1, 6), dtype=torch.int64))
