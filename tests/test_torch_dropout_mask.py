"""The port's standalone dropout mask (ops/dropout_mask.py) on the CPU, where
the wrapper runs its plain version: the properties tests/test_dropout_pallas.py
holds the JAX function to (values in {0, 1}, zero rate within 0.01,
deterministic, seed-sensitive, any shape), beside the JAX function itself on
the same shapes.  The streams are different generators and need not match."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
from tpu_sednn.ops.dropout_pallas import dropout_mask_pallas
import tpu_sednn_torch.model as tm
from tpu_sednn_torch.model.mlp import _dropout_mask
from tpu_sednn_torch.ops.dropout_mask import dropout_mask, dropout_mask_reference
from tpu_sednn_torch.ops.philox import mask_threshold, philox_bits
from tpu_sednn_torch.ops.train_step import fused_train_step
from tpu_sednn_torch.train.step import OptConfig, init_train_state


@pytest.mark.parametrize("omit", [0.1, 0.5])
def test_distribution_matches_the_jax_function(omit):
    m = dropout_mask(42, (256, 1024), omit, device="cpu")
    j = np.asarray(dropout_mask_pallas(jnp.int32(42), (256, 1024), omit))
    assert m.dtype == torch.float32 and m.shape == j.shape
    assert set(m.unique().tolist()) <= {0.0, 1.0} and set(np.unique(j)) <= {0.0, 1.0}
    assert abs((1.0 - float(m.mean())) - omit) < 0.01
    assert abs(float(m.mean()) - j.mean()) < 0.01


def test_deterministic_and_seed_sensitive():
    before = dropout_mask.launches
    a = dropout_mask(7, (64, 256), 0.2, device="cpu")
    assert torch.equal(a, dropout_mask(7, (64, 256), 0.2, device="cpu"))
    assert not torch.equal(a, dropout_mask(8, (64, 256), 0.2, device="cpu"))
    assert torch.equal(a, dropout_mask_reference(7, (64, 256), 0.2))
    assert torch.equal(a, dropout_mask(7 - 2 ** 32, (64, 256), 0.2, device="cpu"))  # seed mod 2**32
    assert dropout_mask.launches == before  # the CPU launches no kernel


def test_unaligned_shape():
    m = dropout_mask(1, (100, 1548), 0.1, device="cpu")
    assert m.shape == (100, 1548) and abs((1.0 - float(m.mean())) - 0.1) < 0.02
    assert np.asarray(dropout_mask_pallas(jnp.int32(1), (100, 1548), 0.1)).shape == (100, 1548)
    assert dropout_mask(1, (0, 5), 0.1, device="cpu").shape == (0, 5)


def test_one_stream_per_block_of_512_rows_keyed_seed_plus_block():
    tall = dropout_mask(2 ** 32 - 1, (1300, 37), 0.2, device="cpu")  # seed + block wraps
    assert torch.equal(tall[512:1024], dropout_mask(0, (512, 37), 0.2, device="cpu"))
    assert torch.equal(tall[1024:], dropout_mask(1, (276, 37), 0.2, device="cpu"))
    # element (row, col) of block k: word col % 4 of counter (col // 4, row % 512), key seed + k
    bits = philox_bits(1, 276, 37)
    assert torch.equal(tall[1024:], (bits >= mask_threshold(0.2)).float())
    assert not torch.equal(tall[:276], tall[1024:])


def test_threshold_edges_and_bad_arguments():
    assert not dropout_mask(3, (16, 16), 1.0, device="cpu").any() or mask_threshold(1.0) < 2 ** 32
    assert bool(dropout_mask(3, (16, 16), 0.0, device="cpu").all())
    with pytest.raises(ValueError, match="2-D"):
        dropout_mask(0, (4,), 0.1, device="cpu")
    with pytest.raises(ValueError, match="omit"):
        dropout_mask(0, (4, 4), 1.5, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the call would not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dropout_mask(0, (4, 4), 0.1)  # device defaults to the card


def test_model_dropout_rng_selects_the_philox_mask():
    gen = torch.Generator().manual_seed(5)
    a = _dropout_mask(gen, (40, 30), 0.2, torch.device("cpu"), "tpu_prng")
    seed = int(torch.randint(-2 ** 31, 2 ** 31, (), generator=torch.Generator().manual_seed(5)))
    assert torch.equal(a, dropout_mask(seed, (40, 30), 0.2, device="cpu"))
    b = _dropout_mask(gen, (40, 30), 0.2, torch.device("cpu"), "tpu_prng")  # the generator moved on
    assert not torch.equal(a, b)
    threefry = _dropout_mask(torch.Generator().manual_seed(5), (40, 30), 0.2, torch.device("cpu"))
    assert not torch.equal(a, threefry)
    with pytest.raises(ValueError, match="dropout_rng"):
        _dropout_mask(gen, (4, 4), 0.2, torch.device("cpu"), "nope")
    assert tm.ModelConfig().dropout_rng == jm.ModelConfig().dropout_rng == "threefry"


@pytest.mark.parametrize("mode", ["parity", "inverted"])
def test_forward_and_fused_step_draw_through_it(mode):
    sizes = (20, 32, 8)
    cfg = tm.ModelConfig(layersizes=sizes, dropout_vis=0.1, dropout_hid=0.2, dropout_mode=mode,
                         dropout_rng="tpu_prng")
    mlp = tm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 20)).astype(np.float32))
    out = tm.forward(mlp, x, cfg, train=True, generator=torch.Generator().manual_seed(9))
    # the same masks, drawn by hand from the same generator
    gen = torch.Generator().manual_seed(9)
    masks = [_dropout_mask(gen, (16, sizes[l]), o, x.device, "tpu_prng")
             for l, o in enumerate((0.1, 0.2))]
    want = tm.forward(mlp, x, cfg, train=True, dropout_masks=masks)
    assert torch.equal(out, want)
    assert not torch.equal(out, tm.forward(mlp, x, cfg, train=True,
                                           generator=torch.Generator().manual_seed(10)))
    # ops/train_step.py draws through the same function
    t = torch.zeros(16, 8)
    opt = OptConfig(lrate=0.1, momentum=0.5, bunchsize=16)
    a = fused_train_step(init_train_state(mlp), x, t, cfg, opt, generator=torch.Generator().manual_seed(9))
    b = fused_train_step(init_train_state(mlp), x, t, cfg, opt, dropout_masks=masks)
    assert torch.equal(a.params.w[0], b.params.w[0]) and torch.equal(a.deltas.b[1], b.deltas.b[1])


# ---------------------------------------------------------------------------
# a batch of masks a launch (dropout_masks) and the helpers that draw through it
# ---------------------------------------------------------------------------

import ctypes
import importlib
import re
from pathlib import Path

from tpu_sednn_torch.model.mlp import _bunch_masks, _dropout_masks
from tpu_sednn_torch.ops.dropout_mask import dropout_masks, dropout_masks_reference
from tpu_sednn_torch.parallel.mesh import Mesh, _rank_masks
from tpu_sednn_torch.train import step as tstep
from tpu_sednn_torch.train.loop import make_chunk_runner
from tpu_sednn_torch.ops.train_step import make_fused_train_chunk

dm_mod = importlib.import_module("tpu_sednn_torch.ops.dropout_mask")  # the package exports its function

# rows past 512, D not a multiple of 4, omit 0 and 1, row0 > 0, an empty mask
BATCH = ((11, (600, 37), 0.2, 0), (12, (128, 3084), 0.1, 0), (-3, (64, 257), 0.0, 700),
         (2 ** 32 - 1, (300, 20), 1.0, 400), (14, (5, 2048), 0.5, 1021), (15, (0, 8), 0.2, 3),
         (16, (513, 1), 0.3, 511))


def _columns(batch):
    seeds, shapes, omits, row0s = (list(c) for c in zip(*batch))
    return seeds, shapes, omits, row0s


@pytest.mark.parametrize("fn", [dropout_masks_reference,
                                lambda *a: dropout_masks(*a, device="cpu")],
                         ids=["reference", "wrapper_on_cpu"])
def test_batch_equals_the_per_mask_draws(fn):
    before = dropout_mask.launches
    seeds, shapes, omits, row0s = _columns(BATCH)
    got = fn(seeds, shapes, omits, row0s)
    assert len(got) == len(BATCH) and dropout_mask.launches == before
    for m, (seed, shape, omit, row0) in zip(got, BATCH):
        assert m.shape == shape and m.dtype == torch.float32
        assert torch.equal(m, dropout_mask_reference(seed, shape, omit, row0=row0))
        assert torch.equal(m, dropout_mask(seed, (row0 + shape[0], shape[1]), omit,
                                           device="cpu")[row0:])
    assert bool(got[2].all()) and not got[3].any()  # omit 0 keeps all, omit 1 drops all
    # row0 = 0 everywhere is the single-mask wrapper's draw
    whole = fn(seeds, shapes, omits, None)
    for m, seed, shape, omit in zip(whole, seeds, shapes, omits):
        assert torch.equal(m, dropout_mask(seed, shape, omit, device="cpu"))


@pytest.mark.parametrize("row0, rows", [(0, 40), (1, 40), (500, 30), (511, 2), (512, 7),
                                        (700, 600), (1023, 300)])
def test_a_row0_slice_is_the_rows_of_the_full_mask(row0, rows):
    full = dropout_mask(2 ** 32 - 2, (row0 + rows, 33), 0.25, device="cpu")
    part = dropout_mask_reference(2 ** 32 - 2, (rows, 33), 0.25, row0=row0)
    assert torch.equal(part, full[row0:])
    assert torch.equal(dropout_masks([2 ** 32 - 2], [(rows, 33)], [0.25], [row0],
                                     device="cpu")[0], part)


@pytest.mark.parametrize("fn", [dropout_masks_reference,
                                lambda *a: dropout_masks(*a, device="cpu")],
                         ids=["reference", "wrapper_on_cpu"])
def test_bad_batch_arguments_are_refused(fn):
    with pytest.raises(ValueError, match="negative row0"):
        fn([1, 2], [(4, 4), (4, 4)], [0.1, 0.1], [0, -1])
    for args in (([1, 2], [(4, 4)], [0.1, 0.1], None), ([1], [(4, 4)], [0.1, 0.2], None),
                 ([1], [(4, 4)], [0.1], [0, 0])):
        with pytest.raises(ValueError, match="seeds"):
            fn(*args)
    with pytest.raises(ValueError, match="2-D"):
        fn([1], [(4,)], [0.1], None)
    with pytest.raises(ValueError, match="omit"):
        fn([1], [(4, 4)], [-0.1], None)
    assert fn([], [], [], None) == []


def test_bad_row0_of_one_mask_and_the_card_default():
    with pytest.raises(ValueError, match="negative"):
        dropout_mask_reference(1, (4, 4), 0.1, row0=-3)
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the call would not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dropout_masks([0], [(4, 4)], [0.1])  # device defaults to the card


def test_the_c_entry_takes_what_the_wrapper_binds():
    """The ctypes argtypes of ops/dropout_mask.py against the C signature, and
    one launch's descriptor count against the kernel's table."""
    src = (Path(dm_mod.__file__).resolve().parent.parent / "csrc" / "dropout_mask.cu").read_text()
    m = re.search(r'extern "C" int philox_dropout_masks_f32\(([^)]*)\)', src)
    kinds = {"float*": ctypes.c_void_p, "int": ctypes.c_int, "void*": ctypes.c_void_p,
             "const long long*": ctypes.POINTER(ctypes.c_longlong),
             "const int*": ctypes.POINTER(ctypes.c_int),
             "const unsigned*": ctypes.POINTER(ctypes.c_uint)}
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    want = [kinds[p[:max(p.rfind(" "), p.rfind("*")) + 1].strip().replace(" *", "*")]
            for p in params]

    class FakeLib:
        class philox_dropout_masks_f32:
            argtypes = restype = None

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dm_mod._build, "load", lambda name: FakeLib)
        dm_mod._lib.cache_clear()
        try:
            lib = dm_mod._lib()
        finally:
            dm_mod._lib.cache_clear()
    assert lib.philox_dropout_masks_f32.argtypes == want
    assert lib.philox_dropout_masks_f32.restype is ctypes.c_int
    assert int(re.search(r"kMaxMasks = (\d+);", src).group(1)) == dm_mod.MAX_MASKS


@pytest.mark.parametrize("impl", ["tpu_prng", "threefry"])
def test_dropout_masks_helper_draws_as_one_by_one(impl):
    shapes, omits = [(16, 20), (16, 32), (16, 32), (16, 9)], [0.1, 0.2, 0.2, 0.0]
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    got = _dropout_masks(a, shapes, omits, torch.device("cpu"), impl)
    want = [_dropout_mask(b, s, o, torch.device("cpu"), impl) for s, o in zip(shapes, omits)]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(a.get_state(), b.get_state())
    if impl == "threefry":
        with pytest.raises(ValueError, match="row0s"):
            _dropout_masks(a, shapes, omits, torch.device("cpu"), impl, row0s=[0] * 4)
    with pytest.raises(ValueError, match="dropout_rng"):
        _dropout_masks(a, shapes, omits, torch.device("cpu"), "nope")


def test_bunch_masks_cover_the_bunches_in_forward_order():
    cfg = tm.ModelConfig(layersizes=(20, 32, 32, 8), dropout_vis=0.1, dropout_hid=0.2,
                         dropout_rng="tpu_prng")
    a, b = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    got = _bunch_masks(a, cfg, 16, [20, 32, 32], torch.device("cpu"), n_bunches=3)
    for bunch in got:
        want = [_dropout_mask(b, (16, w), o, torch.device("cpu"), "tpu_prng")
                for w, o in ((20, 0.1), (32, 0.2), (32, 0.2))]
        assert all(torch.equal(g, w) for g, w in zip(bunch, want))
    assert torch.equal(a.get_state(), b.get_state())
    off = tm.ModelConfig(layersizes=(20, 32, 8), dropout_hid=0.2, dropout_rng="tpu_prng")
    assert _bunch_masks(a, off, 4, [20, 32], torch.device("cpu"))[0][0] is None


@pytest.mark.parametrize("impl", ["tpu_prng", "threefry"])
@pytest.mark.parametrize("n_data", [2, 4])
def test_rank_masks_are_the_rows_of_the_global_masks(impl, n_data):
    sizes, bunch = (20, 32, 32, 8), 32
    cfg = tm.ModelConfig(layersizes=sizes, dropout_vis=0.1, dropout_hid=0.2, dropout_rng=impl)
    for index in range(n_data):
        a, b = torch.Generator().manual_seed(21), torch.Generator().manual_seed(21)
        got = _rank_masks(cfg, a, bunch, Mesh(n_data, index, torch.device("cpu")),
                          torch.device("cpu"))
        rows = slice(index * bunch // n_data, (index + 1) * bunch // n_data)
        want = [_dropout_mask(b, (bunch, n), o, torch.device("cpu"), impl)[rows]
                for n, o in zip(sizes, (0.1, 0.2, 0.2))]
        assert len(got) == 3 and all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(a.get_state(), b.get_state())


def _tiny_chunk(n_bunches, bs=8, sizes=(12, 16, 16, 5), impl="tpu_prng"):
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((n_bunches * bs + 3, sizes[0])).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((n_bunches * bs + 3, sizes[-1])).astype(np.float32))
    cfg = tm.ModelConfig(layersizes=sizes, dropout_vis=0.1, dropout_hid=0.2, dropout_rng=impl)
    mlp = tm.init_params(torch.Generator().manual_seed(4), cfg, device="cpu")
    return x, t, cfg, mlp, OptConfig(lrate=0.5, momentum=0.5, weightcost=1e-4, bunchsize=bs)


def _tensors(state):
    return [*state.params.w, *state.params.b, *state.deltas.w, *state.deltas.b]


def _masks_by_hand(gen, cfg, bs):
    return [_dropout_mask(gen, (bs, n), o, torch.device("cpu"), cfg.dropout_rng)
            for n, o in zip(cfg.layersizes, (0.1, 0.2, 0.2))]


@pytest.mark.parametrize("impl", ["tpu_prng", "threefry"])
def test_xla_chunk_runner_draws_a_group_of_bunches_at_once(monkeypatch, impl):
    """10 bunches (a group of 8 and 2): the state and the generator equal 10
    reference_train_step calls with masks drawn layer by layer; two batch
    draws with tpu_prng."""
    x, t, cfg, mlp, opt = _tiny_chunk(10, impl=impl)
    draws = []
    real = dm_mod.dropout_masks
    monkeypatch.setattr(dm_mod, "dropout_masks",
                        lambda seeds, *a, **k: draws.append(len(seeds)) or real(seeds, *a, **k))
    run = make_chunk_runner(cfg, opt, engine="xla", device="cpu")
    calls = tstep.reference_train_chunk.calls
    gen = torch.Generator().manual_seed(33)
    got = run(init_train_state(mlp), x, t, gen, 0.5, 0.5, 1e-4)
    assert tstep.reference_train_chunk.calls == calls + 1
    assert draws == ([3 * tstep.MASK_GROUP, 3 * 2] if impl == "tpu_prng" else [])
    want, by_hand = init_train_state(mlp), torch.Generator().manual_seed(33)
    for i in range(10):
        want = tstep.reference_train_step(want, x[i * 8:(i + 1) * 8], t[i * 8:(i + 1) * 8], cfg,
                                          opt, dropout_masks=_masks_by_hand(by_hand, cfg, 8))
    for a, b in zip(_tensors(got), _tensors(want)):
        assert torch.equal(a, b)
    assert got.step == want.step == 10
    assert torch.equal(gen.get_state(), by_hand.get_state())


@pytest.mark.parametrize("impl", ["tpu_prng", "threefry"])
def test_fused_chunk_draws_a_group_of_bunches_at_once(impl):
    x, t, cfg, mlp, opt = _tiny_chunk(10, impl=impl)
    gen = torch.Generator().manual_seed(34)
    got = make_fused_train_chunk(cfg, opt, bf16=False)(init_train_state(mlp), x, t, gen)
    want, by_hand = init_train_state(mlp), torch.Generator().manual_seed(34)
    for i in range(10):
        fused_train_step(want, x[i * 8:(i + 1) * 8], t[i * 8:(i + 1) * 8], cfg, opt,
                         dropout_masks=_masks_by_hand(by_hand, cfg, 8), bf16=False)
    for a, b in zip(_tensors(got), _tensors(want)):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), by_hand.get_state())
