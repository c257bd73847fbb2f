"""The port's stochastic-rounding update (ops/sr_update.py, ops/philox.py) on
the CPU, where the wrappers run their plain versions, against
tpu_sednn.ops.sr_update on the same numpy-seeded inputs.

Off the TPU the JAX function rounds to nearest; the port rounds
stochastically everywhere.  Both round the same float32 value (one float32
operation at a time in both), so every element is within one bfloat16 ulp,
and an element whose float32 value bfloat16 holds exactly is equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
from tpu_sednn.ops.sr_update import sr_momentum_update as j_sr_update
import tpu_sednn_torch.model as tm
from tpu_sednn_torch.model.convert import params_from_jax, params_to_numpy
from tpu_sednn_torch.ops.philox import (SR_DELTA_SHIFT, SR_TAG, SR_WEIGHT_SHIFT, philox4x32_10,
                                        sr_bits, sr_to_bf16_reference)
from tpu_sednn_torch.ops.sr_update import (sr_momentum_update, sr_momentum_update_reference,
                                           sr_round_on_device, sr_train_step)
from tpu_sednn_torch.train.step import OptConfig, TrainState, cv_squared_error, init_train_state


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _to_jax_bf16(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)  # float32 holds bfloat16 exactly


def _ulp_bf16(v: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


@pytest.mark.parametrize("shape", [(64, 128), (600, 37), (129,)])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_update_within_one_ulp_of_jax(shape, g_dtype):
    rng = np.random.default_rng(0)
    w = _bf16(rng.standard_normal(shape) * 0.1)
    d = _bf16(rng.standard_normal(shape) * 1e-3)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.01).to(g_dtype)
    before = sr_momentum_update.launches
    w2, d2 = sr_momentum_update(w, d, g, 11, 0.9, 0.1, 1e-3)
    assert sr_momentum_update.launches == before  # a CPU tensor launches no kernel
    assert w2.dtype == d2.dtype == torch.bfloat16 and w2.shape == w.shape
    jg = _to_jax_bf16(g) if g_dtype == torch.bfloat16 else jnp.asarray(g.numpy())
    jw, jd = j_sr_update(_to_jax_bf16(w), _to_jax_bf16(d), jg, jnp.int32(11), jnp.float32(0.9),
                         jnp.float32(0.1), jnp.float32(1e-3))
    for got, want in ((w2, jw), (d2, jd)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert np.all(np.abs(got - want) <= _ulp_bf16(want))  # stochastic vs nearest: one ulp
    assert torch.equal(w2, sr_momentum_update_reference(w, d, g, 11, 0.9, 0.1, 1e-3)[0])
    # deterministic in the seed, another rounding for another seed
    assert torch.equal(d2, sr_momentum_update(w, d, g, 11, 0.9, 0.1, 1e-3)[1])
    if len(shape) == 2:
        assert not torch.equal(d2, sr_momentum_update(w, d, g, 12, 0.9, 0.1, 1e-3)[1])


def test_update_exact_when_nothing_is_dropped():
    rng = np.random.default_rng(1)
    w = _bf16(rng.standard_normal((40, 24)) * 0.1)
    d = _bf16(rng.standard_normal((40, 24)) * 1e-3)
    zero = torch.zeros(40, 24)
    w2, d2 = sr_momentum_update(w, d, zero, 5, 0.0, 0.1, 0.0)  # g = 0, m = 0: nd = 0
    jw, jd = j_sr_update(_to_jax_bf16(w), _to_jax_bf16(d), jnp.zeros((40, 24)), jnp.int32(5),
                         jnp.float32(0.0), jnp.float32(0.1), jnp.float32(0.0))
    np.testing.assert_array_equal(w2.float().numpy(), np.asarray(jw, np.float32))
    np.testing.assert_array_equal(d2.float().numpy(), np.asarray(jd, np.float32))
    assert torch.equal(w2, w) and not d2.any()


def test_update_mean_tracks_the_float32_update():
    """Tiny updates survive: over many elements the mean of w' - w equals the
    mean float32 step, where nearest rounding would drop it entirely."""
    w = torch.full((256, 256), 1.0, dtype=torch.bfloat16)
    d = torch.zeros_like(w)
    g = torch.full((256, 256), 1.0)
    step = 2.0 ** -7 * 0.05  # a twentieth of an ulp of 1.0
    w2, _ = sr_momentum_update(w, d, g, 3, 0.0, step, 0.0)
    moved = float((w2.float() - 1.0).mean())
    sigma = 2.0 ** -8 * np.sqrt(0.1 * 0.9 / w.numel())  # below 1.0 the spacing is 2^-8
    assert abs(moved + step) <= 4 * sigma
    jw, _ = j_sr_update(_to_jax_bf16(w), _to_jax_bf16(d), jnp.asarray(g.numpy()), jnp.int32(3),
                        jnp.float32(0.0), jnp.float32(step), jnp.float32(0.0))
    assert float(np.asarray(jw, np.float32).mean()) == 1.0  # nearest rounding loses the step


def test_row_blocks_are_streams_of_their_own():
    rng = np.random.default_rng(2)
    w = _bf16(rng.standard_normal((1100, 12)) * 0.1)
    d = _bf16(rng.standard_normal((1100, 12)) * 1e-3)
    g = torch.from_numpy(rng.standard_normal((1100, 12)).astype(np.float32) * 0.01)
    w2, d2 = sr_momentum_update(w, d, g, 40, 0.9, 0.1, 0.0)
    for blk, r0 in ((1, 512), (2, 1024)):
        wb, db = sr_momentum_update(w[r0:r0 + 512], d[r0:r0 + 512], g[r0:r0 + 512], 40 + 7919 * blk,
                                    0.9, 0.1, 0.0)
        assert torch.equal(wb, w2[r0:r0 + 512]) and torch.equal(db, d2[r0:r0 + 512])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    w = torch.zeros(4, 4, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        sr_momentum_update(w.float(), w, w, 0, 0.9, 0.1, 0.0)
    with pytest.raises(TypeError, match="g must be"):
        sr_momentum_update(w, w, w.double(), 0, 0.9, 0.1, 0.0)
    with pytest.raises(ValueError, match="shapes"):
        sr_momentum_update(w, w[:2], w, 0, 0.9, 0.1, 0.0)
    with pytest.raises(TypeError, match="block_rows"):  # the TPU kernel's layout knob is gone
        sr_momentum_update(w, w, w, 0, 0.9, 0.1, 0.0, block_rows=256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sr_round_on_device(torch.zeros(2, 2))


# ---------------------------------------------------------------------------
# the plain rounding function
# ---------------------------------------------------------------------------

def test_sr_exact_on_representable_values_whatever_the_bits():
    vals = torch.tensor([0.0, -0.0, 1.0, -1.5, 0.0078125, 3.3895313892515355e38, 2.0 ** -133,
                         float("inf"), -float("inf")])
    for bits in (0, 0x1234, 0xFFFF, 0xFFFF0000 + 77):
        out = sr_to_bf16_reference(vals, torch.full(vals.shape, bits, dtype=torch.int64))
        assert out.dtype == torch.bfloat16 and torch.equal(out.float(), vals)
        assert torch.equal(torch.signbit(out.float()), torch.signbit(vals))
    nan = sr_to_bf16_reference(torch.tensor([float("nan")]), torch.tensor([0xFFFF]))
    assert bool(torch.isnan(nan.float()).all())
    # a NaN whose payload is in the low half only stays a NaN
    low_nan = torch.tensor([0x7F800001], dtype=torch.int32).view(torch.float32)
    assert bool(torch.isnan(sr_to_bf16_reference(low_nan, torch.tensor([0])).float()).all())
    with pytest.raises(TypeError):
        sr_to_bf16_reference(vals.double(), torch.zeros(vals.shape, dtype=torch.int64))


def test_sr_rounds_up_with_probability_of_the_dropped_fraction():
    lo, hi = 1.0, 1.0 + 2.0 ** -7
    for frac in (0.25, 0.5, 0.875):
        v = torch.full((1,), lo + frac * (hi - lo))
        threshold = int((1.0 - frac) * 65536)  # bits at or above it carry into the kept half
        assert float(sr_to_bf16_reference(v, torch.tensor([threshold - 1])).float()) == lo
        assert float(sr_to_bf16_reference(v, torch.tensor([threshold])).float()) == hi
    # negative values move away from zero
    assert float(sr_to_bf16_reference(torch.tensor([-1.001]), torch.tensor([0xFFFF])).float()) \
        == -(1.0 + 2.0 ** -7)


def test_sr_unbiased_mean():
    ulp, p, shape = 2.0 ** -7, 0.3, (64, 128)
    const = torch.full(shape, 1.0 + p * ulp)
    for shift in (SR_DELTA_SHIFT, SR_WEIGHT_SHIFT):
        out = sr_to_bf16_reference(const, sr_bits(7, *shape, shift))
        assert set(out.float().unique().tolist()) == {1.0, 1.0 + ulp}
        sigma = ulp * np.sqrt(p * (1 - p) / const.numel())
        assert abs(float(out.double().mean()) - float(const[0, 0])) <= 4 * sigma
    nearest = const.to(torch.bfloat16).double().mean()
    assert abs(float(nearest) - float(const[0, 0])) > 10 * sigma


def test_sr_carry_runs_into_the_exponent():
    below_two = torch.tensor([2.0 - 2.0 ** -20])  # kept mantissa all ones
    assert float(sr_to_bf16_reference(below_two, torch.tensor([0xFFFF])).float()) == 2.0
    assert float(sr_to_bf16_reference(below_two, torch.tensor([0])).float()) == 2.0 - 2.0 ** -7
    top = torch.tensor([3.4e38])  # above the largest bfloat16: up is Inf
    assert float(sr_to_bf16_reference(top, torch.tensor([0xFFFF])).float()) == float("inf")
    assert float(sr_to_bf16_reference(top, torch.tensor([0])).float()) == 3.3895313892515355e38


def test_sr_bits_layout_and_bit_pattern_helpers():
    words = sr_bits(123, 5, 10, SR_DELTA_SHIFT) | (sr_bits(123, 5, 10, SR_WEIGHT_SHIFT) << 16)
    for r, c in ((0, 0), (3, 6), (4, 9)):
        assert int(words[r, c]) == int(philox4x32_10((c // 4, r, 0, 0), (123, SR_TAG))[c % 4])
    assert int(sr_bits(123, 5, 10).max()) < 2 ** 16
    # bfloat16 leaves cross model/convert.py with their patterns: out as float32, in as bfloat16
    t = torch.tensor([[1.0, -2.5, 0.0078125]], dtype=torch.bfloat16)
    out = params_to_numpy(tm.MLP([t], [t[0]]))["w"][0]
    assert out.dtype == np.float32
    leaf = np.asarray(jnp.asarray(out, jnp.bfloat16))
    assert leaf.view(np.uint16).tolist() == [[0x3F80, 0xC020, 0x3C00]]
    back = params_from_jax({"w": (leaf,), "b": (leaf[0],)}, device="cpu")
    assert back.w[0].dtype == torch.bfloat16 and torch.equal(back.w[0], t)


# ---------------------------------------------------------------------------
# sr_train_step
# ---------------------------------------------------------------------------

def test_bf16_sr_training_learns():
    """The gate of tests/test_sr_update.py: bfloat16 state, 13 epochs of 16
    steps, the mean loss halves and the CV error is small."""
    sizes = (24, 128, 8)
    cfg = tm.ModelConfig(layersizes=sizes, dropout_mode="inverted")
    opt = OptConfig(lrate=0.02, momentum=0.9, weightcost=0.0, bunchsize=64)
    p = jm.init_params(jax.random.key(0), jm.ModelConfig(layersizes=sizes), "glorot")
    st = init_train_state(tm.params_from_jax(jax.tree.map(np.asarray, p), device="cpu"))
    st = TrainState(params=tm.MLP([w.data.bfloat16() for w in st.params.w],
                                  [b.data.bfloat16() for b in st.params.b]),
                    deltas=tm.MLP([d.data.bfloat16() for d in st.deltas.w],
                                  [d.data.bfloat16() for d in st.deltas.b]), step=0)
    rng = np.random.default_rng(1)
    proj = rng.standard_normal((sizes[0], sizes[-1])).astype(np.float32) * 0.4
    x = rng.standard_normal((1024, sizes[0])).astype(np.float32)
    t = np.tanh(x @ proj)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)

    def epoch(st, e, seed):
        perm = np.random.default_rng(100 + e).permutation(1024).reshape(-1, 64)
        losses = []
        for idx in perm:
            st, loss = sr_train_step(st, xt[idx], tt[idx], cfg, opt, None, seed)
            seed += 100
            losses.append(float(loss))
        return st, float(np.mean(losses))

    st, l0 = epoch(st, 0, 0)
    for e in range(12):
        st, l1 = epoch(st, 1 + e, 1000 * e)
    assert l1 < 0.5 * l0, (l0, l1)
    assert st.step == 13 * 16
    assert all(a.dtype == torch.bfloat16 for a in list(st.params.w) + list(st.params.b)
               + list(st.deltas.w) + list(st.deltas.b))
    assert float(cv_squared_error(st.params, xt, tt, cfg)) / 1024 < 1.0  # bfloat16 params widen
