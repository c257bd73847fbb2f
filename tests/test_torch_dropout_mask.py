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
