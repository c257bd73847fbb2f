"""Port MLP against tpu_sednn.model on the CPU: the same weights (made by the
JAX package's init or by numpy) give the same eval forward, fold and .wts
files.  Tolerance rtol/atol 1e-5: fp32 matmuls summed in another order."""

import jax
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
from tpu_sednn.io.wts import load_wts as j_load_wts
from tpu_sednn.io.wts import save_wts as j_save_wts
import tpu_sednn_torch.model as tm
from tpu_sednn_torch.io import load_wts, save_wts

SIZES = (132, 64, 64, 33)


def _jax_params(cfg, seed=0):
    p = jm.init_params(jax.random.key(seed), cfg, scheme="glorot")
    return {"w": tuple(np.asarray(w) for w in p["w"]),
            "b": tuple(np.asarray(b) + 0.01 * i for i, b in enumerate(p["b"]))}


def _x(n=37, seed=1):
    return np.random.default_rng(seed).standard_normal((n, SIZES[0])).astype(np.float32)


@pytest.mark.parametrize("hidden", ["relu", "sigmoid"])
@pytest.mark.parametrize("output", ["linear", "sigmoid"])
@pytest.mark.parametrize("dropout", [(0.0, 0.0), (0.1, 0.2)])
def test_forward_eval_matches_jax(hidden, output, dropout):
    jcfg = jm.ModelConfig(layersizes=SIZES, hidden=hidden, output=output,
                          dropout_vis=dropout[0], dropout_hid=dropout[1])
    tcfg = tm.ModelConfig(layersizes=SIZES, hidden=hidden, output=output,
                          dropout_vis=dropout[0], dropout_hid=dropout[1])
    p = _jax_params(jcfg)
    x = _x()
    want = np.asarray(jm.forward_eval(jax.tree.map(jax.numpy.asarray, p), x, jcfg))
    mlp = tm.params_from_jax(p, device="cpu")
    got = tm.forward_eval(mlp, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # module call and a leading batch dim give the same rows
    np.testing.assert_allclose(mlp(torch.from_numpy(x[None]), tcfg)[0].numpy(), got,
                               rtol=1e-6, atol=1e-6)
    # parity fold: same output, dropout-free config, the caller's module untouched
    folded, fcfg = tm.fold_eval_params(mlp, tcfg)
    assert not fcfg.use_dropout
    np.testing.assert_allclose(tm.forward_eval(folded, torch.from_numpy(x), fcfg).numpy(),
                               got, rtol=1e-5, atol=1e-6)
    jf, _ = jm.fold_eval_params(jax.tree.map(jax.numpy.asarray, p), jcfg)
    for a, b in zip(tm.params_to_numpy(folded)["w"], jf["w"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tm.params_to_numpy(mlp)["w"], p["w"]):
        np.testing.assert_array_equal(a, b)


def test_params_round_trip_and_wts_interop(tmp_path):
    cfg = jm.ModelConfig(layersizes=SIZES)
    p = _jax_params(cfg, seed=3)
    mlp = tm.params_from_jax(p, device="cpu")
    assert mlp.layersizes == SIZES
    back = tm.params_to_numpy(mlp)
    for a, b in zip(back["w"] + back["b"], p["w"] + p["b"]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # .wts written by the port reads into the JAX package and back, bit for bit
    path = str(tmp_path / "m.wts")
    save_wts(path, *tm.params_to_wts(mlp))
    jw, jb = j_load_wts(path, layersizes=SIZES)
    for a, b in zip(jw + jb, list(p["w"]) + list(p["b"])):
        np.testing.assert_array_equal(a, b)
    j_save_wts(str(tmp_path / "j.wts"), jw, jb)
    assert (tmp_path / "j.wts").read_bytes() == (tmp_path / "m.wts").read_bytes()
    mlp2 = tm.params_from_wts(*load_wts(path), device="cpu")
    for a, b in zip(list(mlp2.w) + list(mlp2.b), list(mlp.w) + list(mlp.b)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scheme", ["glorot", "fanin", "uniform"])
def test_init_params_schemes(scheme):
    cfg = tm.ModelConfig(layersizes=SIZES)
    a = tm.init_params(torch.Generator().manual_seed(5), cfg, scheme=scheme, device="cpu",
                       b_range=(-0.5, 0.5))
    b = tm.init_params(torch.Generator().manual_seed(5), cfg, scheme=scheme, device="cpu",
                       b_range=(-0.5, 0.5))
    assert a.layersizes == SIZES
    for l, (w, bias) in enumerate(zip(a.w, a.b)):
        n_in, n_out = SIZES[l], SIZES[l + 1]
        assert w.shape == (n_in, n_out) and w.dtype == torch.float32
        r = {"glorot": np.sqrt(6.0 / (n_in + n_out)), "fanin": 1.0 / np.sqrt(n_in),
             "uniform": 0.1}[scheme]
        assert float(w.abs().max()) <= r and float(w.abs().max()) > 0.8 * r
        if scheme == "uniform":
            assert float(bias.abs().max()) <= 0.5 and float(bias.abs().max()) > 0
        else:
            assert not bias.any()
        assert torch.equal(w, b.w[l])  # same seed, same weights
    with pytest.raises(ValueError):
        tm.init_params(torch.Generator(), cfg, scheme="nope", device="cpu")


def test_mlp_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        tm.MLP([torch.zeros(4, 3)], [torch.zeros(4)])
    with pytest.raises(ValueError):
        tm.MLP([torch.zeros(4, 3)], [])


def test_forward_with_bf16_products_matches_jax():
    """compute_dtype=bfloat16: operands rounded to bfloat16, products summed
    in float32, in both packages; rounded operands multiply exactly in
    float32, so only the summation order differs (rtol/atol 1e-5)."""
    jcfg, tcfg = jm.ModelConfig(layersizes=SIZES), tm.ModelConfig(layersizes=SIZES)
    p = _jax_params(jcfg, seed=5)
    x = _x(seed=6)
    want = np.asarray(jm.forward(jax.tree.map(jax.numpy.asarray, p), x, jcfg, train=True,
                                 compute_dtype=jax.numpy.bfloat16))
    mlp = tm.params_from_jax(p, device="cpu")
    got = tm.forward(mlp, torch.from_numpy(x), tcfg, train=True, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    full = tm.forward(mlp, torch.from_numpy(x), tcfg, train=True).numpy()
    assert 1e-4 < np.abs(got.numpy() - full).max() < 5e-2  # it did round the operands
    ev = tm.forward_eval(mlp, torch.from_numpy(x), tcfg, compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_array_equal(ev, got.numpy())  # no dropout: train and eval agree


def test_mlp_keeps_bfloat16_leaves_and_eval_widens_them():
    cfg = tm.ModelConfig(layersizes=SIZES, dropout_vis=0.1, dropout_hid=0.2)
    mlp = tm.params_from_jax(_jax_params(jm.ModelConfig(layersizes=SIZES)), device="cpu")
    half = tm.MLP([w.data.bfloat16() for w in mlp.w], list(mlp.b))
    assert half.w[0].dtype == torch.bfloat16 and half.b[0].dtype == torch.float32
    assert tm.MLP([w.data.double() for w in mlp.w], list(mlp.b)).w[0].dtype == torch.float32
    x = torch.from_numpy(_x())
    got = tm.forward_eval(half, x, cfg)
    assert got.dtype == torch.float32
    # as the JAX package evaluates a bfloat16 weight: scaled in bfloat16, then widened
    jp = {"w": tuple(jax.numpy.asarray(tm.params_to_numpy(half)["w"][l], jax.numpy.bfloat16)
                     for l in range(3)),
          "b": tuple(jax.numpy.asarray(b.numpy()) for b in mlp.b)}
    want = np.asarray(jm.forward_eval(jp, x.numpy(), jm.ModelConfig(
        layersizes=SIZES, dropout_vis=0.1, dropout_hid=0.2, precision="highest")), np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
