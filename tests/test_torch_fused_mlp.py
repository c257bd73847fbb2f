"""The fused layer kernels' plain versions (what the wrappers run on CPU
tensors) against the Pallas kernels of tpu_sednn.ops.fused_mlp in interpret
mode with bf16=False, as tests/test_pallas_ops.py runs them, both packages
pinned to float32 products: rtol/atol 1e-5 (float32 sums in another order).
tests/test_torch_tensor_core.py holds bf16=True.  Also ops/train_step.py's per-bunch step
against the JAX package's, and the source hashing of ops/_build.py."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
import tpu_sednn.ops.fused_mlp as jfm
import tpu_sednn.ops.train_step as jts
from tpu_sednn.train.step import OptConfig as JOpt, init_train_state as j_init
import tpu_sednn_torch.model as tm
import tpu_sednn_torch.ops.fused_mlp as tfm
import tpu_sednn_torch.ops.train_step as tts
from tpu_sednn_torch.ops import _build
from tpu_sednn_torch.ops.philox import philox_mask
from tpu_sednn_torch.train.step import OptConfig, init_train_state, reference_train_chunk

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["linear", "relu", "sigmoid"])
@pytest.mark.parametrize("shape", [(16, 256, 384), (8, 128, 128)])
def test_fused_linear_act_matches_pallas(act, shape):
    B, K, N = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    want = jfm.fused_linear_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act,
                                block_n=128, interpret=True, bf16=False)
    args = [torch.from_numpy(a) for a in (x, w, b)]
    got = tfm.fused_linear_act(*args, act=act, bf16=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, tfm.fused_linear_act_reference(*args, act=act, bf16=False))
    np.testing.assert_allclose(tfm.fused_linear_act_reference(*args, act=act, dtype=torch.float64,
                                                              bf16=False).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(16, 100, 37), (8, 1548 // 4, 129)])  # the port pads nothing
def test_fused_linear_act_unaligned_matches_jax(shape):
    B, K, N = shape
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    want = jfm.fused_linear_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act="relu",
                                interpret=True, bf16=False)
    got = tfm.fused_linear_act(*(torch.from_numpy(a) for a in (x, w, b)), act="relu", bf16=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_linear_act_masks():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((16, 40)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((40, 24)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    im, om = philox_mask(3, 16, 40, 0.1), philox_mask(4, 16, 24, 0.2)
    want = torch.relu((x * im / 0.9) @ w + b) * om
    # an explicit 0/1 tensor and the (key, omit) spec of the same stream agree
    for kw in (dict(in_mask=im, out_mask=om), dict(in_mask=(3, 0.1), out_mask=(4, 0.2))):
        got = tfm.fused_linear_act(x, w, b, "relu", in_scale=1 / 0.9, bf16=False, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tfm.fused_linear_act(x, w, b, "tanh")
    with pytest.raises(ValueError):
        tfm.fused_linear_act(x, w.T.contiguous(), b)


@pytest.mark.parametrize("shape", [(16, 256, 384), (8, 128, 256)])
def test_fused_bwd_update_matches_pallas(shape):
    B, K, N = shape
    rng = np.random.default_rng(2)
    arrs = dict(dedx=rng.standard_normal((B, N)), yprev=rng.standard_normal((B, K)),
                w=rng.standard_normal((K, N)) * 0.05, delta=rng.standard_normal((K, N)) * 0.01,
                b=rng.standard_normal(N) * 0.1, db=rng.standard_normal(N) * 0.01)
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    m, lr, inv_n, wc = 0.7, 0.4, 1.0 / B, 1e-3
    want = jfm.fused_bwd_update(*(jnp.asarray(arrs[k]) for k in ("dedx", "yprev", "w", "delta", "b", "db")),
                                jnp.float32(m), jnp.float32(lr), jnp.float32(inv_n), jnp.float32(wc),
                                block_k=128, block_n=128, interpret=True, bf16=False)
    t = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    pure = tfm.fused_bwd_update_reference(t["dedx"], t["yprev"], t["w"], t["delta"], t["b"], t["db"],
                                          m, lr, inv_n, wc, bf16=False)
    np.testing.assert_array_equal(t["w"].numpy(), arrs["w"])  # the plain version is pure
    got = tfm.fused_bwd_update(t["dedx"], t["yprev"], t["w"], t["delta"], t["b"], t["db"],
                               m, lr, inv_n, wc, bf16=False)
    # the wrapper updates W, delta, b, delta_b in place and hands them back
    assert got[0] is t["w"] and got[1] is t["delta"] and got[3] is t["b"] and got[4] is t["db"]
    for g, p, wnt in zip(got, pure, want):
        assert torch.equal(g, p)
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)
    # dedy uses W before the update
    np.testing.assert_allclose(got[2].numpy(), arrs["dedx"] @ arrs["w"].T, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("deriv", ["relu", "sigmoid"])
def test_fused_bwd_update_derivative_and_mask_options(deriv):
    rng = np.random.default_rng(3)
    B, K, N = 8, 20, 12
    dedx = torch.from_numpy(rng.standard_normal((B, N)).astype(np.float32))
    y = torch.from_numpy(rng.random((B, K)).astype(np.float32)) * philox_mask(5, B, K, 0.3)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    zeros = lambda *s: torch.zeros(*s)  # noqa: E731
    plain = tfm.fused_bwd_update_reference(dedx, y, w, zeros(K, N), zeros(N), zeros(N),
                                           0.5, 1.0, 1 / B, 0.0, bf16=False)
    fused = tfm.fused_bwd_update_reference(dedx, y, w, zeros(K, N), zeros(N), zeros(N),
                                           0.5, 1.0, 1 / B, 0.0, deriv=deriv, bf16=False)
    want = torch.where(y > 0, plain[2], torch.zeros(())) if deriv == "relu" else y * (1 - y) * plain[2]
    np.testing.assert_allclose(fused[2].numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    # in_mask masks y_prev on load: same as handing in the masked y_prev
    raw = torch.from_numpy(rng.random((B, K)).astype(np.float32))
    a = tfm.fused_bwd_update_reference(dedx, raw, w, zeros(K, N), zeros(N), zeros(N), 0.5, 1.0,
                                       1 / B, 0.0, in_mask=(5, 0.3), in_scale=2.0, bf16=False)
    b = tfm.fused_bwd_update_reference(dedx, raw * philox_mask(5, B, K, 0.3) * 2.0, w, zeros(K, N),
                                       zeros(N), zeros(N), 0.5, 1.0, 1 / B, 0.0, bf16=False)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tfm.fused_bwd_update(dedx, y, w.clone(), zeros(K, N), zeros(N), zeros(N), 0.5, 1.0, 1 / B,
                             0.0, in_mask=(5, 0.3), deriv=deriv)
    with pytest.raises(TypeError):
        tfm.fused_bwd_update(dedx.double(), y, w.clone(), zeros(K, N), zeros(N), zeros(N), 0.5, 1.0,
                             1 / B, 0.0)


def _padded(a: np.ndarray, shape) -> np.ndarray:
    """a in the corner of zeros of `shape` (the Pallas kernel tiles by 128)."""
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, n) for n in a.shape)] = a
    return out


@pytest.mark.parametrize("N", [129, 257])  # the 8 and 16 kHz heads' widths
@pytest.mark.parametrize("M", [128, 256, 512])  # where the card's stripes narrow: 64, 32, 16 rows
def test_f32_bwd_at_the_stripe_rows_matches_pallas(M, N):
    """fused_bwd_update and fused_bwd_grad_out with float32 products (the
    plain versions, which a CPU tensor takes) at the rows and widths of the
    card's stripe shapes, against the Pallas kernel in interpret mode on the
    same arrays zero-padded to its 128-multiples (the padding adds exact
    zeros).  The gradient-out form is read off a JAX update with m = 0, lr =
    1, inv_n = 1, wc = 0 and delta = 0: delta' = -G, delta_b' = -gb."""
    K = 100
    Kp, Np = 128, -(-N // 128) * 128
    rng = np.random.default_rng(M + N)
    arrs = dict(dedx=rng.standard_normal((M, N)) * 0.02,
                yprev=np.maximum(rng.standard_normal((M, K)), 0),
                w=rng.standard_normal((K, N)) * 0.05, delta=rng.standard_normal((K, N)) * 0.01,
                b=rng.standard_normal(N) * 0.1, db=rng.standard_normal(N) * 0.01)
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    shapes = dict(dedx=(M, Np), yprev=(M, Kp), w=(Kp, Np), delta=(Kp, Np), b=(Np,), db=(Np,))
    padded = {k: jnp.asarray(_padded(v, shapes[k])) for k, v in arrs.items()}
    names = ("dedx", "yprev", "w", "delta", "b", "db")
    cut = ((slice(K), slice(N)), (slice(K), slice(N)), (slice(M), slice(K)), (slice(N),),
           (slice(N),))

    def jax_bwd(delta, db, *hyp):
        out = jfm.fused_bwd_update(padded["dedx"], padded["yprev"], padded["w"], delta,
                                   padded["b"], db, *(jnp.float32(h) for h in hyp), block_k=128,
                                   block_n=128, interpret=True, bf16=False)
        return [np.asarray(a)[c] for a, c in zip(out, cut)]

    hyp = (0.7, 0.4, 1.0 / M, 1e-3)
    want = jax_bwd(padded["delta"], padded["db"], *hyp)
    t = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    got = tfm.fused_bwd_update(*(t[k] for k in names), *hyp, bf16=False)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt, **TOL)

    zeros = jnp.zeros_like(padded["delta"])
    _, neg_g, dedy, _, neg_gb = jax_bwd(zeros, jnp.zeros_like(padded["db"]), 0.0, 1.0, 1.0, 0.0)
    grad, dy = tfm.fused_bwd_grad_out(*(torch.from_numpy(arrs[k]) for k in ("dedx", "yprev", "w")),
                                      bf16=False)
    np.testing.assert_allclose(grad[:K * N].reshape(K, N).numpy(), -neg_g, **TOL)
    np.testing.assert_allclose(grad[K * N:].numpy(), -neg_gb, **TOL)
    np.testing.assert_allclose(dy.numpy(), dedy, **TOL)


# The float32 backward's decomposition on the card (csrc/fused_mlp.cuh:
# stripe_bwd_kernel<false, ...>), emulated in float32: a stripe of BK = 64, 32
# or 16 rows of W for up to 128, 256, 512 rows; N in chunks of BWD_BN columns, split into `split` ranges of whole
# chunks (a cluster's blocks); G's chunk summed row by row in 64 / BK groups,
# group q over rows q * s.. of each step of up to 128 rows (s = the step's
# rows / groups, rounded up), the groups added in order; dedy summed column by
# column within each chunk, the chunks' sums added in order within a range and
# the ranges' partials added in float64 and rounded once, then the derivative;
# gb summed row by row.  The kernel may pick any split from 1 to 8 (bwd_split: the card's
# occupancy).
BWD_BN = 64


def _f32_bwd_emulation(dedx, y_prev, w, split, bk, deriv=None):
    """-> (G, gb, dedy) as the float32 kernel sums them (FMA rounding aside)."""
    (M, N), K = dedx.shape, y_prev.shape[1]
    groups = 64 // bk
    g_parts = [torch.zeros(K, N) for _ in range(groups)]
    for j0 in range(0, M, 128):
        rows = min(128, M - j0)
        share = -(-rows // groups)
        for m in range(rows):
            g_parts[m // share] += y_prev[j0 + m][:, None] * dedx[j0 + m][None, :]
    g = g_parts[0]
    for part in g_parts[1:]:
        g = g + part
    n_chunks = -(-N // BWD_BN)
    per = -(-n_chunks // split)
    dedy = torch.zeros(M, K, dtype=torch.float64)
    for rank in range(split):
        part = torch.zeros(M, K)
        for c in range(rank * per, min(n_chunks, (rank + 1) * per)):
            chunk = torch.zeros(M, K)
            for n in range(c * BWD_BN, min(N, (c + 1) * BWD_BN)):
                chunk += dedx[:, n][:, None] * w[:, n][None, :]
            part = part + chunk
        dedy = dedy + part.double()
    dedy = dedy.float()
    if deriv == "relu":
        dedy = torch.where(y_prev > 0, dedy, torch.zeros(()))
    gb = torch.zeros(N)
    for m in range(M):
        gb = gb + dedx[m]
    return g, gb, dedy


@pytest.mark.parametrize("split", (1, 3, 8))
@pytest.mark.parametrize("M,bk", [(128, 64), (64, 64), (136, 32), (512, 16)])
def test_f32_bwd_sum_order_matches_float64_plain(M, bk, split):
    """The float32 kernel's order of sums against the port's float64 plain
    version, at each stripe width (rows past 128 come as further steps of a
    chunk), at the rtol/atol of the JAX comparisons."""
    K, N = 100, 257
    rng = np.random.default_rng(7)
    dedx = torch.from_numpy((rng.standard_normal((M, N)) * 0.02).astype(np.float32))
    y_prev = torch.from_numpy(np.maximum(rng.standard_normal((M, K)), 0).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.03).astype(np.float32))
    grad, dy = tfm.fused_bwd_grad_out_reference(dedx, y_prev, w, deriv="relu",
                                                dtype=torch.float64, bf16=False)
    g, gb, dedy = _f32_bwd_emulation(dedx, y_prev, w, split, bk, "relu")
    for got, want in ((g.reshape(-1), grad[:K * N]), (gb, grad[K * N:]), (dedy, dy)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# The float32 forward's order of sums on the card (csrc/fused_mlp.cuh:
# f32_fwd_kernel), which its redesign kept bit for bit from the two-launch form
# it replaced: K in the chunks of fwd_k_chunk (mirrored by _fwd_k_chunk; the
# DP forward plans them for the global tile's rows), each chunk's sum taken
# by one thread with fmaf for k ascending from 0.0f (emulated: the exact
# product plus the running sum in float64, rounded to float32 at each step),
# the chunks' sums added in order from 0.0f, then bias, activation and the
# next layer's mask.
def _fwd_k_chunk(M, K, N):
    """-> (chunk, n_chunks) as csrc/fused_mlp.cuh:fwd_k_chunk gives them."""
    tiles = -(-N // 64) * -(-M // 32)  # kFwdPlanBN, kFwdPlanBM
    want = min(max(-(-(4 * 132) // tiles), 1), 16)
    chunk = max(-(-(-(-K // want)) // 32) * 32, 32)  # whole steps of kFwdBK
    return chunk, (-(-K // chunk) if K > 0 else 1)


def _f32_fwd_emulation(x, w, b, act, plan_rows=None, in_mask=None, in_scale=1.0, out_mask=None,
                       out_scale=1.0):
    """-> y as the float32 kernel sums it (explicit 0/1 masks)."""
    (M, K), N = x.shape, w.shape[1]
    h = x if in_mask is None else x * (in_mask * in_scale)
    chunk, n_chunks = _fwd_k_chunk(plan_rows or M, K, N)
    h64, w64 = h.double(), w.double()
    s = torch.zeros(M, N)
    for c in range(n_chunks):
        acc = torch.zeros(M, N)
        for k in range(c * chunk, min(K, (c + 1) * chunk)):
            acc = (acc.double() + h64[:, k:k + 1] * w64[k:k + 1, :]).float()
        s = acc if n_chunks == 1 else s + acc
    y = tfm._act(act, s + b)
    return y if out_mask is None else y * (out_mask * out_scale)


@pytest.mark.parametrize("K,N", [(1548 // 4, 129), (384, 256)])  # 128-aligned: the Pallas kernel
@pytest.mark.parametrize("M", [8, 64, 128, 136, 512])
def test_f32_fwd_sum_order_matches_float64_plain_and_jax(M, K, N):
    """The float32 forward's chunked order of sums against the port's float64
    plain version and the JAX fused_linear_act (interpret mode where its
    shapes are 128-aligned, its XLA form elsewhere), at the JAX comparisons'
    rtol/atol; with masks (and a DP rank's rows planned for 128) against the
    float64 plain version."""
    rng = np.random.default_rng(M + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    want = jfm.fused_linear_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act="relu",
                                interpret=True, bf16=False)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    got = _f32_fwd_emulation(xt, wt, bt, "relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), tfm.fused_linear_act_reference(
        xt, wt, bt, "relu", dtype=torch.float64, bf16=False).numpy(), **TOL)
    im, om = philox_mask(3, M, K, 0.1), philox_mask(4, M, N, 0.2)
    kw = dict(in_mask=im, in_scale=1 / 0.9, out_mask=om, out_scale=1.25)
    want = tfm.fused_linear_act_reference(xt, wt, bt, "sigmoid", dtype=torch.float64, bf16=False,
                                          **kw)
    for plan_rows in (None, 128):
        got = _f32_fwd_emulation(xt, wt, bt, "sigmoid", plan_rows, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("K,N,n_chunks,chunk", [(1548, 2048, 5, 320), (2048, 2048, 5, 416),
                                                (3084, 2048, 5, 640), (2048, 129, 16, 128),
                                                (2048, 257, 16, 128)])
def test_f32_fwd_chunks_at_the_flagship_layers(K, N, n_chunks, chunk):
    """fwd_k_chunk's chunks at a bunch of 128 through the 8 and 16 kHz nets'
    layers (a cluster of f32_fwd_kernel is that many blocks, at most 16), the
    same for a DP rank's 64 rows planned for 128, and one chunk at a batch
    that fills the card's SMs alone."""
    assert _fwd_k_chunk(128, K, N) == (chunk, n_chunks)
    assert _fwd_k_chunk(-(-528 // -(-N // 64)) * 32, K, N)[1] == 1


def test_f32_fwd_chunk_mirror_matches_the_kernel_source():
    """_fwd_k_chunk's constants are the kernel's."""
    src = (Path(tfm.__file__).resolve().parent.parent / "csrc" / "fused_mlp.cuh").read_text()
    assert "constexpr int kFwdPlanBM = 32, kFwdPlanBN = 64, kFwdBK = 32;" in src
    body = src[src.index("inline int fwd_k_chunk("):]
    body = body[:body.index("\n}\n")]
    assert "int want = (4 * 132 + tiles - 1) / tiles;" in body
    assert "want = want < 1 ? 1 : (want > 16 ? 16 : want);" in body
    for gone in ("fwd_sum_kernel", "fwd_scratch_floats"):
        assert gone not in src


def test_bwd_rows_past_the_kernels_cap_are_refused():
    """Above BWD_MAX_ROWS a card tensor is refused before any launch (either
    product form); a CPU tensor takes any rows (the plain version)."""
    tfm._check_bwd_rows(tfm.BWD_MAX_ROWS)
    with pytest.raises(ValueError, match="at most 512 rows"):
        tfm._check_bwd_rows(tfm.BWD_MAX_ROWS + 1)
    M, K, N = tfm.BWD_MAX_ROWS + 8, 8, 12
    rng = np.random.default_rng(4)
    dedx, y = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((M, N), (M, K)))
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    grad, dy = tfm.fused_bwd_grad_out(dedx, y, w, bf16=False)
    torch.testing.assert_close(dy, dedx @ w.T)


def _params(sizes, seed=0):
    p = jm.init_params(jax.random.key(seed), jm.ModelConfig(layersizes=sizes), "glorot")
    return p, {"w": tuple(np.asarray(w) for w in p["w"]), "b": tuple(np.asarray(b) for b in p["b"])}


@pytest.mark.parametrize("hidden,output", [("relu", "linear"), ("sigmoid", "sigmoid")])
def test_fused_step_matches_pallas_step(hidden, output):
    sizes = (128, 256, 256, 128)
    jcfg = jm.ModelConfig(layersizes=sizes, hidden=hidden, output=output)
    tcfg = tm.ModelConfig(layersizes=sizes, hidden=hidden, output=output)
    opt = dict(lrate=0.5, momentum=0.6, weightcost=1e-4, bunchsize=16)
    p, pn = _params(sizes)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, sizes[0])).astype(np.float32)
    t = rng.standard_normal((16, sizes[-1])).astype(np.float32)
    jst = jts.pallas_train_step(j_init(p), jnp.asarray(x), jnp.asarray(t), jcfg, JOpt(**opt),
                                interpret=True, bf16=False)
    st0 = init_train_state(tm.params_from_jax(pn, device="cpu"))
    st = tts.pallas_train_step(st0, torch.from_numpy(x), torch.from_numpy(t), tcfg, OptConfig(**opt),
                               bf16=False)
    assert st is st0 and st.step == 1 and tts.pallas_train_step is tts.fused_train_step
    for l in range(len(sizes) - 1):
        np.testing.assert_allclose(st.params.w[l].numpy(), np.asarray(jst.params["w"][l]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st.deltas.b[l].numpy(), np.asarray(jst.deltas["b"][l]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hidden,output", [("relu", "linear"), ("sigmoid", "linear"),
                                           ("relu", "sigmoid")])
def test_fused_chunk_unaligned_sizes_match_pallas_chunk(hidden, output):
    sizes = (132, 256, 60)  # the JAX package zero-pads these; the port takes them as they are
    jcfg = jm.ModelConfig(layersizes=sizes, hidden=hidden, output=output)
    tcfg = tm.ModelConfig(layersizes=sizes, hidden=hidden, output=output)
    opt = dict(lrate=0.5, momentum=0.5, weightcost=0.0, bunchsize=16)
    p, pn = _params(sizes)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((52, sizes[0])).astype(np.float32)
    t = rng.standard_normal((52, sizes[-1])).astype(np.float32)
    jst = jts.make_pallas_train_chunk(jcfg, JOpt(**opt), interpret=True, bf16=False)(
        j_init(p), jnp.asarray(x), jnp.asarray(t), jax.random.key(1))
    st = tts.make_pallas_train_chunk(tcfg, OptConfig(**opt), bf16=False)(
        init_train_state(tm.params_from_jax(pn, device="cpu")), torch.from_numpy(x),
        torch.from_numpy(t), None)
    assert st.step == int(jst.step) == 3
    for l in range(len(sizes) - 1):
        np.testing.assert_allclose(st.params.w[l].numpy(), np.asarray(jst.params["w"][l]),
                                   rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(st.params.b[l].numpy(), np.asarray(jst.params["b"][l]),
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("mode", ["parity", "inverted"])
def test_fused_step_with_dropout_matches_plain_step(mode):
    """In parity mode the fused step is the plain step.  In inverted mode the
    fused step, like the TPU chunk kernel, takes the derivative on the stored
    masked-and-scaled activation and so leaves 1/(1-omit) out of the
    backward: it equals the plain step only where no hidden mask scales."""
    sizes = (39, 64, 64, 13)
    hid = 0.2 if mode == "parity" else 0.0
    tcfg = tm.ModelConfig(layersizes=sizes, dropout_vis=0.1, dropout_hid=hid, dropout_mode=mode)
    opt = OptConfig(lrate=0.5, momentum=0.6, weightcost=1e-4, bunchsize=16)
    _, pn = _params(sizes)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((32, sizes[0])).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((32, sizes[-1])).astype(np.float32))
    masks = [[philox_mask(10 * i + l, 16, sizes[l], 0.1 if l == 0 else 0.2) for l in range(3)]
             for i in range(2)]
    a = init_train_state(tm.params_from_jax(pn, device="cpu"))
    for i in range(2):
        tts.fused_train_step(a, x[16 * i:16 * i + 16], t[16 * i:16 * i + 16], tcfg, opt,
                             dropout_masks=masks[i], bf16=False)
    b = reference_train_chunk(init_train_state(tm.params_from_jax(pn, device="cpu")), x, t, tcfg,
                              opt, dropout_masks=masks)
    for u, v in zip(list(a.params.w) + list(a.deltas.b), list(b.params.w) + list(b.deltas.b)):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=2e-5, atol=2e-6)
    with pytest.raises(ValueError, match="generator or explicit masks"):
        tts.fused_train_step(a, x[:16], t[:16], tcfg, opt)


def test_kernel_library_hash_covers_included_headers(tmp_path, monkeypatch):
    names = {p.name for p in _build.source_files("resident_chunk")}
    headers = {"fused_mlp.cuh", "mma_bf16.cuh", "pdl.cuh", "philox.cuh", "sr_round.cuh",
               "vec4.cuh"}
    assert names == {"resident_chunk.cu"} | headers
    assert {p.name for p in _build.source_files("fused_mlp")} == {"fused_mlp.cu"} | headers
    assert [p.name for p in _build.source_files("stft_lps")] == ["stft_lps.cu"]
    # editing a header alone moves every library that includes it, and no other
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _build.SRC_DIR.iterdir():
        (src / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "SRC_DIR", src)
    before = {n: _build.library_path(n).name for n in ("stft_lps", "fused_mlp", "resident_chunk")}
    (src / "philox.cuh").write_text((src / "philox.cuh").read_text() + "\n// edited\n")
    after = {n: _build.library_path(n).name for n in before}
    assert after["stft_lps"] == before["stft_lps"]
    assert after["fused_mlp"] != before["fused_mlp"]
    assert after["resident_chunk"] != before["resident_chunk"]
