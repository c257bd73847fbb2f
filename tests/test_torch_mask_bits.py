"""The chunk trainer's input-mask table (ops/resident_chunk.py:input_mask_bits
and its plain version): a call's input masks drawn once, 32 columns to a
32-bit word, one table a tile, which the layer-0 forward and backward read
(csrc/philox.cuh, mask mode 3) instead of drawing Philox bits themselves.

Held here, on the CPU: the table unpacks bit for bit to the masks the trainer
drew before it (sample_resident_masks_reference) under the JAX package's key
formula and threshold (tpu_sednn/ops/resident_chunk.py: seed + gi *
_BUNCH_STRIDE, _mask_threshold); a model of mode 3's read equals mode 2's
draw at every column a thread reads; the layer wrappers given a table equal
the same wrappers given the Philox spec, and the JAX package's Pallas layer
kernels (interpret mode, float32 products) on the masked input within their
1e-5; a chunk stepped through the wrappers with the tables, as the card runs
it, matches the JAX package's reference_train_step fed the same masks
(rtol 2e-5 / atol 2e-6, the JAX package's tolerance for its chunk trainer)
and the port's plain chunk trainer.  The kernel itself runs only on the card
(chip_smoke.py's [kernel] philox lines)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
import tpu_sednn.ops.fused_mlp as jfm
from tpu_sednn.ops.resident_chunk import (_BUNCH_STRIDE as J_BUNCH_STRIDE,
                                          _LAYER_STRIDE as J_LAYER_STRIDE,
                                          _mask_threshold as j_mask_threshold)
from tpu_sednn.train.step import (OptConfig as JOpt, TrainState as JState,
                                  reference_train_step as j_train_step)
import tpu_sednn_torch.model as tm
import tpu_sednn_torch.ops.fused_mlp as tfm
import tpu_sednn_torch.ops.resident_chunk as rc
from tpu_sednn_torch.ops.philox import (mask_words, pack_mask_words, philox_bits, philox_mask,
                                        unpack_mask_words)
from tpu_sednn_torch.train.step import OptConfig, init_train_state

SEED = 2**31 - 5  # seed + gi * 7919 wraps past 2**31: keys are sums mod 2**32
TILE = 16
N_REAL = 3
FWD_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_fused_mlp.py's, against the Pallas kernels
CHUNK_TOL = dict(rtol=2e-5, atol=2e-6)  # the JAX package's for its chunk trainer


def _jax_keep(gi: int, rows: int, cols: int, omit: float) -> torch.Tensor:
    """The keep decisions of tile gi's input mask, from the JAX package's key
    formula and threshold and the port's Philox words."""
    key = (SEED + gi * J_BUNCH_STRIDE) & 0xFFFFFFFF
    return philox_bits(key, rows, cols) >= j_mask_threshold(omit)


@pytest.mark.parametrize("omit", [0.1, 0.5])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("K", [1548, 3084, 129, 33])
def test_table_unpacks_to_the_trainers_input_masks(K, accum, omit):
    n_tiles = N_REAL * accum
    table = rc.input_mask_bits(SEED, n_tiles, TILE, K, omit, device="cpu")
    assert table.dtype == torch.int32 and table.shape == (n_tiles, TILE, mask_words(K))
    assert torch.equal(table, rc.input_mask_bits_reference(SEED, n_tiles, TILE, K, omit))
    for gi in range(n_tiles):
        mask = unpack_mask_words(table[gi], K)
        assert torch.equal(mask, rc.sample_resident_masks_reference(SEED, gi, 0, (TILE, K), omit))
        assert torch.equal(mask, _jax_keep(gi, TILE, K, omit).to(torch.float32))
    if K % 32:  # the columns past K read 0
        assert not bool(((table[..., -1].to(torch.int64) & 0xFFFFFFFF) >> (K % 32)).any())
    zeros = 1.0 - float(unpack_mask_words(table.reshape(-1, mask_words(K)), K).mean())
    n = n_tiles * TILE * K
    assert abs(zeros - omit) <= 4.0 * np.sqrt(omit * (1.0 - omit) / n)
    # every tile its own stream
    assert len({table[gi].numpy().tobytes() for gi in range(n_tiles)}) == n_tiles


@pytest.mark.parametrize("K", [1548, 129, 33, 5])
def test_mode3_read_equals_mode2_draw_at_every_thread_column(K):
    """csrc/philox.cuh:mask4 on a float4 of columns col..col+3 (col % 4 ==
    0): mode 2 keeps column col + j where word j of philox(counter (col / 4,
    row)) >= threshold; mode 3 takes bits (col & 31) + j of word col >> 5 of
    the row's table; both drop columns at or past K."""
    omit, rows = 0.3, 8
    key = (SEED + 5 * J_BUNCH_STRIDE) & 0xFFFFFFFF
    table = rc.input_mask_bits_reference(SEED, 6, rows, K, omit)[5].to(torch.int64) & 0xFFFFFFFF
    words = philox_bits(key, rows, 4 * ((K + 3) // 4))  # the four words of each call
    thr = j_mask_threshold(omit)
    for col in range(0, K, 4):
        word = table[:, col >> 5] >> (col & 31)
        for j in range(4):
            mode3 = ((word >> j) & 1).bool() & (col + j < K)
            mode2 = (words[:, col + j] >= thr) & (col + j < K)
            assert torch.equal(mode3, mode2), (col, j)


def test_pack_and_unpack_are_inverse():
    rng = np.random.default_rng(9)
    for cols in (1, 31, 32, 33, 100):
        keep = torch.from_numpy(rng.random((5, cols)) < 0.5)
        table = pack_mask_words(keep)
        assert table.shape == (5, mask_words(cols)) and table.dtype == torch.int32
        assert torch.equal(unpack_mask_words(table, cols), keep.to(torch.float32))


@pytest.mark.parametrize("K", [129, 33])
def test_layer_wrappers_read_a_table_as_they_draw_philox(K):
    B, N, omit = 16, 40, 0.2
    rng = np.random.default_rng(K)
    x = rng.standard_normal((B, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    dedx = rng.standard_normal((B, N)).astype(np.float32)
    table = rc.input_mask_bits(SEED, 1, B, K, omit, device="cpu")[0]
    key = rc.mask_key(SEED, 0, 0)
    mask = philox_mask(key, B, K, omit).numpy()
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    y_tab = tfm.fused_linear_act(tx, tw, tb, "relu", in_mask=table, in_scale=1.25, bf16=False)
    y_phi = tfm.fused_linear_act(tx, tw, tb, "relu", in_mask=(key, omit), in_scale=1.25, bf16=False)
    assert torch.equal(y_tab, y_phi)
    want = jfm.fused_linear_act(jnp.asarray(x * mask * np.float32(1.25)), jnp.asarray(w),
                                jnp.asarray(b), act="relu", interpret=True, bf16=False)
    np.testing.assert_allclose(y_tab.numpy(), np.asarray(want), **FWD_TOL)
    got = []
    for m in (table, (key, omit)):
        state = [torch.from_numpy(a.copy()) for a in (w, np.zeros_like(w), b, np.zeros_like(b))]
        got.append(tfm.fused_bwd_update(torch.from_numpy(dedx), tx, *state, 0.5, 0.4, 1.0 / B,
                                        1e-3, in_mask=m, bf16=False))
    for u, v in zip(*got):
        assert torch.equal(u, v)
    with pytest.raises(ValueError):  # a table has ceil(K / 32) words a row
        tfm.fused_linear_act(tx, tw, tb, in_mask=table[:, :-1].contiguous(), bf16=False)
    with pytest.raises(ValueError):  # a table masks the input only
        tfm.fused_linear_act(tx, tw, tb, out_mask=table, bf16=False)


def _chunk_through_the_tables(cfg, opt, params, x, t, table):
    """The card's path of a chunk-trainer call (csrc/resident_chunk.cu:
    train_chunk) stepped through the layer wrappers on the CPU: bunch i's
    layer-0 forward and backward read table[i], each hidden layer's mask is
    drawn in the forward before it, dedx = 2/bunch (out - t)."""
    ws, bs = [w.clone() for w in params.w], [b.clone() for b in params.b]
    ds, dbs = [torch.zeros_like(w) for w in ws], [torch.zeros_like(b) for b in bs]
    L, n = len(ws), opt.bunchsize
    for i in range(x.shape[0] // n):
        xi, ti = x[i * n:(i + 1) * n], t[i * n:(i + 1) * n]
        ys, h = [], xi
        for l in range(L):
            ys.append(h)
            out_mask = (rc.mask_key(SEED, i, l + 1), cfg.dropout_hid) if l < L - 1 else None
            h = tfm.fused_linear_act(h, ws[l], bs[l], cfg.hidden if l < L - 1 else cfg.output,
                                     in_mask=table[i] if l == 0 else None, out_mask=out_mask,
                                     bf16=False)
        dedx = (2.0 / n) * (h - ti)
        for l in range(L - 1, -1, -1):
            _, _, dedx, _, _ = tfm.fused_bwd_update(
                dedx, ys[l], ws[l], ds[l], bs[l], dbs[l], opt.momentum, opt.lrate, 1.0 / n,
                opt.weightcost, in_mask=table[i] if l == 0 else None,
                deriv=cfg.hidden if l > 0 else None, bf16=False)
    return ws, bs, ds, dbs


@pytest.mark.parametrize("sizes", [(33, 24, 16, 8), (129, 40, 17)])
def test_a_chunk_through_the_tables_matches_jax(sizes):
    rng = np.random.default_rng(len(sizes))
    kw = dict(layersizes=sizes, dropout_vis=0.1, dropout_hid=0.2)
    opt = dict(lrate=0.5, momentum=0.6, weightcost=1e-4, bunchsize=TILE)
    p = jm.init_params(jax.random.key(1), jm.ModelConfig(layersizes=sizes), "glorot")
    pn = {"w": tuple(np.asarray(w) for w in p["w"]), "b": tuple(np.asarray(b) for b in p["b"])}
    x = rng.standard_normal((N_REAL * TILE, sizes[0])).astype(np.float32)
    t = rng.standard_normal((N_REAL * TILE, sizes[-1])).astype(np.float32)
    cfg, topt = tm.ModelConfig(**kw), OptConfig(**opt)
    mlp = tm.params_from_jax(pn, device="cpu")
    table = rc.input_mask_bits(SEED, N_REAL, TILE, sizes[0], cfg.dropout_vis, device="cpu")
    got = _chunk_through_the_tables(cfg, topt, mlp, torch.from_numpy(x), torch.from_numpy(t),
                                    table)
    # the JAX package's per-bunch reference step, fed the same masks
    L = len(sizes) - 1
    zeros = lambda a: tuple(jnp.zeros_like(v) for v in a)  # noqa: E731
    jst = JState(params={"w": tuple(jnp.asarray(w) for w in pn["w"]),
                         "b": tuple(jnp.asarray(b) for b in pn["b"])},
                 deltas={"w": zeros(pn["w"]), "b": zeros(pn["b"])}, step=0)
    for i in range(N_REAL):
        masks = [jnp.asarray(unpack_mask_words(table[i], sizes[0]).numpy())]
        for l in range(1, L):
            key = (SEED + i * J_BUNCH_STRIDE + l * J_LAYER_STRIDE) & 0xFFFFFFFF
            masks.append(jnp.asarray((philox_bits(key, TILE, sizes[l])
                                      >= j_mask_threshold(0.2)).to(torch.float32).numpy()))
        jst = j_train_step(jst, jnp.asarray(x[i * TILE:(i + 1) * TILE]),
                           jnp.asarray(t[i * TILE:(i + 1) * TILE]), jm.ModelConfig(**kw),
                           JOpt(**opt), dropout_masks=masks)
    want = (jst.params["w"], jst.params["b"], jst.deltas["w"], jst.deltas["b"])
    for g_group, w_group in zip(got, want):
        for g, w in zip(g_group, w_group):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **CHUNK_TOL)
    # and the port's plain chunk trainer, which draws the same masks itself
    st = rc.make_resident_train_chunk(cfg, topt, bf16=False)(
        init_train_state(mlp), torch.from_numpy(x), torch.from_numpy(t), SEED)
    for g_group, s_group in zip(got, (st.params.w, st.params.b, st.deltas.w, st.deltas.b)):
        for g, s in zip(g_group, s_group):
            np.testing.assert_allclose(g.numpy(), s.numpy(), **CHUNK_TOL)


def test_the_draw_raises_without_a_card_and_refuses_bad_shapes():
    with pytest.raises(RuntimeError):
        rc.input_mask_bits(SEED, 2, TILE, 33, 0.1, device="cuda")
    with pytest.raises(ValueError):
        rc.input_mask_bits(SEED, 2, 0, 33, 0.1, device="cpu")
    assert rc.input_mask_bits(SEED, 0, TILE, 33, 0.1, device="cpu").shape == (0, TILE, 2)
    assert rc.input_mask_bits.launches == 0  # the CPU runs the plain version
    assert {"input_mask_table", "input_mask_philox"} <= set(rc.kernel_launches)


# The data-parallel trainer's tables: a rank draws its rows of the call's
# tables (row0 = rank * local tile), which must be exactly the rows the JAX
# package's DP contract gives a device (tpu_sednn/ops/resident_chunk.py:
# sample_resident_masks with device_idx: the global tile's mask, the device's
# bunch_part rows).

@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("K", [129, 33])
def test_a_ranks_table_holds_its_rows_of_the_global_masks(K, n_dev):
    tile_g, omit, n_tiles = 32, 0.2, 3
    tile = tile_g // n_dev
    tables = [rc.input_mask_bits(SEED, n_tiles, tile, K, omit, device="cpu", row0=d * tile)
              for d in range(n_dev)]
    whole = rc.input_mask_bits_reference(SEED, n_tiles, tile_g, K, omit)
    # the ranks' tables stacked are the single-device table of the global tile
    assert torch.equal(torch.cat(tables, dim=1), whole)
    for d, table in enumerate(tables):
        assert torch.equal(table, rc.input_mask_bits_reference(SEED, n_tiles, tile, K, omit,
                                                               row0=d * tile))
        for gi in range(n_tiles):
            mask = unpack_mask_words(table[gi], K)
            assert torch.equal(mask, rc.sample_resident_masks_reference(
                SEED, gi, 0, (tile_g, K), omit, device_idx=d, n_dev=n_dev))
            assert torch.equal(mask, _jax_keep(gi, tile_g, K, omit)[d * tile:(d + 1) * tile]
                               .to(torch.float32))
    # and the ranks' rows differ from one another
    assert len({t.numpy().tobytes() for t in tables}) == n_dev


def test_a_negative_row0_is_refused():
    for draw in (rc.input_mask_bits, rc.input_mask_bits_reference):
        with pytest.raises(ValueError, match="row -1"):
            draw(SEED, 2, TILE, 33, 0.1, device="cpu", row0=-1)
    with pytest.raises(ValueError, match="row -8"):  # before any launch
        rc.input_mask_bits(SEED, 2, TILE, 33, 0.1, device="cuda", row0=-8)
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the card's draw would not raise")
    with pytest.raises(RuntimeError):
        rc.input_mask_bits(SEED, 2, TILE, 33, 0.1, device="cuda", row0=TILE)
