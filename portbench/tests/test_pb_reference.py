"""The plain reference against the port's plain versions at a small size on
the CPU (the tests may import the port; the reference may not)."""

import numpy as np
import pytest
import torch

from portbench.reference import decode as ref_decode
from portbench.reference import philox as ref_philox
from portbench.reference import train as ref_train
from tpu_sednn_torch.model.mlp import MLP, ModelConfig
from tpu_sednn_torch.ops import resident_chunk
from tpu_sednn_torch.ops.philox import philox_mask
from tpu_sednn_torch.train.step import (OptConfig, cv_squared_error, init_train_state,
                                        reference_train_step)

SIZES = (60, 24, 24, 24, 5)
OMITS = [0.1, 0.2, 0.2, 0.2]


def _net(seed, sizes=SIZES):
    g = torch.Generator().manual_seed(seed)
    ws = [torch.rand(a, b, generator=g) * 0.4 - 0.2 for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [torch.rand(b, generator=g) * 0.1 for b in sizes[1:]]
    return ws, bs


def _rows(seed, n, sizes=SIZES):
    g = torch.Generator().manual_seed(seed + 1)
    return torch.randn(n, sizes[0], generator=g), torch.randn(n, sizes[-1], generator=g)


def test_philox_known_answer():
    """Random123's known-answer vector for philox4x32-10, counter 0, key 0."""
    words = ref_philox.philox4x32_10((0, 0, 0, 0), (0, 0))
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


@pytest.mark.parametrize("seed, bunch, layer", [(0, 0, 0), (12345, 3, 1), (2 ** 31 - 2, 799, 3)])
def test_masks_equal_the_ports(seed, bunch, layer):
    key = ref_philox.mask_key(seed, bunch, layer)
    assert key == resident_chunk.mask_key(seed, bunch, layer)
    for omit in (0.1, 0.2):
        ours = ref_philox.keep_mask(key, 37, 45, omit, "cpu")
        assert torch.equal(ours.float(), philox_mask(key, 37, 45, omit))


def test_f64_step_equals_the_ports_parity_step():
    ws, bs = _net(1)
    x, t = _rows(1, 16)
    masks = [ref_philox.keep_mask(ref_philox.mask_key(7, 0, l), 16, SIZES[l], o, "cpu").float()
             for l, o in enumerate(OMITS)]
    cfg = ModelConfig(SIZES).with_dropout(0.1, 0.2)
    st = reference_train_step(init_train_state(MLP(ws, bs)), x, t, cfg,
                              OptConfig(1.0, 0.5, 0.001, 16), dropout_masks=masks,
                              dtype=torch.float64)
    net = ref_train.Net.fresh(ws, bs)
    ref_train.train_step(net, x, t, 7, 0, OMITS, 1.0, 0.5, 0.001, "f64")
    for ours, theirs in zip(net.w + net.b + net.dw + net.db,
                            list(st.params.w) + list(st.params.b) + list(st.deltas.w)
                            + list(st.deltas.b)):
        assert torch.allclose(ours.float(), theirs, rtol=1e-5, atol=1e-7)


def test_bf16_steps_equal_the_chunk_trainers_plain_version():
    """Two bunches of one call (bunch indices 0 and 1) with bfloat16
    operands: the port's plain chunk trainer in float64 and the reference."""
    ws, bs = _net(2)
    x, t = _rows(2, 32)
    cfg = ModelConfig(SIZES).with_dropout(0.1, 0.2)
    st = init_train_state(MLP(ws, bs))
    coefs = resident_chunk._scal_coefs("parity", 16, SIZES[-1], 1.0, 0.5, 0.0)
    resident_chunk.resident_train_chunk_reference(st, x, t, cfg, 16, coefs, 99,
                                                  dtype=torch.float64, bf16=True)
    net = ref_train.Net.fresh(ws, bs)
    for b in range(2):
        ref_train.train_step(net, x[16 * b:16 * (b + 1)], t[16 * b:16 * (b + 1)], 99, b, OMITS,
                             1.0, 0.5, 0.0, "bf16")
    for ours, theirs in zip(net.w + net.b, list(st.params.w) + list(st.params.b)):
        assert torch.allclose(ours.float(), theirs, rtol=1e-6, atol=1e-7)


def test_fp8_operands_round_coarser_than_bf16():
    a = torch.randn(64, 64, dtype=torch.float64)
    e8 = float((ref_train.operand(a, "fp8") - a).abs().max() / a.abs().max())
    e16 = float((ref_train.operand(a, "bf16") - a).abs().max() / a.abs().max())
    assert e16 < 2 ** -8 and e8 > 4 * e16


def test_cv_equals_the_ports():
    ws, bs = _net(3)
    x, t = _rows(3, 300)
    cfg = ModelConfig(SIZES).with_dropout(0.1, 0.2)
    ours = ref_train.cv_mse(ws, bs, x, t, [1 - o for o in OMITS], block=128)
    theirs = float(cv_squared_error(MLP(ws, bs), x, t, cfg)) / 300
    assert ours == pytest.approx(theirs, rel=1e-5)


@pytest.mark.parametrize("rate, win, hop", [(8000, 32, 16), (16000, 64, 32)])
def test_decode_equals_the_ports(rate, win, hop):
    from tpu_sednn_torch.dsp.stft import StftConfig
    from tpu_sednn_torch.enhance.decode import EnhanceConfig, make_serving_decoder

    bins = win // 2 + 1
    sizes = (12 * bins, 24, 24, 24, bins)
    ws, bs = _net(4, sizes)
    g = torch.Generator().manual_seed(5)
    wavs = torch.randn(3, 40 * hop + 7, generator=g) * 0.1
    mean = np.full(bins, -4.0, np.float32)
    istd = np.full(bins, 0.5, np.float32)
    cfg = ModelConfig(sizes).with_dropout(0.1, 0.2)
    dec = make_serving_decoder(MLP(ws, bs), cfg, EnhanceConfig(StftConfig(rate, win, hop, win)),
                               mean, istd, device="cpu")
    got = dec(wavs).double()
    want = ref_decode.enhance(wavs, ws, bs, [0.9, 0.8, 0.8, 0.8], torch.from_numpy(mean),
                              torch.from_numpy(istd), win, hop, win, 11, 5, 6)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < 5e-6
    low = ref_decode.enhance(wavs, ws, bs, [0.9, 0.8, 0.8, 0.8], torch.from_numpy(mean),
                             torch.from_numpy(istd), win, hop, win, 11, 5, 6, "tf32").double()
    assert float((low - want).abs().max() / want.abs().max()) > 1e-5
