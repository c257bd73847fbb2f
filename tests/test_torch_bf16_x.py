"""The tensor-core forward's bfloat16 input (csrc/fused_mlp.cuh,
csrc/resident_chunk.cu).

In the chunk trainer's tensor-core chain the forward of each hidden layer
stores rne(y), its masked activation rounded to bfloat16, beside y, and the
forward of the next layer reads that copy by tensor copies in place of
rounding float32 y again: tc_fwd_kernel<TW, BN, unsigned short>, which a
trace counts as tc_fwd_kernel_xbf16 (chip_smoke.py:KERNEL_FORMS).  Layer 0,
whose input takes the input's dropout mask, the float32 products, the
standalone fused_linear_act and the data-parallel forward round float32 x
(tc_fwd_kernel<TW, BN, float>, counted as tc_fwd_kernel).  The split of K,
W's rounding, the products' order, the cluster sum and the epilogue are the
same in both forms, so the outputs are the same bits.

On the CPU: the copies' place in the workspace is held in
tests/test_torch_bf16_dedx.py (its plan's mirror), the trace's reading of
the forms in tests/test_chip_smoke_traces.py.  On the card (`python -m pytest
--noconftest tests/test_torch_bf16_x.py -q -m card`: tests/conftest.py
imports JAX, which the card's machine lacks): the form that reads the copy
against the form that rounds float32 x, standing alone, bit for bit, at
several widths and rows and both W storages; the chain's state digests (held
in tests/test_torch_bf16_dedx.py, recorded before either copy existed); and
which form each path launches, read from a torch.profiler trace.  This file
imports no JAX."""

import pytest
import torch

WIDTHS = (129, 257, 2048)
ROWS = (32, 64, 128)


@pytest.fixture
def card():
    """The card, for the tests marked `card`; skips where no CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: card-only tests run on the chip")
    return torch.device("cuda", 0)


def _chip_smoke():
    import importlib

    return importlib.import_module("chip_smoke")


@pytest.mark.card
@pytest.mark.parametrize("w_bf16", (False, True))
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("N", WIDTHS)
def test_copy_form_is_bit_equal_to_the_rounding_form(card, N, M, w_bf16):
    """y, rne(y), dedx and rne(dedx) of a head reading its input's copy are
    those of the head that rounds float32 x (chip_smoke.py:_fwd_copy_case
    raises where one bit differs)."""
    _chip_smoke()._fwd_copy_case(N, M, w_bf16)


def _kernel_counts(fn, want: dict) -> dict:
    return _chip_smoke()._kernel_counts(fn, want)[0]


def _net(card, dropout: bool = True):
    from tpu_sednn_torch.model.mlp import ModelConfig, init_params
    from tpu_sednn_torch.train.step import OptConfig, init_train_state

    cfg = ModelConfig(layersizes=(1548, 2048, 2048, 2048, 129),
                      dropout_vis=0.1 if dropout else 0.0, dropout_hid=0.2 if dropout else 0.0)
    opt = OptConfig(lrate=1e-3, momentum=0.5, weightcost=0.0, bunchsize=128)
    params = init_params(torch.Generator().manual_seed(5), cfg, scheme="glorot", device=card)
    return cfg, opt, params, init_train_state(params)


@pytest.mark.card
@pytest.mark.parametrize("form", ("f32_state", "sr_state", "f32_products"))
def test_chain_reads_the_copies_above_layer_0(card, form):
    """A bunch of the tensor-core chain launches one forward that rounds
    float32 x (layer 0) and L - 1 = 3 that read the copy; the float32-product
    chain launches neither."""
    from tpu_sednn_torch.ops import resident_chunk as rc

    cfg, opt, _, st = _net(card)
    kw = {"f32_state": {}, "sr_state": dict(sr_state=True), "f32_products": dict(bf16=False)}[form]
    run = rc.make_resident_train_chunk(cfg, opt, **kw)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(3 * 128, 1548, generator=g).to(card)
    t = torch.randn(3 * 128, 129, generator=g).to(card)
    tc = form != "f32_products"
    want = {"tc_fwd_kernel": 3 if tc else 0, "tc_fwd_kernel_xbf16": 9 if tc else 0,
            "f32_fwd_kernel": 0 if tc else 12, "stripe_bwd_kernel": 12}
    assert _kernel_counts(lambda: run(st, x, t, 3), want) == want


@pytest.mark.card
def test_standalone_and_data_parallel_forwards_round_float32_x(card):
    """fused_linear_act (either product form) and the data-parallel forward
    of a tile launch no form that reads a copy."""
    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.ops.fused_mlp import fused_linear_act

    cfg, _, params, _ = _net(card, dropout=False)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(128, 1548, generator=g).to(card)
    t = torch.randn(64, 129, generator=g).to(card)
    w, b = params.w[0], params.b[0]

    def standalone():
        for bf16 in (True, False):
            for _ in range(4):
                fused_linear_act(x, w, b, "relu", bf16=bf16)

    want = {"tc_fwd_kernel": 4, "tc_fwd_kernel_xbf16": 0, "f32_fwd_kernel": 4}
    assert _kernel_counts(standalone, want) == want
    fwd = rc.dp_tile_forward(cfg, 64, 128, True, card)  # a rank's 64 rows of a tile of 128

    def dp():
        for _ in range(3):
            fwd(x[:64], t, params.w, params.b, 17, 64, 2.0 / 128)

    want = {"tc_fwd_kernel": 12, "tc_fwd_kernel_xbf16": 0}
    assert _kernel_counts(dp, want) == want
