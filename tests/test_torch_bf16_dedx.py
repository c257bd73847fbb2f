"""The tensor-core backward's bfloat16 dedx (csrc/fused_mlp.cuh,
csrc/resident_chunk.cu).

stripe_bwd_kernel's tensor-core form reads dedx rounded to bfloat16, rne(dedx),
from a copy that the launch which made dedx writes beside it: the head's
forward in its epilogue, each backward as the dedy it hands on.  The copy's
rows are padded to 16 bytes (ops/fused_mlp.py:bf16_ld) so that it goes by
tensor copies at every width, and the chunk trainer's workspace holds two of
them beside the two float32 dedx buffers, and after them a copy of each
hidden layer's output, which the next layer's tensor-core forward reads
(tests/test_torch_bf16_x.py).  The standalone wrappers, which hold float32
dedx alone, make the copy with one cast launch a call.

On the CPU: the padded stride and the workspace's plan (mirrored here), and
that the CPU path is the plain version, which rounds the operands itself.
On the card (`python -m pytest --noconftest tests/test_torch_bf16_dedx.py -q
-m card`: tests/conftest.py imports JAX, which the card's machine lacks):
the backward, standalone in every storage form, against the float64 plain
version at the tensor-core limits on any card and, on a 132-SM H100,
standalone and in the chunk trainer's chain, bit-equal to the kernel that
rounded float32 dedx in each step (its outputs' digests, recorded on an H100
SXM); the kernels a traced call runs (the chain no cast, the wrappers one a
tensor-core call); and the workspace's plan against the C entry point.  This
file imports no JAX."""

import pytest
import torch

from tpu_sednn_torch.ops import fused_mlp as fm
from tpu_sednn_torch.ops import resident_chunk as rc

WIDTHS = (129, 257, 2048)
ROWS = (32, 64, 128, 256, 512)


def _workspace(sizes, bunch):
    """csrc/resident_chunk.cu:plan_workspace, in floats: the layers' stored
    inputs, the output, the two float32 dedx buffers, their two bfloat16
    copies, and the bfloat16 copies of the stored inputs (ys_bf[l - 1]: layer
    l's, l = 1..L-1)."""
    L = len(sizes) - 1
    off, max_w = sum(bunch * s for s in sizes[1:L]) + bunch * sizes[L], max(sizes)
    plan = {"dedx_a": off, "dedx_b": off + bunch * max_w}
    off += 2 * bunch * max_w
    bf_floats = (bunch * fm.bf16_ld(max_w) // 2 + 3) // 4 * 4
    off = (off + 3) // 4 * 4
    plan.update(bf_a=off, bf_b=off + bf_floats)
    off += 2 * bf_floats
    plan["ys_bf"] = []
    for l in range(1, L):
        plan["ys_bf"].append(off)
        off += (bunch * fm.bf16_ld(sizes[l]) // 2 + 3) // 4 * 4
    plan["total"] = off
    return plan


@pytest.fixture
def card():
    """The card, for the tests marked `card`; skips where no CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: card-only tests run on the chip")
    return torch.device("cuda", 0)


def test_bf16_ld_is_the_kernels():
    """The kernels' padding (csrc/fused_mlp.cuh:bf16_ld): N up to a multiple of 8."""
    assert [fm.bf16_ld(n) for n in (1, 8, 9, 129, 257, 1548, 2048)] == [8, 8, 16, 136, 264, 1552,
                                                                        2048]


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("N", WIDTHS)
def test_bf16_copy_stride_and_workspace(N, M):
    """The copy's rows are 16-byte multiples at least N wide, and both copies
    (the head's dedx, M x bf16_ld(N), and a hidden layer's, M x
    bf16_ld(2048)) fit their buffers, 16-byte aligned, past the float32 dedx
    and within resident_workspace_floats."""
    ld = fm.bf16_ld(N)
    assert ld >= N and (2 * ld) % 16 == 0 and ld - N < 8
    for sizes in ((1548, 2048, 2048, 2048, N), (3084, 2048, 2048, 2048, N)):
        ws = _workspace(sizes, M)
        need = max(M * fm.bf16_ld(w) for w in sizes[1:]) / 2  # floats of the widest copy
        assert ws["bf_a"] % 4 == 0 and ws["bf_b"] % 4 == 0  # 16 bytes into a float32 buffer
        assert ws["bf_a"] >= ws["dedx_b"] + M * max(sizes)
        assert ws["bf_a"] + need <= ws["bf_b"] and ws["bf_b"] + need <= ws["ys_bf"][0]
        assert (ws["ys_bf"][0] - ws["bf_a"]) * 4 <= 2 * M * fm.bf16_ld(max(sizes)) * 2 + 32


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("N", WIDTHS)
def test_y_copies_in_the_workspace(N, M):
    """Each hidden layer's output has its bfloat16 copy (M x bf16_ld(width)),
    16-byte aligned, past the dedx copies, the copies apart and within
    resident_workspace_floats; the float32 buffers' offsets are the parent
    plan's (the copies come last).  Hidden widths N and 2048, heads N."""
    for sizes in ((1548, N, 2048, 2048, 129), (3084, 2048, N, 2048, N), (1548, N, N)):
        ws, L = _workspace(sizes, M), len(sizes) - 1
        assert len(ws["ys_bf"]) == L - 1
        bounds = ws["ys_bf"] + [ws["total"]]
        for l in range(1, L):
            off = ws["ys_bf"][l - 1]
            assert off % 4 == 0  # 16 bytes into a float32 buffer
            assert off + M * fm.bf16_ld(sizes[l]) / 2 <= bounds[l]
            assert (bounds[l] - off) * 4 <= 2 * M * fm.bf16_ld(sizes[l]) + 12
        assert ws["ys_bf"][0] >= ws["bf_b"] + M * fm.bf16_ld(max(sizes)) / 2
        floats = sum(M * s for s in sizes[1:])  # the stored inputs and the output
        assert ws["dedx_a"] == floats and ws["dedx_b"] == floats + M * max(sizes)


def test_wrappers_cast_nothing_on_the_cpu():
    """On CPU tensors the wrappers are the plain versions, which round
    float32 dedx as they multiply: no copy of it is made."""
    g = torch.Generator().manual_seed(3)
    M, K, N = 16, 24, 9
    dedx, y = torch.randn(M, N, generator=g) * 0.02, torch.relu(torch.randn(M, K, generator=g))
    w, d = torch.randn(K, N, generator=g) * 0.03, torch.zeros(K, N)
    b, db = torch.zeros(N), torch.zeros(N)
    want = fm.fused_bwd_update_reference(dedx, y, w, d, b, db, 0.5, 1.0, 1.0 / M, 0.0,
                                         deriv="relu", bf16=True)
    got = fm.fused_bwd_update(dedx, y, w, d, b, db, 0.5, 1.0, 1.0 / M, 0.0, deriv="relu",
                              bf16=True)
    assert all(torch.equal(a, e) for a, e in zip(got, want))
    want = fm.fused_bwd_grad_out_reference(dedx, y, w, deriv="relu", bf16=True)
    got = fm.fused_bwd_grad_out(dedx, y, w, deriv="relu", bf16=True)
    assert all(torch.equal(a, e) for a, e in zip(got, want))


# SHA-256 digests of the outputs of the kernel that rounded float32 dedx in
# each step (chip_smoke.py:_bwd_digests and _chunk_digests, recorded on an
# NVIDIA H100 80GB HBM3 with 132 SMs: the split of N, and with it dedy's sums,
# follows the card's SMs).
ROUNDING_KERNEL_BWD_DIGESTS = {
    "fused_bwd_update 128x1548x2048 f32":
        "101934d8cc9ad6dbde70c9ee19ed348c4c92da6f228621b9e0a4115ae383242d",
    "fused_bwd_update 128x1548x2048 sr_delta":
        "e8a21f3456fe87ad65d68f652eccb8456c584090d773ed841b9fc081a72fe86e",
    "fused_bwd_update 128x1548x2048 sr_state":
        "645e26bc7232b40502a356e7a461b640d79dc8b078802804e1b176c3a69fa950",
    "fused_bwd_update 128x2048x129 f32":
        "76faf75f7f984bb1d4c3b9fcc8f0e0872bf8b26b1369fb01e41eba66049be646",
    "fused_bwd_update 128x2048x129 sr_delta":
        "462be581fce687ef8492504c97f920e33f8deb8563c364d97158196634747a72",
    "fused_bwd_update 128x2048x129 sr_state":
        "cc5ccdeba4e50b5dfe445496c9ff80a83ccd371c3e30cedb28eb941c760f8a12",
    "fused_bwd_update 128x3084x2048 f32":
        "3384e604f50150c02b7f02e6cecbf2fde92557b58802c5ff8086bdaa35e2595d",
    "fused_bwd_update 128x3084x2048 sr_delta":
        "a2cb79a8e971f2a260e99345efd68ea268d1886aeb932c32f4d52b3f9ce19963",
    "fused_bwd_update 128x3084x2048 sr_state":
        "322b52444bb191d43b587f84b078299ddb6655c4f30105ecf461eb2b0053cc91",
    "fused_bwd_update 128x2048x257 f32":
        "944c479c3b88e17cb90b57a3b608ee62680fede8ff19c69336ba84482f2a02ee",
    "fused_bwd_update 128x2048x257 sr_delta":
        "a602ac0f0955c109459770d56474bc4b5270e88ffcd8593130cf149219431691",
    "fused_bwd_update 128x2048x257 sr_state":
        "7ee767682c66317dc881411e7650ff2d0fc8c5c226ec3d67d56a49058021b1f9",
    "fused_bwd_update 256x2048x2048 f32":
        "1666de2b21d1db09ff804b25fcf89d2901a43703d7297ba1c71fca71c93d56ba",
    "fused_bwd_update 256x2048x2048 sr_delta":
        "cd6b4d51d61f470bf3ea967075a2eb5ca4da2219d069290e727d06b1e6f79a99",
    "fused_bwd_update 256x2048x2048 sr_state":
        "02d9f6c960d4af2703e4a263c6dccd9d53e2e370d1fce6f32c047697d7452879",
    "fused_bwd_update 512x2048x2048 f32":
        "38878e59cd67b5bf5d15367d29307006cbbad5dea5f2951728caffe7b857e4af",
    "fused_bwd_update 512x2048x2048 sr_delta":
        "5260f759b9603a08eef3f9a93ae2832802e96993f583345953b12b22954a70eb",
    "fused_bwd_update 512x2048x2048 sr_state":
        "3019bb506551811bc3f95bfc771123ed0986fbcd00971d89d37a2af87acc3732",
    "fused_bwd_grad_out 64x2048x2048":
        "61fd4bc68c0a8d6c514ad846c7bb151222b6d0b2993231c2d32f92bca66b2a61",
    "fused_bwd_grad_out 64x1548x2048":
        "a74f403480f28380cda021db6ca6e43cb95f1cd676d12981a161961a08203081",
}
ROUNDING_KERNEL_CHUNK_DIGESTS = {
    "8k_tc":
        "9f627f9f1352485d39d5c43b081f179cc4e757eef4f207ed207f8077c798f484",
    "16k_sr_delta":
        "c914f79954a2b1755b673d3a9e713a5d7441e948812fcc8f2404570beb1e0575",
    "16k_sr_state":
        "22b018a0fc4364cef1b00b3c8b81397066c4c433c482a5e913b7f3d909a4350d",
    "16k_tile_rows_64":
        "e123ea5abbf73a5e70554cf8a0e0327a2afa4cbe198292a5e02884221d2d2b9e",
}
TC_CHUNK_FORMS = ("8k_tc", "16k_sr_delta", "16k_sr_state", "16k_tile_rows_64")


def _chip_smoke(card, digests=True):
    """chip_smoke.py, whose holds and digests these tests use; with digests,
    skips on a card with other than 132 SMs, on which the recorded digests
    were not made."""
    import importlib

    if digests and torch.cuda.get_device_properties(card).multi_processor_count != 132:
        pytest.skip("the recorded digests are of a 132-SM H100")
    return importlib.import_module("chip_smoke")


@pytest.mark.card
def test_tc_backward_holds_to_the_plain_version(card):
    """_bwd_digests holds every output against the float64 plain version (it
    raises where one misses the tensor-core limits), on any card."""
    assert set(_chip_smoke(card, digests=False)._bwd_digests()) == set(ROUNDING_KERNEL_BWD_DIGESTS)


@pytest.mark.card
def test_tc_backward_is_bit_equal_to_the_rounding_kernel(card):
    got = _chip_smoke(card)._bwd_digests()
    assert got == ROUNDING_KERNEL_BWD_DIGESTS


@pytest.mark.card
def test_tc_chain_is_bit_equal_to_the_rounding_kernel(card):
    got = _chip_smoke(card)._chunk_digests(TC_CHUNK_FORMS)
    assert got == {k: ROUNDING_KERNEL_CHUNK_DIGESTS[k] for k in TC_CHUNK_FORMS}


def _kernel_counts(card, fn, want: dict) -> dict:
    """{name: launches of the kernels of that name} in a torch.profiler trace
    of one call of fn, for the names of `want`: chip_smoke.py's reading,
    traced again until it reads `want` exactly (a lost record only lowers a
    count)."""
    return _chip_smoke(card, digests=False)._kernel_counts(fn, want)[0]


@pytest.mark.card
def test_chain_reads_its_own_copies_and_wrappers_cast_once(card):
    from tpu_sednn_torch.model.mlp import ModelConfig, init_params
    from tpu_sednn_torch.train.step import OptConfig, init_train_state

    cfg = ModelConfig(layersizes=(1548, 2048, 2048, 2048, 129), dropout_vis=0.1, dropout_hid=0.2)
    opt = OptConfig(lrate=1e-3, momentum=0.5, weightcost=0.0, bunchsize=128)
    st = init_train_state(init_params(torch.Generator().manual_seed(5), cfg, scheme="glorot",
                                      device=card))
    g = torch.Generator().manual_seed(6)
    x = torch.randn(3 * 128, 1548, generator=g).to(card)
    t = torch.randn(3 * 128, 129, generator=g).to(card)
    for bf16 in (True, False):  # the chain casts nothing: its launches write the copies
        run = rc.make_resident_train_chunk(cfg, opt, bf16=bf16)
        want = {"tc_fwd_kernel": 3 if bf16 else 0, "tc_fwd_kernel_xbf16": 9 if bf16 else 0,
                "f32_fwd_kernel": 0 if bf16 else 12, "stripe_bwd_kernel": 12,
                "bf16_copy_kernel": 0}
        assert _kernel_counts(card, lambda: run(st, x, t, 3), want) == want
    dedx, y = x[:128, :129].contiguous() * 0.01, torch.relu(x[:128, :1548]).contiguous()
    w = torch.randn(1548, 129, generator=g).to(card) * 0.03
    for bf16 in (True, False):  # one cast a tensor-core call, none for float32 products
        def calls():
            fm.fused_bwd_grad_out(dedx, y, w, with_dedy=False, bf16=bf16)
            fm.fused_bwd_update(dedx, y, w, torch.zeros_like(w), torch.zeros(129, device=card),
                                torch.zeros(129, device=card), 0.5, 1.0, 1.0 / 128, 0.0, bf16=bf16)

        want = {"stripe_bwd_kernel": 2, "bf16_copy_kernel": 2 if bf16 else 0}
        assert _kernel_counts(card, calls, want) == want


@pytest.mark.card
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("N", WIDTHS)
def test_workspace_mirror_is_the_c_entry_point(card, N, M):
    import ctypes

    lib = rc._lib()
    for sizes in ((1548, 2048, 2048, 2048, N), (3084, 2048, 2048, 2048, N),
                  (1548, N, 2048, 2048, 129), (3084, 2048, N, 2048, N), (1548, N, N)):
        c_sizes = (ctypes.c_int * len(sizes))(*sizes)
        assert lib.resident_workspace_floats(c_sizes, len(sizes) - 1, M) == \
            _workspace(sizes, M)["total"]
