"""The causal CRN (model/crn.py), its recurrence's plain version
(ops/lstm_cell.py) and its serving decoder (enhance/decode.py:
make_crn_decoder) on the CPU, against the plain float64 reference
tests/ref_crn.py on seeded random weights: 161 bins, channels (2, 4, 4, 8, 8),
an LSTM of 32 units, 12 frames, a batch of 2.

Tolerance: the largest gap over the reference's peak, TOL = 1e-5.  The
port's float32 sums run over at most 1,024 terms (the 32-unit LSTM's, 192
at these widths) and read about 2e-7 here; products with operands rounded
to TF32 (2^-11) read about 6e-4, and must miss TOL by at least 10x
(test_tf32_misses_the_tolerance), so the comparison tells float32 from the
lower precision the card would use with TF32 on."""

import importlib
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import ref_crn
from tpu_sednn_torch.dsp.stft import LPS_FLOOR, StftConfig, reconstruct_from_lps, stft_real_imag
from tpu_sednn_torch.enhance.decode import make_crn_decoder
from tpu_sednn_torch.model import crn
from tpu_sednn_torch.model.crn import CRNConfig, crn_forward_eval, fold_eval_crn, init_crn
from tpu_sednn_torch.ops import (KERNEL_SOURCES, _build, lstm_cell_reference, lstm_plan,
                                 lstm_steps, lstm_steps_reference)
from tpu_sednn_torch.ops.lstm_cell import LstmPlan, run_plan

TOL = 1e-5
SMALL = CRNConfig(channels=(2, 4, 4, 8, 8), lstm_hidden=32)
STFT = StftConfig(16000, 320, 160, 320)
N_SAMPLES = 320 + 11 * 160  # 12 frames
STAGES = ["sednn.decode.stft", "sednn.decode.crn.encoder", "sednn.decode.crn.lstm",
          "sednn.decode.crn.decoder", "sednn.decode.istft"]


def _params(seed, cfg=SMALL):
    return init_crn(torch.Generator().manual_seed(seed), cfg, device="cpu")


def _mag(seed, frames=12, batch=2):
    # STFT magnitudes of noisy speech at 16 kHz reach tens
    return torch.rand(batch, frames, 161, generator=torch.Generator().manual_seed(100 + seed)) * 20


def _wavs(seed):
    return 0.3 * torch.randn(2, N_SAMPLES, generator=torch.Generator().manual_seed(200 + seed))


def _gap(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def _decode_with_ref_net(params, wavs, precision="f64"):
    """The decode composed of the port's STFT and overlap-add (tested in
    test_torch_stft.py) around the reference net."""
    re_, im_ = stft_real_imag(wavs, STFT)
    mag = torch.sqrt(re_ * re_ + im_ * im_)
    est = ref_crn.crn_forward(params.tensors, mag, precision=precision).float()
    lps = torch.log(torch.clamp(est * est, min=LPS_FLOOR))
    return reconstruct_from_lps(lps, re_, im_, STFT, n_samples=wavs.shape[-1]).double()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_matches_reference(seed):
    params, mag = _params(seed), _mag(seed)
    assert _gap(crn_forward_eval(params, mag), ref_crn.crn_forward(params.tensors, mag)) < TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_decoder_matches_reference(seed):
    params, wavs = _params(seed), _wavs(seed)
    got = make_crn_decoder(params, STFT, device="cpu")(wavs)
    assert got.shape == wavs.shape and got.dtype == torch.float32
    assert _gap(got, _decode_with_ref_net(params, wavs)) < TOL


def test_decoder_returns_its_magnitude_and_takes_stages():
    """decode(wavs, magnitude=True) gives the net's magnitude beside the same
    waveform; a stage given to make_crn_decoder takes model/crn.py's place."""
    params, wavs = _params(2), _wavs(2)
    decode = make_crn_decoder(params, STFT, device="cpu")
    wav, est = decode(wavs, magnitude=True)
    torch.testing.assert_close(wav, decode(wavs), rtol=0, atol=0)
    re_, im_ = stft_real_imag(wavs, STFT)
    torch.testing.assert_close(est, crn_forward_eval(params, torch.sqrt(re_ * re_ + im_ * im_)),
                               rtol=0, atol=0)
    calls = []

    def decoder(folded, h, skips):
        calls.append(len(skips))
        return crn.crn_decoder(folded, h, [torch.zeros_like(e) for e in skips])

    wav2, est2 = make_crn_decoder(params, STFT, device="cpu", decoder=decoder)(wavs, magnitude=True)
    assert calls == [5] and not torch.equal(est2, est) and wav2.shape == wav.shape


@pytest.mark.parametrize("what", ["forward", "decoder"])
def test_tf32_misses_the_tolerance(what):
    params = _params(0)
    if what == "forward":
        mag = _mag(0)
        want = ref_crn.crn_forward(params.tensors, mag)
        low = ref_crn.crn_forward(params.tensors, mag, precision="tf32")
    else:
        wavs = _wavs(0)
        want = _decode_with_ref_net(params, wavs)
        low = _decode_with_ref_net(params, wavs, precision="tf32")
    assert _gap(low, want) > 10 * TOL


def test_causal():
    """Changing frame t moves no output before t."""
    params, mag = _params(3), _mag(3)
    base = crn_forward_eval(params, mag)
    for t in (0, 5, 11):
        moved = mag.clone()
        moved[:, t] += 3.0
        out = crn_forward_eval(params, moved)
        torch.testing.assert_close(out[:, :t], base[:, :t], rtol=0, atol=0)
        assert not torch.equal(out[:, t], base[:, t])


def test_fold_equals_unfolded_batch_norm():
    """Each folded layer (one product of its taps) equals PyTorch's causal
    convolution, or transposed convolution, followed by eval-mode batch
    norm as written."""
    params = _params(4)
    t, f = params.tensors, fold_eval_crn(params).tensors
    eps = params.cfg.bn_eps
    gen = torch.Generator().manual_seed(5)

    def bn(y, name):
        shape = (1, -1, 1, 1)
        return ((y - t[f"{name}.mean"].view(shape)) / torch.sqrt(t[f"{name}.var"].view(shape) + eps)
                * t[f"{name}.gamma"].view(shape) + t[f"{name}.beta"].view(shape))

    names = [n for n in sorted({k.split(".")[0] for k in t}) if not n.startswith("lstm")]
    assert len(names) == 10 and not any(k.endswith(("gamma", "beta", "mean", "var")) for k in f)
    T = 5
    for name in names:
        w = t[f"{name}.w"]
        if name.startswith("enc"):
            x = torch.randn(2, w.shape[1], T, 11, generator=gen)  # (B, C, T, F)
            want = F.conv2d(x, w, t[f"{name}.b"], stride=(1, 2), padding=(1, 0))[:, :, :T]
            got = crn.conv_layer(x.permute(0, 2, 3, 1), f[f"{name}.w"], f[f"{name}.b"])
        else:
            x = torch.randn(2, w.shape[0], T, 11, generator=gen)
            want = F.conv_transpose2d(x, w.flip(2), t[f"{name}.b"], stride=(1, 2),
                                      output_padding=(0, 1))[:, :, :T]
            got = crn.deconv_layer(x.permute(0, 2, 3, 1), f[f"{name}.w"], f[f"{name}.b"], 24)
        if f"{name}.gamma" in t:
            want = bn(want, name)
        torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="folded already"):
        fold_eval_crn(fold_eval_crn(params))
    with pytest.raises(ValueError, match="fold_eval_crn"):
        crn.crn_encoder(params, _mag(0))


def test_shapes_at_published_widths():
    cfg = CRNConfig()
    assert cfg.freq_bins == (161, 80, 39, 19, 9, 4)
    params = init_crn(torch.Generator().manual_seed(6), cfg, device="cpu")
    t = params.tensors
    assert t["enc1.w"].shape == (16, 1, 2, 3) and t["enc5.w"].shape == (256, 128, 2, 3)
    assert t["dec5.w"].shape == (512, 128, 2, 3) and t["dec1.w"].shape == (32, 1, 2, 3)
    assert "dec1.gamma" not in t and t["dec2.gamma"].shape == (16,)
    assert t["lstm1.w_ih"].shape == t["lstm2.w_hh"].shape == (1024, 4096)
    folded = fold_eval_crn(params)
    skips = crn.crn_encoder(folded, _mag(0, frames=3, batch=1))
    assert [tuple(e.shape) for e in skips] == [(1, 3, f, c) for c, f in
                                               zip(cfg.channels, cfg.freq_bins[1:])]
    h = crn.crn_lstm(folded, skips[-1])
    assert h.shape == (3, 1, 1024)
    out = crn.crn_decoder(folded, h, skips)
    assert out.shape == (1, 3, 161) and bool((out > 0).all())


def test_parameter_count_is_the_papers():
    """Tan & Wang report 17.58 M parameters; running statistics are not
    counted."""
    params = init_crn(torch.Generator().manual_seed(7), CRNConfig(), device="cpu")
    assert params.n_parameters() == 17_571_265
    assert abs(params.n_parameters() / 17.58e6 - 1) < 1e-3


def test_config_refuses_a_mismatched_lstm():
    with pytest.raises(ValueError, match="LSTM"):
        CRNConfig(lstm_hidden=512)
    with pytest.raises(ValueError, match="bins"):
        make_crn_decoder(_params(0), StftConfig(16000, 320, 160, 512), device="cpu")


@pytest.mark.parametrize("B,H", [(3, 8), (2, 5)])
def test_one_step_from_zero_h_is_the_cell_update(B, H):
    """At T = 1 with h[0] = 0 the step's product adds exact zeros, so
    lstm_steps is the cell update of the gates given (how the card holds
    its kernel against lstm_cell_reference), and that is the float64 cell."""
    gen = torch.Generator().manual_seed(8)
    gates, c0 = torch.randn(B, 4 * H, generator=gen) * 3, torch.randn(B, H, generator=gen)
    w_hh = torch.randn(H, 4 * H, generator=gen)
    hs, c = torch.zeros(2, B, H), c0.clone()
    lstm_steps(gates.clone().view(1, B, 4 * H), w_hh, hs, c)
    c2, h2 = c0.clone(), torch.empty(B, H)
    lstm_cell_reference(gates, c2, h2)
    assert torch.equal(c, c2) and torch.equal(hs[1], h2)
    g = gates.double()
    i, f, gg, o = (g[:, k * H:(k + 1) * H] for k in range(4))
    c64 = torch.sigmoid(f) * c0.double() + torch.sigmoid(i) * torch.tanh(gg)
    torch.testing.assert_close(c.double(), c64, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(hs[1].double(), torch.sigmoid(o) * torch.tanh(c64), rtol=1e-6,
                               atol=1e-6)


def test_lstm_steps_refuses_bad_arguments():
    T, B, H = 2, 2, 4
    proj, w_hh, c = torch.zeros(T, B, 4 * H), torch.zeros(H, 4 * H), torch.zeros(B, H)
    with pytest.raises(ValueError, match="want"):
        lstm_steps(torch.zeros(T, B, 12), w_hh, torch.zeros(T + 1, B, H), c)
    with pytest.raises(TypeError, match="float32"):
        lstm_steps(proj.double(), w_hh, torch.zeros(T + 1, B, H), c)
    with pytest.raises(ValueError, match="want"):
        lstm_steps(proj, w_hh, torch.zeros(T + 1, B, H), torch.zeros(B + 1, H))


def test_a_step_is_one_cell_update(monkeypatch):
    """The plain recurrence updates the cell once a step of each layer (on
    a card one kernel launch runs a layer's steps, 2 a decode)."""
    cell_mod = importlib.import_module("tpu_sednn_torch.ops.lstm_cell")  # the package exports
    calls = []
    monkeypatch.setattr(cell_mod, "lstm_cell_reference", lambda g, c, h: calls.append(g.shape)
                        or lstm_cell_reference(g, c, h))
    decode = make_crn_decoder(_params(0), STFT, device="cpu")
    decode(_wavs(0))
    assert calls == [(2, 128)] * (2 * 12)


def test_lstm_steps_equal_the_step_loop():
    """A layer's steps equal the plain cell update a step after the product;
    bad shapes are refused."""
    gen = torch.Generator().manual_seed(10)
    T, B, H = 5, 3, 8
    proj, w_hh = torch.randn(T, B, 4 * H, generator=gen), torch.randn(H, 4 * H, generator=gen)
    hs, c = torch.zeros(T + 1, B, H), torch.zeros(B, H)
    lstm_steps(proj.clone(), w_hh, hs, c)
    want_h, want_c = torch.zeros(B, H), torch.zeros(B, H)
    for t in range(T):
        g = proj[t] + want_h @ w_hh
        lstm_cell_reference(g, want_c, want_h)
        assert torch.equal(hs[t + 1], want_h)
    assert torch.equal(c, want_c)
    with pytest.raises(ValueError, match="want"):
        lstm_steps(proj, w_hh, torch.zeros(T, B, H), c)


def test_decoder_opens_its_five_stage_spans_in_order():
    decode = make_crn_decoder(_params(9), STFT, device="cpu")
    wavs = _wavs(9)
    want = decode(wavs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = decode(wavs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CPU and e.is_user_annotation
                   and e.name.startswith("sednn."))
    assert [s[2] for s in spans] == ["sednn.decode"] + STAGES
    (a, b, _), stages = spans[0], spans[1:]
    assert all(a <= s <= e <= b for s, e, _ in stages)
    assert all(e0 <= s1 for (_, e0, _), (s1, _, _) in zip(stages, stages[1:]))


def test_kernel_source_is_listed_and_its_c_signature_bound():
    assert "lstm_cell" in KERNEL_SOURCES
    assert [p.name for p in _build.source_files("lstm_cell")] == ["lstm_cell.cu"]
    src = (_build.SRC_DIR / "lstm_cell.cu").read_text()
    assert re.findall(r'extern "C" int (\w+)', src) == ["lstm_card_limits", "lstm_steps_f32"]
    sig = re.search(r'extern "C" int lstm_steps_f32\(([^)]*)\)', src).group(1)
    # proj, w_hh, hs, c, flags; T, B, row0, rows, H; the plan's units, col_groups, k_passes,
    # col_passes, ring, grid, smem; stream
    assert [int("*" in p) for p in sig.split(",")] == [1] * 5 + [0] * 12 + [1]
    sig = re.search(r'extern "C" int lstm_card_limits\(([^)]*)\)', src).group(1)
    assert [int("*" in p) for p in sig.split(",")] == [1, 1]
    # the step's product is the kernel's own: no cuBLAS, nothing linked besides the runtime
    assert not re.search(r"#include <cublas|cublas\w*\(", src) and not hasattr(_build, "LINK_FLAGS")
    assert Path(_build.library_path("lstm_cell")).name.startswith("liblstm_cell-")


H100 = (132, 232448)  # SMs and the shared memory a block may opt in to
PLANS = {  # (B, H) on an H100 -> the plan
    "crn-16k": ((64, 1024), LstmPlan(h=1024, units=8, col_groups=4, grid=128, k_chunk=1024,
                                     k_passes=1, col_passes=1, ring=3, rows=64, launches=1,
                                     smem=206912, resident=True)),
    "tiny": ((2, 32), LstmPlan(h=32, units=2, col_groups=1, grid=16, k_chunk=32, k_passes=1,
                               col_passes=1, ring=3, rows=2, launches=1, smem=204880, resident=True)),
    "h5": ((3, 5), LstmPlan(h=8, units=2, col_groups=1, grid=4, k_chunk=8, k_passes=1,
                            col_passes=1, ring=3, rows=3, launches=1, smem=204888, resident=True)),
    "h8": ((3, 8), LstmPlan(h=8, units=2, col_groups=1, grid=4, k_chunk=8, k_passes=1,
                            col_passes=1, ring=3, rows=3, launches=1, smem=204888, resident=True)),
    "ragged": ((100, 1000), LstmPlan(h=1000, units=8, col_groups=4, grid=125, k_chunk=1000,
                                     k_passes=1, col_passes=1, ring=3, rows=100, launches=1,
                                     smem=208064, resident=True)),
    "streamed": ((64, 2048), LstmPlan(h=2048, units=16, col_groups=8, grid=128, k_chunk=512,
                                      k_passes=4, col_passes=1, ring=3, rows=64, launches=1,
                                      smem=225344, resident=False)),
    "streamed-1056": ((64, 1056), LstmPlan(h=1056, units=8, col_groups=4, grid=132,
                                           k_chunk=1024, k_passes=2, col_passes=1, ring=3,
                                           rows=64, launches=1, smem=215104, resident=False)),
    "two-col-passes": ((64, 4096), LstmPlan(h=4096, units=32, col_groups=8, grid=128,
                                            k_chunk=512, k_passes=8, col_passes=2, ring=3,
                                            rows=64, launches=1, smem=229440, resident=False)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_lstm_plan_is_pinned(name):
    """The kernel's plan at the CRN's (64, 1024) on an H100: 128 blocks of 8
    units, W_hh in registers, a ring of 3 stages of 16 x 1024 floats, one
    launch; the small widths the CPU tests and TINY use; H = 1056 streams
    W_hh over 2 passes over k (the first as wide as a stage's row, the rows
    not), H = 2048 over 4, H = 4096 over 8 and 2 passes over columns."""
    shape, want = PLANS[name]
    assert lstm_plan(*shape, *H100) == want


@pytest.mark.parametrize("sms,smem", [H100, (114, 232448), (16, 232448)])  # SXM, PCIe, few SMs
def test_lstm_plan_fits_the_card(sms, smem):
    """Over many shapes: every block resident (one an SM), every unit owned,
    k covered by the passes, 2 to 4 ring stages, shared memory within the
    card's, the batch's rows over the launches."""
    for B in (1, 3, 8, 9, 64, 100, 1000, 20000):
        for H in (1, 5, 8, 32, 257, 1000, 1024, 1056, 1057, 2048, 3000):
            p = lstm_plan(B, H, sms, smem)
            assert p.grid <= sms and p.grid * p.units >= p.h >= H and p.h % 4 == 0
            assert p.units == 2 * p.col_groups * p.col_passes and p.col_groups in (1, 2, 4, 8)
            assert p.k_passes * 512 * 8 // p.col_groups >= p.h
            assert p.k_chunk == min(512 * 8 // p.col_groups, p.h) <= 1024  # a stage's row
            assert 2 <= p.ring <= 4 and p.smem <= smem
            assert p.launches == -(-B // p.rows) and p.rows <= B
            assert p.resident == (p.k_passes == 1 and p.col_passes == 1)
    with pytest.raises(ValueError):
        lstm_plan(0, 8, sms, smem)


@pytest.mark.parametrize("B,H,offset", [(3, 5, 0), (2, 8, 1), (4, 12, 0)])
def test_run_plan_pads_to_the_kernels_width(B, H, offset):
    """Where H is not a multiple of 4 or a tensor is not 16-byte aligned the
    launch sees zero-padded copies of width plan.h: the padded units' h and
    c stay 0 and the real ones are the plain step loop's."""
    gen = torch.Generator().manual_seed(23)
    T = 6
    proj, w_hh = torch.randn(T, B, 4 * H, generator=gen), torch.randn(H, 4 * H, generator=gen)
    c0 = torch.randn(B, H, generator=gen)
    plan = lstm_plan(B, H, *H100)
    seen = []

    def launch(p, pp, ww, hh, cc):
        assert p is plan and pp.shape == (T, B, 4 * p.h) and ww.shape == (p.h, 4 * p.h)
        seen.append(pp.data_ptr() != given.data_ptr())
        lstm_steps_reference(pp, ww, hh, cc)
        assert not hh[:, :, H:].any() and not cc[:, H:].any()

    store = torch.zeros((T + 1) * B * H + offset)
    hs = store[offset:].view(T + 1, B, H)
    c, given = c0.clone(), proj.clone()
    run_plan(plan, given, w_hh, hs, c, launch=launch)
    want_hs, want_c = torch.zeros(T + 1, B, H), c0.clone()
    lstm_steps_reference(proj.clone(), w_hh, want_hs, want_c)
    assert seen == [H % 4 != 0 or offset != 0]
    torch.testing.assert_close(hs, want_hs, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(c, want_c, rtol=1e-6, atol=1e-6)
