"""The CRN serving cell (drivers/serve_crn.py) end to end at its TINY size on
the CPU: the result line and the traced line have the contract's shape and
`correct` true; the TF32 control and the `stale` and `noskip` faults, put
in the program's place, read `correct` false.  crn_roofline's counts are
pinned at the published widths.  On the card (`python3 -m pytest
portbench/tests/test_pb_crn.py -q -m card`): the program within the limit
and the control and faults past it at the published widths, a pool cut to
CARD_CUT."""

import json

import pytest
import torch

from portbench import crn_roofline, readings, run
from portbench.drivers import serve_crn
from portbench.reference import crn as ref

CPU = torch.device("cpu")
SEED = 2 ** 31 + 23
CELL = "serve-crn16k-batch"
PUBLISHED = dict(n_bins=161, channels=[16, 32, 64, 128, 256], lstm_hidden=1024, lstm_layers=2)


def _line(bench, found, trace, program=None):
    res = run.run_cell(bench, found, SEED, 0.3, trace, CPU, program)
    if trace:  # a CPU run has no kernel spans: the slice reads as all idle
        res["layers"]["slice"].setdefault("busy_s", 0.0)
    return json.loads(json.dumps(run.result_line(res, {"platform": "cpu", "kind": "cpu",
                                                       "count": 1}, trace)))


def test_result_line(tiny):
    bench, found = tiny(CELL)
    line = _line(bench, found, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"enhance_audio_s_per_s", "enhance_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert list(line["checks"]) == ["wav_err", "mag_err"]


def test_traced_line(tiny):
    bench, found = tiny(CELL)
    line = _line(bench, found, True)
    assert line["correct"] is True
    # the recurrence's metrics read the device's copy of its span, which a CPU run lacks
    assert set(line["metrics"]) == {"crn_mfu_pct"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("mode", ["control", "stale", "noskip"])
def test_control_and_faults_fail(tiny, mode):
    bench, found = tiny(CELL)
    assert _line(bench, found, False, serve_crn.STAND_INS[mode])["correct"] is False


def test_weights_are_the_ports_layout(tiny):
    """The benchmark draws every tensor the port's CRN holds, under its
    name and shape, at the published widths, in the configuration's ranges;
    a seed gives the same weights again."""
    from tpu_sednn_torch.model.crn import CRN, CRNConfig, init_crn

    _, found = tiny(CELL)
    cfg = dict(found["config"], **PUBLISHED)
    t = serve_crn.weights(torch.Generator().manual_seed(SEED), cfg, CPU)
    port = init_crn(torch.Generator().manual_seed(0), CRNConfig(), device="cpu").tensors
    assert {k: v.shape for k, v in t.items()} == {k: v.shape for k, v in port.items()}
    assert CRN(CRNConfig(), t).n_parameters() == cfg["parameters"]
    assert all(v.dtype == torch.float32 for v in t.values())
    assert float(t["enc1.w"].abs().max()) <= 6 ** -0.5  # fan_in 1 x 2 x 3
    assert float(t["dec5.w"].abs().max()) <= (128 * 6) ** -0.5  # the output channels'
    assert float(t["lstm2.w_hh"].abs().max()) <= 1024 ** -0.5
    assert 0.5 <= float(t["dec2.gamma"].min()) and float(t["enc3.var"].max()) <= 1.5
    again = serve_crn.weights(torch.Generator().manual_seed(SEED), cfg, CPU)
    assert all(torch.equal(v, again[k]) for k, v in t.items())


def test_phase_slack_covers_the_bins_left_to_rounding(tiny):
    """A constant waveform's frames are zero in every bin past the first
    two, but for rounding: the float32 STFT gives those bins a phase of
    rounding, which moves the program's waveform far from the reference's,
    and no further than the reference's phase slack."""
    _, found = tiny(CELL)
    cfg = found["config"]
    tensors = serve_crn.weights(torch.Generator().manual_seed(SEED), cfg, CPU)
    wavs = torch.full((2, 4000), 0.5)
    got = serve_crn.Program(cfg, tensors, CPU).decode(wavs).double()
    want, _, slack = ref.enhance(wavs, tensors, cfg)
    gap, peak = (got - want).abs(), float(want.abs().max())
    assert float(gap.max()) > 0.05 * peak
    assert float((gap - slack).max()) < 1e-5 * peak


def test_roofline_counts():
    per = crn_roofline.stage_flop_per_frame(PUBLISHED)
    assert per == {"encoder": 3_179_520.0, "lstm": 33_554_432.0, "decoder": 6_359_040.0}
    assert crn_roofline.flop_per_frame(PUBLISHED) == 43_092_992.0
    assert crn_roofline.cell_bytes(64, 1024) == 1_835_008
    # 2 layers x (a projection of 799 x 64 frames + 799 steps): 26.48 ms
    assert crn_roofline.lstm_bound_s(PUBLISHED, 64, 799) == pytest.approx(26.4849e-3, rel=1e-4)
    cfg = run.load_json(run.os.path.join(run.ROOT, "portbench/configs/crn-16k.json"))
    assert crn_roofline.flop_per_frame(cfg) == cfg["flop_per_frame"]


@pytest.mark.card
def test_program_within_and_control_and_faults_past_the_limit(card):
    bench = run.load_json(run.os.path.join(run.ROOT, "BENCHMARK.json"))
    found = run.find_cell(bench, CELL)
    cut = serve_crn.CARD_CUT
    found["config"] = dict(found["config"], **cut["config"])
    found["traffic"] = dict(found["traffic"], **cut["traffic"])
    read = readings.read_seed(found, 2 ** 31 + 101, serve_crn.MODES, card)
    limits = found["limits"]

    def within(numbers):
        return all(numbers[k] <= v for k, v in limits.items())

    assert within(read["program"])
    assert not any(within(read[m]) for m in ("control", "stale", "noskip"))
