"""The per-layer metrics that read the program's spans (layer_metrics/
decode_idle_pct.py, decode_dsp_pct.py) on synthetic slice readings: a value
where the program's spans are in the trace, nothing where they are not (a
program without them, or a CPU run with no device timeline), and only the
program's `sednn.` names counted, never a driver's label."""

import pytest

from portbench import run

WINDOW = 0.4


def _serve(labels, gaps):
    """A serving cell's traced reading: the device's copies of labels, idle
    gaps by label, over a 0.4 s slice."""
    return {"requests_s": 0.8, "frames": 1000, "sizes": [1548, 2048, 2048, 2048, 129],
            "slice": {"busy_s": WINDOW - sum(v for _, v in gaps), "window_s": WINDOW,
                      "kernels": 100, "device_label_s": labels,
                      "breakdown": {"device_ops": [], "idle_gaps": [list(g) for g in gaps]}}}


SPANS = {"sednn.decode.stft": 0.012, "sednn.decode.features": 0.015,
         "sednn.decode.forward": 0.339, "sednn.decode.istft": 0.011}
GAPS = [("sync", 0.019), ("sednn.decode.stft", 0.010), ("sednn.decode.features", 0.004),
        ("host_other", 0.001), ("sednn.decode", 0.0005), ("sednn.decode.forward", 0.0005),
        ("decode_request", 0.003), ("sednn.decoder", 0.002), ("sednn.chunk.prepare", 0.001)]


def test_decode_idle_counts_the_decode_spans_alone():
    got = run.read_layer_metric("decode_idle_pct", _serve(SPANS, GAPS))
    assert got == pytest.approx(100.0 * (0.010 + 0.004 + 0.0005 + 0.0005) / WINDOW)


def test_decode_dsp_is_the_stages_but_the_forward():
    got = run.read_layer_metric("decode_dsp_pct", _serve(SPANS, GAPS))
    assert got == pytest.approx(100.0 * (0.012 + 0.015 + 0.011) / WINDOW)


@pytest.mark.parametrize("name", ["decode_idle_pct", "decode_dsp_pct"])
@pytest.mark.parametrize("labels", [
    {"decode_request": 0.37},  # a program without the spans: the driver's label alone
    {},  # a CPU run: no device timeline
    {k: v for k, v in SPANS.items() if k != "sednn.decode.forward"},
], ids=["no_spans", "cpu", "no_forward"])
def test_nothing_without_the_forward_span(name, labels):
    assert run.read_layer_metric(name, _serve(labels, GAPS)) is None


@pytest.mark.parametrize("name", ["decode_idle_pct", "decode_dsp_pct"])
def test_nothing_from_a_training_reading(name):
    r = {"bunches": 800, "slice": {"busy_s": 3.0, "window_s": 3.2, "device_label_s":
                                   {"chunk_train": 3.1}, "breakdown": {"idle_gaps": []}}}
    assert run.read_layer_metric(name, r) is None


def test_no_idle_in_the_spans_reads_zero():
    gaps = [g for g in GAPS if not g[0].startswith("sednn.decode.") and g[0] != "sednn.decode"]
    assert run.read_layer_metric("decode_idle_pct", _serve(SPANS, gaps)) == 0.0
