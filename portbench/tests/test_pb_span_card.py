"""On the card: the program's spans in a traced run of a cell, at the cells'
published widths with a corpus and batches cut to what a test run holds
(each driver's CARD_CUT).  The decode's stages each have a copy on the
device's timeline and the metrics that read them give finite numbers; the
chunk trainer's spans enclose no launch, so the driver's label around a
chunk call keeps the call's device time; the run stays correct; and in a
raw profile each device copy of the forward starts after its host span
(the two share the profiler's clock).  Run on the chip: `python3 -m pytest
portbench/tests -q -m card`."""

import math
from types import SimpleNamespace

import pytest
import torch

from portbench import run
from portbench.drivers import serve_batch
from portbench.tests.test_pb_card import _cut

SEED = 2 ** 31 + 307
DECODE_SPANS = ("sednn.decode.stft", "sednn.decode.features", "sednn.decode.forward",
                "sednn.decode.istft")


def _traced(card, workload):
    bench = run.load_json(run.os.path.join(run.ROOT, "BENCHMARK.json"))
    found = _cut(workload)
    res = run.run_cell(bench, found, SEED, 3.0, True, card)
    return res, res["layers"]["slice"]


@pytest.mark.card
def test_decode_spans_on_the_device(card):
    res, sl = _traced(card, "serve-8k-batch")
    assert res["correct"]
    under = sl["device_label_s"]
    assert all(under.get(name, 0.0) > 0.0 for name in DECODE_SPANS), under
    for name in ("decode_idle_pct", "decode_dsp_pct"):
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and 0.0 <= value <= 100.0, (name, value)


@pytest.mark.card
def test_trainer_spans_leave_the_call_to_its_caller(card):
    res, sl = _traced(card, "train-8k-resident")
    assert res["correct"]
    under = sl["device_label_s"]
    assert under.get("chunk_train", 0.0) > 0.0, under
    assert not [k for k in under if k.startswith("sednn.")], under
    assert {"epoch_overhead_pct", "trainer_roofline"} <= set(res["metrics"])


@pytest.mark.card
def test_forward_span_shares_the_device_clock(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    found = _cut("serve-8k-batch")
    cell = SimpleNamespace(config=found["config"], traffic=found["traffic"], seed=SEED,
                           device=card)
    rec = serve_batch.setup(cell)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(rec["pool"].shape[0]):
            rec["prog"].decode(rec["pool"][k])
        torch.cuda.synchronize(card)
    name = "sednn.decode.forward"
    host = sorted(e.time_range.start for e in prof.events()
                  if e.device_type == DeviceType.CPU and e.name == name)
    device = sorted(e.time_range.start for e in prof.events()
                    if e.device_type == DeviceType.CUDA and e.name == name)
    assert len(host) == len(device) == rec["pool"].shape[0]
    assert all(d >= h for h, d in zip(host, device)), list(zip(host, device))
