"""Each driver end to end at a tiny size on the CPU (the port's plain
trainer and decode): the result line has the contract's shape and `correct`
true; the lower-precision control, put in the program's place, and each
fault the cell can have, planted in the timed path, read `correct` false."""

import json

import pytest
import torch

from portbench import run
from portbench.drivers import serve_batch, train_resident

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11
CELLS = ["train-8k-resident", "serve-8k-batch", "train-16k-resident", "serve-16k-batch"]


def _line(bench, found, trace, program=None, seconds=0.3):
    res = run.run_cell(bench, found, SEED, seconds, trace, CPU, program)
    if trace:  # a CPU run has no kernel spans: the slice reads as all idle
        res["layers"]["slice"].setdefault("busy_s", 0.0)
    return json.loads(json.dumps(run.result_line(res, {"platform": "cpu", "kind": "cpu",
                                                       "count": 1}, trace)))


@pytest.mark.parametrize("workload", CELLS)
def test_result_line(tiny, workload):
    bench, found = tiny(workload)
    line = _line(bench, found, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert line["checks"] and all(c["value"] <= c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("workload", ["train-8k-resident", "serve-8k-batch"])
def test_traced_line(tiny, workload):
    bench, found = tiny(workload)
    line = _line(bench, found, True)
    assert line["correct"] is True
    names = {m["name"] for m in bench["per_layer"] if workload in m["workloads"]}
    # the device's idle share and the trainer's time need the device's spans,
    # which a CPU run has none of
    on_device = ("device_idle", "epoch_overhead", "trainer_roofline")
    assert set(line["metrics"]) == {n for n in names if not n.startswith(on_device)}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "window_s" in line["device"] and "busy_s" in line["device"]


def test_no_card_no_result(capsys):
    assert run.main(["--workload", "serve-8k-batch", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


class _HalfBunch(train_resident.Program):
    """Each bunch's second half replaced by its first: the mean over half."""

    def train(self, state, x, t, rng, lrate, m, n_real=None):
        bunch = self.cfg["bunchsize"]
        rows = x.shape[0] // bunch * bunch
        x, t = x[:rows].clone(), t[:rows].clone()
        for a in (x, t):
            v = a.view(-1, bunch, a.shape[1])
            v[:, bunch // 2:] = v[:, :bunch // 2]
        return super().train(state, x, t, rng, lrate, m, n_real)


class _AlteredCV(train_resident.Program):
    def cv(self, state, x, t):
        return super().cv(state, x, t) * 1.01


# faults that act only in a full chunk call, as the window makes them (the
# check's set-up calls train one or two bunches)
class _SkipsPastFew(train_resident.Program):
    """A full call trains its first few bunches alone."""

    def train(self, state, x, t, rng, lrate, m, n_real=None):
        return super().train(state, x, t, rng, lrate, m, 4 if n_real is None else n_real)


class _StaleMomentum(train_resident.Program):
    """A full call keeps the first epoch's momentum."""

    def train(self, state, x, t, rng, lrate, m, n_real=None):
        if n_real is None:
            m = self.cfg["momentum_start"]
        return super().train(state, x, t, rng, lrate, m, n_real)


class _FullCallAltered(train_resident.Program):
    """A full call's result altered where it is produced."""

    def train(self, state, x, t, rng, lrate, m, n_real=None):
        out = super().train(state, x, t, rng, lrate, m, n_real)
        if n_real is None:
            state.params.w[1].mul_(1.01)
        return out


TRAIN_FAULTS = {"control": train_resident.STAND_INS["control"],
                "unchanged": train_resident.Unchanged, "half_bunch": _HalfBunch,
                "altered_cv": _AlteredCV, "skips_past_few": _SkipsPastFew,
                "stale_momentum": _StaleMomentum, "full_call_altered": _FullCallAltered}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_control_and_faults_fail(tiny, fault):
    bench, found = tiny("train-8k-resident")
    # a window long enough for the last call to come after the first epochs
    seconds = 1.5 if fault == "stale_momentum" else 0.3
    assert _line(bench, found, False, TRAIN_FAULTS[fault], seconds)["correct"] is False


class _Wrapped(serve_batch.Program):
    def __init__(self, *args):
        super().__init__(*args)
        inner = self.decode
        self.decode = lambda wavs: self.alter(inner, wavs)


class _Unenhanced(_Wrapped):
    def alter(self, inner, wavs):
        return wavs.clone()


class _HalfBatch(_Wrapped):
    def alter(self, inner, wavs):
        half = inner(wavs[:wavs.shape[0] // 2])
        return torch.cat([half, half])[:wavs.shape[0]]


class _AlteredSample(_Wrapped):
    def alter(self, inner, wavs):
        out = inner(wavs).clone()
        out[0, out.shape[1] // 2] += 0.05 * float(out.abs().max())
        return out


SERVE_FAULTS = {"control": serve_batch.Reference, "unenhanced": _Unenhanced,
                "half_batch": _HalfBatch, "altered_sample": _AlteredSample}


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_serve_control_and_faults_fail(tiny, fault):
    bench, found = tiny("serve-8k-batch")
    assert _line(bench, found, False, SERVE_FAULTS[fault])["correct"] is False
