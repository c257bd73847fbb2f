"""The program's spans (utils/profiling.py:span) on the CPU: one shared null
context while no profiler records, and under torch.profiler the decode's
and the chunk trainer's spans, nested as the module's docstring lists them.
Their copies on the device's timeline are held on the card
(portbench/tests/test_pb_span_card.py)."""

import contextlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import tpu_sednn_torch.utils.profiling as profiling
from tpu_sednn_torch.dsp.stft import StftConfig
from tpu_sednn_torch.enhance.decode import EnhanceConfig, make_serving_decoder
from tpu_sednn_torch.model.mlp import MLP, ModelConfig
from tpu_sednn_torch.train.loop import make_chunk_runner
from tpu_sednn_torch.train.step import OptConfig, init_train_state

# the serve benchmark's test widths: 11 frames of 9 bins and the NAT estimate
SIZES = (108, 32, 32, 32, 9)
DECODE_STAGES = ["sednn.decode.stft", "sednn.decode.features", "sednn.decode.forward",
                 "sednn.decode.istft"]


def _decoder():
    gen = torch.Generator().manual_seed(5)
    ws = [torch.randn(a, b, generator=gen) * 0.1 for a, b in zip(SIZES[:-1], SIZES[1:])]
    bs = [torch.zeros(b) for b in SIZES[1:]]
    mcfg = ModelConfig(SIZES).with_dropout(0.1, 0.2, "parity")
    ecfg = EnhanceConfig(stft=StftConfig(8000, 16, 8, 16), fea_context=11, targ_offset=5,
                         nat=True, nat_frames=6)
    mean, inv_std = np.zeros(9, np.float32), np.ones(9, np.float32)
    return make_serving_decoder(MLP(ws, bs), mcfg, ecfg, mean, inv_std, device="cpu")


def _wavs():
    return torch.randn(2, 400, generator=torch.Generator().manual_seed(6))


def _spans(prof):
    """(start, end, name) of the host's `sednn.` ranges, in order of start."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CPU and e.is_user_annotation
                  and e.name.startswith("sednn."))


def test_span_is_one_null_context_without_a_profiler(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("sednn.a"), profiling.span("sednn.b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or contextlib.nullcontext())
    decode = _decoder()
    decode(_wavs())
    assert opened == []


def test_decode_records_its_stages_nested_in_order():
    decode = _decoder()
    wavs = _wavs()
    want = decode(wavs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = decode(wavs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    spans = _spans(prof)
    assert [s[2] for s in spans] == ["sednn.decode"] + DECODE_STAGES
    (a, b, _), stages = spans[0], spans[1:]
    assert all(a <= s <= e <= b for s, e, _ in stages)
    assert all(e0 <= s1 for (_, e0, _), (s1, _, _) in zip(stages, stages[1:]))


@pytest.mark.parametrize("engine,want", [("resident", ["sednn.chunk.prepare"]), ("xla", [])])
def test_chunk_runner_records_the_trainer_stages(engine, want):
    """A CPU state runs the plain versions: the resident trainer's checks
    are spanned, its allocations and C call happen only on a card, and the
    plain parity trainer has no span."""
    cfg = ModelConfig((12, 16, 4)).with_dropout(0.1, 0.2, "parity")
    opt = OptConfig(lrate=0.1, momentum=0.5, bunchsize=8)
    run = make_chunk_runner(cfg, opt, engine, device="cpu", bf16=False)
    gen = torch.Generator().manual_seed(7)
    w = [torch.randn(12, 16, generator=gen) * 0.1, torch.randn(16, 4, generator=gen) * 0.1]
    state = init_train_state(MLP(w, [torch.zeros(16), torch.zeros(4)]))
    x, t = torch.randn(32, 12, generator=gen), torch.randn(32, 4, generator=gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(state, x, t, torch.Generator().manual_seed(8), 0.1, 0.5, 0.0)
    assert [s[2] for s in _spans(prof)] == want
    assert int(state.step) == 4
