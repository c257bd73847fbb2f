"""Closed-loop offline enhancement by the causal CRN (Tan & Wang 2018), one
client: each request is a batch of noisy utterances of one length, enhanced
by the port's CRN decoder (enhance/decode.py:make_crn_decoder) and
synchronised; the next request is sent when it returns.  The weights, drawn
here from the seed (`weights`), and a pool of batches are made at set-up;
the pool is cycled.  The window, the request and the sampled check's
reservoir are serve_batch's.

The check holds a sample of the window's requests against the float64
reference (reference/crn.py), utterance by utterance: `mag_err`, the widest
gap of the net's enhanced magnitude (which the decoder returns beside its
waveform, from the same call) from the reference's over the reference's
peak, and `wav_err`, the widest gap of the enhanced waveform from the
reference's beyond the reference's phase slack, over the reference's peak.
The slack is there because where the noisy spectrum has a notch (|X| under
1e-4 of its frame's sum of |window x|), the float32 STFT (rounding of up to
about 7e-7 of that sum) leaves the noisy phase to rounding, while random
weights put an enhanced magnitude of order 1 there: without the slack a
sound program's gap had a heavy tail (7.6e-3 of the peak at its worst, three
seeds in about fifty over 3e-3), with no bound below the TF32 control's.
The magnitude sees the noisy magnitude, which float32 keeps, and reads the
net alone.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from portbench import crn_roofline, harness
from portbench.drivers.serve_batch import _request, window
from portbench.generate import noisy_speech
from portbench.reference import crn as ref


def weights(gen: torch.Generator, cfg: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The CRN's tensors by name and layout (reference/crn.py), float32,
    drawn on `device` from `gen` as the configuration's `assumed.init` says,
    layer by layer (enc1 .. enc5, lstm1, lstm2, dec5 .. dec1):
    (de)convolutions U(+-1/sqrt(fan_in)) for weight and bias, fan_in the
    weight's dim 1 times its 2 x 3 taps (a transposed convolution's output
    channels, as PyTorch's default has it); batch norm gamma U(0.5, 1.5),
    beta and running mean N(0, 0.1^2), running variance U(0.5, 1.5), after
    every layer but dec1; LSTM U(+-1/sqrt(H)) for every tensor."""
    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    t: Dict[str, torch.Tensor] = {}

    def conv(name, w_shape, n_out, bn):
        r = (w_shape[1] * 6) ** -0.5
        t[f"{name}.w"], t[f"{name}.b"] = uniform(w_shape, -r, r), uniform((n_out,), -r, r)
        if bn:
            t[f"{name}.gamma"] = uniform((n_out,), 0.5, 1.5)
            t[f"{name}.beta"] = normal((n_out,), 0.1)
            t[f"{name}.mean"] = normal((n_out,), 0.1)
            t[f"{name}.var"] = uniform((n_out,), 0.5, 1.5)

    ch = [1] + list(cfg["channels"])
    depth, H = len(ch) - 1, cfg["lstm_hidden"]
    for l in range(1, depth + 1):
        conv(f"enc{l}", (ch[l], ch[l - 1], 2, 3), ch[l], True)
    r = H ** -0.5
    for k in range(1, cfg["lstm_layers"] + 1):
        for name, shape in (("w_ih", (H, 4 * H)), ("w_hh", (H, 4 * H)), ("b", (4 * H,))):
            t[f"lstm{k}.{name}"] = uniform(shape, -r, r)
    for l in range(depth, 0, -1):
        conv(f"dec{l}", (2 * ch[l], ch[l - 1], 2, 3), ch[l - 1], l > 1)
    return t


class Program:
    """The port's CRN decoder, built once on the benchmark's weights, with
    the net's stages that `stages` gives (none: model/crn.py's).  Its output
    waveform carries, as `magnitude`, the net's enhanced magnitude of the
    same call."""

    stages: Dict = {}

    def __init__(self, cfg: Dict, tensors: Dict[str, torch.Tensor], dev: torch.device):
        from tpu_sednn_torch.dsp.stft import StftConfig
        from tpu_sednn_torch.enhance.decode import make_crn_decoder
        from tpu_sednn_torch.model.crn import CRN, CRNConfig

        net = CRNConfig(n_bins=cfg["n_bins"], channels=tuple(cfg["channels"]),
                        lstm_hidden=cfg["lstm_hidden"], lstm_layers=cfg["lstm_layers"],
                        bn_eps=cfg["bn_eps"])
        decode = make_crn_decoder(CRN(net, tensors), StftConfig(cfg["sample_rate"], cfg["win_len"],
                                                                cfg["hop"], cfg["n_fft"]),
                                  device=dev, **self.stages)

        def with_magnitude(wavs):
            out, mag = decode(wavs, magnitude=True)
            out.magnitude = mag
            return out

        self.decode = with_magnitude


class Reference:
    """reference/crn.py in the decoder's place, in `precision` ("tf32": the
    control of float32 products)."""

    def __init__(self, cfg: Dict, tensors: Dict[str, torch.Tensor], dev: torch.device,
                 precision: str = "tf32"):
        def decode(wavs):
            wav, mag, _ = ref.enhance(wavs, tensors, cfg, precision)
            out = wav.float()
            out.magnitude = mag.float()
            return out

        self.decode = decode


def _stale_lstm(folded, e_last):
    """The recurrence's stage (model/crn.py:crn_lstm) with h and c reset at
    every step: each step's gates from its input alone, in plain torch."""
    p = folded.tensors
    B, T = e_last.shape[:2]
    h = e_last.permute(1, 0, 3, 2).reshape(T * B, -1)  # channel-major, as the stage takes it
    for k in range(1, folded.cfg.lstm_layers + 1):
        i, _, g, o = torch.addmm(p[f"lstm{k}.b"], h, p[f"lstm{k}.w_ih"]).chunk(4, dim=1)
        h = torch.sigmoid(o) * torch.tanh(torch.sigmoid(i) * torch.tanh(g))
    return h.view(T, B, -1)


def _noskip_decoder(folded, h, skips):
    """The decoder's stage (model/crn.py:crn_decoder) with its skip inputs
    zeroed."""
    from tpu_sednn_torch.model.crn import crn_decoder

    return crn_decoder(folded, h, [torch.zeros_like(e) for e in skips])


class Stale(Program):
    """h and c reset at every step."""

    stages = {"lstm": _stale_lstm}


class NoSkip(Program):
    """The decoder's skip inputs zeroed."""

    stages = {"decoder": _noskip_decoder}


# the modes of `python3 -m portbench.readings`, each the decoder or its stand-in
STAND_INS = {"program": Program, "control": Reference, "stale": Stale, "noskip": NoSkip}
MODES = tuple(STAND_INS)
# a size the CPU decodes in a second (the tests)
TINY = dict(config=dict(channels=[2, 4, 4, 8, 8], lstm_hidden=32),
            traffic=dict(utterances=2, utterance_seconds=0.5, pool=2, checked_requests=2,
                         mfu_requests=2, trace_requests=1))
# the published widths, a pool a test run on the card holds
CARD_CUT = dict(config={}, traffic=dict(pool=2, checked_requests=2))


def setup(cell, program_cls=Program) -> Dict:
    import tpu_sednn_torch.model.crn  # noqa: F401  (first: a program without the CRN stops here)

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    gen = torch.Generator(device=dev).manual_seed(cell.seed)
    tensors = weights(gen, cfg, dev)
    n = int(round(tr["utterance_seconds"] * cfg["sample_rate"]))
    pool = noisy_speech(gen, tr["pool"] * tr["utterances"], n, cfg["sample_rate"],
                        tuple(tr["snr_db"]), dev).view(tr["pool"], tr["utterances"], n)
    prog = program_cls(cfg, tensors, dev)
    for k in range(min(2, tr["pool"])):
        prog.decode(pool[k])
    harness.sync(dev)
    return dict(tensors=tensors, pool=pool, prog=prog)


def _frames(rec, cfg) -> int:
    return 1 + (rec["pool"].shape[-1] - cfg["win_len"]) // cfg["hop"]


def measure_layers(rec, cell) -> Dict:
    """The traced run's readings: `mfu_requests` requests timed by the
    host's clock as the window times them (a sample of them checked as the
    window's are), then a profiled slice of `trace_requests` requests, with
    the recurrence's least time for those requests (crn_roofline)."""
    dev, pool, prog, tr, cfg = cell.device, rec["pool"], rec["prog"], cell.traffic, cell.config
    timed = window(rec, cell, count=tr["mfu_requests"])
    reading: Dict = {}
    with harness.traced(dev, reading):
        for i in range(tr["trace_requests"]):
            _request(prog, pool[i % pool.shape[0]], dev)
    frames, batch = _frames(rec, cfg), pool.shape[1]
    return dict(requests_s=timed["seconds"], frames=timed["requests"] * batch * frames,
                flop_per_frame=crn_roofline.flop_per_frame(cfg),
                lstm_bound_s=tr["trace_requests"] * crn_roofline.lstm_bound_s(cfg, batch, frames),
                slice=reading, kept=timed["kept"])


def readings(rec, cell, kept, whole: bool = False) -> Dict[str, float]:
    """`wav_err` and `mag_err` (see the module's docstring): the worst
    utterance of the checked requests; with `whole`, also `wav_err_whole`,
    the waveform's gap without the phase slack."""
    refs: Dict = {}
    worst = dict.fromkeys(("wav_err", "mag_err") + (("wav_err_whole",) if whole else ()), 0.0)
    for k, out in kept:
        if k not in refs:
            refs[k] = ref.enhance(rec["pool"][k], rec["tensors"], cell.config)
        wav, mag, slack = refs[k]
        gap = (out.to(torch.float64) - wav).abs()
        gaps = {"wav_err": (gap - slack).clamp(min=0).amax(dim=-1),
                "mag_err": (out.magnitude.to(torch.float64) - mag).abs().flatten(1).amax(dim=-1),
                "wav_err_whole": gap.amax(dim=-1)}
        peaks = {"wav_err": wav.abs().amax(dim=-1), "mag_err": mag.abs().flatten(1).amax(dim=-1),
                 "wav_err_whole": wav.abs().amax(dim=-1)}
        for name in worst:
            rel = gaps[name] / peaks[name]
            if not bool(torch.isfinite(rel).all()):
                return {n: float("inf") for n in worst}
            worst[name] = max(worst[name], float(rel.max()))
    return worst


def read_seed(cell, modes, steps: bool = True) -> Dict[str, Dict[str, float]]:
    """The numbers of each mode on one seed (`python3 -m portbench.readings`):
    as many requests back to back as a run checks."""
    out = {}
    for mode in modes:
        rec = setup(cell, STAND_INS[mode])
        w = window(rec, cell, count=cell.traffic["checked_requests"])
        rec.pop("prog")
        cell.release()
        out[mode] = readings(rec, cell, w["kept"], whole=True)
        del rec, w
    return out


def run(cell, program_cls=Program) -> Dict:
    rec = setup(cell, program_cls)
    cell.setup_done()
    out: Dict = {}
    if cell.trace:
        out["layers"] = measure_layers(rec, cell)
        kept = out["layers"].pop("kept")
        out["attempted"], out["failed"] = cell.traffic["mfu_requests"], 0
    else:
        w = window(rec, cell)
        lat = np.asarray(w["latencies"]) * 1e3
        print(f"serve: {w['requests']} requests in {w['seconds']:.3f} s; ms median "
              f"{np.median(lat):.3f}, p95 {np.percentile(lat, 95):.3f}, max {lat.max():.3f}",
              file=sys.stderr)
        audio = w["requests"] * rec["pool"].shape[1] * cell.traffic["utterance_seconds"]
        out["e2e"] = {"enhance_audio_s_per_s": (audio / w["seconds"], "audio-s/s"),
                      "enhance_p95_ms": (float(np.percentile(w["latencies"], 95)) * 1e3, "ms")}
        out["attempted"], out["failed"] = w["requests"], 0
        kept = w["kept"]
    out["memory_peak_bytes"] = cell.memory_peak()
    rec.pop("prog")
    cell.release()
    out["numbers"] = readings(rec, cell, kept)
    return out
