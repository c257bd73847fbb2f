"""Closed-loop offline enhancement, one client: each request is a batch of
noisy utterances of one length, enhanced by the port's serving decoder and
synchronised; the next request is sent when it returns.  A pool of batches
made at set-up is cycled.

A sample of the window's requests, drawn from the seed by reservoir
sampling over all of them, is held against the reference decode once the
window has closed.
"""

from __future__ import annotations

import random
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import harness
from portbench.generate import noisy_speech
from portbench.reference import decode as ref


def keeps(cfg: Dict) -> List[float]:
    layers = len(cfg["layersizes"]) - 1
    return [1.0 - cfg["dropout_vis"]] + [1.0 - cfg["dropout_hid"]] * (layers - 1)


class Program:
    """The port's serving decoder, built once."""

    def __init__(self, cfg: Dict, ws, bs, mean: np.ndarray, inv_std: np.ndarray,
                 dev: torch.device):
        from tpu_sednn_torch.dsp.stft import StftConfig
        from tpu_sednn_torch.enhance.decode import EnhanceConfig, make_serving_decoder
        from tpu_sednn_torch.model.mlp import MLP, ModelConfig

        mcfg = ModelConfig(tuple(cfg["layersizes"]), hidden=cfg["hidden"],
                           output=cfg["output"]).with_dropout(
            cfg["dropout_vis"], cfg["dropout_hid"], cfg["dropout_mode"])
        ecfg = EnhanceConfig(stft=StftConfig(cfg["sample_rate"], cfg["win_len"], cfg["hop"],
                                             cfg["n_fft"]),
                             fea_context=cfg["fea_context"], targ_offset=cfg["targ_offset"],
                             nat=True, nat_frames=cfg["nat_frames"])
        self.decode = make_serving_decoder(MLP(ws, bs), mcfg, ecfg, mean, inv_std, device=dev)


class Reference:
    """reference/decode.py in the decoder's place, in `precision` ("tf32":
    the control of float32 products)."""

    def __init__(self, cfg: Dict, ws, bs, mean, inv_std, dev: torch.device,
                 precision: str = "tf32"):
        mean_d = torch.as_tensor(mean, device=dev)
        istd_d = torch.as_tensor(inv_std, device=dev)

        def decode(wavs):
            return ref.enhance(wavs, ws, bs, keeps(cfg), mean_d, istd_d, cfg["win_len"],
                               cfg["hop"], cfg["n_fft"], cfg["fea_context"], cfg["targ_offset"],
                               cfg["nat_frames"], precision).float()

        self.decode = decode


# the modes of `python3 -m portbench.readings`, each the decoder or its stand-in
STAND_INS = {"program": Program, "control": Reference}
MODES = tuple(STAND_INS)
# a size the CPU decodes in a second (the tests)
TINY = dict(config=dict(layersizes=[108, 32, 32, 32, 9], n_fft=16, win_len=16, hop=8),
            traffic=dict(utterances=4, utterance_seconds=0.5, pool=3, checked_requests=3,
                         mfu_requests=4, trace_requests=2))
# the published widths, a pool a test run on the card holds
CARD_CUT = dict(config={}, traffic=dict(pool=2, checked_requests=2))


def lps_stats(wavs: torch.Tensor, cfg: Dict):
    """Per-bin mean and inverse deviation of the noisy LPS of `wavs`, as
    float32 numpy arrays (the normalisation both sides are handed)."""
    win = ref.hamming(cfg["win_len"], torch.float32, wavs.device)
    frames = wavs.reshape(-1, wavs.shape[-1]).unfold(-1, cfg["win_len"], cfg["hop"]).contiguous()
    spec = torch.fft.rfft(frames * win, n=cfg["n_fft"])
    lps = torch.log(torch.clamp(spec.real ** 2 + spec.imag ** 2, min=ref.LPS_FLOOR))
    lps = lps.reshape(-1, lps.shape[-1]).double()
    mean, std = lps.mean(dim=0), lps.std(dim=0)
    return (mean.float().cpu().numpy(), (1.0 / std).float().cpu().numpy())


def setup(cell, program_cls=Program) -> Dict:
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    gen = torch.Generator(device=dev).manual_seed(cell.seed)
    ws, bs = harness.uniform_weights(gen, cfg["layersizes"], dev)
    n = int(round(tr["utterance_seconds"] * cfg["sample_rate"]))
    pool = noisy_speech(gen, tr["pool"] * tr["utterances"], n, cfg["sample_rate"],
                        tuple(tr["snr_db"]), dev).view(tr["pool"], tr["utterances"], n)
    mean, inv_std = lps_stats(pool, cfg)
    prog = program_cls(cfg, ws, bs, mean, inv_std, dev)
    for k in range(min(2, tr["pool"])):
        prog.decode(pool[k])
    harness.sync(dev)
    return dict(ws=ws, bs=bs, pool=pool, mean=mean, inv_std=inv_std, prog=prog)


def _request(prog, batch, dev):
    with harness.label("decode_request"):
        out = prog.decode(batch)
    with harness.label("sync"):
        harness.sync(dev)
    return out


def window(rec, cell, count: int = 0) -> Dict:
    """Requests back to back until `seconds` have passed (or `count`
    requests are done); each request's time from its submission to its
    synchronised output."""
    dev, pool, prog = cell.device, rec["pool"], rec["prog"]
    keep_n = cell.traffic["checked_requests"]
    rnd = random.Random(cell.seed)
    kept: List = []
    lat: List[float] = []
    harness.sync(dev)
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % pool.shape[0]
        t_sub = time.perf_counter()
        out = _request(prog, pool[k], dev)
        t_done = time.perf_counter()
        lat.append(t_done - t_sub)
        if i < keep_n:
            kept.append((k, out))
        else:
            j = rnd.randint(0, i)
            if j < keep_n:
                kept[j] = (k, out)
        i += 1
        if (i >= count) if count else (t_done - t0 >= cell.seconds):
            break
    return dict(requests=i, seconds=t_done - t0, latencies=lat, kept=kept)


def measure_layers(rec, cell) -> Dict:
    """The traced run's readings: `mfu_requests` requests timed by the
    host's clock as the window times them (a sample of them checked as the
    window's are), then a profiled slice of `trace_requests` requests."""
    dev, pool, prog, tr = cell.device, rec["pool"], rec["prog"], cell.traffic
    timed = window(rec, cell, count=tr["mfu_requests"])
    reading: Dict = {}
    with harness.traced(dev, reading):
        for i in range(tr["trace_requests"]):
            _request(prog, pool[i % pool.shape[0]], dev)
    cfg = cell.config
    frames = 1 + (pool.shape[-1] - cfg["win_len"]) // cfg["hop"]
    return dict(requests_s=timed["seconds"], frames=timed["requests"] * pool.shape[1] * frames,
                sizes=cfg["layersizes"], slice=reading, kept=timed["kept"])


def readings(rec, cell, kept, precision: str = "f64") -> Dict[str, float]:
    """The widest gap of a checked request's enhanced waveforms from the
    reference's, against the reference's peak, utterance by utterance."""
    cfg = cell.config
    refs: Dict[int, torch.Tensor] = {}
    worst = 0.0
    for k, out in kept:
        if k not in refs:
            refs[k] = ref.enhance(rec["pool"][k], rec["ws"], rec["bs"], keeps(cfg),
                                  torch.as_tensor(rec["mean"], device=out.device),
                                  torch.as_tensor(rec["inv_std"], device=out.device),
                                  cfg["win_len"], cfg["hop"], cfg["n_fft"], cfg["fea_context"],
                                  cfg["targ_offset"], cfg["nat_frames"], precision)
        r = refs[k].to(torch.float64)
        gap = (out.to(torch.float64) - r).abs().amax(dim=-1) / r.abs().amax(dim=-1)
        if not bool(torch.isfinite(gap).all()):
            return {"wav_err": float("inf")}
        worst = max(worst, float(gap.max()))
    return {"wav_err": worst}


def read_seed(cell, modes, steps: bool = True) -> Dict[str, Dict[str, float]]:
    """The numbers of each mode on one seed (`python3 -m portbench.readings`):
    as many requests back to back as a run checks."""
    out = {}
    for mode in modes:
        rec = setup(cell, STAND_INS[mode])
        w = window(rec, cell, count=cell.traffic["checked_requests"])
        rec.pop("prog")
        cell.release()
        out[mode] = readings(rec, cell, w["kept"])
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
