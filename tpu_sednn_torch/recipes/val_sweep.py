"""Held-out validation sweep for decode-time parameters (ADVICE/VERDICT r2).

The decode gain window (min/max_gain_db), mask floor, and GV mode used to be
swept on the three `enh_wav_example` demo clips — the same clips the tracked
quality gate scores, so the gate partially measured a parameter tuned on its
own test set.  This module fixes that:

* `make_val_clips` builds a HELD-OUT synthetic validation set (fresh seed
  stream, disjoint from every training corpus seed; noise kinds x SNRs
  spanning the demo-clip conditions) WITH clean ground truth — so decode
  parameters are scored against actual clean speech, not a proxy;
* `sweep_decode_params` grid-searches the decode parameters on those clips,
  maximizing mean LSD improvement subject to a non-negative mean STOI gain;
* the winner is FROZEN into the run dir's run.json, which demo_gate and the
  enhance CLI read — the demo clips stay a pure regression gate.

CLI:  python -m tpu_sednn_torch.recipes.val_sweep RUN_DIR [--grid small|full]
          [--device cuda|cpu]

Counterpart of tpu_sednn/recipes/val_sweep.py: the decode (enhance_lps +
overlap-add) runs on `device`, the card unless the CPU is asked for; the
scores on the host.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# validation conditions approximate the gate clips' regimes (stationary +
# babble-like noise, low-to-mid SNR) without using any gate audio
VAL_NOISE_KINDS = ("white", "pink", "babble", "hfchannel")
VAL_SNRS = (0.0, 5.0, 10.0)
VAL_SEED = 777000  # disjoint from every recipe/corpus seed in the repo


def make_val_clips(sr: int, n_clips: int = 8, seconds: float = 4.0,
                   seed: int = VAL_SEED) -> List[Tuple[np.ndarray, np.ndarray]]:
    """-> [(clean, noisy)] held-out validation pairs at sample rate `sr`."""
    from tpu_sednn_torch.data.mixing import mix_at_snr, synth_noise, synth_speech

    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    clips = []
    for i in range(n_clips):
        clean = synth_speech(rng, n, sr, style="rich")
        kind = VAL_NOISE_KINDS[i % len(VAL_NOISE_KINDS)]
        snr = VAL_SNRS[i % len(VAL_SNRS)]
        try:
            noise = synth_noise(rng, n, kind)
        except (KeyError, ValueError):  # noise family not in this build
            noise = synth_noise(rng, n, "white")
        clips.append((clean, mix_at_snr(clean, noise, snr, rng)))
    return clips


def _prep_clips(clips, stft, sr, device="cuda"):
    """Per-clip precompute shared by every sweep candidate: STFT of the noisy
    clip (re/im/lps, on `device`), clean LPS, and the clean-vs-noisy baseline
    metrics — the per-candidate work shrinks to enhance_lps + overlap-add +
    metrics."""
    import torch

    from tpu_sednn_torch.dsp import LPS_FLOOR, stft_real_imag
    from tpu_sednn_torch.metrics import lsd, seg_snr, stoi
    from tpu_sednn_torch.recipes.multi_condition import host_lps

    prepped = []
    for clean, noisy in clips:
        re, im = stft_real_imag(torch.as_tensor(np.asarray(noisy, np.float32), device=device), stft)
        noisy_lps = torch.log(torch.clamp(re * re + im * im, min=LPS_FLOOR))
        c_lps = host_lps(clean, stft, device)
        prepped.append({
            "clean": clean, "noisy": noisy, "re": re, "im": im,
            "noisy_lps": noisy_lps, "clean_lps": c_lps,
            "lsd_noisy": lsd(c_lps, noisy_lps.cpu().numpy()),
            "stoi_noisy": stoi(clean, noisy, sr),
            "segsnr_noisy": seg_snr(clean, noisy, sr),
        })
    return prepped


def _score(params, mcfg, ecfg, prepped, mean, inv_std, target_norm, gv_ref,
           device="cuda"):
    """Mean (lsd_gain, stoi_gain, segsnr_gain) vs CLEAN over prepped clips."""
    import torch

    from tpu_sednn_torch.dsp import reconstruct_from_lps
    from tpu_sednn_torch.enhance.decode import enhance_lps
    from tpu_sednn_torch.metrics import lsd, seg_snr, stoi
    from tpu_sednn_torch.recipes.multi_condition import host_lps

    def on(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    sr = ecfg.stft.sample_rate
    tn = None if target_norm is None else (on(target_norm[0]), on(target_norm[1]))
    gv = None if gv_ref is None else on(gv_ref)
    params = params.on(device)
    lsd_g, stoi_g, seg_g = [], [], []
    for p in prepped:
        with torch.inference_mode():
            e_lps = enhance_lps(params, mcfg, ecfg, p["noisy_lps"], on(mean), on(inv_std),
                                target_norm=tn, gv_ref=gv)
            enh = reconstruct_from_lps(e_lps, p["re"], p["im"], ecfg.stft,
                                       n_samples=len(p["noisy"])).cpu().numpy()
        n = min(len(p["clean"]), len(enh))
        c, e = p["clean"][:n], enh[:n]
        lsd_g.append(p["lsd_noisy"] - lsd(p["clean_lps"], host_lps(e, ecfg.stft, device)))
        stoi_g.append(stoi(c, e, sr) - p["stoi_noisy"])
        seg_g.append(seg_snr(c, e, sr) - p["segsnr_noisy"])
    return (float(np.mean(lsd_g)), float(np.mean(stoi_g)), float(np.mean(seg_g)))


# 0.01 STOI is worth ~0.5 dB of LSD in the combined objective: intelligibility
# degrades far less gracefully than spectral distance, and a pure-LSD
# objective picks unbounded suppression that is fragile off-distribution
STOI_WEIGHT = 50.0


def sweep_decode_params(params, mcfg, ecfg_base, clips, mean, inv_std,
                        target_norm=None, gv_ref=None,
                        grid: str = "small", device="cuda") -> Dict:
    """Grid-search decode params on held-out clips.

    Objective: maximize `lsd_gain + STOI_WEIGHT * stoi_gain` subject to mean
    stoi_gain >= 0 (fall back to the best stoi_gain candidate if none
    qualify).  The combined score keeps bounded-suppression candidates
    competitive — a pure-LSD winner tends to suppress without limit, which is
    brittle on real out-of-distribution recordings.  Returns
    {"best": {...}, "table": [...]}.  params is an MLP; the decode runs on
    `device`.
    """
    from dataclasses import replace

    mask_head = ecfg_base.head in ("irm", "ibm", "psm")
    if grid == "full":
        gains = [(None, None), (-8.0, 0.0), (-10.0, 0.0), (-13.0, 0.0),
                 (-16.0, 0.0), (-20.0, 0.0)]
        floors = [0.0, 0.03, 0.05, 0.08, 0.12] if mask_head else [0.0]
        gv_modes = ["off", "global"]
    else:
        gains = [(None, None), (-10.0, 0.0), (-15.0, 0.0)]
        floors = [0.0, 0.05, 0.1] if mask_head else [0.0]
        gv_modes = ["off"]

    from tpu_sednn_torch._device import resolve_device

    device = resolve_device(device)
    prepped = _prep_clips(clips, ecfg_base.stft, ecfg_base.stft.sample_rate, device)
    table = []
    for (mn, mx), fl, gvm in itertools.product(gains, floors, gv_modes):
        if gvm != "off" and gv_ref is None:
            continue
        ecfg = replace(ecfg_base, min_gain_db=mn, max_gain_db=mx,
                       mask_floor=fl, gv_mode=gvm)
        lsd_g, stoi_g, seg_g = _score(params, mcfg, ecfg, prepped, mean,
                                      inv_std, target_norm,
                                      gv_ref if gvm != "off" else None, device)
        table.append({"min_gain_db": mn, "max_gain_db": mx, "mask_floor": fl,
                      "gv_mode": gvm, "lsd_gain": round(lsd_g, 4),
                      "stoi_gain": round(stoi_g, 5),
                      "segsnr_gain": round(seg_g, 3),
                      "score": round(lsd_g + STOI_WEIGHT * stoi_g, 4)})

    ok = [r for r in table if r["stoi_gain"] >= 0.0]
    if ok:
        best = max(ok, key=lambda r: r["score"])
    else:
        best = max(table, key=lambda r: r["stoi_gain"])
    return {"best": best, "table": table,
            "n_clips": len(clips), "seed": VAL_SEED,
            "constraint": ("mean stoi_gain >= 0; maximize lsd_gain + "
                           f"{STOI_WEIGHT:g}*stoi_gain on held-out clips")}


def sweep_run_dir(run_dir: str, grid: str = "small",
                  write: bool = True, device="cuda") -> Dict:
    """Load a trained run dir (mlp.final.wts + fea.norm + run.json), sweep on
    held-out clips on `device`, and freeze the winner back into run.json."""
    from tpu_sednn_torch.dsp import StftConfig
    from tpu_sednn_torch.enhance.decode import EnhanceConfig
    from tpu_sednn_torch.io.norm import load_norm
    from tpu_sednn_torch.io.wts import load_wts
    from tpu_sednn_torch.model.mlp import ModelConfig, params_from_wts

    man_path = os.path.join(run_dir, "run.json")
    with open(man_path) as f:
        manifest = json.load(f)
    ws, bs = load_wts(os.path.join(run_dir, "mlp.final.wts"))
    params = params_from_wts(ws, bs, device=device)
    d = len(bs[-1])
    sizes = tuple([ws[0].shape[0]] + [len(b) for b in bs])
    head = manifest.get("head", "lps")
    sr = manifest["sample_rate"]
    dr = manifest.get("dropout", (0.1, 0.2))
    mcfg = ModelConfig(layersizes=sizes, dropout_vis=dr[0], dropout_hid=dr[1],
                       dropout_mode="parity",
                       output="sigmoid" if head in ("irm", "ibm", "psm") else "linear")
    mean, inv_std = load_norm(os.path.join(run_dir, "fea.norm"), d)
    tn = None
    if os.path.exists(os.path.join(run_dir, "targ.norm")):
        tn = load_norm(os.path.join(run_dir, "targ.norm"), d)
    gv = None
    if os.path.exists(os.path.join(run_dir, "gv.txt")):
        gv = np.loadtxt(os.path.join(run_dir, "gv.txt")).astype(np.float32)
    ecfg = EnhanceConfig(stft=StftConfig.for_rate(sr),
                         fea_context=manifest["fea_context"],
                         targ_offset=manifest["targ_offset"],
                         nat=manifest.get("nat", True), head=head)
    clips = make_val_clips(sr)
    res = sweep_decode_params(params, mcfg, ecfg, clips, mean, inv_std,
                              target_norm=tn, gv_ref=gv, grid=grid, device=device)
    with open(os.path.join(run_dir, "val_sweep.json"), "w") as f:
        json.dump(res, f, indent=2)
    if write:
        best = res["best"]
        manifest.update({
            "min_gain_db": best["min_gain_db"],
            "max_gain_db": best["max_gain_db"],
            "mask_floor": best["mask_floor"],
            "gv_mode": best["gv_mode"],
            "decode_params_provenance":
                f"val_sweep grid={grid} on {res['n_clips']} held-out clips "
                f"(seed {VAL_SEED}); {res['constraint']}",
        })
        with open(man_path, "w") as f:
            json.dump(manifest, f, indent=2)
    return res


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    opts = {"--grid": "small", "--device": "cuda"}
    for flag in opts:
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i:i + 2]
    if len(argv) != 1:
        print("usage: python -m tpu_sednn_torch.recipes.val_sweep RUN_DIR "
              "[--grid small|full] [--device cuda|cpu]", file=sys.stderr)
        return 1
    res = sweep_run_dir(argv[0], grid=opts["--grid"], device=opts["--device"])
    print(json.dumps(res["best"], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
