"""Held-out sweep of the head-fusion blend weight — counterpart of
tpu_sednn/recipes/fusion_sweep.py.

Sweeps the convex blend of enhance.fusion over held-out validation clips
(recipes/val_sweep.py's clip builder: a fresh seed stream, never the gate
clips), picks the weight maximizing the objective val_sweep uses (mean
lsd_gain + 50 * mean stoi_gain, subject to mean stoi_gain >= 0), and scores
the demo gate with the winning blend.

CLI:
    python -m tpu_sednn_torch.recipes.fusion_sweep RUN_A RUN_B \
        [--out fusion_sweep.json] [--gate demo_gate_fusion.json] \
        [--alphas 0,0.25,0.5,0.75,1] [--device cuda|cpu]

alpha = weight on RUN_A (1-alpha on RUN_B).  The alpha 0 and 1 rows are the
single-model baselines under the same eval.  The decode runs on `device`
(default cuda), the scores on the host.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Sequence

import numpy as np


def sweep_fusion(model_a, model_b, sr: int,
                 alphas: Sequence[float] = (0.0, 0.25, 0.4, 0.5, 0.6, 0.75, 1.0),
                 n_clips: int = 8, device="cuda") -> Dict:
    """-> {"table": [...], "best": {...}} over held-out val clips.

    Each model's enhanced LPS is computed once per clip; per-alpha work is
    the blend, the overlap-add and the metrics."""
    import torch

    from tpu_sednn_torch._device import resolve_device
    from tpu_sednn_torch.dsp import LPS_FLOOR, reconstruct_from_lps, stft_real_imag
    from tpu_sednn_torch.enhance.fusion import enhance_lps_multi
    from tpu_sednn_torch.metrics import lsd, seg_snr, stoi
    from tpu_sednn_torch.recipes.multi_condition import host_lps
    from tpu_sednn_torch.recipes.val_sweep import make_val_clips

    dev = resolve_device(device)
    models = (model_a, model_b)
    stft = model_a[2].stft
    clips = make_val_clips(sr, n_clips=n_clips)
    prepped = []
    with torch.inference_mode():
        for clean, noisy in clips:
            re, im = stft_real_imag(torch.as_tensor(np.asarray(noisy, np.float32), device=dev),
                                    stft)
            noisy_lps = torch.log(torch.clamp(re * re + im * im, min=LPS_FLOOR))
            clean_lps = host_lps(clean, stft, dev)
            prepped.append({
                "clean": clean, "re": re, "im": im, "n": len(noisy),
                "lps_a": enhance_lps_multi(models, noisy_lps, (1.0, 0.0)),
                "lps_b": enhance_lps_multi(models, noisy_lps, (0.0, 1.0)),
                "clean_lps": clean_lps,
                "lsd_noisy": lsd(clean_lps, noisy_lps.cpu().numpy()),
                "stoi_noisy": stoi(clean, noisy, sr),
                "segsnr_noisy": seg_snr(clean, noisy, sr),
            })

        table: List[Dict] = []
        for a in alphas:
            rows = []
            for p in prepped:
                fused = a * p["lps_a"] + (1.0 - a) * p["lps_b"]
                enh = reconstruct_from_lps(fused, p["re"], p["im"], stft,
                                           n_samples=p["n"]).cpu().numpy()
                rows.append({
                    "lsd_gain": p["lsd_noisy"] - lsd(p["clean_lps"], fused.cpu().numpy()),
                    "stoi_gain": stoi(p["clean"], enh, sr) - p["stoi_noisy"],
                    "segsnr_gain": seg_snr(p["clean"], enh, sr) - p["segsnr_noisy"],
                })
            m = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
            m["alpha"] = float(a)
            m["score"] = m["lsd_gain"] + 50.0 * m["stoi_gain"]
            table.append(m)
    feasible = [m for m in table if m["stoi_gain"] >= 0.0] or table
    best = max(feasible, key=lambda m: m["score"])
    return {"table": table, "best": best,
            "objective": "lsd_gain + 50*stoi_gain s.t. stoi_gain >= 0 "
                         "on held-out val clips (val_sweep seed stream)"}


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    opts = {"--out": "fusion_sweep.json", "--gate": None, "--alphas": None, "--device": "cuda"}
    for flag in opts:
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i:i + 2]
    alphas = ((0.0, 0.25, 0.4, 0.5, 0.6, 0.75, 1.0) if opts["--alphas"] is None
              else tuple(float(x) for x in opts["--alphas"].split(",")))
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    run_a, run_b = argv
    out_path, gate_path, device = opts["--out"], opts["--gate"], opts["--device"]

    from tpu_sednn_torch.recipes.artifact import load_run_dir

    model_a = load_run_dir(run_a, device=device)
    model_b = load_run_dir(run_b, device=device)
    sr = model_a[2].stft.sample_rate
    if model_b[2].stft.sample_rate != sr:
        print(f"sample-rate mismatch: {sr} vs {model_b[2].stft.sample_rate}",
              file=sys.stderr)
        return 1

    res = sweep_fusion(model_a, model_b, sr, alphas=alphas, device=device)
    res["run_a"] = run_a
    res["run_b"] = run_b
    for row in res["table"]:
        print(f"alpha={row['alpha']:.2f}  lsd={row['lsd_gain']:+.3f}  "
              f"stoi={row['stoi_gain']:+.4f}  segsnr={row['segsnr_gain']:+.2f}  "
              f"score={row['score']:.3f}")
    print(f"best: alpha={res['best']['alpha']}")

    if gate_path:
        from tpu_sednn_torch.enhance.fusion import enhance_waveform_fused
        from tpu_sednn_torch.recipes.demo_gate import evaluate_demo_clips

        a = res["best"]["alpha"]
        gate = evaluate_demo_clips(
            None, model_a[1], model_a[2], None, None,
            enhance_fn=lambda noisy: enhance_waveform_fused(
                (model_a, model_b), noisy, (a, 1.0 - a), device=device),
            device=device)
        gate["fusion"] = {"alpha": a, "run_a": run_a, "run_b": run_b}
        with open(gate_path, "w") as f:
            json.dump(gate, f, indent=2)
        res["gate"] = gate
        print(f"gate (alpha={a}): pass={gate.get('pass')} -> {gate_path}")

    with open(out_path, "w") as f:
        json.dump(res, f, indent=2)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
