"""Demo-clip quality gate — the reference's ONLY end-to-end regression
fixture, made quantitative (VERDICT r1 item 1).

The reference ships before/after pairs in enh_wav_example/ (readme.txt:1,
README.md:46-52) for listening comparison:

    test1_org_noisy.wav      vs  test1_mySEDNN.wav
    test2_noisy_chinese.wav  vs  test2_mySEDNN_chinese.wav
    test3_ForestGump_noisy.wav vs test3_ForestGump_Proposed DNN_enh.wav

This CLI enhances each noisy clip with a trained model and scores
how much CLOSER to the shipped SEDNN output the result is than the raw noisy
clip, using the shipped enhanced wav as the reference signal (there is no
clean ground truth for these real recordings):

    lsd_gain    = LSD(noisy, shipped)   - LSD(ours, shipped)     (dB, >0 good)
    stoi_gain   = STOI(shipped, ours)   - STOI(shipped, noisy)   (>0 good)
    segsnr_gain = SegSNR(shipped, ours) - SegSNR(shipped, noisy) (dB, >0 good)

Usage:
    python -m tpu_sednn_torch.recipes.demo_gate RUN_DIR [--out demo_gate.json]
        [--device cuda|cpu]

RUN_DIR must hold mlp.final.wts + fea.norm (and optionally targ.norm,
gv.txt) as written by recipes.multi_condition.  Counterpart of
tpu_sednn/recipes/demo_gate.py: the decode runs on `device` (the card unless
the CPU is asked for), the scores on the host.  The clips are optional: a
pair that is absent is listed under "missing" and the gate does not pass.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

# where the reference checkout keeps its demo clips, as tpu_sednn/recipes/demo_gate.py:36
DEMO_DIR = "/root/reference/enh_wav_example"
PAIRS = [
    ("test1", "test1_org_noisy.wav", "test1_mySEDNN.wav"),
    ("test2", "test2_noisy_chinese.wav", "test2_mySEDNN_chinese.wav"),
    ("test3", "test3_ForestGump_noisy.wav", "test3_ForestGump_Proposed DNN_enh.wav"),
]


def _resample(x: np.ndarray, sr: int, target: int) -> np.ndarray:
    if sr == target:
        return x.astype(np.float32)
    from scipy.signal import resample_poly

    g = np.gcd(sr, target)
    return resample_poly(x, target // g, sr // g).astype(np.float32)


def evaluate_demo_clips(params, model_cfg, enh_cfg, mean, inv_std,
                        target_norm=None, gv_ref=None,
                        demo_dir: str = DEMO_DIR, out_dir: str | None = None,
                        enhance_fn=None, device="cuda"):
    """-> {clip: {lsd_gain, stoi_gain, segsnr_gain, ...}} for every shipped
    before/after pair, plus a 'pass' summary.  All audio is compared at the
    model's sample rate (the 16 kHz clips are resampled).

    enhance_fn: optional noisy_waveform -> enhanced_waveform override (the
    head-fusion decoder scores the gate through this); enh_cfg still sets
    the sample rate and the metric STFT.  params is an MLP; the decode and
    the metric STFT run on `device`, the scores on the host."""
    from tpu_sednn_torch.enhance.decode import enhance_waveform
    from tpu_sednn_torch.io import read_wav, write_wav
    from tpu_sednn_torch.metrics import lsd, pesq, seg_snr, stoi
    from tpu_sednn_torch.recipes.multi_condition import host_lps

    sr = enh_cfg.stft.sample_rate

    def _lps(w):
        return host_lps(w, enh_cfg.stft, device)
    results = {}
    missing = []
    for name, noisy_f, shipped_f in PAIRS:
        noisy_p = os.path.join(demo_dir, noisy_f)
        shipped_p = os.path.join(demo_dir, shipped_f)
        if not (os.path.exists(noisy_p) and os.path.exists(shipped_p)):
            missing.append(name)
            continue
        noisy, nsr = read_wav(noisy_p)
        shipped, ssr = read_wav(shipped_p)
        noisy = _resample(noisy, nsr, sr)
        shipped = _resample(shipped, ssr, sr)
        n = min(len(noisy), len(shipped))
        noisy, shipped = noisy[:n], shipped[:n]

        if enhance_fn is not None:
            ours = np.asarray(enhance_fn(noisy))[:n]
        else:
            ours = enhance_waveform(params, model_cfg, enh_cfg, noisy, mean,
                                    inv_std, target_norm=target_norm,
                                    gv_ref=gv_ref, device=device)[:n]
        if out_dir:
            write_wav(os.path.join(out_dir, f"{name}_tpu_sednn_enh.wav"), ours, sr)

        shipped_lps = _lps(shipped)
        m = {
            "lsd_noisy_vs_shipped": lsd(shipped_lps, _lps(noisy)),
            "lsd_ours_vs_shipped": lsd(shipped_lps, _lps(ours)),
            "stoi_shipped_vs_noisy": stoi(shipped, noisy, sr),
            "stoi_shipped_vs_ours": stoi(shipped, ours, sr),
            "segsnr_shipped_vs_noisy": seg_snr(shipped, noisy, sr),
            "segsnr_shipped_vs_ours": seg_snr(shipped, ours, sr),
            # PESQ-estimator proximity (in-repo P.862-style estimator, see
            # metrics/pesq.py — self-consistent across rounds, not ITU-certified)
            "pesq_shipped_vs_noisy": pesq(shipped, noisy, sr),
            "pesq_shipped_vs_ours": pesq(shipped, ours, sr),
            "finite": bool(np.isfinite(ours).all()),
        }
        m["lsd_gain"] = m["lsd_noisy_vs_shipped"] - m["lsd_ours_vs_shipped"]
        m["stoi_gain"] = m["stoi_shipped_vs_ours"] - m["stoi_shipped_vs_noisy"]
        m["segsnr_gain"] = m["segsnr_shipped_vs_ours"] - m["segsnr_shipped_vs_noisy"]
        m["pesq_gain"] = m["pesq_shipped_vs_ours"] - m["pesq_shipped_vs_noisy"]
        results[name] = {k: (round(float(v), 4) if not isinstance(v, bool) else v)
                         for k, v in m.items()}
    if missing:
        # a gate that scored nothing must not read as passing
        results["missing"] = missing
    results["pass"] = not missing and all(
        r["finite"] and r["lsd_gain"] > 0 for r in results.values()
        if isinstance(r, dict)
    )
    return results


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    out_name = "demo_gate.json"
    device = "cuda"
    for flag in ("--out", "--device"):
        if flag in argv:
            i = argv.index(flag)
            if flag == "--out":
                out_name = argv[i + 1]
            else:
                device = argv[i + 1]
            del argv[i : i + 2]
    if len(argv) != 1:
        print("usage: python -m tpu_sednn_torch.recipes.demo_gate RUN_DIR [--out f.json] "
              "[--device cuda|cpu]", file=sys.stderr)
        return 1
    run_dir = argv[0]

    from tpu_sednn_torch.recipes.artifact import load_run_dir

    params, mcfg, ecfg, mean, inv_std, tn, gv = load_run_dir(run_dir, device=device)

    res = evaluate_demo_clips(params, mcfg, ecfg, mean, inv_std,
                              target_norm=tn, gv_ref=gv, demo_dir=DEMO_DIR,
                              out_dir=run_dir, device=device)
    out_path = os.path.join(run_dir, out_name)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
