"""Load a trained run directory back into a ready-to-decode model.

Every training recipe (recipes/multi_condition.py) writes a self-contained
artifact dir: `mlp.final.wts` (reference weight format, Interface.cc:411-465
layout), `fea.norm` (byte-exact normalization file, Interface.cc:300-326),
optional `targ.norm` / `gv.txt`, and a `run.json` manifest pinning the decode
configuration frozen by the held-out val sweep.  This loader rebuilds
(params, ModelConfig, EnhanceConfig, norms, gv) from that dir — shared by the
demo-gate scorer and the unseen-noise evaluation.  Counterpart of
tpu_sednn/recipes/artifact.py: the model comes back as the port's MLP on
`device`.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch


def load_run_dir(run_dir: str, quiet: bool = False, device: str | torch.device = "cuda"):
    """-> (params, mcfg, ecfg, mean, inv_std, target_norm, gv_ref).

    run.json pins head/rate/decode params; legacy dirs without it fall back
    to the canonical-lps-recipe defaults (gv auto-enabled iff gv.txt exists,
    preserved from the original demo_gate behavior).  params is an MLP on
    `device`; the norms and gv are numpy arrays."""
    from tpu_sednn_torch.dsp import StftConfig
    from tpu_sednn_torch.enhance.decode import EnhanceConfig
    from tpu_sednn_torch.io.norm import load_norm
    from tpu_sednn_torch.io.wts import load_wts
    from tpu_sednn_torch.model.mlp import ModelConfig, params_from_wts

    ws, bs = load_wts(os.path.join(run_dir, "mlp.final.wts"))
    params = params_from_wts(ws, bs, device=device)
    d = len(bs[-1])
    sizes = tuple([ws[0].shape[0]] + [len(b) for b in bs])
    manifest = {}
    man_path = os.path.join(run_dir, "run.json")
    if os.path.exists(man_path):
        with open(man_path) as f:
            manifest = json.load(f)
    head = manifest.get("head", "lps")
    sr = manifest.get("sample_rate", 8000 if d == 129 else 16000)
    stft = StftConfig.for_rate(sr)
    # recipe geometry: layersizes[0] = context*d + d (NAT appended)
    context = manifest.get("fea_context", (sizes[0] // d) - 1)
    nat = manifest.get("nat", sizes[0] == context * d + d)
    dr_vis, dr_hid = manifest.get("dropout", (0.1, 0.2))
    mcfg = ModelConfig(layersizes=sizes, dropout_vis=dr_vis, dropout_hid=dr_hid,
                       dropout_mode="parity",
                       output="sigmoid" if head in ("irm", "ibm", "psm") else "linear")
    mean, inv_std = load_norm(os.path.join(run_dir, "fea.norm"), d)
    tn = None
    tnorm_path = os.path.join(run_dir, "targ.norm")
    if os.path.exists(tnorm_path):
        tn = load_norm(tnorm_path, d)
    gv = None
    gv_path = os.path.join(run_dir, "gv.txt")
    if manifest:
        gv_mode = manifest.get("gv_mode", "off")
    else:
        # legacy run dirs (no run.json): the presence of gv.txt auto-enables
        # global GV equalization (ADVICE r2: silently dropping it would
        # change re-scored numbers)
        gv_mode = "global" if os.path.exists(gv_path) else "off"
        if gv_mode == "global" and not quiet:
            print(f"note: no run.json in {run_dir}; gv.txt present -> "
                  "gv_mode=global (legacy fallback)", file=sys.stderr)
    if os.path.exists(gv_path) and gv_mode != "off":
        gv = np.loadtxt(gv_path).astype(np.float32)
    else:
        gv_mode = "off"
    ecfg = EnhanceConfig(stft=stft, fea_context=context,
                         targ_offset=manifest.get("targ_offset",
                                                  (context - 1) // 2),
                         nat=nat, head=head,
                         mask_floor=manifest.get("mask_floor", 0.0),
                         gv_mode=gv_mode,
                         min_gain_db=manifest.get("min_gain_db"),
                         max_gain_db=manifest.get("max_gain_db"))
    return params, mcfg, ecfg, mean, inv_std, tn, gv
