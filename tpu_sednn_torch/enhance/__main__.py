"""Enhancement decode as a command — the port of `python -m tpu_sednn.enhance`:

    python -m tpu_sednn_torch.enhance out_dir in1.wav [in2.wav ...] \
        --wts mlp.wts --norm fea.norm [--layersizes 1548,2048,2048,2048,129]
        [--context 11] [--targ-offset 5] [--head lps|irm|ibm|psm] [--sr 8000]
        [--targ-norm targ.norm] [--mask-floor 0.05] [--no-nat]
        [--quant int8] [--stream BLOCK_FRAMES [--stream-device]]
        [--fuse-with RUN_DIR --fuse-alpha 0.65] [--device cuda|cpu]

Each input produces out_dir/<name>_enh.wav.  The flags and output names are
the JAX command's: --stream decodes through StreamingEnhancer (with
--stream-device, DeviceStreamingEnhancer; without --stream that flag is
ignored, as in the JAX command), --quant int8 serves the w8a8 forward
(model/quant.py), --fuse-with blends the primary model's enhanced
log-spectra with a second trained run dir's (enhance/fusion.py; alpha =
weight on the primary).  --device (default cuda) picks where the decode
runs and fails if CUDA is asked for and absent.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("wavs", nargs="+")
    ap.add_argument("--wts", required=True)
    ap.add_argument("--norm", required=True)
    ap.add_argument("--layersizes", default=None,
                    help="comma-separated; default inferred from the .wts file")
    ap.add_argument("--context", type=int, default=11)
    ap.add_argument("--targ-offset", type=int, default=5)
    ap.add_argument("--head", choices=["lps", "irm", "ibm", "psm"], default="lps")
    ap.add_argument("--sr", type=int, default=None, help="resample inputs to this rate")
    ap.add_argument("--targ-norm", default=None,
                    help=".norm for target denormalization (target-normalized models)")
    ap.add_argument("--mask-floor", type=float, default=0.0)
    ap.add_argument("--mask-smooth", type=int, default=0)
    ap.add_argument("--gv-mode", choices=["off", "global", "per-dim"], default="off",
                    help="global-variance equalization (TASLP'15 post-processing)")
    ap.add_argument("--gv-ref", default=None,
                    help="text file of per-dim clean-LPS global variances "
                         "(one float per line; produce with enhance.compute_gv)")
    ap.add_argument("--min-gain-db", type=float, default=None,
                    help="cap per-bin suppression at this many dB below the "
                         "noisy spectrum (lps head; bounds speech distortion)")
    ap.add_argument("--max-gain-db", type=float, default=None,
                    help="cap per-bin amplification over the noisy spectrum (dB)")
    ap.add_argument("--no-nat", action="store_true")
    ap.add_argument("--hidden", choices=["relu", "sigmoid"], default="relu")
    ap.add_argument("--visible-omit", type=float, default=0.0,
                    help="visible_omit the model was TRAINED with (parity dropout "
                         "models need keep-prob weight scaling at decode)")
    ap.add_argument("--hid-omit", type=float, default=0.0,
                    help="hid_omit the model was trained with")
    ap.add_argument("--quant", choices=["none", "int8"], default="none",
                    help="int8: w8a8 dynamic-quantized serving forward "
                         "(model/quant.py; int32 products)")
    ap.add_argument("--stream", type=int, default=0, metavar="BLOCK_FRAMES",
                    help="decode through the causal StreamingEnhancer in "
                         "blocks of this many frames (0 = offline decode); "
                         "output equals the offline decode to float32 "
                         "rounding, gv/smoothing must be off")
    ap.add_argument("--stream-device", action="store_true",
                    help="with --stream: keep the rolling streaming state in "
                         "device tensors (DeviceStreamingEnhancer; requires "
                         "targ_offset < context-1)")
    ap.add_argument("--fuse-with", default=None, metavar="RUN_DIR",
                    help="head-fusion decode: blend this trained run dir's "
                         "enhanced log-spectra with the primary model's "
                         "(enhance.fusion; same sample rate required)")
    ap.add_argument("--fuse-alpha", type=float, default=0.65,
                    help="weight on the PRIMARY model in a --fuse-with blend "
                         "(1-alpha on --fuse-with)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the decode runs (default cuda; no fall back)")
    args = ap.parse_args(argv)
    if args.fuse_with and (args.stream > 0 or args.quant != "none"):
        raise SystemExit("--fuse-with is an offline f32 decode "
                         "(no --stream/--quant)")
    if args.fuse_with and not 0.0 <= args.fuse_alpha <= 1.0:
        raise SystemExit(f"--fuse-alpha {args.fuse_alpha} outside [0, 1] "
                         "(the blend is convex)")

    from tpu_sednn_torch._device import resolve_device
    from tpu_sednn_torch.dsp import StftConfig
    from tpu_sednn_torch.enhance.decode import EnhanceConfig, enhance_waveform
    from tpu_sednn_torch.io import load_norm, load_wts, read_wav, write_wav
    from tpu_sednn_torch.model import ModelConfig, params_from_wts

    device = resolve_device(args.device)
    ws, bs = load_wts(args.wts)
    sizes = ([int(v) for v in args.layersizes.split(",")] if args.layersizes
             else [ws[0].shape[0]] + [w.shape[1] for w in ws])
    params = params_from_wts(ws, bs, device=device)
    d_out = sizes[-1]
    nat = not args.no_nat
    fea_dim = sizes[0] // (args.context + (1 if nat else 0))
    mean, inv_std = load_norm(args.norm, fea_dim)
    target_norm = None
    if args.targ_norm:
        target_norm = load_norm(args.targ_norm, d_out)
    gv_ref = None
    if args.gv_mode != "off":
        if not args.gv_ref:
            raise SystemExit("--gv-mode requires --gv-ref")
        gv_ref = np.loadtxt(args.gv_ref, dtype=np.float32).reshape(-1)
        if gv_ref.shape[0] != d_out:
            raise SystemExit(f"--gv-ref has {gv_ref.shape[0]} dims, model outputs {d_out}")

    mcfg = ModelConfig(
        layersizes=tuple(sizes), hidden=args.hidden,
        output="sigmoid" if args.head in ("irm", "ibm", "psm") else "linear",
        # parity-dropout-trained weights need keep-prob scaling at inference
        dropout_vis=args.visible_omit, dropout_hid=args.hid_omit,
        dropout_mode="parity",
    )
    fuse_model = None
    if args.fuse_with:  # the fusion partner, loaded once for every input
        from tpu_sednn_torch.recipes.artifact import load_run_dir

        fuse_model = load_run_dir(args.fuse_with, device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in args.wavs:
        x, sr = read_wav(path)
        if args.sr is not None and sr != args.sr:
            from scipy.signal import resample_poly

            g = np.gcd(sr, args.sr)
            x = resample_poly(x, args.sr // g, sr // g).astype(np.float32)
            sr = args.sr
        cfg_stft = StftConfig.for_rate(sr)
        if cfg_stft.n_bins != fea_dim:
            raise SystemExit(
                f"{path}: {sr} Hz gives {cfg_stft.n_bins} bins but the model "
                f"expects {fea_dim}; use --sr to resample"
            )
        enh_cfg = EnhanceConfig(
            stft=cfg_stft, fea_context=args.context, targ_offset=args.targ_offset,
            nat=nat, head=args.head, mask_floor=args.mask_floor,
            mask_smooth=args.mask_smooth, gv_mode=args.gv_mode,
            min_gain_db=args.min_gain_db, max_gain_db=args.max_gain_db,
        )
        if args.stream > 0:
            from tpu_sednn_torch.enhance.streaming import (
                DeviceStreamingEnhancer, StreamingEnhancer,
            )

            cls = DeviceStreamingEnhancer if args.stream_device else StreamingEnhancer
            se = cls(params, mcfg, enh_cfg, mean, inv_std, target_norm=target_norm,
                     block_frames=args.stream, quant=args.quant, device=device)
            y = np.concatenate([se.push(x), se.flush()])
        elif args.quant == "int8":
            from tpu_sednn_torch.enhance.decode import make_serving_decoder

            dec = make_serving_decoder(params, mcfg, enh_cfg, mean, inv_std,
                                       target_norm=target_norm, gv_ref=gv_ref,
                                       quant="int8", device=device)
            y = dec(x[None, :])[0].cpu().numpy()
        elif args.fuse_with:
            from tpu_sednn_torch.enhance.fusion import enhance_waveform_fused

            if fuse_model[2].stft.sample_rate != sr:
                raise SystemExit(
                    f"--fuse-with model is {fuse_model[2].stft.sample_rate} Hz, "
                    f"input is {sr} Hz")
            model_a = (params, mcfg, enh_cfg, mean, inv_std, target_norm, gv_ref)
            a = args.fuse_alpha
            y = enhance_waveform_fused((model_a, fuse_model), x, (a, 1.0 - a),
                                       device=device)
        else:
            y = enhance_waveform(params, mcfg, enh_cfg, x, mean, inv_std,
                                 target_norm=target_norm, gv_ref=gv_ref, device=device)
        out = os.path.join(
            args.out_dir,
            os.path.splitext(os.path.basename(path))[0] + "_enh.wav",
        )
        write_wav(out, y, sr)
        print(f"{path} -> {out} ({len(y) / sr:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
