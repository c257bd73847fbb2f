"""wav -> LPS pfile builder — the port of `python -m tpu_sednn.tools.make_pfile`:

    python -m tpu_sednn_torch.tools.make_pfile out.pfile out.norm wav1 wav2 ...
        [--sr 8000] [--shuffle SEED] [--scp list.scp] [--normalize]
        [--device cuda|cpu]

Features are computed by `ops.stft_lps`: the hand-written CUDA STFT kernel on
the card (default), its plain torch version with --device cpu.  The `.norm`
(mean / inverse stddev) is written alongside.

--normalize writes NORMALIZED frames ((lps - mean) * inv_std) into the pfile
instead of raw LPS.  Use it for the TARGET pfile: the trainer applies the
.norm only to input features, so target conditioning is the packer's job;
the enhance command's --targ-norm denormalizes the model output with the
emitted .norm at decode time.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch

from tpu_sednn_torch._device import resolve_device
from tpu_sednn_torch.dsp import StftConfig
from tpu_sednn_torch.io import compute_norm, read_wav, save_norm, write_pfile
from tpu_sednn_torch.ops.stft_lps import stft_lps


def build_pfile(wavs: List[str], out_pfile: str, out_norm: str | None,
                sample_rate: int | None = None, shuffle_seed: int | None = None,
                normalize: bool = False, device: str | torch.device = "cuda") -> int:
    """Featurize `wavs` into `out_pfile` (and `out_norm`); -> total frames."""
    dev = resolve_device(device)
    if shuffle_seed is not None:
        # corpus-level randomization, the job of the reference's rand_list.pl
        rng = np.random.default_rng(shuffle_seed)
        wavs = [wavs[i] for i in rng.permutation(len(wavs))]

    feats = []
    cfg = None
    for p in wavs:
        x, sr = read_wav(p)
        if sample_rate is not None and sr != sample_rate:
            from scipy.signal import resample_poly

            g = np.gcd(sr, sample_rate)
            x = resample_poly(x, sample_rate // g, sr // g).astype(np.float32)
            sr = sample_rate
        if cfg is None:
            cfg = StftConfig.for_rate(sr)
        feats.append(stft_lps(torch.from_numpy(x).to(dev), cfg).cpu().numpy())
    mean, inv_std = compute_norm(np.concatenate(feats))
    if normalize:
        feats = [(f - mean) * inv_std for f in feats]
    write_pfile(out_pfile, feats)
    if out_norm:
        save_norm(out_norm, mean, inv_std)
    return sum(len(f) for f in feats)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_pfile")
    ap.add_argument("out_norm", nargs="?", default=None)
    ap.add_argument("wavs", nargs="*")
    ap.add_argument("--scp", help="file listing wav paths (one per line)")
    ap.add_argument("--sr", type=int, default=None, help="resample to this rate")
    ap.add_argument("--shuffle", type=int, default=None, metavar="SEED")
    ap.add_argument("--normalize", action="store_true",
                    help="write normalized frames (for TARGET pfiles; see "
                         "module docstring)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the STFT runs (default cuda; no fall back)")
    args = ap.parse_args(argv)
    wavs = list(args.wavs)
    if args.scp:
        with open(args.scp) as f:
            wavs += [l.strip() for l in f if l.strip()]
    if not wavs:
        ap.error("no input wavs")
    n = build_pfile(wavs, args.out_pfile, args.out_norm, args.sr, args.shuffle,
                    normalize=args.normalize, device=args.device)
    print(f"wrote {args.out_pfile}: {len(wavs)} utterances, {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
