"""On-device sample construction: wav -> training samples on the card
(the STFT-LPS kernel -> normalize -> splice -> NAT -> target extraction) —
counterpart of tpu_sednn/data/device_pipeline.py.

No host-side feature files: raw audio goes in, (X, T) sample matrices come
out on the device the signals were given on, ready for the chunk trainer.
The LPS comes from `ops.stft_lps` (the hand-written kernel `csrc/stft_lps.cu`
on a CUDA tensor, its plain version on a CPU tensor), as the JAX file calls
its Pallas STFT.  The host-side builders (build_training_arrays,
read_chunk_parity) remain for pfile compatibility and parity testing.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from tpu_sednn_torch._device import resolve_device
from tpu_sednn_torch.dsp.stft import StftConfig
from tpu_sednn_torch.ops.stft_lps import stft_lps


def splice_device(lps: torch.Tensor, context: int) -> torch.Tensor:
    """(n, d) -> (n-context+1, context*d) on the tensor's device (same as data.splice)."""
    n, d = lps.shape
    return lps.unfold(0, context, 1).transpose(1, 2).reshape(n - context + 1, context * d)


@torch.no_grad()
def wav_pair_to_samples(
    noisy: torch.Tensor,
    clean: torch.Tensor,
    mean: torch.Tensor,
    inv_std: torch.Tensor,
    cfg: StftConfig,
    fea_context: int = 11,
    targ_offset: int = 5,
    nat: bool = True,
    targ_mean: Optional[torch.Tensor] = None,
    targ_inv_std: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(noisy wav, clean wav) float32 tensors on one device -> (X, T) there.

    X: (n_samples, d*context [+ d]); T: (n_samples, d).  Matches
    build_training_arrays on the same LPS inputs.
    """
    noisy_lps = stft_lps(noisy, cfg)
    clean_lps = stft_lps(clean, cfg)
    normed = (noisy_lps - mean) * inv_std

    x = splice_device(normed, fea_context)
    if nat:
        est = normed[:6].mean(dim=0)  # first-6-frames NAT estimate
        x = torch.cat([x, est.expand(x.shape[0], normed.shape[1])], dim=1)
    t = clean_lps[targ_offset: targ_offset + x.shape[0]]
    if targ_mean is not None:
        t = (t - targ_mean) * targ_inv_std
    return x, t


def streaming_sample_batches(
    wav_pairs: Iterable,
    mean,
    inv_std,
    cfg: StftConfig,
    fea_context: int = 11,
    targ_offset: int = 5,
    nat: bool = True,
    targ_mean=None,
    targ_inv_std=None,
    device: str | torch.device = "cuda",
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Generator over (X, T) per (noisy, clean) pair, computed on `device`.

    Each wav is zero-padded to a multiple of 4 seconds, as the JAX package
    pads so that its compiled program is reused per bucket; here it keeps
    the kernel's shapes to a handful.  Sample rows that would read padding
    are trimmed (the LPS of trailing zeros would otherwise poison training).
    """
    dev = resolve_device(device)

    def on(a):
        return None if a is None else torch.as_tensor(np.asarray(a, np.float32), device=dev)

    mean, inv_std, tm, ts = on(mean), on(inv_std), on(targ_mean), on(targ_inv_std)
    bucket = 4 * cfg.sample_rate  # 4-second buckets

    for noisy, clean in wav_pairs:
        n = len(noisy)
        n_frames_true = 1 + (n - cfg.win_len) // cfg.hop if n >= cfg.win_len else 0
        n_samples_true = max(0, n_frames_true - fea_context + 1)
        if n_samples_true == 0:
            continue
        padded = ((n + bucket - 1) // bucket) * bucket
        pair = np.zeros((2, padded), np.float32)
        pair[0, :n], pair[1, :n] = noisy, clean
        pd = torch.from_numpy(pair).to(dev)
        x, t = wav_pair_to_samples(pd[0], pd[1], mean, inv_std, cfg, fea_context,
                                   targ_offset, nat, tm, ts)
        yield x[:n_samples_true], t[:n_samples_true]
