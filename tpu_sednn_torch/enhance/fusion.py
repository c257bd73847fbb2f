"""Head-fusion decode: blend two (or more) models' enhanced log-spectra —
counterpart of tpu_sednn/enhance/fusion.py.

A convex blend of the FINAL enhanced LPS (each model's own post-processing
applied first) is a geometric blend of the estimated magnitudes,

    lps_fused = sum_i w_i * lps_i,   sum w_i = 1,

reconstructed with the shared noisy phase.  The blend weight is a decode-time
parameter, swept on held-out validation clips (recipes/fusion_sweep.py).

Models are the 7-tuples (params, mcfg, ecfg, mean, inv_std, target_norm,
gv) that recipes.artifact.load_run_dir returns; they must share the STFT
geometry.  The decode runs on `device` (default "cuda").
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpu_sednn_torch._device import resolve_device
from tpu_sednn_torch.dsp.stft import LPS_FLOOR, reconstruct_from_lps, stft_real_imag
from tpu_sednn_torch.enhance.decode import _as_tensor, enhance_lps
from tpu_sednn_torch.model.mlp import fold_eval_params


def _check_models(models: Sequence, weights: Sequence[float]) -> None:
    if len(models) != len(weights):
        raise ValueError(f"{len(models)} models vs {len(weights)} weights")
    if abs(sum(weights) - 1.0) > 1e-6:
        raise ValueError(f"weights must sum to 1, got {sum(weights)}")
    geom = {(m[2].stft.sample_rate, m[2].stft.n_bins) for m in models}
    if len(geom) != 1:
        raise ValueError(f"models disagree on STFT geometry: {geom}")


def _on_device(model, dev: torch.device, fold: bool = False):
    """A model tuple with its tensors on `dev` (params folded for eval if
    `fold`): (params, mcfg, ecfg, mean, inv_std, target_norm, gv)."""
    params, mcfg, ecfg, mean, inv_std, tn, gv = model
    params = params.on(dev)
    if fold:
        params, mcfg = fold_eval_params(params, mcfg)
    return (params, mcfg, ecfg, _as_tensor(mean, dev), _as_tensor(inv_std, dev),
            None if tn is None else tuple(_as_tensor(a, dev) for a in tn),
            None if gv is None else _as_tensor(gv, dev))


def _blend(prepped, noisy_lps: torch.Tensor) -> torch.Tensor:
    fused = None
    for w, (params, mcfg, ecfg, mean, inv_std, tn, gv) in prepped:
        lps = enhance_lps(params, mcfg, ecfg, noisy_lps, mean, inv_std,
                          target_norm=tn, gv_ref=gv)
        fused = w * lps if fused is None else fused + w * lps
    return fused


def enhance_lps_multi(models: Sequence, noisy_lps: torch.Tensor,
                      weights: Sequence[float]) -> torch.Tensor:
    """Every model decodes the same noisy LPS (..., n_frames, d) on its
    device; the enhanced log-spectra are blended with `weights` (a model of
    weight 0 is not run)."""
    _check_models(models, weights)
    dev = noisy_lps.device
    with torch.inference_mode():
        return _blend([(w, _on_device(m, dev)) for w, m in zip(weights, models) if w != 0.0],
                      noisy_lps)


def enhance_waveform_fused(models: Sequence, noisy, weights: Sequence[float],
                           device: str | torch.device = "cuda") -> np.ndarray:
    """Noisy waveform -> fused enhanced waveform (noisy-phase overlap-add),
    decoded on `device`."""
    _check_models(models, weights)
    dev = resolve_device(device)
    stft = models[0][2].stft
    with torch.inference_mode():
        x = torch.as_tensor(np.asarray(noisy, np.float32), device=dev)
        re, im = stft_real_imag(x, stft)
        noisy_lps = torch.log(torch.clamp(re * re + im * im, min=LPS_FLOOR))
        fused = enhance_lps_multi(models, noisy_lps, weights)
        return reconstruct_from_lps(fused, re, im, stft, n_samples=x.shape[-1]).cpu().numpy()


def make_fused_serving_decoder(models: Sequence, weights: Sequence[float],
                               device: str | torch.device = "cuda"):
    """Batched wav->wav FUSED decoder, the head-fusion counterpart of
    decode.make_serving_decoder: every model's keep-prob scaling folded into
    its weights once, all constants on `device` once; the STFT, the noisy LPS
    and the reconstruction are computed once for all models.  Models of
    weight 0 are left out.

    Returns decode(wavs: (batch, n)) -> (batch, n) enhanced tensor on `device`."""
    _check_models(models, weights)
    dev = resolve_device(device)
    stft = models[0][2].stft
    prepped = [(float(w), _on_device(m, dev, fold=True))
               for w, m in zip(weights, models) if w != 0.0]

    @torch.inference_mode()
    def decode(wavs) -> torch.Tensor:
        x = torch.as_tensor(wavs, dtype=torch.float32, device=dev)
        re, im = stft_real_imag(x, stft)
        noisy_lps = torch.log(torch.clamp(re * re + im * im, min=LPS_FLOOR))
        return reconstruct_from_lps(_blend(prepped, noisy_lps), re, im, stft,
                                    n_samples=x.shape[-1])

    return decode
