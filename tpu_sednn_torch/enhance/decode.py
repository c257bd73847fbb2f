"""Enhancement decode — counterpart of tpu_sednn/enhance/decode.py.

Pipeline: noisy wav -> STFT -> noisy LPS -> normalize -> splice(+NAT) ->
DNN forward -> enhanced LPS (directly, or via an IRM/IBM mask applied to the
noisy spectrum) -> overlap-add ISTFT with the noisy phase -> enhanced wav.

Every tensor function takes an optional leading batch dimension (LPS
(..., n_frames, d), signals (..., n_samples)) where the JAX package vmaps;
statistics (NAT estimate, GV) are taken per utterance over its frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from tpu_sednn_torch._device import resolve_device
from tpu_sednn_torch.dsp.stft import LPS_FLOOR, StftConfig, reconstruct_from_lps, stft_real_imag
from tpu_sednn_torch.model.mlp import MLP, ModelConfig, fold_eval_params, forward_eval
from tpu_sednn_torch.utils.profiling import span


@dataclass(frozen=True)
class EnhanceConfig:
    stft: StftConfig
    fea_context: int = 11
    targ_offset: int = 5
    nat: bool = True
    nat_frames: int = 6
    head: str = "lps"  # "lps" | "irm" | "ibm" | "psm" (all masks decode alike)
    mask_floor: float = 0.0  # mask post-processing (Interspeech'15 style)
    mask_smooth: int = 0  # moving-average width over time, 0/1 = off
    ibm_threshold: float = 0.5
    # global-variance equalization (TASLP'15): "off" | "global" | "per-dim"
    gv_mode: str = "off"
    # lps-head per-bin power gain window (out - noisy) in dB; None = off
    min_gain_db: float | None = None
    max_gain_db: float | None = None


def _edge_pad(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Repeat the first/last frame (dim -2) before/after times."""
    return torch.cat([x[..., :1, :]] * before + [x] + [x[..., -1:, :]] * after, dim=-2)


def _splice(lps: torch.Tensor, context: int, targ_offset: int) -> torch.Tensor:
    """(..., n, d) -> (..., n, context*d), edge-replicated so window j
    predicts frame j for every j (targ_offset frames before, the rest after)."""
    padded = _edge_pad(lps, targ_offset, context - 1 - targ_offset)
    n = lps.shape[-2]
    return torch.cat([padded[..., j : j + n, :] for j in range(context)], dim=-1)


def enhance_lps(
    params: MLP,
    model_cfg: ModelConfig,
    enh_cfg: EnhanceConfig,
    noisy_lps: torch.Tensor,
    mean: torch.Tensor,
    inv_std: torch.Tensor,
    target_norm: Tuple[torch.Tensor, torch.Tensor] | None = None,
    gv_ref: torch.Tensor | None = None,
    forward_fn=None,
) -> torch.Tensor:
    """Noisy LPS (..., n_frames, d) -> enhanced LPS (..., n_frames, d).

    target_norm=(targ_mean, targ_inv_std) if the model was trained on
    normalized targets; gv_ref: per-dim clean-LPS global variance
    (compute_gv) for enh_cfg.gv_mode != "off".  forward_fn(params, x, cfg):
    another inference forward (the int8 one, model/quant.py); default
    forward_eval.
    """
    x = _features(noisy_lps, mean, inv_std, enh_cfg)
    out = (forward_fn or forward_eval)(params, x, model_cfg)
    return finalize_lps(out, noisy_lps, enh_cfg, target_norm=target_norm, gv_ref=gv_ref)


def _features(noisy_lps: torch.Tensor, mean: torch.Tensor, inv_std: torch.Tensor,
              enh_cfg: EnhanceConfig) -> torch.Tensor:
    """The net's input: the normalised LPS spliced, with the NAT estimate."""
    normed = (noisy_lps - mean) * inv_std
    x = _splice(normed, enh_cfg.fea_context, enh_cfg.targ_offset)
    if enh_cfg.nat:
        est = normed[..., : enh_cfg.nat_frames, :].mean(dim=-2, keepdim=True)
        x = torch.cat([x, est.expand_as(normed)], dim=-1)
    return x


def finalize_lps(
    out: torch.Tensor,
    noisy_lps: torch.Tensor,
    enh_cfg: EnhanceConfig,
    target_norm: Tuple[torch.Tensor, torch.Tensor] | None = None,
    gv_ref: torch.Tensor | None = None,
) -> torch.Tensor:
    """Raw model output -> enhanced LPS: target denormalization, GV
    equalization, mask application, gain window."""
    if target_norm is not None and enh_cfg.head == "lps":
        t_mean, t_inv_std = target_norm
        out = out / t_inv_std + t_mean
    if enh_cfg.head == "lps":
        if enh_cfg.gv_mode != "off":
            if gv_ref is None:
                raise ValueError("gv_mode != 'off' requires gv_ref (see compute_gv)")
            out = equalize_gv(out, gv_ref, enh_cfg.gv_mode)
        return limit_gain(out, noisy_lps, enh_cfg)
    # mask heads: the mask bounds gain to [2*ln(mask_floor), 0]; the dB
    # window still applies on top so decode behaves alike across heads
    return limit_gain(lps_from_mask(out, noisy_lps, enh_cfg), noisy_lps, enh_cfg)


# LPS here is natural-log POWER: gain_db = 10*log10(e) * (out - noisy)
_LN_PER_DB = float(np.log(10.0) / 10.0)


def limit_gain(est_lps: torch.Tensor, noisy_lps: torch.Tensor,
               enh_cfg: EnhanceConfig) -> torch.Tensor:
    """Clip the per-bin power gain (est - noisy) to the configured dB window."""
    if enh_cfg.min_gain_db is None and enh_cfg.max_gain_db is None:
        return est_lps
    lo = None if enh_cfg.min_gain_db is None else enh_cfg.min_gain_db * _LN_PER_DB
    hi = None if enh_cfg.max_gain_db is None else enh_cfg.max_gain_db * _LN_PER_DB
    return noisy_lps + torch.clamp(est_lps - noisy_lps, min=lo, max=hi)


def compute_gv(lps: torch.Tensor) -> torch.Tensor:
    """Per-dimension global (population) variance over frames: (..., n, d) -> (..., d)."""
    return torch.var(lps, dim=-2, correction=0)


def equalize_gv(est_lps: torch.Tensor, gv_ref: torch.Tensor, mode: str = "global") -> torch.Tensor:
    """Global-variance equalization (Xu et al., TASLP 2015): rescale around
    the utterance mean so the output variance matches the clean-corpus
    global variance, alpha = sqrt(GV_ref / GV_est) clipped to [1, 2] (only
    restores lost variance).  mode "global": one scalar alpha per utterance
    from the mean variances; "per-dim": one alpha per frequency bin.
    """
    est_mean = est_lps.mean(dim=-2, keepdim=True)
    gv_est = torch.clamp(torch.var(est_lps, dim=-2, correction=0, keepdim=True), min=1e-8)
    if mode == "per-dim":
        alpha = torch.sqrt(gv_ref / gv_est)
    elif mode == "global":
        alpha = torch.sqrt(gv_ref.mean() / gv_est.mean(dim=-1, keepdim=True))
    else:
        raise ValueError(f"unknown gv mode: {mode!r}")
    alpha = torch.clamp(alpha, 1.0, 2.0)
    return alpha * (est_lps - est_mean) + est_mean


def lps_from_mask(mask: torch.Tensor, noisy_lps: torch.Tensor, enh_cfg: EnhanceConfig) -> torch.Tensor:
    """Apply an estimated IRM/IBM magnitude mask to the noisy spectrum."""
    mask = postprocess_mask(mask, enh_cfg)
    if enh_cfg.head == "ibm":
        mask = (mask >= enh_cfg.ibm_threshold).to(noisy_lps.dtype)
        mask = torch.clamp(mask, min=enh_cfg.mask_floor if enh_cfg.mask_floor > 0 else 1e-3)
    # magnitude-domain mask: |X_enh| = m * |X_noisy| -> LPS + 2*ln(m)
    return noisy_lps + 2.0 * torch.log(torch.clamp(mask, min=1e-6))


def postprocess_mask(mask: torch.Tensor, enh_cfg: EnhanceConfig) -> torch.Tensor:
    """Clip to [floor, 1] and smooth over time with a k-frame moving average
    (edge-replicated: k//2 frames before, k-1-k//2 after)."""
    mask = torch.clamp(mask, 0.0, 1.0)
    if enh_cfg.mask_floor > 0.0:
        mask = torch.clamp(mask, min=enh_cfg.mask_floor)
    if enh_cfg.mask_smooth > 1:
        k = enh_cfg.mask_smooth
        padded = _edge_pad(mask, k // 2, k - 1 - k // 2)
        mask = (padded.unfold(-2, k, 1) * (1.0 / k)).sum(dim=-1)
    return mask


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def make_serving_decoder(
    params: MLP,
    model_cfg: ModelConfig,
    enh_cfg: EnhanceConfig,
    mean: np.ndarray,
    inv_std: np.ndarray,
    target_norm: Tuple[np.ndarray, np.ndarray] | None = None,
    gv_ref: np.ndarray | None = None,
    quant: str = "none",
    device: str | torch.device = "cuda",
):
    """Build a batched wav->wav enhancement closure for serving.

    The parity keep-prob scaling is folded into the weights once
    (fold_eval_params), and weights and normalization / GV constants are put
    on `device` once.  quant="int8": the folded weights are quantized once
    and the forward is w8a8 with int32 products (model/quant.py).  Returns
    decode(wavs: (batch, n_samples) array or tensor) -> (batch, n_samples)
    float32 tensor on `device`.
    """
    dev = resolve_device(device)
    folded, eval_cfg = fold_eval_params(params.on(dev), model_cfg)
    folded, fwd = quantize_for_serving(folded, quant)
    mean_d, istd_d = _as_tensor(mean, dev), _as_tensor(inv_std, dev)
    tn = None if target_norm is None else tuple(_as_tensor(a, dev) for a in target_norm)
    gv = None if gv_ref is None else _as_tensor(gv_ref, dev)
    cfg = enh_cfg.stft

    # enhance_lps written out stage by stage, each stage in its own span (utils/profiling)
    @torch.inference_mode()
    def decode(wavs) -> torch.Tensor:
        with span("sednn.decode"):
            with span("sednn.decode.stft"):
                x = torch.as_tensor(wavs, dtype=torch.float32, device=dev)
                re, im = stft_real_imag(x, cfg)
                noisy_lps = torch.log(torch.clamp(re * re + im * im, min=LPS_FLOOR))
            with span("sednn.decode.features"):
                feats = _features(noisy_lps, mean_d, istd_d, enh_cfg)
            with span("sednn.decode.forward"):
                out = (fwd or forward_eval)(folded, feats, eval_cfg)
            with span("sednn.decode.istft"):
                enh = finalize_lps(out, noisy_lps, enh_cfg, target_norm=tn, gv_ref=gv)
                return reconstruct_from_lps(enh, re, im, cfg, n_samples=x.shape[-1])

    return decode


def quantize_for_serving(folded: MLP, quant: str):
    """-> (params, forward_fn) for a serving mode: "none" keeps the folded
    float32 params and forward_eval; "int8" quantizes them once
    (quantize_params_int8) and serves with forward_eval_int8."""
    if quant == "none":
        return folded, None
    if quant == "int8":
        from tpu_sednn_torch.model.quant import forward_eval_int8, quantize_params_int8

        return quantize_params_int8(folded), forward_eval_int8
    raise ValueError(f"unknown quant mode {quant!r}")


def make_bucketed_decoder(
    params: MLP,
    model_cfg: ModelConfig,
    enh_cfg: EnhanceConfig,
    mean: np.ndarray,
    inv_std: np.ndarray,
    target_norm: Tuple[np.ndarray, np.ndarray] | None = None,
    gv_ref: np.ndarray | None = None,
    quant: str = "none",
    bucket_seconds: Tuple[float, ...] = (2.0, 4.0, 8.0, 16.0, 32.0),
    batch: int = 8,
    device: str | torch.device = "cuda",
):
    """Variable-length serving front end over make_serving_decoder.

    Each utterance is zero-padded at its end up to the smallest bucket that
    holds it (longer ones keep their own length), same-bucket utterances go
    through in batches of `batch` (a short batch is filled by repeating its
    row 0), and outputs are trimmed back to the true lengths.  Outputs equal
    the per-utterance decode except within the trailing edge region, the
    final window plus the splice lookahead, where the decode sees zeros
    instead of edge replication.  quant: as make_serving_decoder's.

    Returns decode_many(wavs: sequence of 1-D arrays) -> list of enhanced
    1-D numpy arrays in the same order.
    """
    buckets = sorted(int(round(s * enh_cfg.stft.sample_rate)) for s in bucket_seconds)
    dec = make_serving_decoder(params, model_cfg, enh_cfg, mean, inv_std,
                               target_norm=target_norm, gv_ref=gv_ref, quant=quant,
                               device=device)

    def decode_many(wavs) -> list:
        wavs = [np.asarray(w, np.float32).ravel() for w in wavs]
        by_bucket: dict[int, list] = {}
        for i, w in enumerate(wavs):
            n = next((b for b in buckets if b >= w.size), w.size)
            by_bucket.setdefault(n, []).append(i)
        out: list = [None] * len(wavs)
        for n, idxs in by_bucket.items():
            for j in range(0, len(idxs), batch):
                group = idxs[j : j + batch]
                block = np.zeros((batch, n), np.float32)
                for r, i in enumerate(group):
                    block[r, : wavs[i].size] = wavs[i]
                block[len(group):] = block[0]  # pad batch: repeat row 0
                y = dec(block).cpu().numpy()
                for r, i in enumerate(group):
                    out[i] = y[r, : wavs[i].size]
        return out

    return decode_many


def enhance_waveform(
    params: MLP,
    model_cfg: ModelConfig,
    enh_cfg: EnhanceConfig,
    noisy,
    mean: np.ndarray,
    inv_std: np.ndarray,
    target_norm: Tuple[np.ndarray, np.ndarray] | None = None,
    gv_ref: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Noisy waveform -> enhanced waveform (noisy-phase overlap-add), on `device`."""
    dev = resolve_device(device)
    with torch.inference_mode():
        x = torch.as_tensor(noisy, dtype=torch.float32, device=dev)
        re, im = stft_real_imag(x, enh_cfg.stft)
        noisy_lps = torch.log(torch.clamp(re * re + im * im, min=LPS_FLOOR))
        tn = None if target_norm is None else tuple(_as_tensor(a, dev) for a in target_norm)
        enh_lps = enhance_lps(
            params.on(dev), model_cfg, enh_cfg, noisy_lps, _as_tensor(mean, dev),
            _as_tensor(inv_std, dev), target_norm=tn,
            gv_ref=None if gv_ref is None else _as_tensor(gv_ref, dev),
        )
        out = reconstruct_from_lps(enh_lps, re, im, enh_cfg.stft, n_samples=x.shape[-1])
        return out.cpu().numpy()
