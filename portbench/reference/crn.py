"""Offline enhancement of a batch of noisy waveforms by the causal
convolutional recurrent network of Tan & Wang (Interspeech 2018, Table 1),
written out in plain torch:

    the noisy magnitude |X| of the real DFT of win_len-sample periodic
    Hamming frames every hop (n_fft points; the tail that fills no frame is
    dropped); five causal encoder convolutions (2 x 3 taps, frames t-1 and
    t, stride 2 over frequency, no padding), batch norm, ELU; the last map
    flattened channel-major; two LSTM layers (gates i, f, g, o, a single
    bias, h and c from zero); five causal transposed convolutions of the
    decoder's map beside its encoder twin's (3 taps at stride 2 over
    frequency, a last bin fed by the bias alone where the twin's input has
    an even count), batch norm and ELU, softplus at the last; the enhanced
    magnitude m given the noisy phase: X m / |X| by way of ln(max(m^2,
    1e-12)), inverse real DFT, the window again, overlap-add divided by the
    overlapped window's square (at least 1e-8), zeros past the last frame.

Convolutions are sums of products over their taps and the LSTM an explicit
step loop; batch norm is applied as written, not folded.  The transforms are
the products with the DFT's matrices of reference/decode.py, built here the
same way, so that every product of the decode is one: `precision` "f64"
computes in float64; "tf32" in float32 with the operands of every product
rounded to TF32 (10 mantissa bits, to nearest), the lower-precision control
of a float32 program.  The weights are given by name, as the program names
them (enc{l}.w (C_out, C_in, 2, 3) with time tap k on frame t-1+k, .b,
.gamma, .beta, .mean, .var; lstm{k}.w_ih, .w_hh (n_in, 4H), .b; dec{l}.w
(C_in, C_out, 2, 3), ...).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.reference.decode import LPS_FLOOR, hamming, tf32


def _prev(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) delayed by one frame, a zero frame first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def net(mag: torch.Tensor, t: Dict[str, torch.Tensor], cfg: Dict, mm, eps: float) -> torch.Tensor:
    """(B, T, F) magnitude -> (B, T, F) enhanced magnitude, in mag's type.
    Activations are (B, T, F, C): a tap is a product over channels."""
    def bn(y, name):
        if f"{name}.gamma" not in t:
            return y
        return ((y - t[f"{name}.mean"]) / torch.sqrt(t[f"{name}.var"] + eps) * t[f"{name}.gamma"]
                + t[f"{name}.beta"])

    def elu(y):
        return torch.where(y > 0, y, torch.expm1(y))

    depth = len(cfg["channels"])
    x = mag.unsqueeze(-1)
    B, T = x.shape[:2]
    skips = [x]
    for l in range(1, depth + 1):
        w = t[f"enc{l}.w"]
        f_out = (x.shape[2] - 3) // 2 + 1
        y = t[f"enc{l}.b"].expand(B, T, f_out, -1)
        for k, src in enumerate((_prev(x), x)):
            for j in range(3):
                y = y + mm(src[:, :, j:j + 2 * f_out - 1:2], w[:, :, k, j].T)
        x = elu(bn(y, f"enc{l}"))
        skips.append(x)
    c_l, f_l = x.shape[3], x.shape[2]
    h = x.transpose(2, 3).reshape(B, T, c_l * f_l)
    for k in range(1, cfg["lstm_layers"] + 1):
        w_hh = t[f"lstm{k}.w_hh"]
        H = w_hh.shape[0]
        gx = mm(h, t[f"lstm{k}.w_ih"]) + t[f"lstm{k}.b"]
        hp = torch.zeros(B, H, dtype=mag.dtype, device=mag.device)
        cp = torch.zeros_like(hp)
        out = []
        for s in range(T):
            g = gx[:, s] + mm(hp, w_hh)
            i, f, gg, o = g.split(H, dim=1)
            cp = torch.sigmoid(f) * cp + torch.sigmoid(i) * torch.tanh(gg)
            hp = torch.sigmoid(o) * torch.tanh(cp)
            out.append(hp)
        h = torch.stack(out, dim=1)
    d = h.view(B, T, c_l, f_l).transpose(2, 3)
    for l in range(depth, 0, -1):
        x = torch.cat([d, skips[l]], dim=-1)
        w = t[f"dec{l}.w"]
        f_in = x.shape[2]
        y = torch.zeros(B, T, skips[l - 1].shape[2], w.shape[1], dtype=mag.dtype,
                        device=mag.device)
        for k, src in enumerate((_prev(x), x)):
            for j in range(3):
                y[:, :, j:j + 2 * f_in - 1:2] += mm(src, w[:, :, k, j])
        y = bn(y + t[f"dec{l}.b"], f"dec{l}")
        d = elu(y) if l > 1 else torch.logaddexp(y, torch.zeros_like(y))
    return d.squeeze(-1)


# a float32 DFT rounds a bin by up to about 7e-7 of its frame's sum of
# |window x|: a bin whose noisy |X| is under RHO times that sum may have its
# phase off by 7e-3 rad or more, up to all of it
RHO = 1e-4


def _transforms(win_len: int, n_fft: int, dt, dev):
    """-> (window, forward cos, forward sin, inverse cos, inverse sin, the
    inverse's scale a bin (bins, 1) in float64)."""
    window = hamming(win_len, torch.float64, dev)
    bins = n_fft // 2 + 1
    ang = (2 * math.pi / n_fft) * torch.outer(
        torch.arange(win_len, dtype=torch.float64, device=dev),
        torch.arange(bins, dtype=torch.float64, device=dev))
    fwd_cos = (torch.cos(ang) * window[:, None]).to(dt)
    fwd_sin = (-torch.sin(ang) * window[:, None]).to(dt)
    scale = torch.full((bins, 1), 2.0 / n_fft, dtype=torch.float64, device=dev)
    scale[0] = scale[-1] = 1.0 / n_fft
    inv_cos, inv_sin = (torch.cos(ang.T) * scale).to(dt), (-torch.sin(ang.T) * scale).to(dt)
    return window.to(dt), fwd_cos, fwd_sin, inv_cos, inv_sin, scale


def _overlap_add(out_frames: torch.Tensor, window: torch.Tensor, hop: int, n: int) -> torch.Tensor:
    """(batch, frames, win_len) synthesised frames (the window applied) ->
    (batch, n): overlap-added, divided by the overlapped window's square (at
    least 1e-8), zeros past the last frame."""
    lead, (n_frames, win_len) = out_frames.shape[:-2], out_frames.shape[-2:]
    total = (n_frames - 1) * hop + win_len
    sig = out_frames.new_zeros(*lead, total)
    wsum = out_frames.new_zeros(total)
    for f in range(0, win_len, hop):
        # frames whose samples f .. f + hop - 1 land in hop-aligned blocks
        sig[..., f:f + n_frames * hop].view(*lead, n_frames, hop).add_(out_frames[..., f:f + hop])
        wsum[f:f + n_frames * hop].view(n_frames, hop).add_(window[f:f + hop] ** 2)
    sig = sig / torch.clamp(wsum, min=1e-8)
    if n > total:
        sig = torch.nn.functional.pad(sig, (0, n - total))
    return sig[..., :n]


def enhance(wavs: torch.Tensor, tensors: Dict[str, torch.Tensor], cfg: Dict,
            precision: str = "f64") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(batch, n) noisy waveforms -> ((batch, n) enhanced waveforms, the
    net's (batch, frames, bins) enhanced magnitude, (batch, n) phase slack).
    `cfg`: the configuration's win_len, hop, n_fft, channels, lstm_layers,
    bn_eps.

    The slack of a sample is the most that the bins whose noisy phase a
    float32 DFT leaves to rounding (|X| under RHO of the frame's sum of
    |window x|) can move it, whatever phase a program gives them: such a
    bin's enhanced value, of magnitude at most m, and the reference's differ
    by at most 2 m (m the reference's magnitude), which the inverse DFT
    scales by its factor and overlap-add spreads under the window."""
    if precision not in ("f64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    win_len, hop, n_fft = cfg["win_len"], cfg["hop"], cfg["n_fft"]
    if win_len % hop:
        raise ValueError(f"overlap-add here needs hop {hop} to divide win_len {win_len}")
    dt = torch.float64 if precision == "f64" else torch.float32

    def mm(a, b):
        return a @ b if precision == "f64" else tf32(a) @ tf32(b)

    dev = wavs.device
    t = {k: v.to(dev, dt) for k, v in tensors.items()}
    x = wavs.to(dt)
    n = x.shape[-1]
    window, fwd_cos, fwd_sin, inv_cos, inv_sin, scale = _transforms(win_len, n_fft, dt, dev)
    frames = x.unfold(-1, win_len, hop)
    re, im = mm(frames, fwd_cos), mm(frames, fwd_sin)
    power = re ** 2 + im ** 2
    est = net(torch.sqrt(power), t, cfg, mm, cfg["bn_eps"])
    lps = torch.log(torch.clamp(est * est, min=LPS_FLOOR))
    gain = torch.exp(0.5 * lps) / torch.sqrt(torch.clamp(power, min=LPS_FLOOR))
    wav = _overlap_add((mm(re * gain, inv_cos) + mm(im * gain, inv_sin)) * window, window, hop, n)
    loose = torch.sqrt(power) < RHO * (frames * window).abs().sum(-1, keepdim=True)
    reach = (2 * est * loose) @ scale.to(dt)  # (batch, frames, 1)
    slack = _overlap_add(reach * window.abs(), window, hop, n)
    return wav, est, slack
