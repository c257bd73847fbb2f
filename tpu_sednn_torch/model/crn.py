"""Causal convolutional recurrent network (CRN) for speech enhancement:
K. Tan and D. Wang, "A Convolutional Recurrent Neural Network for Real-Time
Speech Enhancement", Interspeech 2018, pp. 3229-3233, Table 1.

(B, T, n_bins) noisy STFT magnitude -> (B, T, n_bins) enhanced magnitude, in
float32.  With C_l channels and F_l bins at layer l (F_0 = n_bins, F_l =
(F_{l-1} - 3) // 2 + 1: 161, 80, 39, 19, 9, 4 at the published widths):

  encoder, l = 1..5   e_l[t] = ELU(BN(sum_k conv_f(e_{l-1}[t-1+k], K_l[k]) + b_l))
                      2 x 3 kernels (time x frequency), stride 2 in frequency
                      with no padding; a frame before the first is zero, so
                      frame t reads frames t-1 and t; e_0 is the magnitude
  flatten             z[t] = e_5[t] channel-major (c * F_5 + f), C_5 F_5 wide
  two LSTM layers     G = z W_ih + b + h[t-1] W_hh; gates i, f, g, o; i, f, o
                      sigmoid, g tanh; c[t] = f c[t-1] + i g; h[t] = o tanh(c[t]);
                      h and c start at zero for each utterance
  decoder, l = 5..1   the causal transposed convolution of concat_channels(d_{l+1},
                      e_l) (d_6: the LSTM output reshaped to C_5 x F_5), 3 taps
                      at stride 2 in frequency (2 F_l + 1 bins, one more bin fed
                      by the bias alone where F_{l-1} is even), frames t-1 and t
                      in time; BN and ELU, softplus at l = 1

Weights, by name in `CRN.tensors` (the layout of PyTorch's Conv2d and
ConvTranspose2d, time tap k applying to frame t-1+k; the LSTM's as the
port's MLP keeps them, x @ W):

  enc{l}.w (C_l, C_{l-1}, 2, 3), enc{l}.b, and its batch norm enc{l}.gamma,
  .beta, .mean, .var, l = 1..5;
  lstm{k}.w_ih (C_5 F_5, 4H), lstm{k}.w_hh (H, 4H), lstm{k}.b (4H,), k = 1, 2;
  dec{l}.w (2 C_l, C_{l-1}, 2, 3), dec{l}.b, and for l = 2..5 its batch norm.

`fold_eval_crn` folds each eval-mode batch norm into the weights and bias of
the (de)convolution before it, laid out for one product a layer.  The
forward runs in three stages that the serving decoder spans (`crn_encoder`,
`crn_lstm`, `crn_decoder`) on (B, T, F, C) activations, channels last.  A
(de)convolution is one float32 product of its input's taps gathered side by
side (im2col) with the layer's weights, so it rounds as the port's other
float32 products do and needs no cuDNN setting: cuDNN, asked for the same
convolutions on an H100, chose FFT kernels for some of them, whose rounding
is relative to a whole tile's magnitude, at the same speed.  Each LSTM
layer's input projection is one product over all frames, and the
recurrence (`lstm_layer`) is one launch a layer of the port's persistent
LSTM kernel, which runs every step's product and cell update with W_hh
held on the SMs (ops/lstm_cell.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_sednn_torch._device import resolve_device
from tpu_sednn_torch.ops.lstm_cell import lstm_steps

# running statistics are state, not parameters
_STATS = ("mean", "var")


@dataclass(frozen=True)
class CRNConfig:
    n_bins: int = 161
    channels: Tuple[int, ...] = (16, 32, 64, 128, 256)
    lstm_hidden: int = 1024
    lstm_layers: int = 2
    bn_eps: float = 1e-5

    def __post_init__(self):
        bins = self.freq_bins
        if bins[-1] < 1:
            raise ValueError(f"{self.n_bins} bins leave none after {len(self.channels)} layers")
        if self.channels[-1] * bins[-1] != self.lstm_hidden:
            raise ValueError(f"the LSTM's {self.lstm_hidden} units must equal the last map's "
                             f"{self.channels[-1]} x {bins[-1]} values, which the decoder "
                             "reshapes its output to")

    @property
    def freq_bins(self) -> Tuple[int, ...]:
        """F_0 .. F_L: the bins at the input and after each encoder layer."""
        bins = [self.n_bins]
        for _ in self.channels:
            bins.append((bins[-1] - 3) // 2 + 1)
        return tuple(bins)

    @property
    def depth(self) -> int:
        return len(self.channels)


@dataclass
class CRN:
    """The CRN's tensors by name (see the module's docstring), float32.
    `folded`: batch norm folded into the (de)convolutions by fold_eval_crn
    (no BN tensors; weights laid out for one product a layer)."""

    cfg: CRNConfig
    tensors: Dict[str, torch.Tensor]
    folded: bool = field(default=False)

    def on(self, device) -> "CRN":
        return CRN(self.cfg, {k: v.to(device) for k, v in self.tensors.items()}, self.folded)

    def n_parameters(self) -> int:
        """Learned values: weights, biases and batch norm's scale and shift."""
        return sum(v.numel() for k, v in self.tensors.items()
                   if k.rsplit(".", 1)[1] not in _STATS)


def init_crn(generator: torch.Generator, cfg: CRNConfig = CRNConfig(),
             device: str | torch.device = "cuda") -> CRN:
    """Random CRN drawn on the host from `generator` (a seed gives the same
    weights on every device), then moved to `device`, layer by layer in the
    order enc1..enc5, lstm1, lstm2, dec5..dec1 and within a layer in the
    order of the module's docstring:
      (de)convolutions: PyTorch's default, U(+-1/sqrt(fan_in)) for weight
        and bias, fan_in = weight.shape[1] * 6 (so the transposed
        convolutions take their output channels, as PyTorch's does);
      LSTM: U(+-1/sqrt(H)) for every tensor;
      batch norm: gamma U(0.5, 1.5), beta N(0, 0.1^2), running mean
        N(0, 0.1^2), running variance U(0.5, 1.5)."""
    dev = resolve_device(device)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, dtype=torch.float32) * (hi - lo) + lo

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * std

    t: Dict[str, torch.Tensor] = {}

    def conv(name, w_shape, bn):
        r = 1.0 / np.sqrt(w_shape[1] * 6)
        t[f"{name}.w"] = uniform(w_shape, -r, r)
        t[f"{name}.b"] = uniform((w_shape[0] if name.startswith("enc") else w_shape[1],), -r, r)
        if bn:
            n = t[f"{name}.b"].numel()
            t[f"{name}.gamma"] = uniform((n,), 0.5, 1.5)
            t[f"{name}.beta"] = normal((n,), 0.1)
            t[f"{name}.mean"] = normal((n,), 0.1)
            t[f"{name}.var"] = uniform((n,), 0.5, 1.5)

    ch = (1,) + tuple(cfg.channels)
    for l in range(1, cfg.depth + 1):
        conv(f"enc{l}", (ch[l], ch[l - 1], 2, 3), True)
    H = cfg.lstm_hidden
    r = 1.0 / np.sqrt(H)
    for k in range(1, cfg.lstm_layers + 1):
        t[f"lstm{k}.w_ih"] = uniform((H, 4 * H), -r, r)
        t[f"lstm{k}.w_hh"] = uniform((H, 4 * H), -r, r)
        t[f"lstm{k}.b"] = uniform((4 * H,), -r, r)
    for l in range(cfg.depth, 0, -1):
        conv(f"dec{l}", (2 * ch[l], ch[l - 1], 2, 3), l > 1)
    return CRN(cfg, {k: v.to(dev) for k, v in t.items()})


def fold_eval_crn(params: CRN) -> CRN:
    """Eval-mode batch norm folded into the (de)convolution before it:
    s = gamma / sqrt(var + eps), W' = W s and b' = (b - mean) s + beta, per
    output channel (dim 0 of a convolution's weight, dim 1 of a transposed
    one's).  W' comes out laid out for conv_layer and deconv_layer: a
    convolution's (C_in * 2 * 3, C_out), a transposed one's (C_in * 2,
    3 * C_out)."""
    if params.folded:
        raise ValueError("the CRN is folded already")
    src, eps = params.tensors, params.cfg.bn_eps
    out: Dict[str, torch.Tensor] = {k: v for k, v in src.items() if k.startswith("lstm")}
    for name in sorted({k.split(".")[0] for k in src if not k.startswith("lstm")}):
        w, b = src[f"{name}.w"], src[f"{name}.b"]
        dim = 0 if name.startswith("enc") else 1
        if f"{name}.gamma" in src:
            s = src[f"{name}.gamma"] / torch.sqrt(src[f"{name}.var"] + eps)
            shape = [1] * w.dim()
            shape[dim] = -1
            w = w * s.view(shape)
            b = (b - src[f"{name}.mean"]) * s + src[f"{name}.beta"]
        if dim == 0:
            out[f"{name}.w"] = w.reshape(w.shape[0], -1).t().contiguous()
        else:
            out[f"{name}.w"] = w.permute(0, 2, 3, 1).reshape(w.shape[0] * 2, -1).contiguous()
        out[f"{name}.b"] = b.contiguous()
    return CRN(params.cfg, out, folded=True)


def _folded(params: CRN) -> Dict[str, torch.Tensor]:
    if not params.folded:
        raise ValueError("the CRN's stages take fold_eval_crn's output")
    return params.tensors


def _time_pairs(x: torch.Tensor) -> torch.Tensor:
    """x (B, T, F, C) -> a (B, T, F, C, 2) view of frames t-1 and t side by
    side, a zero frame before the first."""
    return F.pad(x, (0, 0, 0, 0, 1, 0)).unfold(1, 2, 1)


def conv_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A causal 2 x 3 convolution at stride 2 over frequency, no padding:
    x (B, T, F, C_in) -> (B, T, (F - 3) // 2 + 1, C_out), with fold_eval_crn's
    w (C_in * 6, C_out) and b (C_out,)."""
    B, T = x.shape[:2]
    cols = _time_pairs(x).unfold(2, 3, 2)  # (B, T, F_out, C_in, 2, 3)
    f_out = cols.shape[2]
    return torch.addmm(b, cols.reshape(B * T * f_out, -1), w).view(B, T, f_out, -1)


def deconv_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, f_out: int) -> torch.Tensor:
    """A causal transposed convolution, 2 x 3 taps at stride 2 over
    frequency: x (B, T, F, C_in) -> (B, T, f_out, C_out), f_out 2F + 1 or
    2F + 2 (the last bin then fed by the bias alone), with fold_eval_crn's w
    (C_in * 2, 3 * C_out) and b (C_out,).  Input bin f meets tap j at output
    bin 2f + j."""
    B, T, n, _ = x.shape
    y = (_time_pairs(x).reshape(B * T * n, -1) @ w).view(B, T, n, 3, -1)
    out = b.expand(B, T, f_out, b.numel()).contiguous()
    for j in range(3):
        out[:, :, j:j + 2 * n - 1:2] += y[:, :, :, j]
    return out


def crn_encoder(params: CRN, mag: torch.Tensor) -> List[torch.Tensor]:
    """(B, T, n_bins) magnitude -> [e_1 .. e_L], e_l (B, T, F_l, C_l)."""
    p, cfg = _folded(params), params.cfg
    x = mag.unsqueeze(-1)
    outs = []
    for l in range(1, cfg.depth + 1):
        x = F.elu(conv_layer(x, p[f"enc{l}.w"], p[f"enc{l}.b"]))
        outs.append(x)
    return outs


def lstm_layer(proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """One LSTM layer's recurrence from zero h and c: proj (T, B, 4H), the
    layer's input projection z W_ih + b (the plain version leaves the gates
    in it); -> h (T, B, H).  A step is the gates proj[t] + h[t-1] W_hh and
    the cell update; on a card one kernel launch runs all T steps
    (ops/lstm_cell.py:lstm_steps)."""
    T, B, G = proj.shape
    hs = proj.new_zeros(T + 1, B, G // 4)
    lstm_steps(proj, w_hh, hs, proj.new_zeros(B, G // 4))
    return hs[1:]


def crn_lstm(params: CRN, e_last: torch.Tensor) -> torch.Tensor:
    """e_L (B, T, F_L, C_L) -> the last LSTM layer's h, (T, B, H)."""
    p, cfg = _folded(params), params.cfg
    B, T = e_last.shape[:2]
    h = e_last.permute(1, 0, 3, 2).reshape(T * B, -1)  # channel-major
    for k in range(1, cfg.lstm_layers + 1):
        proj = torch.addmm(p[f"lstm{k}.b"], h, p[f"lstm{k}.w_ih"]).view(T, B, -1)
        h = lstm_layer(proj, p[f"lstm{k}.w_hh"]).reshape(T * B, -1)
    return h.view(T, B, -1)


def crn_decoder(params: CRN, h: torch.Tensor, skips: List[torch.Tensor]) -> torch.Tensor:
    """The LSTM's h (T, B, H) and the encoder's [e_1 .. e_L] -> (B, T,
    n_bins) enhanced magnitude."""
    p, cfg = _folded(params), params.cfg
    T, B, _ = h.shape
    bins = cfg.freq_bins
    d = h.view(T, B, cfg.channels[-1], bins[-1]).permute(1, 0, 3, 2)
    for l in range(cfg.depth, 0, -1):
        y = deconv_layer(torch.cat([d, skips[l - 1]], dim=-1), p[f"dec{l}.w"], p[f"dec{l}.b"],
                         bins[l - 1])
        d = F.elu(y) if l > 1 else F.softplus(y)
    return d.squeeze(-1)


def crn_forward_eval(params: CRN, mag: torch.Tensor) -> torch.Tensor:
    """(B, T, n_bins) noisy magnitude -> (B, T, n_bins) enhanced magnitude,
    eval mode: batch norm folded (fold_eval_crn), then the three stages."""
    folded = fold_eval_crn(params)
    skips = crn_encoder(folded, mag)
    return crn_decoder(folded, crn_lstm(folded, skips[-1]), skips)
