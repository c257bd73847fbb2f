"""Operations and bytes of the causal CRN's decode (Tan & Wang 2018), from
the configuration's shapes, whatever kernel does the work: the products of
each stage a frame, and the least time the recurrence of a request could
take on the chip.  Peaks as in roofline.py."""

from __future__ import annotations

from typing import Dict

from portbench.roofline import F32, F32_FLOPS, HBM_BYTES_S


def freq_bins(cfg: Dict):
    """F_0 .. F_L: the bins at the input and after each encoder layer."""
    bins = [cfg["n_bins"]]
    for _ in cfg["channels"]:
        bins.append((bins[-1] - 3) // 2 + 1)
    return bins


def stage_flop_per_frame(cfg: Dict) -> Dict[str, float]:
    """2 x multiply-adds of each stage's products for one frame:
    an encoder layer 2 C_in C_out 6 F_out; an LSTM layer 2 (I + H) 4H;
    a decoder layer 2 C_in C_out 6 F_in (each input bin meets 6 taps; its
    input is twice its twin's channels, with the skip)."""
    ch, bins = [1] + list(cfg["channels"]), freq_bins(cfg)
    H = cfg["lstm_hidden"]
    enc = sum(2 * ch[l - 1] * ch[l] * 6 * bins[l] for l in range(1, len(ch)))
    dec = sum(2 * (2 * ch[l]) * ch[l - 1] * 6 * bins[l] for l in range(1, len(ch)))
    lstm = cfg["lstm_layers"] * 2 * (ch[-1] * bins[-1] + H) * 4 * H
    return {"encoder": float(enc), "lstm": float(lstm), "decoder": float(dec)}


def flop_per_frame(cfg: Dict) -> float:
    return sum(stage_flop_per_frame(cfg).values())


def cell_bytes(batch: int, hidden: int) -> int:
    """One step's cell update: the gates (B, 4H) and c read, c and h
    written, float32."""
    return F32 * batch * (4 * hidden + 3 * hidden)


def lstm_bound_s(cfg: Dict, batch: int, frames: int) -> float:
    """The least time a request's recurrence could take: each layer's input
    projection (all frames at once) and its steps' products h W_hh at the
    float32 peak, plus each step's cell update at HBM bandwidth, the steps
    one after another."""
    H = cfg["lstm_hidden"]
    proj = 2.0 * frames * batch * H * 4 * H / F32_FLOPS
    step = 2.0 * batch * H * 4 * H / F32_FLOPS + cell_bytes(batch, H) / HBM_BYTES_S
    return cfg["lstm_layers"] * (proj + frames * step)
