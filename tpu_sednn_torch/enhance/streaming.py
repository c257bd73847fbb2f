"""Streaming (online) enhancement — counterpart of
tpu_sednn/enhance/streaming.py: push audio in chunks of any size, get
enhanced samples back with bounded algorithmic latency.

The offline pipeline (STFT -> LPS -> normalize -> splice+NAT -> DNN forward
-> noisy-phase overlap-add) restructured as an incremental state machine
whose output equals the offline `enhance_waveform` to float32 rounding, for
any chunking of the input (tests/test_torch_streaming.py).

Latency (samples, for StftConfig(win, hop), context C, targ_offset o):
  * splice lookahead: frame j's network input needs frames j..j+(C-1-o)
  * overlap-add: a sample is final once no later window can touch it,
    (win - hop) more samples
  * blocks: centers are forwarded block_frames at a time (1 = least latency)
  bound: (C-1-o + block_frames-1)*hop + win  (the 8 kHz flagship at block 8:
  (5+7)*128 + 256 = 1792 samples = 224 ms).

Refused up front: gv_mode != "off" (global variance is an utterance-level
statistic) and mask_smooth > 1 (a centered moving average).

NAT follows the reference (Interface.cc:776-779): the noise estimate is the
mean normalized LPS of the stream's first nat_frames frames, then frozen;
output starts after those frames have arrived.

Every tensor of the decode lives on `device` (default "cuda", through
resolve_device); the host keeps only framing and bookkeeping, and in
StreamingEnhancer the overlap-add buffers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_sednn_torch._device import resolve_device
from tpu_sednn_torch.dsp.stft import LPS_FLOOR, _irdft_matrices, _window_np, rdft_on
from tpu_sednn_torch.enhance.decode import (
    EnhanceConfig,
    _as_tensor,
    finalize_lps,
    quantize_for_serving,
)
from tpu_sednn_torch.model.mlp import MLP, ModelConfig, fold_eval_params, forward_eval


class _StreamCore:
    """What every streaming decoder shares: the folded (or int8-quantized)
    eval params on the device, the rDFT / irDFT matrices, and two functions
    on device tensors: `block` (B + C - 1 raw frames -> B windowed
    time-domain enhanced frames) and `nat_of` (the NAT estimate of the first
    frames).  Built once per (model, decode config, block size, device)."""

    def __init__(
        self,
        params: MLP,
        model_cfg: ModelConfig,
        enh_cfg: EnhanceConfig,
        mean: np.ndarray,
        inv_std: np.ndarray,
        target_norm: Tuple[np.ndarray, np.ndarray] | None,
        block_frames: int,
        quant: str,
        device: str | torch.device = "cuda",
    ):
        if enh_cfg.gv_mode != "off":
            raise ValueError("streaming cannot apply GV equalization "
                             "(utterance-global statistic); use gv_mode='off'")
        if enh_cfg.mask_smooth > 1:
            raise ValueError("streaming does not support centered mask "
                             "smoothing (mask_smooth > 1)")
        self.enh_cfg = enh_cfg
        self.block_frames = int(block_frames)
        if self.block_frames < 1:
            raise ValueError("block_frames must be >= 1")
        dev = resolve_device(device)
        self.device = dev
        stft = enh_cfg.stft
        self.win, self.hop = stft.win_len, stft.hop
        self.d = stft.n_bins
        self.pad_l = enh_cfg.targ_offset
        self.pad_r = enh_cfg.fea_context - 1 - enh_cfg.targ_offset

        folded, eval_cfg = fold_eval_params(params.on(dev), model_cfg)
        self.params, fwd = quantize_for_serving(folded, quant)
        forward_fn = fwd or forward_eval
        mean_d, istd_d = _as_tensor(mean, dev), _as_tensor(inv_std, dev)
        tn = None if target_norm is None else tuple(_as_tensor(a, dev) for a in target_norm)
        cos_d, sin_d = rdft_on(stft, dev)
        icos_d, isin_d = (torch.from_numpy(a).to(dev)
                          for a in _irdft_matrices(stft.win_len, stft.n_fft))
        w_np = _window_np(stft)
        win_d = torch.from_numpy(w_np).to(dev)
        self.ww = (w_np * w_np).astype(np.float32)

        C, B, d, pad_l = enh_cfg.fea_context, self.block_frames, self.d, self.pad_l
        use_nat = enh_cfg.nat

        def block(raw_frames: torch.Tensor, nat_est: torch.Tensor) -> torch.Tensor:
            """(B+C-1 context-extended raw sample frames, win) -> (B, win)
            windowed time-domain enhanced frames for the B centers."""
            re, im = raw_frames @ cos_d, raw_frames @ sin_d
            noisy_lps = torch.log(torch.clamp(re * re + im * im, min=LPS_FLOOR))
            normed = (noisy_lps - mean_d) * istd_d
            x = torch.cat([normed[j : j + B] for j in range(C)], dim=1)
            if use_nat:
                x = torch.cat([x, nat_est.expand(B, d)], dim=1)
            out = forward_fn(self.params, x, eval_cfg)
            re_c, im_c = re[pad_l : pad_l + B], im[pad_l : pad_l + B]
            enh = finalize_lps(out, noisy_lps[pad_l : pad_l + B], enh_cfg, target_norm=tn)
            mag = torch.sqrt(torch.clamp(re_c ** 2 + im_c ** 2, min=LPS_FLOOR))
            g = torch.exp(0.5 * enh) / mag
            return ((re_c * g) @ icos_d + (im_c * g) @ isin_d) * win_d

        def nat_of(raw_frames: torch.Tensor) -> torch.Tensor:
            re, im = raw_frames @ cos_d, raw_frames @ sin_d
            lps = torch.log(torch.clamp(re * re + im * im, min=LPS_FLOOR))
            return ((lps - mean_d) * istd_d).mean(dim=0)

        self.block = block
        self.nat_of = nat_of

    def on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)


class StreamingEnhancer:
    """Stateful one-utterance streaming enhancer; framing and overlap-add on
    the host, each block of centers through `_StreamCore.block` on the
    device.

    Usage:
        se = StreamingEnhancer(params, model_cfg, enh_cfg, mean, inv_std)
        for chunk in audio_chunks:
            out.append(se.push(chunk))
        out.append(se.flush())
        enhanced = np.concatenate(out)   # same length as the input

    One instance = one stream (NAT estimate and overlap-add state are per
    utterance); `reset()` rearms it.
    """

    def __init__(
        self,
        params: MLP,
        model_cfg: ModelConfig,
        enh_cfg: EnhanceConfig,
        mean: np.ndarray,
        inv_std: np.ndarray,
        target_norm: Tuple[np.ndarray, np.ndarray] | None = None,
        block_frames: int = 8,
        quant: str = "none",
        core: "_StreamCore | None" = None,
        device: str | torch.device = "cuda",
    ):
        core = core or _StreamCore(params, model_cfg, enh_cfg, mean, inv_std,
                                   target_norm, block_frames, quant, device)
        self._core = core
        self.enh_cfg = core.enh_cfg
        self.block_frames = core.block_frames
        self._win, self._hop = core.win, core.hop
        self._pad_l, self._pad_r = core.pad_l, core.pad_r
        self._ww = core.ww
        self.reset()

    # -- state ---------------------------------------------------------------

    def reset(self) -> None:
        self._raw = np.zeros(0, np.float32)  # samples not yet fully framed
        self._frames: list[np.ndarray] = []  # raw (win,) frames, sliding
        self._frames_start = 0  # absolute index of self._frames[0]
        self._n_frames = 0  # frames produced so far
        self._next_center = 0  # first frame index not yet enhanced
        self._n_in = 0  # total samples pushed
        self._n_emitted = 0  # total samples returned
        self._nat_est = (None if self.enh_cfg.nat
                         else torch.zeros(self._core.d, device=self._core.device))
        self._acc = np.zeros(0, np.float32)  # OLA accumulator from _n_emitted
        self._wacc = np.zeros(0, np.float32)  # window-square accumulator
        self._flushed = False

    @property
    def algorithmic_latency_samples(self) -> int:
        """Worst-case input-to-output sample latency (see module docstring)."""
        return (self._pad_r + self.block_frames - 1) * self._hop + self._win

    # -- streaming api -------------------------------------------------------

    @torch.inference_mode()
    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed a chunk of samples; returns finalized enhanced samples (may be
        empty while the pipeline fills)."""
        if self._flushed:
            raise RuntimeError("stream already flushed; call reset()")
        samples = np.asarray(samples, np.float32).ravel()
        self._n_in += samples.size
        self._raw = np.concatenate([self._raw, samples])
        if self._raw.size >= self._win:
            # every complete frame in one gather (a per-frame re-slice is
            # O(N^2/hop) copying for one large push, as the command makes)
            n_new = (self._raw.size - self._win) // self._hop + 1
            idx = (np.arange(n_new)[:, None] * self._hop
                   + np.arange(self._win)[None, :])
            self._frames.extend(self._raw[idx])
            self._raw = self._raw[n_new * self._hop:]
            self._n_frames += n_new
        self._maybe_nat()
        self._run_ready_blocks(final=False)
        return self._emit(limit=self._next_center * self._hop)

    @torch.inference_mode()
    def flush(self) -> np.ndarray:
        """End of stream: process the tail (edge-replicated lookahead, as
        the offline decode does) and return all remaining samples; the total
        output length equals the total input length."""
        if self._flushed:
            raise RuntimeError("stream already flushed; call reset()")
        self._flushed = True
        self._maybe_nat(final=True)
        if self._n_frames == 0 or self._nat_est is None:
            # shorter than one analysis window: the offline framing has no
            # frame either; silence of the input's length
            return np.zeros(self._n_in - self._n_emitted, np.float32)
        self._run_ready_blocks(final=True)
        total = (self._n_frames - 1) * self._hop + self._win
        out = self._emit(limit=total)
        if self._n_emitted < self._n_in:  # framing truncated the tail
            pad = np.zeros(self._n_in - self._n_emitted, np.float32)
            self._n_emitted = self._n_in
            out = np.concatenate([out, pad])
        return out[: out.size - max(0, self._n_emitted - self._n_in)]

    # -- internals -----------------------------------------------------------

    def _maybe_nat(self, final: bool = False) -> None:
        if self._nat_est is not None:
            return
        k = self.enh_cfg.nat_frames
        if self._n_frames >= k:
            self._nat_est = self._core.nat_of(self._core.on_device(np.stack(self._frames[:k])))
        elif final and self._n_frames > 0:
            # short stream: the offline decode averages the frames that exist
            self._nat_est = self._core.nat_of(self._core.on_device(np.stack(self._frames)))

    def _frame_at(self, idx: int) -> np.ndarray:
        """Raw frame by absolute index with edge replication outside [0, n)."""
        idx = min(max(idx, 0), self._n_frames - 1)
        return self._frames[idx - self._frames_start]

    def _run_ready_blocks(self, final: bool) -> None:
        if self._nat_est is None:
            return
        B, C = self.block_frames, self.enh_cfg.fea_context
        while True:
            last_center = self._next_center + B - 1
            if not final and last_center + self._pad_r >= self._n_frames:
                return
            if final and self._next_center >= self._n_frames:
                return
            n_valid = min(B, self._n_frames - self._next_center)
            rows = np.stack([self._frame_at(self._next_center - self._pad_l + j)
                             for j in range(B + C - 1)])
            td = self._core.block(self._core.on_device(rows), self._nat_est).cpu().numpy()
            self._ola_add(td[:n_valid], self._next_center)
            self._next_center += n_valid
            self._trim_history()

    def _ola_add(self, td: np.ndarray, first_center: int) -> None:
        start = first_center * self._hop - self._n_emitted
        need = start + (td.shape[0] - 1) * self._hop + self._win
        if self._acc.size < need:
            grow = need - self._acc.size
            self._acc = np.concatenate([self._acc, np.zeros(grow, np.float32)])
            self._wacc = np.concatenate([self._wacc, np.zeros(grow, np.float32)])
        for k in range(td.shape[0]):
            s = start + k * self._hop
            self._acc[s : s + self._win] += td[k]
            self._wacc[s : s + self._win] += self._ww

    def _emit(self, limit: int) -> np.ndarray:
        n = min(limit - self._n_emitted, self._acc.size)
        if n <= 0:
            return np.zeros(0, np.float32)
        out = self._acc[:n] / np.maximum(self._wacc[:n], 1e-8)
        self._acc = self._acc[n:]
        self._wacc = self._wacc[n:]
        self._n_emitted += n
        return out

    def _trim_history(self) -> None:
        keep_from = max(self._next_center - self._pad_l, 0)
        drop = keep_from - self._frames_start
        if drop > 0:
            del self._frames[:drop]
            self._frames_start = keep_from


class DeviceStreamingEnhancer:
    """Streaming enhancer whose rolling state lives in device tensors.

    The carry — context frame ring (C-1, win), raw-sample tail (win-hop,),
    overlap-add accumulators (win-hop,) x2 and the frozen NAT estimate — is a
    tuple of device tensors threaded through `_step(carry, new)`: each step
    consumes exactly block_frames*hop new samples and emits as many
    finalized enhanced samples, with no host state between steps.
    `scan_blocks` runs N steps back to back on device tensors with no host
    synchronisation between them (one copy in, one copy out), the counterpart
    of the JAX class's lax.scan.

    Output equals StreamingEnhancer / enhance_waveform to float32 rounding:
    priming (the context ring and the NAT estimate from the first nat_frames
    frames) and the end-of-stream tail (edge-replicated lookahead) are framed
    on the host and run through the same `block` on the device; everything
    in between is the device step.  A stream too short to prime is handed,
    as in the JAX package, to StreamingEnhancer on the same core (same
    params, same device): the decode still runs on this device.

    Needs targ_offset < fea_context - 1 (at least one lookahead frame); use
    StreamingEnhancer for zero-lookahead configs.
    """

    def __init__(
        self,
        params: MLP,
        model_cfg: ModelConfig,
        enh_cfg: EnhanceConfig,
        mean: np.ndarray,
        inv_std: np.ndarray,
        target_norm: Tuple[np.ndarray, np.ndarray] | None = None,
        block_frames: int = 8,
        quant: str = "none",
        device: str | torch.device = "cuda",
    ):
        core = _StreamCore(params, model_cfg, enh_cfg, mean, inv_std,
                           target_norm, block_frames, quant, device)
        if core.pad_r < 1:
            raise ValueError("DeviceStreamingEnhancer needs >= 1 lookahead "
                             "frame (targ_offset < fea_context - 1)")
        self._core = core
        self.enh_cfg = core.enh_cfg
        self.block_frames = core.block_frames
        win, hop, B = core.win, core.hop, core.block_frames
        self._win, self._hop = win, hop
        # samples consumed when the carry is primed: frames 0..pad_r-1 formed,
        # plus the (win-hop)-sample tail ahead of frame pad_r
        self._n_prime = (core.pad_r - 1) * hop + win
        L = (B - 1) * hop + win

        def ola(frames: torch.Tensor) -> torch.Tensor:
            """(B, win) -> (L,): frame k added at k*hop."""
            return F.fold(frames.t().unsqueeze(0), output_size=(1, L),
                          kernel_size=(1, win), stride=(1, hop)).reshape(L)

        ww_ola = ola(torch.from_numpy(np.tile(core.ww, (B, 1))).to(core.device))

        def step(carry, new):
            """(carry, (B*hop,) new samples) -> (carry, (B*hop,) enhanced)."""
            prev, tail, acc, wacc, nat = carry
            seg = torch.cat([tail, new])
            rows = torch.cat([prev, seg.unfold(0, win, hop)], dim=0)  # (C-1+B, win)
            accf = ola(core.block(rows, nat))
            accf[: win - hop] += acc
            waccf = ww_ola.clone()
            waccf[: win - hop] += wacc
            out = accf[: B * hop] / torch.clamp(waccf[: B * hop], min=1e-8)
            return (rows[B:], seg[B * hop:], accf[B * hop:], waccf[B * hop:], nat), out

        self._step = step
        self.reset()

    # -- state ---------------------------------------------------------------

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)  # unconsumed samples
        self._carry = None
        self._n_in = 0
        self._n_emitted = 0
        self._frames_done = 0  # frames already folded into the carry
        self._centers_done = 0  # centers already emitted
        self._flushed = False

    @property
    def algorithmic_latency_samples(self) -> int:
        return (self._core.pad_r + self.block_frames - 1) * self._hop + self._win

    def _try_prime(self) -> bool:
        """Build the device carry once enough samples are buffered: the first
        pad_r frames (after pad_l copies of frame 0) as the context ring, the
        NAT estimate of the first nat_frames frames, zeroed OLA accumulators."""
        core = self._core
        win, hop = self._win, self._hop
        need = self._n_prime
        k = self.enh_cfg.nat_frames
        if self.enh_cfg.nat:
            need = max(need, (k - 1) * hop + win)
        if self._buf.size < need:
            return False
        buf = self._buf
        pad_l, pad_r = core.pad_l, core.pad_r
        f0 = np.stack([buf[j * hop : j * hop + win] for j in range(pad_r)])
        prev = np.concatenate([np.repeat(f0[:1], pad_l, axis=0), f0], axis=0)
        if self.enh_cfg.nat:
            nat = core.nat_of(core.on_device(np.stack([buf[j * hop : j * hop + win]
                                                       for j in range(k)])))
        else:
            nat = torch.zeros(core.d, device=core.device)
        z = torch.zeros(win - hop, device=core.device)
        self._carry = (core.on_device(prev), core.on_device(buf[pad_r * hop : self._n_prime]),
                       z, z.clone(), nat)
        self._buf = buf[self._n_prime:]
        self._frames_done = pad_r
        self._centers_done = 0
        return True

    # -- streaming api -------------------------------------------------------

    @torch.inference_mode()
    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed samples; returns finalized enhanced samples (empty while the
        pipeline fills).  Each full block of block_frames*hop buffered samples
        runs one device step; the push copies its blocks in once and its
        output out once."""
        if self._flushed:
            raise RuntimeError("stream already flushed; call reset()")
        s = np.asarray(samples, np.float32).ravel()
        self._n_in += s.size
        self._buf = np.concatenate([self._buf, s])
        if self._carry is None and not self._try_prime():
            return np.zeros(0, np.float32)
        step_in = self.block_frames * self._hop
        n = self._buf.size // step_in
        if n == 0:
            return np.zeros(0, np.float32)
        out = self._run(self._buf[: n * step_in].reshape(n, step_in))
        self._buf = self._buf[n * step_in:]
        return out.reshape(-1)

    @torch.inference_mode()
    def scan_blocks(self, blocks: np.ndarray) -> np.ndarray:
        """Run N steady-state steps back to back on the device.

        blocks: (N, block_frames*hop).  The stream must be primed (push at
        least the priming samples first) and hold no partial block.  Returns
        (N, block_frames*hop) enhanced samples; the state advances exactly as
        N push() blocks would."""
        if self._carry is None:
            raise RuntimeError("stream not primed yet (push more samples)")
        if self._buf.size:
            raise RuntimeError("unconsumed buffered samples; push whole "
                               "blocks before scan_blocks")
        blocks = np.asarray(blocks, np.float32)
        n, width = blocks.shape
        if width != self.block_frames * self._hop:
            raise ValueError(f"blocks must be (N, {self.block_frames * self._hop})")
        self._n_in += n * width
        return self._run(blocks)

    def _run(self, blocks: np.ndarray) -> np.ndarray:
        """N steps over (N, B*hop) samples: one copy to the device, the steps
        enqueued back to back, one copy of the (N, B*hop) output back."""
        n, width = blocks.shape
        new = self._core.on_device(blocks)
        outs = torch.empty_like(new)
        carry = self._carry
        for i in range(n):
            carry, outs[i] = self._step(carry, new[i])
        self._carry = carry
        self._frames_done += n * self.block_frames
        self._centers_done += n * self.block_frames
        self._n_emitted += n * width
        return outs.cpu().numpy()

    @torch.inference_mode()
    def flush(self) -> np.ndarray:
        """End of stream: the tail (edge-replicated lookahead) framed on the
        host and run through the same `block` on the device; total output
        length equals total input length."""
        if self._flushed:
            raise RuntimeError("stream already flushed; call reset()")
        self._flushed = True
        core = self._core
        win, hop, B, C = self._win, self._hop, self.block_frames, self.enh_cfg.fea_context
        pad_l = core.pad_l
        if self._carry is None:
            # never primed (a short stream): the host class on this core,
            # whose decode runs on the same device; self._buf holds ALL input
            se = StreamingEnhancer(None, None, None, None, None, core=core)
            parts = [se.push(self._buf)] if self._buf.size else []
            parts.append(se.flush())
            return np.concatenate(parts)
        prev_d, tail_d, acc_d, wacc_d, nat = self._carry
        prev = prev_d.cpu().numpy()
        rest = np.concatenate([tail_d.cpu().numpy(), self._buf])
        n_more = (len(rest) - win) // hop + 1 if len(rest) >= win else 0
        frames = {}
        for idx in range(C - 1):  # frames centers_done-pad_l .. frames_done-1
            frames[self._centers_done - pad_l + idx] = prev[idx]
        for j in range(n_more):
            frames[self._frames_done + j] = rest[j * hop : j * hop + win]
        n_frames = self._frames_done + n_more
        lo_key = self._centers_done - pad_l

        def frame_at(i):
            return frames[min(max(i, lo_key), n_frames - 1)]

        total = (n_frames - 1) * hop + win
        need = total - self._n_emitted
        acc_h = np.zeros(max(need, win - hop), np.float32)
        wacc_h = np.zeros_like(acc_h)
        acc_h[: win - hop] = acc_d.cpu().numpy()
        wacc_h[: win - hop] = wacc_d.cpu().numpy()
        c = self._centers_done
        while c < n_frames:
            n_valid = min(B, n_frames - c)
            rows = np.stack([frame_at(c - pad_l + j) for j in range(B + C - 1)])
            td = core.block(core.on_device(rows), nat).cpu().numpy()
            for k in range(n_valid):
                s = (c + k) * hop - self._n_emitted
                acc_h[s : s + win] += td[k]
                wacc_h[s : s + win] += core.ww
            c += n_valid
        out = (acc_h / np.maximum(wacc_h, 1e-8))[:need]
        self._n_emitted = total
        if self._n_emitted < self._n_in:  # framing truncated the tail
            out = np.concatenate(
                [out, np.zeros(self._n_in - self._n_emitted, np.float32)])
            self._n_emitted = self._n_in
        return out[: out.size - max(0, self._n_emitted - self._n_in)]
