"""On-device chunk construction for the pfile training path.

The parity chunk reader ships fully-spliced samples to the device:
(traincache, fea_dim*context + fea_dim) — each frame is replicated `context`
times plus a NAT copy, ~12x the raw feature bytes.  Over a bandwidth-limited
host->device link (PCIe) that
transfer is the larger part of a chunk's input cost.  Here the host sends
only the RAW normalized frames (fea_dim wide) plus small int32 index tables,
and the splice + NAT + shuffled scatter run on the device as torch index
gathers — the same (X, T) matrices as `read_chunk_parity` (NAT mean up to
fp summation order), at ~1/12th the transfer.  Counterpart of
tpu_sednn/data/device_chunk.py.

Semantics reproduced (citations into the reference's Interface.cc):
* 11-frame per-sentence-segment splicing, no cross-sentence windows (:770-775)
* NAT: per-segment mean of the first 6 frames, /6.0 unconditionally for
  segments >= 6 frames (:776-779)
* targets from the window start + targ_offset (:833-853)
* lrand48-shuffled sample placement — folded into the host-built index
  tables, so the device does gathers, not scatters (:731-735)

Shapes are padded to fixed capacities by the caller, as in the JAX package
(where one compiled program then serves every chunk; the port compiles
nothing per shape, but keeps the contract); rows past the real sample count
are garbage and the trainer skips them via its n_real bunch count.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu_sednn_torch.data.pipeline import ChunkPlan, _segments_in_chunk
from tpu_sednn_torch.data.rand48 import Rand48
from tpu_sednn_torch.io.pfile import PFILE_HEADER_SIZE, PfileInfo


@torch.no_grad()
def build_chunk_on_device(
    fea: torch.Tensor,        # (frames_cap, d) normalized features
    targ: torch.Tensor,       # (frames_cap, d_out) raw targets
    win_start: torch.Tensor,  # (samples_cap,) int chunk-relative window starts
    seg_id: torch.Tensor,     # (samples_cap,) int segment index per sample
    seg_off: torch.Tensor,    # (seg_cap,) int segment offsets
    seg_len: torch.Tensor,    # (seg_cap,) int segment lengths (0 = padding)
    context: int,
    targ_offset: int,
    nat: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (X (samples_cap, context*d [+ d]), T (samples_cap, d_out)) on the
    device the inputs live on, by index gathers."""
    n_frames, d = fea.shape
    dev = fea.device
    win_start, seg_id = win_start.long(), seg_id.long()
    seg_off, seg_len = seg_off.long(), seg_len.long()
    idx = win_start[:, None] + torch.arange(context, device=dev)[None, :]
    x = fea[idx.clamp(0, n_frames - 1)].reshape(win_start.shape[0], context * d)
    if nat:
        # per-segment first-6-frames mean; /6.0 unconditionally when the
        # segment has >= 6 frames, /k for shorter (nat_estimate semantics)
        k = seg_len.clamp(0, 6)
        six = torch.arange(6, device=dev)
        rows = seg_off[:, None] + six[None, :]
        vals = fea[rows.clamp(0, n_frames - 1)]  # (seg_cap, 6, d)
        valid = six[None, :] < k[:, None]
        div = torch.where(seg_len >= 6, torch.full_like(k, 6), k.clamp(min=1)).to(fea.dtype)
        nat_seg = (vals * valid[:, :, None].to(fea.dtype)).sum(dim=1) / div[:, None]
        x = torch.cat([x, nat_seg[seg_id]], dim=1)
    t_idx = (win_start + targ_offset).clamp(0, targ.shape[0] - 1)
    return x, targ[t_idx]


def read_chunk_indexed(
    fea_info: PfileInfo,
    targ_info: PfileInfo,
    plan: ChunkPlan,
    chunk_index: int,
    fea_context: int,
    mean: np.ndarray,
    inv_std: np.ndarray,
    rand: Rand48 | None,
    frames_cap: int | None = None,
    samples_cap: int | None = None,
    seg_cap: int | None = None,
    use_native: bool = False,
):
    """Host half of the on-device chunk build: read + normalize the raw
    frames and construct the gather tables that
    realize the reference's splice + shuffled scatter as device gathers.

    Consumes the lrand48 stream exactly like `read_chunk_parity` (one
    shuffle of samples_in_chunk draws), so parity runs can switch paths
    freely.  All outputs are padded to the given capacities (None = exact).

    Returns (fea, targ, win_start, seg_id, seg_off, seg_len, n_samples).
    """
    from tpu_sednn_torch.io import native as _native
    from tpu_sednn_torch.io.pfile import read_pfile_frames

    fbs = fea_info.frames_before_sent
    starts = plan.chunk_frame_st
    if chunk_index == plan.total_chunks - 1:
        frames_need = int(fbs[plan.sent_en]) - int(starts[chunk_index])
        n_samples = plan.total_samples - chunk_index * plan.traincache
    else:
        frames_need = int(starts[chunk_index + 1]) - int(starts[chunk_index])
        n_samples = plan.traincache
    start = int(starts[chunk_index])
    d, d_out = fea_info.fea_dim, targ_info.fea_dim

    if use_native and not _native.available():
        raise RuntimeError("use_native=True but native/libsednn_native.so cannot be loaded")
    if use_native:
        fea = _native.read_frames_native(
            fea_info.path, PFILE_HEADER_SIZE, start, frames_need, d, mean, inv_std)
        targ = _native.read_frames_native(
            targ_info.path, PFILE_HEADER_SIZE, start, frames_need, d_out, None, None)
    else:
        fea = (read_pfile_frames(fea_info.path, d, start, frames_need) - mean) * inv_std
        targ = read_pfile_frames(targ_info.path, d_out, start, frames_need)

    sample_index = (rand.shuffle_indices(n_samples) if rand is not None
                    else np.arange(n_samples))
    segs = _segments_in_chunk(fbs, start, frames_need)
    win_start = np.zeros(samples_cap or n_samples, np.int32)
    seg_id = np.zeros(samples_cap or n_samples, np.int32)
    cur = 0
    for s, (off, seg_len_i) in enumerate(segs):
        if seg_len_i < fea_context:
            continue
        n_s = seg_len_i - fea_context + 1
        rows = sample_index[cur : cur + n_s]
        win_start[rows] = off + np.arange(n_s, dtype=np.int32)
        seg_id[rows] = s
        cur += n_s
    if cur != n_samples:
        raise AssertionError(f"chunk {chunk_index}: built {cur} samples, planned {n_samples}")

    seg_off_a = np.zeros(seg_cap or len(segs), np.int32)
    seg_len_a = np.zeros(seg_cap or len(segs), np.int32)
    for s, (off, ln) in enumerate(segs):
        seg_off_a[s] = off
        seg_len_a[s] = ln
    if frames_cap is not None and frames_cap > frames_need:
        fea = np.pad(fea, ((0, frames_cap - frames_need), (0, 0)))
        targ = np.pad(targ, ((0, frames_cap - frames_need), (0, 0)))
    return fea, targ, win_start, seg_id, seg_off_a, seg_len_a, n_samples


def chunk_capacities(fea_info: PfileInfo, plan: ChunkPlan, fea_context: int):
    """(frames_cap, samples_cap, seg_cap) over all chunks of `plan`, rounded
    up a little, so every chunk of the epoch has the same shapes."""
    fbs = fea_info.frames_before_sent
    starts = plan.chunk_frame_st
    frames_cap = segs_cap = 0
    for ci in range(plan.total_chunks):
        if ci == plan.total_chunks - 1:
            need = int(fbs[plan.sent_en]) - int(starts[ci])
        else:
            need = int(starts[ci + 1]) - int(starts[ci])
        frames_cap = max(frames_cap, need)
        segs_cap = max(segs_cap, len(_segments_in_chunk(fbs, int(starts[ci]), need)))
    round_to = 512
    frames_cap = ((frames_cap + round_to - 1) // round_to) * round_to
    segs_cap = ((segs_cap + 63) // 64) * 64
    return frames_cap, plan.traincache, segs_cap
