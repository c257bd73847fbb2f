"""Input pipeline: chunk planning, context splicing, NAT, sample scattering.

Two tiers:

* `read_chunk_parity` — semantics-exact reproduction of the reference host
  pipeline `Interface::Readchunk` (the reference's Interface.cc:689-861):
  big-endian pfile chunk read, per-dim normalization, 11-frame splicing, NAT
  noise-estimate append, and the lrand48 Fisher-Yates shuffled scatter.  Used
  for parity testing and `.pfile`-based training.

* `build_training_arrays` / `splice` / `nat_estimate` — the in-memory path:
  whole utterances of LPS features become spliced sample matrices with
  vectorized numpy ops (no per-frame host loop).  Feature extraction itself
  lives in tpu_sednn_torch.dsp / tpu_sednn_torch.ops and runs on the device.

Host side only (numpy); own copy of tpu_sednn/data/pipeline.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from tpu_sednn_torch.data.rand48 import Rand48
from tpu_sednn_torch.io.pfile import PfileInfo, read_pfile_frames


# ---------------------------------------------------------------------------
# chunk planning (Interface::get_chunk_info, Interface.cc:558-686)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChunkPlan:
    chunk_frame_st: np.ndarray  # (n_chunks,) absolute start frame of each chunk
    total_chunks: int
    total_samples: int
    sent_st: int
    sent_en: int
    traincache: int


def plan_chunks(
    frames_before_sent: np.ndarray,
    sent_range: Tuple[int, int],
    fea_context: int,
    traincache: int,
) -> ChunkPlan:
    """Exact reproduction of the reference chunk planner.

    Each chunk yields ~traincache spliced samples; a sentence loses
    fea_context-1 frames (or all, if shorter than the context).  When a chunk
    boundary splits a sentence, the next chunk re-reads the tail as a fresh
    segment, so the fea_context-1 windows spanning the boundary are LOST —
    a reference quirk we reproduce (the planner's sample accounting at
    Interface.cc:599-614 matches its reader exactly, including this loss).
    """
    sent_st, sent_en = sent_range
    total_sents = len(frames_before_sent)
    if sent_en < sent_st or sent_st < 0 or sent_en >= total_sents:
        raise ValueError(f"sent range {sent_st}-{sent_en} out of bounds (total {total_sents})")
    total_frames = int(frames_before_sent[-1])

    cur_frame_id = 0 if sent_st == 0 else int(frames_before_sent[sent_st - 1])
    starts = [cur_frame_id]
    cur_chunk_frames = 0
    for sentid in range(sent_st, sent_en + 1):
        frames_inc = int(frames_before_sent[sentid]) - cur_frame_id
        cur_frame_id = int(frames_before_sent[sentid])
        lost = fea_context - 1 if frames_inc >= fea_context else frames_inc
        cur_chunk_frames += frames_inc - lost
        while cur_chunk_frames >= traincache:
            next_st = cur_frame_id - (cur_chunk_frames - traincache)
            if next_st < total_frames:
                starts.append(next_st)
                over = cur_frame_id - next_st
                cur_chunk_frames = over - fea_context + 1 if over > fea_context - 1 else 0
            else:  # pragma: no cover - mirrors the reference's guard
                break
    total_chunks = len(starts)
    total_samples = (total_chunks - 1) * traincache + cur_chunk_frames
    return ChunkPlan(
        np.asarray(starts, np.int64), total_chunks, total_samples, sent_st, sent_en, traincache
    )


# ---------------------------------------------------------------------------
# splicing + NAT (vectorized)
# ---------------------------------------------------------------------------

def splice(features: np.ndarray, context: int) -> np.ndarray:
    """(n, d) -> (n-context+1, context*d): consecutive-frame windows.

    Sample j = concat(frames j..j+context-1), matching the scatter loop at
    Interface.cc:770-775.  Returns a view-backed copy (stride tricks).
    """
    n, d = features.shape
    if n < context:
        return np.empty((0, context * d), features.dtype)
    s0, s1 = features.strides
    win = np.lib.stride_tricks.as_strided(
        features, shape=(n - context + 1, context, d), strides=(s0, s0, s1)
    )
    return win.reshape(n - context + 1, context * d)


def nat_estimate(segment: np.ndarray, n_first: int = 6) -> np.ndarray:
    """Noise-aware-training estimate: mean of the segment's first `n_first`
    frames (hardcoded 6 at Interface.cc:776-779).  The reference divides by
    6.0 unconditionally; we match that when >=6 frames exist and fall back to
    the true mean for shorter segments (the reference would read past the
    segment there).
    """
    k = min(n_first, segment.shape[0])
    est = segment[:k].sum(axis=0) / float(n_first if segment.shape[0] >= n_first else k)
    return est.astype(segment.dtype)


def _segments_in_chunk(
    frames_before_sent: np.ndarray, chunk_start: int, n_frames: int
) -> List[Tuple[int, int]]:
    """Split [chunk_start, chunk_start+n_frames) at sentence boundaries.

    Returns (offset_within_chunk, length) per sentence segment, reproducing
    the reference's walk (Interface.cc:758-790).
    """
    bounds = np.concatenate([[0], frames_before_sent])
    segs = []
    pos = chunk_start
    end = chunk_start + n_frames
    sent = int(np.searchsorted(frames_before_sent, pos, side="right"))
    while pos < end:
        sent_end = int(bounds[sent + 1])
        seg_end = min(sent_end, end)
        segs.append((pos - chunk_start, seg_end - pos))
        pos = seg_end
        sent += 1
    return segs


def build_training_arrays(
    utterances: Sequence[np.ndarray],
    targets: Sequence[np.ndarray],
    fea_context: int = 11,
    targ_offset: int = 5,
    nat: bool = True,
    mean: np.ndarray | None = None,
    inv_std: np.ndarray | None = None,
    targ_mean: np.ndarray | None = None,
    targ_inv_std: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-corpus vectorized equivalent of the splice+NAT sample construction.

    utterances[i]: (n_i, d) noisy LPS; targets[i]: (n_i, d_out) clean LPS (or
    mask).  Output X: (N, d*context [+ d]), T: (N, d_out), N = sum of
    per-utterance n_i - context + 1 (short utterances contribute 0).

    targ_mean/targ_inv_std optionally normalize the regression targets (a
    clean-mode extension; the reference trains on raw clean LPS, which is
    ill-conditioned when the spectrum hits the log floor — decode denormalizes
    via the same stats).
    """
    xs, ts = [], []
    for u, t in zip(utterances, targets):
        u = np.asarray(u, np.float32)
        if mean is not None:
            u = (u - mean) * inv_std
        if u.shape[0] < fea_context:
            continue
        sx = splice(u, fea_context)
        if nat:
            est = np.broadcast_to(nat_estimate(u), (sx.shape[0], u.shape[1]))
            sx = np.concatenate([sx, est], axis=1)
        xs.append(sx.astype(np.float32))
        t = np.asarray(t, np.float32)[targ_offset : targ_offset + sx.shape[0]]
        if targ_mean is not None:
            t = (t - targ_mean) * targ_inv_std
        ts.append(t)
    if not xs:
        raise ValueError("no utterance long enough for the context window")
    return np.concatenate(xs), np.concatenate(ts)


# ---------------------------------------------------------------------------
# parity chunk reader (Interface::Readchunk / Readchunk_cv)
# ---------------------------------------------------------------------------

def read_chunk_parity(
    fea_info: PfileInfo,
    targ_info: PfileInfo,
    plan: ChunkPlan,
    chunk_index: int,
    fea_context: int,
    targ_offset: int,
    mean: np.ndarray,
    inv_std: np.ndarray,
    rand: Rand48 | None,
    nat: bool = True,
    use_native: bool | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One chunk of (indata, targ), shuffled exactly like the reference.

    rand=None reproduces Readchunk_cv (no shuffle, Interface.cc:901-904);
    otherwise the lrand48 Fisher-Yates scatter of Readchunk.  NAT appends the
    per-sentence-segment first-6-frames mean (Interface.cc:776-779).

    use_native: route the hot loops through the threaded C++ library
    (native/pfile_native.cpp); None = the numpy route (the library is used
    only when asked for, and only if it can be loaded).
    """
    from tpu_sednn_torch.io import native as _native

    if use_native is None:
        use_native = False
    elif use_native and not _native.available():
        raise RuntimeError("use_native=True but native/libsednn_native.so cannot be loaded")
    fbs = fea_info.frames_before_sent
    starts = plan.chunk_frame_st
    if chunk_index == plan.total_chunks - 1:
        frames_need = int(fbs[plan.sent_en]) - int(starts[chunk_index])
        samples_in_chunk = plan.total_samples - chunk_index * plan.traincache
    else:
        frames_need = int(starts[chunk_index + 1]) - int(starts[chunk_index])
        samples_in_chunk = plan.traincache

    d = fea_info.fea_dim
    d_out = targ_info.fea_dim
    start = int(starts[chunk_index])
    sample_index = (
        rand.shuffle_indices(samples_in_chunk) if rand is not None
        else np.arange(samples_in_chunk)
    )
    segs = _segments_in_chunk(fbs, start, frames_need)
    seg_off = np.array([o for o, _ in segs], np.int64)
    seg_len = np.array([l for _, l in segs], np.int64)

    if use_native:
        from tpu_sednn_torch.io.pfile import PFILE_HEADER_SIZE

        fea = _native.read_frames_native(
            fea_info.path, PFILE_HEADER_SIZE, start, frames_need, d, mean, inv_std
        )
        targ = _native.read_frames_native(
            targ_info.path, PFILE_HEADER_SIZE, start, frames_need, d_out, None, None
        )
        indata = _native.splice_scatter_native(
            fea, seg_off, seg_len, fea_context, nat, sample_index, samples_in_chunk
        )
        outdata = _native.target_scatter_native(
            targ, seg_off, seg_len, fea_context, targ_offset, sample_index, samples_in_chunk
        )
        return indata, outdata

    fea = read_pfile_frames(fea_info.path, d, start, frames_need)
    fea = (fea - mean) * inv_std
    targ = read_pfile_frames(targ_info.path, d_out, start, frames_need)

    in_dim = d * fea_context + (d if nat else 0)
    indata = np.zeros((samples_in_chunk, in_dim), np.float32)
    outdata = np.zeros((samples_in_chunk, d_out), np.float32)
    cur = 0
    for off, seg_len_i in segs:
        if seg_len_i < fea_context:
            continue
        seg = fea[off : off + seg_len_i]
        sx = splice(seg, fea_context)
        n_s = sx.shape[0]
        rows = sample_index[cur : cur + n_s]
        indata[rows, : d * fea_context] = sx
        if nat:
            indata[rows, d * fea_context :] = nat_estimate(seg)
        outdata[rows] = targ[off + targ_offset : off + targ_offset + n_s]
        cur += n_s
    if cur != samples_in_chunk:
        raise AssertionError(f"chunk {chunk_index}: built {cur} samples, planned {samples_in_chunk}")
    return indata, outdata
