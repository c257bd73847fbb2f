"""Quicknet "Pfile" feature-archive codec.

Byte-exact with what the reference trainer actually reads
(the reference's Interface.cc:468-555 `get_pfile_info`, :689-861 `Readchunk`,
:1057-1093 `get_uint`/`read_tail`, plus the format notes in
the reference's how_to_get_pfile.txt):

  * 32768-byte ASCII header (PFILE_HEADER_SIZE, Interface.cc:13) containing at
    least "-num_sentences N" and "-num_frames N".
  * `num_frames` frames, each big-endian: uint32 sentence_id, uint32 frame_id,
    fea_dim float32 feature values.
  * a sentence-index tail of (num_sentences + 1) big-endian int32 values
    [0, cum_1, ..., cum_S]; the trainer skips the leading 0 and reads the
    cumulative frame counts (read_tail skips 4 bytes, Interface.cc:1080-1093).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

PFILE_HEADER_SIZE = 32768


@dataclass(frozen=True)
class PfileInfo:
    path: str
    num_sentences: int
    num_frames: int
    fea_dim: int
    frames_before_sent: np.ndarray  # (num_sentences,) cumulative frames THROUGH sentence i

    @property
    def frames_per_sent(self) -> np.ndarray:
        return np.diff(np.concatenate([[0], self.frames_before_sent]))


def _header_uint(header: str, key: str) -> int:
    # Mirrors Interface::get_uint: strstr then sscanf "%u" (Interface.cc:1057-1078).
    m = re.search(re.escape(key) + r"\s+(\d+)", header)
    if m is None:
        raise ValueError(f"pfile header missing {key}")
    return int(m.group(1))


def read_pfile_info(path: str, fea_dim: int) -> PfileInfo:
    with open(path, "rb") as f:
        header = f.read(PFILE_HEADER_SIZE).decode("ascii", errors="replace")
        num_sentences = _header_uint(header, "-num_sentences")
        num_frames = _header_uint(header, "-num_frames")
        size_per_frame = 4 * (2 + fea_dim)
        # Tail starts right after the data; skip the leading 0 entry.
        f.seek(PFILE_HEADER_SIZE + num_frames * size_per_frame + 4)
        tail = np.frombuffer(f.read(4 * num_sentences), dtype=">i4")
        if tail.size != num_sentences:
            raise ValueError(f"pfile tail truncated: {path}")
    tail = tail.astype(np.int64)
    # Sanity-check the sentence index: strictly increasing, ending at num_frames.
    # (A wrong fea_dim lands the tail read in the middle of frame data; the
    # reference would silently consume garbage here — we reject instead.)
    if tail[-1] != num_frames or np.any(np.diff(tail) <= 0) or tail[0] <= 0:
        raise ValueError(
            f"pfile sentence index inconsistent in {path} (wrong fea_dim? "
            f"expected cumulative counts ending at {num_frames}, got {tail[:3]}...)"
        )
    return PfileInfo(path, num_sentences, num_frames, fea_dim, tail)


def read_pfile_frames(path: str, fea_dim: int, start: int, count: int) -> np.ndarray:
    """Read `count` raw frames starting at absolute frame `start`.

    Returns float32 (count, fea_dim); the two id words are dropped.
    """
    size_per_frame = 4 * (2 + fea_dim)
    with open(path, "rb") as f:
        f.seek(PFILE_HEADER_SIZE + start * size_per_frame)
        raw = np.frombuffer(f.read(count * size_per_frame), dtype=">f4")
    if raw.size != count * (2 + fea_dim):
        raise ValueError(f"short read from {path} at frame {start}")
    return raw.reshape(count, 2 + fea_dim)[:, 2:].astype(np.float32)


def read_pfile_utterances(path: str, fea_dim: int) -> List[np.ndarray]:
    """Read the whole pfile as a list of per-sentence (n_frames, fea_dim) arrays."""
    info = read_pfile_info(path, fea_dim)
    data = read_pfile_frames(path, fea_dim, 0, info.num_frames)
    bounds = np.concatenate([[0], info.frames_before_sent])
    return [data[bounds[i] : bounds[i + 1]] for i in range(info.num_sentences)]


def write_pfile(path: str, utterances: Sequence[np.ndarray]) -> None:
    """Write a pfile from per-utterance (n_frames, fea_dim) float32 arrays."""
    if not utterances:
        raise ValueError("no utterances")
    fea_dim = int(utterances[0].shape[1])
    num_frames = int(sum(u.shape[0] for u in utterances))
    num_sentences = len(utterances)
    data_size = num_frames * 4 * (2 + fea_dim)

    header = (
        "-pfile_header version 0 size 32768\n"
        f"-data size {data_size // 4} offset 0 ndim 2\n"
        f"-nrow {num_frames} -ncol {2 + fea_dim}\n"
        f"-num_frames {num_frames}\n"
        f"-num_sentences {num_sentences}\n"
        f"-first_feature_column 2\n-num_features {fea_dim}\n"
        f"-format dd{fea_dim}f\n"
        "-end\n"
    )
    header_bytes = header.encode("ascii")
    if len(header_bytes) > PFILE_HEADER_SIZE:
        raise ValueError("pfile header overflow")
    header_bytes = header_bytes + b"\0" * (PFILE_HEADER_SIZE - len(header_bytes))

    with open(path, "wb") as f:
        f.write(header_bytes)
        for sent_id, utt in enumerate(utterances):
            utt = np.asarray(utt, dtype=np.float32)
            if utt.ndim != 2 or utt.shape[1] != fea_dim:
                raise ValueError(f"utterance {sent_id}: bad shape {utt.shape}")
            n = utt.shape[0]
            frame = np.empty((n, 2 + fea_dim), dtype=">f4")
            # id words are uint32 stored in the same 4-byte slots
            frame[:, 0:2].view(">u4")[:, 0] = sent_id
            frame[:, 0:2].view(">u4")[:, 1] = np.arange(n, dtype=np.uint32)
            frame[:, 2:] = utt
            f.write(frame.tobytes())
        # sentence-index tail: 0, then cumulative frame counts
        counts = np.array([u.shape[0] for u in utterances], dtype=np.int64)
        tail = np.concatenate([[0], np.cumsum(counts)]).astype(">i4")
        f.write(tail.tobytes())
