"""HTK feature-file codec (both endiannesses) — a copy of
tpu_sednn/io/htk.py (numpy; the port imports nothing of the JAX package).

The header is int32 nSamples, int32 sampPeriod (100 ns units), int16
sampSize (bytes per frame), int16 paramKind, followed by float32 frame data.
quicknet's feacat requires big-endian files, so big-endian is the default;
`htk_le2be` rewrites a little-endian file as big-endian.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

HTK_USER = 9  # paramKind USER: generic float features


def write_htk(
    path: str,
    features: np.ndarray,
    sample_period_100ns: int = 160000,  # 16 ms shift, matching feacat -period 16.0
    param_kind: int = HTK_USER,
    big_endian: bool = True,
) -> None:
    features = np.asarray(features, dtype=np.float32)
    if features.ndim != 2:
        raise ValueError("features must be (n_frames, dim)")
    n, dim = features.shape
    bo = ">" if big_endian else "<"
    with open(path, "wb") as f:
        f.write(struct.pack(f"{bo}iihh", n, sample_period_100ns, dim * 4, param_kind))
        f.write(features.astype(f"{bo}f4").tobytes())


def read_htk(path: str, big_endian: bool = True) -> Tuple[np.ndarray, int, int]:
    """-> (features (n_frames, dim) float32, sample_period_100ns, param_kind)."""
    bo = ">" if big_endian else "<"
    with open(path, "rb") as f:
        n, period, samp_size, kind = struct.unpack(f"{bo}iihh", f.read(12))
        dim = samp_size // 4
        data = np.frombuffer(f.read(4 * n * dim), dtype=f"{bo}f4")
    if data.size != n * dim:
        raise ValueError(f"truncated HTK file {path}")
    return data.reshape(n, dim).astype(np.float32), period, kind


def htk_le2be(src: str, dst: str) -> None:
    """Little->big endian rewrite, the job of toolbox/step3_le2be.m."""
    fea, period, kind = read_htk(src, big_endian=False)
    write_htk(dst, fea, sample_period_100ns=period, param_kind=kind, big_endian=True)
