"""Text `.norm` (mean / inverse-stddev) codec.

Format per the reference loader (the reference's Interface.cc:300-326):
    <header line>
    fea_dim lines: mean[j]
    <header line>
    fea_dim lines: dVar[j]        (inverse stddev)
Applied at chunk-load time as x = (x - mean) * dVar (Interface.cc:745-746).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def save_norm(path: str, mean: np.ndarray, inv_std: np.ndarray) -> None:
    mean = np.asarray(mean, dtype=np.float64).ravel()
    inv_std = np.asarray(inv_std, dtype=np.float64).ravel()
    if mean.shape != inv_std.shape:
        raise ValueError("mean and inv_std must have the same length")
    with open(path, "w") as f:
        f.write(f"mean {mean.size}\n")
        for v in mean:
            f.write(f"{v:.9g}\n")
        f.write(f"invstd {inv_std.size}\n")
        for v in inv_std:
            f.write(f"{v:.9g}\n")


def load_norm(path: str, fea_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Read (mean, inv_std) as float32 arrays of length fea_dim.

    Mirrors the reference exactly: skips one header line, reads fea_dim
    values via atof (first float on each line), skips a second header line,
    reads fea_dim more values.
    """
    with open(path, "r") as f:
        lines = f.readlines()
    if len(lines) < 2 * fea_dim + 2:
        raise ValueError(f"norm file {path} too short for fea_dim={fea_dim}")
    mean = np.array([float(lines[1 + j].split()[0]) for j in range(fea_dim)], dtype=np.float32)
    inv_std = np.array(
        [float(lines[2 + fea_dim + j].split()[0]) for j in range(fea_dim)], dtype=np.float32
    )
    return mean, inv_std


def compute_norm(features: np.ndarray, eps: float = 1e-8) -> Tuple[np.ndarray, np.ndarray]:
    """Per-dimension mean and inverse stddev over a (n_frames, fea_dim) array.

    The reference ships no norm-computation tool (SURVEY.md §3.5 notes the
    format only); this is the canonical recipe: global mean/variance over the
    training features.
    """
    features = np.asarray(features, dtype=np.float64)
    mean = features.mean(axis=0)
    std = features.std(axis=0)
    inv_std = 1.0 / np.maximum(std, eps)
    return mean.astype(np.float32), inv_std.astype(np.float32)
