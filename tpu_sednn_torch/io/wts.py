"""Quicknet-style `.wts` weight-file codec.

Byte-exact with the reference trainer's reader/writer
(`Interface::Writeweights`, the reference's Interface.cc:411-465 and the
loader at Interface.cc:353-391):

per layer l = 1..L-1, in order:
    int32[5] stat = {10, cur, prev, 0, len(name)+1}   (native little-endian)
    char[stat[4]] name = "weights{l}{l+1}\0"
    float32[prev*cur] weight data
    int32[5] stat = {10, 1, cur, 0, len(name)+1}
    char[stat[4]] name = "bias{l+1}\0"
    float32[cur] bias data

Weight-buffer layout: the trainer's GEMM is column-major `x = W·y` with `W`
stored (cur x prev) column-major (see SgemmNN, the reference's DevFunc.h:45-56
and the commented transpose in Interface.cc:437-446).  Interpreted row-major,
the flat buffer therefore has shape (prev, cur) — exactly the `W` for the
row-major sample convention `y = x @ W + b` used throughout this framework.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

MAGIC = 10  # stat[0] tag used by the reference for every section


def save_wts(path: str, weights: Sequence[np.ndarray], biases: Sequence[np.ndarray],
             debug_txt: str | None = None) -> None:
    """Write a `.wts` file.

    weights[l] has shape (prev, cur); biases[l] has shape (cur,).
    Layer numbering in section names follows the reference: the first weight
    matrix is "weights12", its bias "bias2", etc.

    debug_txt: optionally also write the reference's human-readable dump
    (Interface::Writeweights unconditionally emits `weights.txt` next to the
    binary, Interface.cc:420,435-436,458-459).  Divergence, documented: the
    reference's bias lines print the POINTER by mistake (SURVEY §7 "bugs not
    to port"); here they print the values.
    """
    if len(weights) != len(biases):
        raise ValueError("weights and biases must have the same number of layers")
    if debug_txt is not None:
        with open(debug_txt, "w") as ftxt:
            for l, (w, b) in enumerate(zip(weights, biases), start=1):
                ftxt.write(f"weights{l}{l + 1}\n")
                np.savetxt(ftxt, np.asarray(w, np.float32), fmt="%f")
                ftxt.write(f"bias{l + 1}\n")
                np.savetxt(ftxt, np.asarray(b, np.float32)[None, :], fmt="%f")
    with open(path, "wb") as f:
        for l, (w, b) in enumerate(zip(weights, biases), start=1):
            w = np.ascontiguousarray(w, dtype="<f4")
            b = np.ascontiguousarray(b, dtype="<f4")
            if w.ndim != 2 or b.ndim != 1 or w.shape[1] != b.shape[0]:
                raise ValueError(f"layer {l}: shape mismatch {w.shape} vs {b.shape}")
            prev, cur = w.shape
            name = f"weights{l}{l + 1}\0".encode("ascii")
            f.write(struct.pack("<5i", MAGIC, cur, prev, 0, len(name)))
            f.write(name)
            f.write(w.tobytes())  # (prev, cur) row-major == (cur, prev) col-major
            name = f"bias{l + 1}\0".encode("ascii")
            f.write(struct.pack("<5i", MAGIC, 1, cur, 0, len(name)))
            f.write(name)
            f.write(b.tobytes())


def load_wts(
    path: str, layersizes: Sequence[int] | None = None
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Read a `.wts` file -> (weights, biases).

    weights[l]: (prev, cur) float32; biases[l]: (cur,) float32.
    If `layersizes` is given, shapes are validated against it the same way the
    reference loader does (Interface.cc:370-385).
    """
    weights: List[np.ndarray] = []
    biases: List[np.ndarray] = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(20)
            if len(hdr) < 20:
                break
            stat = struct.unpack("<5i", hdr)
            f.read(stat[4])  # section name (NUL-terminated)
            cur, prev = stat[1], stat[2]
            data = np.frombuffer(f.read(4 * cur * prev), dtype="<f4")
            if data.size != cur * prev:
                raise ValueError(f"truncated .wts file: {path}")
            weights.append(data.reshape(prev, cur).copy())

            hdr = f.read(20)
            if len(hdr) < 20:
                raise ValueError(f"missing bias section in {path}")
            stat = struct.unpack("<5i", hdr)
            f.read(stat[4])
            if stat[1] != 1 or stat[2] != cur:
                raise ValueError(f"bias shape mismatch in {path}: {stat}")
            b = np.frombuffer(f.read(4 * cur), dtype="<f4")
            if b.size != cur:
                raise ValueError(f"truncated bias in {path}")
            biases.append(b.copy())

    if layersizes is not None:
        expect = [(layersizes[i - 1], layersizes[i]) for i in range(1, len(layersizes))]
        got = [w.shape for w in weights]
        if expect != got:
            raise ValueError(f"layersizes mismatch: expected {expect}, file has {got}")
    return weights, biases
