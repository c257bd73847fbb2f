"""ctypes binding for the native host-pipeline library (native/pfile_native.cpp).

The reference's hot host loop (fread + byte-swap + normalize + splice + NAT +
scatter, Interface::Readchunk) is C++; `native/libsednn_native.so` is its
threaded counterpart, shared with the JAX package.  This is the port's own
loader of it (own copy of tpu_sednn/io/native.py): read-only, it never builds
the library, and `available()` is False when the file is missing or cannot be
loaded where the program runs, so every caller keeps its NumPy route.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native",
                                         "libsednn_native.so"))

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    i64, i32, f32p, i64p = (ctypes.c_int64, ctypes.c_int32,
                            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64))
    lib.sednn_read_frames.restype = ctypes.c_int
    lib.sednn_read_frames.argtypes = [ctypes.c_char_p, i64, i64, i64, i32, f32p, f32p, f32p, i32]
    lib.sednn_splice_scatter.restype = i64
    lib.sednn_splice_scatter.argtypes = [f32p, i64, i32, i64p, i64p, i32, i32, i32,
                                         i64p, i64, f32p, i32]
    lib.sednn_target_scatter.restype = i64
    lib.sednn_target_scatter.argtypes = [f32p, i64, i32, i64p, i64p, i32, i32, i32,
                                         i64p, i64, f32p, i32]
    if hasattr(lib, "sednn_rand48_shuffle"):
        lib.sednn_rand48_shuffle.restype = ctypes.c_uint64
        lib.sednn_rand48_shuffle.argtypes = [ctypes.c_uint64, i64p, i64]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def shuffle_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "sednn_rand48_shuffle")


def rand48_shuffle_native(state: int, vec: np.ndarray) -> int:
    """In-place lrand48 Fisher-Yates on int64 `vec`; returns the advanced
    48-bit LCG state (bit-exact with Rand48.shuffle_inplace)."""
    lib = _load()
    assert lib is not None and vec.dtype == np.int64 and vec.flags.c_contiguous
    return int(lib.sednn_rand48_shuffle(ctypes.c_uint64(state), _ip(vec), len(vec)))


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def read_frames_native(path: str, header_size: int, frame_start: int, n_frames: int,
                       fea_dim: int, mean: Optional[np.ndarray],
                       inv_std: Optional[np.ndarray], n_threads: int = 8) -> np.ndarray:
    lib = _load()
    assert lib is not None
    out = np.empty((n_frames, fea_dim), np.float32)
    if mean is not None:
        mean = np.ascontiguousarray(mean, np.float32)
        inv_std = np.ascontiguousarray(inv_std, np.float32)
        mp, sp = _fp(mean), _fp(inv_std)
    else:
        mp = sp = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    rc = lib.sednn_read_frames(path.encode(), header_size, frame_start, n_frames,
                               fea_dim, mp, sp, _fp(out), n_threads)
    if rc != 0:
        raise IOError(f"sednn_read_frames({path}) failed with code {rc}")
    return out


def splice_scatter_native(data: np.ndarray, seg_off: np.ndarray, seg_len: np.ndarray,
                          context: int, nat: bool, sample_index: np.ndarray,
                          n_samples: int, n_threads: int = 8) -> np.ndarray:
    lib = _load()
    assert lib is not None
    n_frames, d = data.shape
    in_dim = d * context + (d if nat else 0)
    out = np.zeros((n_samples, in_dim), np.float32)
    data = np.ascontiguousarray(data, np.float32)
    seg_off = np.ascontiguousarray(seg_off, np.int64)
    seg_len = np.ascontiguousarray(seg_len, np.int64)
    sample_index = np.ascontiguousarray(sample_index, np.int64)
    rc = lib.sednn_splice_scatter(_fp(data), n_frames, d, _ip(seg_off), _ip(seg_len),
                                  len(seg_off), context, 1 if nat else 0,
                                  _ip(sample_index), n_samples, _fp(out), n_threads)
    if rc != n_samples:
        raise RuntimeError(f"sednn_splice_scatter wrote {rc}, expected {n_samples}")
    return out


def target_scatter_native(targ: np.ndarray, seg_off: np.ndarray, seg_len: np.ndarray,
                          context: int, targ_offset: int, sample_index: np.ndarray,
                          n_samples: int, n_threads: int = 8) -> np.ndarray:
    lib = _load()
    assert lib is not None
    n_frames, d_out = targ.shape
    out = np.zeros((n_samples, d_out), np.float32)
    targ = np.ascontiguousarray(targ, np.float32)
    seg_off = np.ascontiguousarray(seg_off, np.int64)
    seg_len = np.ascontiguousarray(seg_len, np.int64)
    sample_index = np.ascontiguousarray(sample_index, np.int64)
    rc = lib.sednn_target_scatter(_fp(targ), n_frames, d_out, _ip(seg_off), _ip(seg_len),
                                  len(seg_off), context, targ_offset,
                                  _ip(sample_index), n_samples, _fp(out), n_threads)
    if rc != n_samples:
        raise RuntimeError(f"sednn_target_scatter wrote {rc}, expected {n_samples}")
    return out
