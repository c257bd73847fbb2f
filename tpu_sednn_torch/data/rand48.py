"""Bit-exact drand48/lrand48 reproduction for strict-parity runs.

The reference seeds once with srand48(init_randem_seed)
(the reference's Interface.cc:337) and then draws from the SAME stream for
weight init (drand48, Interface.cc:1036-1042), epoch chunk-order shuffling and
intra-chunk sample scattering (lrand48 Fisher-Yates, Interface.cc:1044-1055).
Reproducing that stream lets parity tests match the reference's shuffles and
random inits exactly.  Clean (non-parity) runs use a torch.Generator instead.
Own copy of tpu_sednn/data/rand48.py (numpy only).

Performance: the canonical net init is 11.8M drand48 calls and every training
chunk shuffles 102,400 samples, so the stream is generated in vectorized
NumPy blocks via LCG jump-ahead — x_{i} = A^i * x_0 + c_i (mod 2^48) with the
48-bit modular products computed from 24-bit limbs in uint64 — instead of one
Python-int step per draw.  The Fisher-Yates swap loop itself is serial; it
runs in the native library when available (native/pfile_native.cpp,
sednn_rand48_shuffle) with a pure-Python fallback over the same vectorized
draw block, all bit-identical to the scalar definition (tests/test_rand48.py).
"""

from __future__ import annotations

import numpy as np

_A = 0x5DEECE66D
_C = 0xB
_MASK = (1 << 48) - 1
_LO24 = (1 << 24) - 1

# Blocked jump-ahead tables: _APOW[i] = A^(i+1) mod 2^48,
# _CACC[i] = (A^i + ... + A + 1)*C mod 2^48, so that after i+1 steps
# x = _APOW[i]*x0 + _CACC[i] (mod 2^48).  Built lazily, once.
_BLOCK = 1 << 16
_APOW: np.ndarray | None = None
_CACC: np.ndarray | None = None


def _tables() -> tuple[np.ndarray, np.ndarray]:
    global _APOW, _CACC
    if _APOW is None:
        apow = np.empty(_BLOCK, np.uint64)
        cacc = np.empty(_BLOCK, np.uint64)
        a, c = _A, _C
        for i in range(_BLOCK):
            apow[i] = a
            cacc[i] = c
            a = (a * _A) & _MASK
            c = (c * _A + _C) & _MASK
        _APOW, _CACC = apow, cacc
    return _APOW, _CACC


def _mulmod48(a: np.ndarray, b: int) -> np.ndarray:
    """(a * b) mod 2^48 elementwise, a uint64 array of 48-bit values."""
    b_lo = np.uint64(b & _LO24)
    b_hi = np.uint64((b >> 24) & _LO24)
    a_lo = a & np.uint64(_LO24)
    a_hi = a >> np.uint64(24)
    cross = (a_hi * b_lo + a_lo * b_hi) & np.uint64(_LO24)
    return (a_lo * b_lo + (cross << np.uint64(24))) & np.uint64(_MASK)


class Rand48:
    def __init__(self, seed: int):
        self.srand48(seed)

    def srand48(self, seed: int) -> None:
        # srand48: Xi = (seed << 16) | 0x330E
        self.x = ((int(seed) & 0xFFFFFFFF) << 16) | 0x330E

    def _step(self) -> int:
        self.x = (_A * self.x + _C) & _MASK
        return self.x

    def _states(self, n: int) -> np.ndarray:
        """The next n LCG states (post-step), advancing the stream by n."""
        apow, cacc = _tables()
        out = np.empty(n, np.uint64)
        pos = 0
        while pos < n:
            m = min(_BLOCK, n - pos)
            blk = (_mulmod48(apow[:m], self.x) + cacc[:m]) & np.uint64(_MASK)
            out[pos:pos + m] = blk
            self.x = int(blk[-1])
            pos += m
        return out

    def drand48(self) -> float:
        return self._step() / float(1 << 48)

    def lrand48(self) -> int:
        return self._step() >> 17

    def uniform(self, lo: float, hi: float, n: int) -> np.ndarray:
        """GetRandWeight: vec[i] = drand48()*(max-min)+min (Interface.cc:1036-1042)."""
        d = self._states(n).astype(np.float64) / float(1 << 48)
        return (d * (hi - lo) + lo).astype(np.float32)

    def shuffle_indices(self, n: int) -> np.ndarray:
        """GetRandIndex semantics (Interface.cc:1044-1055).

        Starts from vec = [0..n-1] and for i in 0..n-2 swaps
        vec[lrand48() % (n-i)] with vec[n-1-i].
        """
        return self.shuffle_inplace(np.arange(n, dtype=np.int64))

    def shuffle_inplace(self, vec: np.ndarray) -> np.ndarray:
        """Same permutation applied to an arbitrary int vector."""
        n = len(vec)
        if n < 2:
            return vec
        from tpu_sednn_torch.io import native

        if native.shuffle_available() and vec.dtype == np.int64 and n >= 4096:
            self.x = native.rand48_shuffle_native(self.x, vec)
            return vec
        draws = (self._states(n - 1) >> np.uint64(17)).astype(np.int64)
        idx = draws % (np.int64(n) - np.arange(n - 1, dtype=np.int64))
        v = vec.tolist()
        for i in range(n - 1):
            j = idx[i]
            v[j], v[n - 1 - i] = v[n - 1 - i], v[j]
        vec[:] = v
        return vec
