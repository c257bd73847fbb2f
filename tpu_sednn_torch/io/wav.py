"""Wav I/O with a self-contained RIFF parser (no soundfile dependency).

Reads PCM (8/16/24/32-bit) and IEEE-float wavs — the reference's demo clips
(enh_wav_example in the reference) are a mix of 16-bit PCM and float32, which
the stdlib `wave` module cannot parse.  Writes 16-bit PCM mono.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 samples in [-1, 1], sample_rate). Multi-channel is averaged."""
    with open(path, "rb") as f:
        riff, _size, wave_id = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave_id != b"WAVE":
            raise ValueError(f"{path} is not a RIFF/WAVE file")
        fmt_tag = None
        n_ch = bits = sr = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", hdr)
            if chunk_id == b"fmt ":
                fmt = f.read(chunk_size)
                fmt_tag, n_ch, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
                if fmt_tag == WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                    # actual format is the first 2 bytes of the SubFormat GUID
                    fmt_tag = struct.unpack("<H", fmt[24:26])[0]
            elif chunk_id == b"data":
                data = f.read(chunk_size)
            else:
                f.seek(chunk_size + (chunk_size & 1), 1)
            if chunk_size & 1 and chunk_id == b"data":
                f.read(1)
    if data is None or fmt_tag is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    if fmt_tag == WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b3 = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            val = (
                b3[:, 0].astype(np.int32)
                | (b3[:, 1].astype(np.int32) << 8)
                | (b3[:, 2].astype(np.int32) << 16)
            )
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            x = val.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif fmt_tag == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(data, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported format tag {fmt_tag}")

    if n_ch and n_ch > 1:
        x = x[: len(x) - len(x) % n_ch].reshape(-1, n_ch).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), int(sr)


def write_wav(path: str, x: np.ndarray, sample_rate: int) -> None:
    """Write mono 16-bit PCM."""
    x = np.asarray(x, dtype=np.float32)
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(data), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(
            struct.pack(
                "<HHIIHH", WAVE_FORMAT_PCM, 1, sample_rate, sample_rate * 2, 2, 16
            )
        )
        f.write(struct.pack("<4sI", b"data", len(data)))
        f.write(data)
