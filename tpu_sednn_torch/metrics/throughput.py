"""Throughput accounting: the north-star metric is training audio-seconds
processed per wall-second per chip (BASELINE.md).  One training sample = one
spliced frame = one hop of audio.

Own copy of tpu_sednn/metrics/throughput.py (plain Python).
"""

from __future__ import annotations


def audio_seconds_per_second(
    samples_per_sec: float, hop: int, sample_rate: int, n_chips: int = 1
) -> float:
    return samples_per_sec * (hop / sample_rate) / n_chips
