"""What every driver shares: device clocks, the traced slice's reduction
(kernel spans, their union, the device's copies of the host's labels, idle
gaps by the host's labels), the weights made from the seed, and the import
boundary check.

Spans are the drivers' own `torch.profiler.record_function` labels around
their calls into the program, whatever their names: a label is any user
annotation that the trace holds.  Nothing here reads the program's
internals.
"""

from __future__ import annotations

import subprocess
import sys
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_sednn")
TOP = 10


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (the program's own package name begins with one)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Mark:
    """A point on the device's stream: a CUDA event, or the host's clock on
    the CPU (where every operation has ended when it returns)."""

    def __init__(self, dev: torch.device):
        self.event = None
        if dev.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.t = time.perf_counter()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def seconds_to(self, later: "Mark") -> float:
        if self.event is not None:
            return self.event.elapsed_time(later.event) / 1e3
        return later.t - self.t


def uniform_weights(gen: torch.Generator, sizes: Sequence[int], device: torch.device):
    """Glorot-uniform weights U(+-sqrt(6 / (n_in + n_out))) and zero biases,
    drawn on `device` in one call from `gen`."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    flat = torch.rand(sum(a * b for a, b in pairs), generator=gen, device=device)
    ws, at = [], 0
    for a, b in pairs:
        r = (6.0 / (a + b)) ** 0.5
        ws.append((flat[at:at + a * b].view(a, b) * (2 * r) - r).contiguous())
        at += a * b
    return ws, [torch.zeros(b, device=device) for _, b in pairs]


def stream_seed(*parts: int) -> int:
    """A 63-bit seed from integers (a stream of its own per tuple)."""
    h = 1469598103934665603
    for p in parts:
        h = ((h ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) * 1099511628211) & 0x7FFFFFFFFFFFFFFF
    return h


# a labelled span on the host (and the trace's device timeline)
label = torch.profiler.record_function


# ----------------------------------------------------------------------------
# the traced slice
# ----------------------------------------------------------------------------

def _label_names(events) -> set:
    """Names of the host's labels: the user annotations on the CPU."""
    from torch.autograd import DeviceType

    return {e.name for e in events if e.device_type == DeviceType.CPU and e.is_user_annotation}


def _device_events(events):
    """(device operations, the device's copies of the host's labels): the
    trace repeats each label on the device's timeline, from the first
    operation launched inside it to the last one's end; those are not
    operations."""
    from torch.autograd import DeviceType

    names = _label_names(events)
    ops, labels = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.time_range.end <= e.time_range.start:
            continue
        span = (e.time_range.start, e.time_range.end, e.name)
        (labels if e.is_user_annotation or e.name in names else ops).append(span)
    return sorted(ops), sorted(labels)


def kernel_spans(events) -> List[Tuple[float, float, str]]:
    """(start, end, name) in microseconds of every device operation a
    profiler trace holds, sorted."""
    return _device_events(events)[0]


def union(spans: Sequence[Tuple[float, float, str]]) -> List[Tuple[float, float]]:
    """The sorted spans merged where they overlap (dependent launches do)."""
    out: List[List[float]] = []
    for a, b, _ in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def host_labels(events) -> List[Tuple[float, float, str]]:
    """(start, end, label) in microseconds of the host's labels."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU and e.is_user_annotation)


def trace_reading(events, t_begin_us: float, t_end_us: float) -> Dict:
    """The traced slice reduced: busy seconds (the union of kernel spans
    inside the slice), the slice's seconds, the device's seconds under each
    label (its copies of the label, clipped to the slice; none on the CPU),
    and the breakdown: device operations by total seconds, idle gaps by the
    label the host was inside when the device went idle."""
    ops, dev_labels = _device_events(events)
    spans = [s for s in ops if s[1] > t_begin_us and s[0] < t_end_us]
    merged = union(spans)
    busy_us = sum(min(b, t_end_us) - max(a, t_begin_us) for a, b in merged)
    by_op: Dict[str, float] = {}
    for a, b, name in spans:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
    under: Dict[str, float] = {}
    for a, b, name in dev_labels:
        a, b = max(a, t_begin_us), min(b, t_end_us)
        if b > a:
            under[name] = under.get(name, 0.0) + (b - a) / 1e6
    labels = host_labels(events)
    gaps: Dict[str, float] = {}
    edges = [t_begin_us] + [x for ab in merged for x in ab] + [t_end_us]
    for i in range(0, len(edges) - 1, 2):
        a, b = max(edges[i], t_begin_us), min(edges[i + 1], t_end_us)
        if b <= a:
            continue
        inside = [lab for lab in labels if lab[0] <= a < lab[1]]
        name = min(inside, key=lambda s: s[1] - s[0])[2] if inside else "host_other"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": busy_us / 1e6, "window_s": (t_end_us - t_begin_us) / 1e6,
            "kernels": len(spans), "device_label_s": under, "breakdown": {"device_ops": top(by_op), "idle_gaps": top(gaps)}}


@contextmanager
def traced(dev: torch.device, out: Dict):
    """Profile the block; `out` receives the slice's reading (see
    trace_reading).  The slice runs from the end of a synchronise before the
    block to the end of one after it, both labelled "sync", in the
    profiler's own time base."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync(dev)
    with profile(activities=acts) as prof:
        with label("sync"):
            sync(dev)
        yield
        with label("sync"):
            sync(dev)
    events = prof.events()
    syncs = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CPU and e.name == "sync")
    out.update(trace_reading(events, syncs[0][1], syncs[-1][1]))


def card_limits() -> Optional[Dict]:
    """The card's name and power limit from nvidia-smi (None where it is
    absent)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    return {"nvidia_smi": line} if line else None
