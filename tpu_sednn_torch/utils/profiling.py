"""Profiling hooks — counterpart of tpu_sednn/utils/profiling.py: replaces the
reference's single wall-clock counter ("Total cost time") with a
torch.profiler trace, and names the program's own stages in it with spans.

Spans (`span`), each a `torch.profiler.record_function` range while a
profiler records and one shared null context otherwise:

  sednn.chunk.prepare   the chunk trainer's argument checks and state casts
  sednn.chunk.alloc     its workspace and input-mask table
  sednn.decode          a call of enhance/decode.py:make_serving_decoder's decode
  sednn.decode.stft     the STFT and the noisy log power
  sednn.decode.features normalisation, splice and the NAT estimate
  sednn.decode.forward  the net's forward
  sednn.decode.istft    the enhanced LPS and the overlap-add

The profiler keeps a range in the time base of its device activity, so a
trace shows which span the host was in while the device waited.  It also
repeats a range on the device's timeline, from the first operation launched
inside it to the last one's end, but only for the launches of which it was
the innermost range open on the host: a range enclosing a span that encloses
every launch gets no device copy.  The decode's stages take their launches'
device time so; the chunk trainer's spans enclose no launch (its C call,
which enqueues the whole chunk, is in none), so a caller's range around a
chunk call keeps the call's device time.
"""

from __future__ import annotations

import contextlib
import os
from typing import ContextManager, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace of the block (CPU activity, and CUDA
    activity where a card is present) and write it as a Chrome/Perfetto trace
    `trace.json` under log_dir; no-op when log_dir is not set.  The trace
    carries the program's `sednn.*` spans (see the module's docstring) on
    the host's timeline and, where a card is present, the device's copies of
    those that enclose launches.  The tracer can lose records of a long run:
    take kernel times from CUDA events."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A named range of the program's work: `torch.profiler.record_function`
    while a profiler records, else one shared null context (an unguarded
    record_function costs about 20 times as much on the host)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
