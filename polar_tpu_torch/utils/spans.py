"""Named host spans that cost one flag check when nothing traces them.

`span(name)` is `torch.profiler.record_function(name)` while a
torch.profiler profile is active, so the span lands in the profile's
Chrome trace beside the card's kernels and copies, on the same clock, with
the span that contains it on its thread as its parent. Otherwise it is one
shared `contextlib.nullcontext()`: no RecordFunction is made, which an
untraced `record_function` does at every entry.

Names are fixed strings. A span neither synchronizes the device nor reads
a tensor.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_UNTRACED = contextlib.nullcontext()


def span(name: str):
    """A context manager over the work it holds: a profiler span named
    `name` while a profile is active, else a shared no-op."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _UNTRACED
