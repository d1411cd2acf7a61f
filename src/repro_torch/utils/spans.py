"""Named spans of a summarization, for ``torch.profiler``.

``span(name)`` opens ``torch.profiler.record_function(name)`` only while a
profiler records in this thread, and otherwise returns one shared null
context: an idle ``record_function`` costs microseconds a span, the check
a fraction of one. There is no flag: the spans record exactly when a
profiler is on. Their host events share the device trace's clock, so a
trace puts each span over the device work it launched. Every name starts
with ``ssumm.``.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("ssumm.stage"):`` — a profiler range when one records."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
