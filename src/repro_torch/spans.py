"""Named spans over the port's layer boundaries, on the profiler's clock.

``with span("engine/extend"):`` marks a stretch of host work as a
``torch.profiler.record_function`` range, so a ``torch.profiler`` trace
carries it beside the operators and the device work launched inside it,
on the trace's own clock; ``@spanned("engine/decode")`` puts a whole
function under one.  A span is on exactly while a profiler records the
calling thread: ``torch.autograd._profiler_enabled()`` is that thread's
flag, and a range opened where it reads False would not be recorded
anyway.  Off, a span is that one check and a shared no-op context; there
is no switch of its own and no store of spans beside the profiler's.

Names are ``layer/what``: ``servicer/step``, ``engine/extend``,
``model/unembed``, ``train/optimizer`` and so on.
"""
from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records
    this thread; otherwise a no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
