"""Spans and counters inside the program, recorded only while a caller asks.

    from repro_torch import tracing

    with tracing.recording() as rec:
        engine.serve(tokens)
    rec.spans       # [Span], in the order they began
    rec.counters    # {name: int}, device counters read when recording stopped

``span(name)`` is a context manager at a layer boundary.  With no
recording open it returns one shared object that does nothing: the cost is
one global read and a ``with`` statement.  While recording, each span keeps
its name, its start and end on ``time.time_ns`` (the wall clock in ns,
which is the clock of torch.profiler's timestamps), the index of the span
that was open when it began (-1 for none).  Spans nest by that index, so
a name is short and fixed and the nesting gives the path.  One thread
records: the serving path runs on one.

``count(name, n)`` adds to a host counter.  ``count_device(name, values,
at_least)`` adds the number of entries of ``values`` at or above
``at_least`` to a 0-d tensor on the tensor's device, with no host sync; the
totals are read once, when recording stops.  Its comparison and reduction
are launched inside a span of its own, named ``count``, so that a reader of
device time by span can leave that work out.  Both do nothing, and launch
nothing, when no recording is open.

``paused()`` records nothing in its block, whether or not a recording is
open: a CUDA graph captured in it holds the same operations either way,
and its replays count nothing.

Nothing is written anywhere: the spans stay in memory and are handed over
in the ``Recorder`` that ``recording()`` yields.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional

_now = time.time_ns
# the Recorder while recording() is open, None otherwise
_active: Optional["Recorder"] = None


class Span:
    __slots__ = ("name", "start_ns", "end_ns", "parent")

    def __init__(self, name: str, parent: int):
        self.name = name
        self.start_ns = self.end_ns = -1      # -1 until entered, and while open
        self.parent = parent


class Recorder:
    """What one ``recording()`` saw."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._device: dict = {}       # name -> 0-d device tensor
        self._open = -1               # index of the innermost open span

    def _stop(self) -> None:
        for name, total in self._device.items():
            self.counters[name] = self.counters.get(name, 0) + int(total)
        self._device.clear()


class _Off:
    """The shared span of no recording."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("rec", "span")

    def __init__(self, rec: Recorder, name: str):
        self.rec = rec
        self.span = Span(name, rec._open)

    def __enter__(self):
        rec = self.rec
        rec._open = len(rec.spans)
        rec.spans.append(self.span)
        self.span.start_ns = _now()
        return self.span

    def __exit__(self, *exc):
        self.span.end_ns = _now()
        self.rec._open = self.span.parent
        return False


def span(name: str):
    """A span named ``name`` around a ``with`` block."""
    rec = _active
    if rec is None:
        return _OFF
    return _On(rec, name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the host counter ``name``."""
    rec = _active
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def count_device(name: str, values, at_least) -> None:
    """Add the number of entries of ``values`` that are ``>= at_least`` to
    the device counter ``name``, on the device.  The comparison is made
    here, behind the check for an open recording, so that the caller
    launches nothing for the counter when none is open."""
    rec = _active
    if rec is None:
        return
    with span("count"):
        s = (values >= at_least).sum()
        total = rec._device.get(name)
        rec._device[name] = s if total is None else total + s


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record spans and counters in the block; the Recorder is complete
    when the block ends.  Recordings do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already open")
    rec = Recorder()
    _active = rec
    try:
        yield rec
    finally:
        _active = None
        rec._stop()


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Record no span and no counter in the block, whether or not a
    recording is open."""
    global _active
    rec, _active = _active, None
    try:
        yield
    finally:
        _active = rec
