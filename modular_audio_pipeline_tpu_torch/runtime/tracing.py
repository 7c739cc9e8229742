"""Spans and counters inside the port, recorded only on request.

    from modular_audio_pipeline_tpu_torch.runtime import tracing

    with tracing.record() as rec:
        pipe.process(audio, sr)
    print(rec.summary())

The port opens :func:`span` around the work of each layer (serving
stages, the Whisper encoder, decode loop, fetch and word alignment, the
diarizer's parts, the train step's parts) and bumps :func:`count` once
per decode step. Nothing is recorded unless :func:`record` has installed
a :class:`Recorder` on the calling thread: without one, ``span`` returns
one shared context that does nothing and ``count`` returns at once, so
the off path reads no clock, makes no CUDA event and allocates nothing.

A recorded span keeps its name, its parent (the innermost span open when
it opened), its host start and end from ``time.time_ns()``, and the
deltas of the port's kernel launch counters and verified fetches
(:data:`LAUNCH_COUNTERS`) and of the recorder's own counters. On a CUDA
machine it also records an event on the current stream at each end; its
device seconds are the stream's timeline between the two events, idle
time included. No span waits for the card: the events are resolved in
:meth:`Recorder.close` after one synchronise.

``time.time_ns()`` is the clock ``torch.profiler`` stamps its events with,
so spans can be laid over a profiler trace as they are. Spans open no
profiler range: a range would show in a CUDA-only trace as device
activity.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, NamedTuple, Optional

__all__ = ["span", "spanned", "count", "record", "Recorder", "SpanRecord",
           "LAUNCH_COUNTERS"]

# counters the port already keeps, read as snapshots at each end of a span
LAUNCH_COUNTERS = ("flash_attention", "flash_attention.backward", "ancestor_attention",
                   "int8_matmul", "fetch")

# per thread: the installed recorder, and the CUDA timing events that
# closed recorders handed back (``events``)
_local = threading.local()


class SpanRecord(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in ``Recorder.spans``, -1 at the top
    start_ns: int  # time.time_ns() at open
    end_ns: int  # and at close; -1 while open
    device_s: Optional[float]  # the stream's seconds between the span's events
    counts: Dict[str, int]  # counter deltas over the span, the nonzero ones


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str):
    """A context manager that records ``name`` on this thread's recorder,
    or does nothing without one."""
    rec = getattr(_local, "recorder", None)
    if rec is None:
        return _NULL
    return _Span(rec, name)


def spanned(name: str) -> Callable:
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to this thread's recorder's counter ``name``."""
    rec = getattr(_local, "recorder", None)
    if rec is not None:
        rec.counters[name] += n


@contextlib.contextmanager
def record():
    """Installs a :class:`Recorder` on the calling thread for the block;
    closes it (resolving the device times) on the way out and puts back
    any recorder installed before."""
    rec = Recorder()
    prev = getattr(_local, "recorder", None)
    _local.recorder = rec
    try:
        yield rec
    finally:
        _local.recorder = prev
        rec.close()


def _launch_snapshot() -> tuple:
    from ..ops.ancestor_attention import ancestor_attention
    from ..ops.attention import flash_attention
    from ..ops.quant import int8_matmul
    from .integrity import counts

    return (flash_attention.launches, flash_attention.backward_launches,
            ancestor_attention.launches, int8_matmul.launches, counts["fetch"])


class _Span:
    __slots__ = ("rec", "name", "index", "events", "snap")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    # the host stamps bracket the events: a span that waits for the card
    # before it closes reads no more device seconds than host seconds
    def __enter__(self):
        rec = self.rec
        self.snap = (_launch_snapshot(), dict(rec.counters))
        parent = rec._open[-1].index if rec._open else -1
        self.index = len(rec.spans)
        rec.spans.append(SpanRecord(self.name, parent, time.time_ns(), -1, None, {}))
        self.events = rec._event_pair()
        rec._events.append(self.events)
        rec._open.append(self)

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        end_ns = time.time_ns()
        rec = self.rec
        rec._open.pop()
        launches, own = self.snap
        counts = {k: b - a for k, a, b in zip(LAUNCH_COUNTERS, launches, _launch_snapshot())
                  if b != a}
        counts.update({k: v - own.get(k, 0) for k, v in rec.counters.items()
                       if v != own.get(k, 0)})
        rec.spans[self.index] = rec.spans[self.index]._replace(end_ns=end_ns, counts=counts)
        return False


class Recorder:
    """What one :func:`record` block saw: ``spans`` (:class:`SpanRecord`,
    in the order they opened) and ``counters`` (totals of :func:`count`)."""

    def __init__(self):
        import torch

        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self.closed = False
        self._cuda = torch.cuda.is_available()
        self._open: List[_Span] = []
        self._events: List[Optional[tuple]] = []  # each span's event pair
        if not hasattr(_local, "events"):
            _local.events = []
        self._pool: List[Any] = _local.events

    def _event_pair(self):
        """Two timing events from the pool, the first recorded now on the
        current stream; None off CUDA and while a CUDA graph is captured.
        A new event is made at once (``torch.cuda.Event`` makes its CUDA
        event on the first ``record``), so no span's close pays for it."""
        if not self._cuda:
            return None
        import torch

        if torch.cuda.is_current_stream_capturing():
            return None
        pool = self._pool
        if len(pool) < 2:
            for _ in range(2):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                pool.append(ev)
        pair = (pool.pop(), pool.pop())
        pair[0].record()
        return pair

    def close(self) -> None:
        """Waits for the card once and fills each closed span's device
        seconds; the events go back to the pool."""
        if self.closed:
            return
        self.closed = True
        if any(ev is not None for ev in self._events):
            import torch

            torch.cuda.synchronize()
            for i, ev in enumerate(self._events):
                if ev is not None and self.spans[i].end_ns >= 0:
                    self.spans[i] = self.spans[i]._replace(
                        device_s=ev[0].elapsed_time(ev[1]) * 1e-3)
                    self._pool.extend(ev)
        self._events = []

    def root(self, i: int) -> int:
        """Index of the outermost span that holds span ``i``."""
        while self.spans[i].parent >= 0:
            i = self.spans[i].parent
        return i

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """For each span name: how many spans, their host seconds, device
        seconds (None off CUDA) and summed counter deltas. A span still
        open is left out."""
        out: Dict[str, Dict[str, Any]] = {}
        for s in self.spans:
            if s.end_ns < 0:
                continue
            e = out.setdefault(s.name, {"spans": 0, "host_s": 0.0, "device_s": None,
                                        "counts": {}})
            e["spans"] += 1
            e["host_s"] += (s.end_ns - s.start_ns) * 1e-9
            if s.device_s is not None:
                e["device_s"] = (e["device_s"] or 0.0) + s.device_s
            for k, v in s.counts.items():
                e["counts"][k] = e["counts"].get(k, 0) + v
        return out
