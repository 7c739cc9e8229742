"""Spans the benchmark records around calls into the program, and the
reduction of a ``torch.profiler`` trace to what the per-layer readers and
the result line need.

A span is opened by :class:`Spans` around a call into one of the port's
layers: with ``sync`` (the traced runs) it synchronises the card at its
end, so its seconds are the layer's device-inclusive time, and it shows in
the profiler's trace as a ``torch.profiler.record_function`` range named
``bp.<span>``. Untraced runs keep only the counters, and no wait.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "bp."


def sync() -> None:
    """Waits for the card (nothing to wait for without one)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Spans:
    """Named host spans: seconds, one list per name."""

    def __init__(self, sync: bool):
        self.sync = sync
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.events: List[Tuple[str, int, int]] = []  # (name, host ns, host ns)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.sync:
            yield
            return
        t0, ns0 = time.perf_counter(), time.time_ns()
        with torch.profiler.record_function(PREFIX + name):
            try:
                yield
            finally:
                sync()
        self.seconds[name].append(time.perf_counter() - t0)
        self.events.append((name, ns0, time.time_ns()))


class Trace:
    """A profiled stretch reduced to kernel intervals and host spans, on
    the profiler's one clock (microseconds)."""

    def __init__(self, kernels: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]], window_s: float):
        self.kernels = sorted(kernels, key=lambda k: k[1])  # (name, start us, end us)
        self.spans = spans  # (name without the prefix, start us, end us)
        self.window_s = window_s

    def kernel_seconds(self, *needles: str) -> Tuple[float, int]:
        """Summed device seconds and launches of kernels whose name holds
        every needle."""
        total, n = 0.0, 0
        for name, a, b in self.kernels:
            if all(s in name for s in needles):
                total += (b - a) * 1e-6
                n += 1
        return total, n

    def busy_s(self) -> float:
        """Seconds in which some kernel ran (the union of intervals)."""
        busy, end = 0.0, None
        for _, a, b in self.kernels:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy * 1e-6

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for name, a, b in self.kernels:
            by[name[:64]] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle device time between kernels, by the innermost span open at
        each gap's midpoint ("other" outside every span)."""
        by: Dict[str, float] = defaultdict(float)
        end = None
        for _, a, b in self.kernels:
            if end is not None and a > end:
                by[self._span_at((a + end) / 2.0)] += (a - end) * 1e-6
            end = b if end is None else max(end, b)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _span_at(self, t: float) -> str:
        best: Optional[Tuple[str, float, float]] = None
        for s in self.spans:
            if s[1] <= t <= s[2] and (best is None or s[2] - s[1] < best[2] - best[1]):
                best = s
        return best[0] if best else "other"


def profile(fn, spans: Optional[Spans] = None) -> Trace:
    """Runs ``fn`` under the profiler and reduces the trace. It records
    CUDA activity only: recording every host operator as well doubled a
    serving request's host time, and with it the idle share. The host
    spans that ``spans`` records meanwhile are placed on the trace's clock
    by a marker: a short spin kernel launched on an idle card right after
    a host timestamp is the trace's first kernel."""
    from torch.profiler import ProfilerActivity

    sync()
    cuda = torch.cuda.is_available()
    first = len(spans.events) if spans is not None else 0
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA if cuda
                                            else ProfilerActivity.CPU]) as prof:
        mark_ns = time.time_ns()
        if cuda:
            torch.cuda._sleep(1000)
            sync()
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    kernels = sorted(((name, a, b) for name, dev, a, b in _events(prof)
                      if dev == "cuda" and not name.startswith(PREFIX)), key=lambda k: k[1])
    host = []
    if kernels and spans is not None:
        offset = kernels[0][1] - mark_ns / 1e3  # trace us minus host us
        host = [(n, a / 1e3 + offset, b / 1e3 + offset) for n, a, b in spans.events[first:]]
    return Trace(kernels[1:] if cuda else kernels, host, window)


def _events(prof):
    """(name, "cuda" | "cpu", start us, end us) of every event: through the
    kineto results where this torch has them (fast), else ``events()``."""
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None:
        for e in res.events():
            dev = "cuda" if "CUDA" in str(e.device_type()) else "cpu"
            a = e.start_ns() / 1e3 if hasattr(e, "start_ns") else float(e.start_us())
            d = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else float(e.duration_us())
            yield e.name(), dev, a, a + d
        return
    for e in prof.events():
        dev = "cuda" if "CUDA" in str(e.device_type) else "cpu"
        yield e.name, dev, e.time_range.start, e.time_range.end
