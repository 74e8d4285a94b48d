"""Request-scoped tracing: the span API and a bounded ring-buffer
recorder (an adapted copy of the part of
``distributed_tensorflow_example_tpu/obs/trace.py`` the generation engine
calls; the Perfetto export, trace contexts and the ``/trace/*`` routes
arrive with the HTTP/observability slice).

- :func:`span` — ``with span("prefill", lane="slot0", request_id=rid):``
  records one complete event into the process recorder. When tracing is
  off it returns a shared no-op context manager after a single attribute
  check: zero allocations, zero recorder calls.
- :func:`add_span` — a retroactive span with explicit
  ``time.perf_counter()`` stamps (queue-wait is only known at admission).
- :class:`TraceRecorder` — a bounded ring (oldest events drop first;
  ``events_dropped`` counts them) of (process, lane, name, t0, t1, args).
"""

from __future__ import annotations

import threading
import time
from collections import deque


class TraceRecorder:
    """Bounded in-memory span store. ``start()`` arms it and anchors the
    timebase; ``stop()`` disarms. Thread-safe: spans arrive from the
    scheduler and HTTP threads."""

    def __init__(self, max_events: int = 65536):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = max_events
        self._buf: deque[tuple] = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self.enabled = False
        self._t0 = 0.0
        self.spans_recorded = 0
        self.events_dropped = 0

    def start(self) -> None:
        with self._lock:
            self._buf.clear()
            self._t0 = time.perf_counter()
            self.spans_recorded = 0
            self.events_dropped = 0
            self.enabled = True

    def stop(self) -> None:
        self.enabled = False

    def add(self, process: str, lane: str, name: str, t0: float,
            t1: float, args: dict | None = None) -> None:
        """One complete span, ``t0``/``t1`` in ``time.perf_counter()``
        seconds, clamped to the capture window (a queue-wait recorded
        retroactively must not start before ``start()``)."""
        if not self.enabled:
            return
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.events_dropped += 1
            self._buf.append((process, lane, name, max(t0, self._t0),
                              max(t1, self._t0), args))
            self.spans_recorded += 1

    def drain(self, process: str | None = None) -> list[tuple]:
        """Remove and return spans sorted by start time — all of them, or
        only one ``process`` label's. Draining does not disarm."""
        with self._lock:
            if process is None:
                items = list(self._buf)
                self._buf.clear()
            else:
                items = [it for it in self._buf if it[0] == process]
                keep = [it for it in self._buf if it[0] != process]
                self._buf.clear()
                self._buf.extend(keep)
        return sorted(items, key=lambda it: it[3])


class _NoopSpan:
    """The disabled fast path: one shared instance, enter/exit do
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _LiveSpan:
    __slots__ = ("_rec", "_process", "_lane", "_name", "_args", "_t0")

    def __init__(self, rec, process, lane, name, args):
        self._rec = rec
        self._process = process
        self._lane = lane
        self._name = name
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._rec.add(self._process, self._lane, self._name, self._t0,
                      time.perf_counter(), self._args or None)
        return False


# the process recorder: one per process, disabled until someone calls
# recorder().start()
_recorder = TraceRecorder()


def recorder() -> TraceRecorder:
    return _recorder


def span(name: str, *, process: str = "serving", lane: str = "main",
         **args):
    """Context manager recording one complete event on ``(process,
    lane)``. Extra keyword args (``request_id=...``) land in the event's
    ``args``."""
    rec = _recorder
    if not rec.enabled:
        return _NOOP
    return _LiveSpan(rec, process, lane, name, args)


def add_span(name: str, t0: float, t1: float, *, process: str = "serving",
             lane: str = "main", **args) -> None:
    """Retroactive span with explicit perf_counter stamps. Same disabled
    fast path as :func:`span`."""
    rec = _recorder
    if not rec.enabled:
        return
    rec.add(process, lane, name, t0, t1, args or None)
