"""Request-scoped tracing: the span API, a bounded ring-buffer recorder
and its Chrome/Perfetto export (an adapted copy of the part of
``distributed_tensorflow_example_tpu/obs/trace.py`` the generation engine
and the trainer call; trace contexts and the ``/trace/*`` routes arrive
with the HTTP/observability slice).

- :func:`span` — ``with span("prefill", lane="slot0", request_id=rid):``
  records one complete event into the process recorder. When tracing is
  off it returns a shared no-op context manager after a single attribute
  check: zero allocations, zero recorder calls.
- :func:`add_span` — a retroactive span with explicit
  ``time.perf_counter()`` stamps (queue-wait is only known at admission).
- :class:`TraceRecorder` — a bounded ring (oldest events drop first;
  ``events_dropped`` counts them) of (process, lane, name, t0, t1, args);
  :meth:`TraceRecorder.to_chrome` dumps it as trace-event JSON through
  :class:`ChromeTraceWriter` (lanes become threads).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any


class ChromeTraceWriter:
    """Builds a chrome://tracing / Perfetto trace-event JSON dict: name
    processes and threads with :meth:`pid` / :meth:`tid` (one metadata
    event per name), one :meth:`complete` per "X" event, then
    :meth:`to_dict`."""

    def __init__(self):
        self.events: list[dict[str, Any]] = []
        self._pids: dict[str, int] = {}
        self._tids: dict[tuple[int, str], int] = {}

    def pid(self, process_name: str) -> int:
        p = self._pids.get(process_name)
        if p is None:
            p = len(self._pids) + 1
            self._pids[process_name] = p
            self.events.append({"ph": "M", "pid": p,
                                "name": "process_name",
                                "args": {"name": process_name}})
        return p

    def tid(self, pid: int, thread_name: str) -> int:
        key = (pid, thread_name)
        t = self._tids.get(key)
        if t is None:
            t = sum(1 for (p, _) in self._tids if p == pid) + 1
            self._tids[key] = t
            self.events.append({"ph": "M", "pid": pid, "tid": t,
                                "name": "thread_name",
                                "args": {"name": thread_name}})
        return t

    def complete(self, *, pid: int, tid: int, name: str, ts_us: float,
                 dur_us: float, args: dict | None = None) -> None:
        ev: dict[str, Any] = {"ph": "X", "pid": pid, "tid": tid,
                              "name": name, "ts": ts_us,
                              # Perfetto drops true-zero durations
                              "dur": max(dur_us, 0.001)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def to_dict(self) -> dict[str, Any]:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}


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

    def to_chrome(self) -> dict[str, Any]:
        """The ring's spans as trace-event JSON, sorted by start time
        (callable while armed), with the drop count in ``metadata``."""
        with self._lock:
            items = sorted(self._buf, key=lambda it: it[3])
            t0 = self._t0
            dropped = self.events_dropped
        w = ChromeTraceWriter()
        for process, lane, name, s, e, args in items:
            pid = w.pid(process)
            tid = w.tid(pid, lane)
            w.complete(pid=pid, tid=tid, name=name,
                       ts_us=(s - t0) * 1e6, dur_us=(e - s) * 1e6,
                       args=args)
        out = w.to_dict()
        out["metadata"] = {"events_dropped": dropped,
                           "max_events": self.max_events}
        return out


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


def ensure_capacity(max_events: int) -> TraceRecorder:
    """The process recorder, replaced by one of ``max_events`` unless a
    capture is armed (its owner's spans must not be discarded)."""
    global _recorder
    if _recorder.max_events != max_events and not _recorder.enabled:
        _recorder = TraceRecorder(max_events)
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
