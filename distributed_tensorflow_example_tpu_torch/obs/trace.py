"""Request-scoped tracing: the span API, a bounded ring-buffer recorder,
its Chrome/Perfetto export and ``traceparent`` contexts (a copy of
``distributed_tensorflow_example_tpu/obs/trace.py``, standard library
only).

- :func:`span` — ``with span("prefill", lane="slot0", request_id=rid):``
  records one complete event into the process recorder. When tracing is
  off it returns a shared no-op context manager after a single attribute
  check: zero allocations, zero recorder calls.
- :func:`add_span` — a retroactive span with explicit
  ``time.perf_counter()`` stamps (queue-wait is only known at admission).
- :class:`TraceRecorder` — a bounded ring (oldest events drop first;
  ``events_dropped`` counts them) of (process, lane, name, t0, t1,
  args). :meth:`TraceRecorder.drain` empties one process label's spans
  (``GET /trace/export``: a second export is empty), and
  :meth:`TraceRecorder.tail` reads the newest spans without removing
  them (the flight recorder's bundle source).
- :class:`ChromeTraceWriter` — the one trace-event JSON emitter: process
  and thread name metadata ("M") events plus complete ("X") events in
  microseconds. ``utils/trace_summary.py`` reads what it writes.
- :class:`TraceContext` carries a W3C-``traceparent``-shaped context
  (``00-<trace_id:32hex>-<span_id:16hex>-<01|00>``) into a server: the
  engine parents its spans under it (``trace_id``/``parent_id`` span
  args). :func:`parse_traceparent` degrades a bad header to None.
- :func:`arm_always_on` starts the ring without clearing a capture
  someone else armed: the flight recorder's mode, so an incident bundle
  always has history. :func:`release_always_on` gives a hold back; the
  last one disarms the ring it started.
- :func:`process_span_stats` counts recorded and dropped spans across
  every recorder this process armed.
"""

from __future__ import annotations

import dataclasses
import secrets
import threading
import time
from collections import deque
from typing import Any

# process-wide span accounting for the tier-1 TRACE banner: survives
# recorder swaps (set_recorder) the way the registry's name accumulator
# survives engine teardown. Updated inside the recorder lock.
_SPAN_TOTALS = {"recorded": 0, "dropped": 0}


def process_span_stats() -> dict[str, int]:
    """{"recorded": N, "dropped": M} across every recorder this process
    armed — the TRACE line in the tier-1 telemetry banner."""
    return dict(_SPAN_TOTALS)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One hop of a distributed trace: the ``traceparent`` triple.

    ``trace_id`` names the whole client request fleet-wide;
    ``span_id`` names the SENDER's span (the receiver's parent);
    ``sampled`` is the propagated record/don't-record decision (the
    router's ``--trace_sample`` draw — an unsampled context still
    carries the ids so logs correlate, but receivers attach no span
    args for it)."""

    trace_id: str
    span_id: str
    sampled: bool = True

    def child(self) -> "TraceContext":
        """Same trace, fresh span id — one per forward attempt."""
        return TraceContext(self.trace_id, new_span_id(), self.sampled)

    def to_traceparent(self) -> str:
        return (f"00-{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")

    def span_args(self) -> dict[str, str]:
        """The args a receiver merges into spans recorded under this
        context ({} when unsampled) — trace_id groups, parent_id
        parents."""
        if not self.sampled:
            return {}
        return {"trace_id": self.trace_id, "parent_id": self.span_id}


def new_trace_id() -> str:
    return secrets.token_hex(16)


def new_span_id() -> str:
    return secrets.token_hex(8)


def parse_traceparent(header: str | None) -> TraceContext | None:
    """``traceparent`` header -> :class:`TraceContext`, or None for a
    missing/malformed value (propagation is best-effort: a garbled
    header must degrade to local-only tracing, never to a 4xx)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id,
                        sampled=bool(int(flags, 16) & 1))


class ChromeTraceWriter:
    """Builds a chrome://tracing / Perfetto trace-event JSON dict.

    Used by the live recorder's dump: call
    :meth:`pid` / :meth:`tid` to name processes/threads (metadata
    events are emitted once per name) and :meth:`complete` per "X"
    event; :meth:`to_dict` yields the loadable object.
    """

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
    """Bounded in-memory span store. ``start()`` arms it and anchors
    the timebase; ``stop()`` disarms; ``to_chrome()`` dumps whatever
    the ring currently holds (callable while armed — a live snapshot).
    Thread-safe: spans arrive from scheduler/HTTP/trainer threads."""

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
        seconds. Spans that began before ``start()`` are clamped to the
        capture window (a queue-wait recorded retroactively must not
        render at negative timestamps)."""
        if not self.enabled:
            return
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.events_dropped += 1
                _SPAN_TOTALS["dropped"] += 1
            self._buf.append((process, lane, name, max(t0, self._t0),
                              max(t1, self._t0), args))
            self.spans_recorded += 1
            _SPAN_TOTALS["recorded"] += 1

    def drain(self, process: str | None = None) -> list[tuple]:
        """Remove and return spans (sorted by start time) — ALL of
        them, or only one ``process`` label's. Per-process drain is the
        ``GET /trace/export`` contract: N in-process replicas share ONE
        ring (distinct labels), and each export must empty only its own
        lane group. Draining does not disarm."""
        with self._lock:
            if process is None:
                items = list(self._buf)
                self._buf.clear()
            else:
                items = [it for it in self._buf if it[0] == process]
                if items:
                    keep = [it for it in self._buf if it[0] != process]
                    self._buf.clear()
                    self._buf.extend(keep)
        return sorted(items, key=lambda it: it[3])

    def tail(self, n: int, process: str | None = None) -> list[tuple]:
        """The newest ``n`` spans (optionally one process label's),
        WITHOUT removing them — the flight recorder's bundle source
        (an incident dump must not eat the capture an operator might
        still export)."""
        with self._lock:
            items = [it for it in self._buf
                     if process is None or it[0] == process]
        items.sort(key=lambda it: it[3])
        return items[-n:] if n > 0 else []

    def to_chrome(self) -> dict[str, Any]:
        """Ring contents as chrome trace-event JSON (via the shared
        :class:`ChromeTraceWriter`). Lanes become threads; events sort
        by timestamp inside the dump so truncated rings still render
        coherently."""
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
    nothing. ``span()`` hands this back after a single enabled check —
    no allocation, no recorder traffic."""

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
# recorder().start() (the POST /trace/start route, a trainer with
# obs.trace_path, or a test)
_recorder = TraceRecorder()


def recorder() -> TraceRecorder:
    return _recorder


def set_recorder(rec: TraceRecorder) -> TraceRecorder:
    """Swap the process recorder (the server does this to honor
    ``--trace_buffer_events``); returns the new one."""
    global _recorder
    _recorder = rec
    return rec


def ensure_capacity(max_events: int) -> TraceRecorder:
    """Resize the process recorder to ``max_events`` — UNLESS a capture
    is currently armed (another server/trainer in this process owns it;
    swapping would silently discard its spans). The one owner of this
    check-then-swap invariant; both ``--trace_buffer_events`` call
    sites go through it. Returns the (possibly unchanged) recorder."""
    rec = _recorder
    if rec.max_events != max_events and not rec.enabled:
        return set_recorder(TraceRecorder(max_events))
    return rec


# the ring arm_always_on started, and how many holders (live servers'
# flight recorders) keep it armed; guarded by _always_on_lock
_always_on: dict[str, Any] = {"rec": None, "holders": 0}
_always_on_lock = threading.Lock()


def arm_always_on(max_events: int = 65536) -> TraceRecorder:
    """The flight-recorder arming path: size the process recorder (the
    usual armed-capture guard applies) and START it — unless a capture
    is already armed, which must not be cleared out from under its
    owner (a second in-process server, or an operator's live
    ``POST /trace/start`` capture). Each call on the ring this path
    started is one hold, given back by :func:`release_always_on`."""
    with _always_on_lock:
        rec = ensure_capacity(max_events)
        if not rec.enabled:
            rec.start()
            _always_on.update(rec=rec, holders=0)
        if _always_on["rec"] is rec:
            _always_on["holders"] += 1
        return rec


def release_always_on(rec: TraceRecorder) -> None:
    """Give back one hold of :func:`arm_always_on` on ``rec``: the last
    holder of a ring that path started disarms it, so a stopped
    server's flight recorder leaves no spans recording behind it. A
    ring armed by someone else (an operator's capture, a trainer's
    ``trace_path``) is left as it is."""
    with _always_on_lock:
        if _always_on["rec"] is not rec or _always_on["holders"] < 1:
            return
        _always_on["holders"] -= 1
        if not _always_on["holders"]:
            _always_on.update(rec=None)
            rec.stop()


def span(name: str, *, process: str = "serving", lane: str = "main",
         **args):
    """Context manager recording one complete event on ``(process,
    lane)``. Extra keyword args (``request_id=...``) land in the
    event's ``args`` — the request-correlation hook."""
    rec = _recorder
    if not rec.enabled:
        return _NOOP
    return _LiveSpan(rec, process, lane, name, args)


def add_span(name: str, t0: float, t1: float, *, process: str = "serving",
             lane: str = "main", **args) -> None:
    """Retroactive span with explicit perf_counter stamps (queue-wait
    is only known at admission). Same disabled fast path as
    :func:`span`."""
    rec = _recorder
    if not rec.enabled:
        return
    rec.add(process, lane, name, t0, t1, args or None)
