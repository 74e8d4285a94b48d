"""Fleet trace stitcher: N per-process span exports into ONE timeline (a
copy of ``distributed_tensorflow_example_tpu/obs/stitch.py``, standard
library only).

Each process stamps its spans (``obs/trace.py``) with its own
``time.perf_counter()``, a monotonic clock with an arbitrary epoch, so two
processes' timestamps mean nothing to each other. This module makes a
fleet request render as one Perfetto timeline (``GET /trace/fleet`` on
the router):

- :func:`estimate_offset`: the NTP-style clock offset from probe
  timestamps. The router stamps ``t_send``/``t_recv`` around each health
  probe in its clock; the replica's ``/healthz`` body carries ``mono_now``
  in the replica's clock; ``offset = mono_now - (t_send + t_recv) / 2``
  (remote minus local midpoint) per sample. The median over recent
  samples rejects the occasional slow probe, whose symmetric-delay
  assumption is worst. A pure function of injected timestamps.
- :func:`stitch`: the router's own export and every replica's ``GET
  /trace/export`` payload merged into Chrome trace-event JSON through
  :class:`~.trace.ChromeTraceWriter`. The first export (the router)
  anchors the timeline and renders as the top process group; each
  replica becomes its own process group, its spans corrected into the
  anchor's clock (``t_anchor = t_remote - offset``). Span args
  (request_id / trace_id / parent_id / span_id) pass through untouched.

Export payload shape (``PredictServer.trace_export`` /
``ReplicaRouter.fleet_trace``)::

    {"process": "replica0", "clock": <perf_counter now>,
     "spans": [[process, lane, name, t0, t1, args|null], ...],
     "events_dropped": 0}

The ``process`` field wins over each span's own label: the router
relabels an external replica's generic "serving" export with its
fleet-side replica name, so lanes group as the routing spans'
``replica=...`` args name them.
"""

from __future__ import annotations

import statistics
from typing import Any, Iterable, Sequence

from .trace import ChromeTraceWriter


def estimate_offset(samples: Iterable[Sequence[float]]) -> float:
    """Median clock offset (REMOTE clock minus LOCAL clock) from
    ``(t_send, t_recv, remote_now)`` probe samples, all in seconds.
    0.0 with no samples — an unmeasured replica renders uncorrected
    rather than not at all."""
    offs = [float(r) - (float(a) + float(b)) / 2.0
            for a, b, r in samples]
    return statistics.median(offs) if offs else 0.0


def stitch(exports: Sequence[dict], *,
           offsets: dict[str, float] | None = None) -> dict[str, Any]:
    """Merge per-process span exports into one Perfetto-loadable trace.

    ``exports[0]`` is the anchor (the router: its process group renders
    on top and its clock defines the timeline); ``offsets`` maps each
    export's ``process`` name to its clock offset REMOTE-minus-anchor
    seconds (:func:`estimate_offset`; absent/0.0 = no correction).
    Every span's args ride through; the stitched metadata records the
    applied offsets so a reader can audit the correction.
    """
    offsets = offsets or {}
    corrected: list[tuple[str, str, str, float, float, dict | None]] = []
    for exp in exports:
        pname = exp.get("process", "?")
        off = float(offsets.get(pname, 0.0))
        for item in exp.get("spans", ()):
            _, lane, name, t0, t1, args = item
            corrected.append((pname, lane, name, float(t0) - off,
                              float(t1) - off, args or None))
    base = min((s[3] for s in corrected), default=0.0)
    w = ChromeTraceWriter()
    # declare process groups in EXPORT order first (router on top —
    # the writer assigns pids by first sight)
    for exp in exports:
        w.pid(exp.get("process", "?"))
    for pname, lane, name, t0, t1, args in sorted(corrected,
                                                  key=lambda s: s[3]):
        pid = w.pid(pname)
        tid = w.tid(pid, lane)
        w.complete(pid=pid, tid=tid, name=name, ts_us=(t0 - base) * 1e6,
                   dur_us=(t1 - t0) * 1e6, args=args)
    out = w.to_dict()
    out["metadata"] = {
        "processes": [e.get("process", "?") for e in exports],
        "clock_offsets_s": {p: round(float(o), 9)
                            for p, o in offsets.items()},
        "events_dropped": sum(int(e.get("events_dropped", 0))
                              for e in exports),
    }
    return out


def spans_for_trace(stitched: dict, trace_id: str) -> list[dict]:
    """Complete events of ``stitched`` whose args carry ``trace_id`` —
    the one-request slice of a fleet timeline (the offline ``--fleet``
    summary and the fleet-chaos structural assertions both read this
    way)."""
    return [e for e in stitched.get("traceEvents", ())
            if e.get("ph") == "X"
            and (e.get("args") or {}).get("trace_id") == trace_id]


def summarize_fleet(stitched: dict) -> dict[str, Any]:
    """Offline summary of a stitched export (``trace_summary.py
    --fleet``): per-process span/lane counts and busy time, the span-
    name vocabulary, and per-trace-id request groups with their end-to-
    end duration in the anchor clock."""
    xs = [e for e in stitched.get("traceEvents", ())
          if e.get("ph") == "X"]
    procs: dict[int, str] = {}
    lanes: dict[tuple[int, int], str] = {}
    for e in stitched.get("traceEvents", ()):
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            procs[e["pid"]] = e["args"]["name"]
        elif e.get("name") == "thread_name":
            lanes[(e["pid"], e["tid"])] = e["args"]["name"]
    per_proc: dict[str, dict[str, Any]] = {}
    for e in xs:
        p = procs.get(e["pid"], str(e["pid"]))
        rec = per_proc.setdefault(p, {"spans": 0, "lanes": set(),
                                      "busy_ms": 0.0})
        rec["spans"] += 1
        rec["lanes"].add(lanes.get((e["pid"], e["tid"]),
                                   str(e["tid"])))
        rec["busy_ms"] += e["dur"] / 1e3
    traces: dict[str, dict[str, Any]] = {}
    for e in xs:
        tid = (e.get("args") or {}).get("trace_id")
        if not tid:
            continue
        rec = traces.setdefault(tid, {"spans": 0, "processes": set(),
                                      "t0_us": e["ts"], "t1_us": e["ts"]})
        rec["spans"] += 1
        rec["processes"].add(procs.get(e["pid"], str(e["pid"])))
        rec["t0_us"] = min(rec["t0_us"], e["ts"])
        rec["t1_us"] = max(rec["t1_us"], e["ts"] + e["dur"])
    return {
        "processes": {
            p: {"spans": r["spans"], "lanes": sorted(r["lanes"]),
                "busy_ms": round(r["busy_ms"], 3)}
            for p, r in per_proc.items()},
        "span_names": sorted({e["name"] for e in xs}),
        "traces": {
            t: {"spans": r["spans"],
                "processes": sorted(r["processes"]),
                "duration_ms": round((r["t1_us"] - r["t0_us"]) / 1e3,
                                     3)}
            for t, r in traces.items()},
        "clock_offsets_s": (stitched.get("metadata") or {}).get(
            "clock_offsets_s", {}),
    }
