"""Trace summary: where the time went in a Chrome trace (port of
``distributed_tensorflow_example_tpu/utils/trace_summary.py``, which
reduces a ``jax.profiler`` xplane capture; the port reduces what the port
writes).

Inputs, told apart by their shape:

- a ``torch.profiler`` Chrome trace (``train/hooks.ProfilerHook``'s
  ``export_chrome_trace`` files, or any ``prof.export_chrome_trace``), a
  JSON object with ``traceEvents``;
- a server's span capture: ``POST /trace/stop``'s Chrome JSON (the same
  shape), or ``GET /trace/export``'s ``{"process", "spans": [[process,
  lane, name, t0, t1, args], ...]}``.

It reports:

- per-lane busy time as an interval union (a lane is a (process, thread)
  pair; CPU ops nest and streams overlap, so a naive sum of event
  durations overcounts: both are printed);
- device time (the ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
  events) by op family: the hand-written kernels by name (B1 the flash
  forward, B2a/B2b the split backward, B3 the fused backward, B4 the
  slab decode, B5 the paged decode over bf16 pools, B6 over int8
  pools), ``gemm``, ``elementwise``, ``copy`` and ``other``, with each
  family's share of the device busy time;
- the top-K ops by total time (device ops when the trace holds any,
  else every event).

Usage::

    python -m distributed_tensorflow_example_tpu_torch.utils.trace_summary \\
        trace.json [--top 20] [--json]

A directory argument summarizes every ``*.json`` under it, one section
each. ``--fleet stitched.json`` reads a stitched ``GET /trace/fleet``
export of the router instead (``obs/stitch.summarize_fleet``): spans,
lanes and busy time per process, the span names, each trace id's spans,
processes and end-to-end duration, and the applied clock offsets.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
from typing import Any

#: trace-event categories that run on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: the op families, in report order
FAMILIES = ("B1", "B2a", "B2b", "B3", "B4", "B5", "B6", "gemm",
            "elementwise", "copy", "other")

_GEMM_MARKS = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")


def union_ms(intervals: list[tuple[float, float]]) -> float:
    """Covered time of possibly-overlapping ``[start, end)`` spans, in
    the spans' unit divided by 1e3 (microseconds in, milliseconds out)."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def kernel_family(name: str, cat: str = "kernel",
                  last_paged: str = "B5") -> str:
    """The family of one device event. ``last_paged`` is the family of the
    latest paged split kernel on the same stream: the paged combine kernel
    is shared by B5 and B6 and belongs to the split it finishes."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy"
    if "flash_fwd_kernel" in name:
        return "B1"
    if "flash_bwd_dq_kernel" in name:
        return "B2a"
    if "flash_bwd_dkv_kernel" in name:
        return "B2b"
    if "flash_bwd_fused_kernel" in name:
        return "B3"
    if "paged::split_kernel" in name:
        return "B6" if ", true>" in name else "B5"
    if "paged::combine_kernel" in name:
        return last_paged
    if any(k in name for k in ("score_kernel", "pv_kernel",
                               "combine_kernel")):
        return "B4"
    low = name.lower()
    if any(k in low for k in _GEMM_MARKS):
        return "gemm"
    if "elementwise" in low:
        return "elementwise"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def _events_from_spans(payload: dict) -> tuple[list[dict], dict]:
    """``GET /trace/export`` rows -> trace events in microseconds, and the
    lane names."""
    events, lanes = [], {}
    for p, lane, name, t0, t1, _args in payload.get("spans", ()):
        key = (p, lane)
        lanes[key] = f"{p}/{lane}"
        events.append({"ph": "X", "pid": p, "tid": lane, "name": name,
                       "ts": float(t0) * 1e6,
                       "dur": max(float(t1) - float(t0), 0.0) * 1e6})
    return events, lanes


def _events_from_chrome(trace: dict) -> tuple[list[dict], dict]:
    """Complete events of a Chrome trace and the lane names its ``M``
    metadata events give (``process/thread``; raw ids otherwise)."""
    procs, threads = {}, {}
    events = []
    for ev in trace.get("traceEvents", ()):
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "process_name":
                procs[ev.get("pid")] = ev.get("args", {}).get("name")
            elif ev.get("name") == "thread_name":
                threads[(ev.get("pid"), ev.get("tid"))] = \
                    ev.get("args", {}).get("name")
        elif ph == "X" and "dur" in ev:
            events.append(ev)
    lanes = {}
    for ev in events:
        key = (ev.get("pid"), ev.get("tid"))
        if key not in lanes:
            p = procs.get(key[0]) or key[0]
            t = threads.get(key) or key[1]
            lanes[key] = f"{p}/{t}"
    return events, lanes


def summarize_trace(trace: dict, *, top: int = 20) -> dict[str, Any]:
    """The summary of one parsed trace (see the module docstring)."""
    if "spans" in trace and "traceEvents" not in trace:
        events, lanes = _events_from_spans(trace)
        source = "trace_export"
    else:
        events, lanes = _events_from_chrome(trace)
        source = "chrome"
    by_lane: dict[Any, list[tuple[float, float]]] = \
        collections.defaultdict(list)
    for ev in events:
        s = float(ev["ts"])
        by_lane[(ev.get("pid"), ev.get("tid"))].append(
            (s, s + float(ev["dur"])))
    lane_rows = []
    for key, iv in by_lane.items():
        lane_rows.append({
            "lane": lanes[key], "events": len(iv),
            "busy_ms": round(union_ms(iv), 6),
            "naive_ms": round(sum(e - s for s, e in iv) / 1e3, 6)})
    lane_rows.sort(key=lambda r: -r["busy_ms"])

    dev = [ev for ev in events if ev.get("cat") in DEVICE_CATS]
    fam_ms = {f: 0.0 for f in FAMILIES}
    fam_n = {f: 0 for f in FAMILIES}
    ops: dict[str, list] = {}
    last_paged: dict[Any, str] = {}
    for ev in sorted(dev, key=lambda e: float(e["ts"])):
        stream = (ev.get("pid"), ev.get("tid"))
        fam = kernel_family(ev.get("name", ""), ev.get("cat", "kernel"),
                            last_paged.get(stream, "B5"))
        if fam in ("B5", "B6") and "split_kernel" in ev.get("name", ""):
            last_paged[stream] = fam
        fam_ms[fam] += float(ev["dur"]) / 1e3
        fam_n[fam] += 1
        rec = ops.setdefault(ev.get("name", "?"), [0.0, 0, fam])
        rec[0] += float(ev["dur"]) / 1e3
        rec[1] += 1
    if not dev:
        for ev in events:
            rec = ops.setdefault(ev.get("name", "?"), [0.0, 0, None])
            rec[0] += float(ev["dur"]) / 1e3
            rec[1] += 1
    dev_busy = union_ms([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                         for e in dev])
    dev_total = sum(fam_ms.values())
    out: dict[str, Any] = {
        "source": source, "events": len(events), "lanes": lane_rows,
        "top_ops": [{"op": name[:160], "ms": round(ms, 6), "count": n,
                     "family": fam}
                    for name, (ms, n, fam) in sorted(
                        ops.items(), key=lambda kv: -kv[1][0])[:top]]}
    if dev:
        out["device"] = {
            "events": len(dev), "busy_ms": round(dev_busy, 6),
            "total_ms": round(dev_total, 6),
            "families_ms": {f: round(v, 6) for f, v in fam_ms.items()
                            if fam_n[f]},
            "families_count": {f: n for f, n in fam_n.items() if n},
            # shares of the summed kernel time (streams may overlap, so
            # the shares of the busy union would not add to 1)
            "families_share": {f: round(v / dev_total, 6)
                               for f, v in fam_ms.items()
                               if fam_n[f] and dev_total > 0}}
    return out


def summarize(path: str, *, top: int = 20) -> dict[str, Any]:
    """``{file: summary}`` of a trace file, or of every ``*.json`` under a
    directory."""
    paths = ([path] if os.path.isfile(path) else sorted(
        glob.glob(os.path.join(path, "**", "*.json"), recursive=True)))
    if not paths:
        raise FileNotFoundError(f"no *.json trace under {path}")
    out = {}
    for p in paths:
        with open(p) as f:
            trace = json.load(f)
        key = os.path.basename(p) if p == path else os.path.relpath(p, path)
        out[key] = summarize_trace(trace, top=top)
    return out


def format_text(summary: dict[str, Any]) -> str:
    parts = []
    for name, rec in summary.items():
        parts.append(f"== {name} ({rec['source']}, {rec['events']} "
                     "events)")
        for ln in rec["lanes"]:
            parts.append(f"  lane {ln['lane']!r}: busy={ln['busy_ms']:.3f}"
                         f"ms (naive sum {ln['naive_ms']:.3f}ms) "
                         f"events={ln['events']}")
        dev = rec.get("device")
        if dev:
            parts.append(f"  device: busy={dev['busy_ms']:.3f}ms "
                         f"kernel sum={dev['total_ms']:.3f}ms")
            for f, ms in dev["families_ms"].items():
                parts.append(f"    {f:12s} {ms:10.3f} ms "
                             f"x{dev['families_count'][f]:<6d} "
                             f"{100 * dev['families_share'].get(f, 0):5.1f}%")
        parts.append("  -- top ops:")
        for o in rec["top_ops"]:
            fam = f" [{o['family']}]" if o["family"] else ""
            parts.append(f"    {o['ms']:10.3f} ms x{o['count']:<6d} "
                         f"{o['op']}{fam}")
    return "\n".join(parts)


def format_fleet(summary: dict[str, Any]) -> str:
    parts = []
    for p, rec in summary["processes"].items():
        parts.append(f"process {p!r}: {rec['spans']} span(s), "
                     f"busy={rec['busy_ms']}ms, lanes="
                     f"{', '.join(rec['lanes'])}")
    offs = summary.get("clock_offsets_s") or {}
    if offs:
        parts.append("clock offsets (s): " + " ".join(
            f"{k}={v}" for k, v in sorted(offs.items())))
    parts.append(f"span names: {', '.join(summary['span_names'])}")
    for t, rec in summary["traces"].items():
        parts.append(f"trace {t}: {rec['spans']} span(s) across "
                     f"{', '.join(rec['processes'])}, "
                     f"{rec['duration_ms']}ms end-to-end")
    return "\n".join(parts)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="a Chrome trace or /trace/export JSON "
                    "file, or a directory of them; with --fleet a "
                    "stitched GET /trace/fleet JSON file")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--fleet", action="store_true",
                    help="summarize a STITCHED fleet trace "
                    "(obs/stitch.py output)")
    args = ap.parse_args(argv)
    if args.fleet:
        from ..obs.stitch import summarize_fleet
        with open(args.trace) as f:
            s = summarize_fleet(json.load(f))
        print(json.dumps(s, indent=1) if args.json else format_fleet(s))
        return 0
    s = summarize(args.trace, top=args.top)
    print(json.dumps(s, indent=1) if args.json else format_text(s))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
