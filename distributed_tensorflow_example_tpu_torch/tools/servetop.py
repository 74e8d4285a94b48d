"""servetop: a live or offline SLO and goodput view of a serving process
(a port copy of ``tools/servetop.py``).

``top`` for the serving fleet: polls ``GET /stats/history`` on a replica
(``serving_http``) or a router (``serving_router``: the fleet rollup) and
renders per-class attainment, error-budget burn, goodput against raw
throughput, queue pressure and the per-replica breakdown. Offline mode
renders a dumped payload file instead (an ``slo_burn`` bundle's
``history_tail`` reads the same way)::

    python -m distributed_tensorflow_example_tpu_torch.tools.servetop \
        --url http://127.0.0.1:8501              # live
        --url ... --frames 1                     # one frame
        --file history.json [--json]             # offline

Everything is computed from the payload's ``[t, snapshot]`` samples by
the pure window queries of ``obs/timeseries.py`` and reported exactly as
the registry counted it: :func:`compute_summary` is the function the
``slo_report`` leg of ``experiments/serving_load.py`` reconciles against
its ledger and the request-log replay, so it adds nothing of its own.
Rates and quantiles are windowed (``--window``, default the whole ring);
attainment is good over served in the same window.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

from ..obs import timeseries as ts

#: priority classes rendered, best first (mirrors serving_batch)
CLASSES = ("interactive", "batch", "best_effort")

#: brownout rung names (mirrors serving_batch.PRESSURE_STATES)
PRESSURE_STATES = ("healthy", "shed_best_effort", "shed_batch",
                   "interactive_only")


def _last(samples, name, default=0):
    """Newest sample's scalar value for ``name``."""
    if not samples:
        return default
    rec = samples[-1][1].get(name)
    return rec["value"] if rec and "value" in rec else default


def _class_block(win, cls: str) -> dict:
    served = ts.delta(win, f"serving_slo_served_{cls}_total")
    good = ts.delta(win, f"serving_slo_good_{cls}_total")
    return {
        "served": served,
        "good": good,
        "attainment": round(good / served, 6) if served else None,
        "shed": ts.delta(win, f"serving_shed_{cls}_total"),
        "p95_ms": round(
            ts.quantile(win, f"serving_latency_{cls}_seconds", 0.95)
            * 1e3, 3),
    }


def compute_summary(payload: dict, *,
                    window_s: float | None = None) -> dict:
    """One frame's numbers from a ``/stats/history`` payload — pure
    (no clocks, no network), so the smoke leg can reconcile it
    EXACTLY against the harness ledger and the request-log replay."""
    samples = ts.parse_payload(payload)
    win = ts.window(samples, window_s)
    summary = {
        "enabled": bool(payload.get("enabled", bool(samples))),
        "process": payload.get("process", "?"),
        "samples": len(samples),
        "window_s": round(ts.duration_s(win), 3),
        "throughput_tps": round(
            ts.rate_per_s(win, "serving_tokens_out_total"), 3),
        "goodput_tps": round(
            ts.rate_per_s(win, "serving_goodput_tokens_total"), 3),
        "requests_per_s": round(
            ts.rate_per_s(win, "serving_slo_served_total"), 3),
        "served": ts.delta(win, "serving_slo_served_total"),
        "good": ts.delta(win, "serving_slo_good_total"),
        "goodput_tokens": ts.delta(win,
                                   "serving_goodput_tokens_total"),
        "tokens": ts.delta(win, "serving_tokens_out_total"),
        "shed": ts.delta(win, "serving_shed_total"),
        "queue_depth": _last(samples, "serving_queue_depth"),
        "queue_age_s": _last(samples, "serving_queue_age_seconds"),
        "pressure": PRESSURE_STATES[
            min(int(_last(samples, "serving_pressure_level")),
                len(PRESSURE_STATES) - 1)],
        "classes": {cls: _class_block(win, cls) for cls in CLASSES},
        "slo": (payload.get("slo") or {}).get("results"),
    }
    replicas = payload.get("replicas")
    if isinstance(replicas, dict):
        summary["replicas"] = {}
        for name, rp in sorted(replicas.items()):
            if not isinstance(rp, dict) or "error" in rp:
                summary["replicas"][name] = {
                    "error": (rp or {}).get("error", "no payload")}
                continue
            rs = ts.parse_payload(rp)
            rwin = ts.window(rs, window_s)
            served = ts.delta(rwin, "serving_slo_served_total")
            good = ts.delta(rwin, "serving_slo_good_total")
            summary["replicas"][name] = {
                "throughput_tps": round(
                    ts.rate_per_s(rwin, "serving_tokens_out_total"),
                    3),
                "goodput_tps": round(
                    ts.rate_per_s(rwin,
                                  "serving_goodput_tokens_total"), 3),
                "served": served,
                "attainment": round(good / served, 6) if served
                else None,
                "queue_depth": _last(rs, "serving_queue_depth"),
                "clock_offset_s": rp.get("clock_offset_s", 0.0),
            }
    return summary


def _fmt_ratio(v) -> str:
    return "   -  " if v is None else f"{100 * v:5.1f}%"


def render(summary: dict) -> str:
    """One text frame. Deliberately plain (no cursor tricks): pipes,
    logs, and tests read it as-is."""
    if not summary.get("enabled"):
        return (f"servetop: {summary.get('process', '?')}: history "
                "sampler is off (start the server with "
                "--history_interval_s > 0)")
    lines = [
        f"servetop — {summary['process']}  "
        f"[{summary['samples']} samples, window "
        f"{summary['window_s']}s]",
        f"  throughput {summary['throughput_tps']:9.2f} tok/s   "
        f"goodput {summary['goodput_tps']:9.2f} tok/s   "
        f"requests {summary['requests_per_s']:7.2f}/s",
        f"  served {summary['served']}  good {summary['good']}  "
        f"shed {summary['shed']}  queue {summary['queue_depth']} "
        f"(age {summary['queue_age_s']}s)  "
        f"pressure {summary['pressure']}",
        "  class         served   good   shed  attain    p95_ms",
    ]
    for cls in CLASSES:
        b = summary["classes"][cls]
        lines.append(
            f"  {cls:<12} {b['served']:7} {b['good']:6} "
            f"{b['shed']:6}  {_fmt_ratio(b['attainment'])} "
            f"{b['p95_ms']:9.3f}")
    if summary.get("slo"):
        lines.append("  objective                 attain  "
                     "burn_fast  burn_slow  state")
        for r in summary["slo"]:
            name = f"{r['class']}:{r['kind']}"
            lines.append(
                f"  {name:<25} {_fmt_ratio(r['attainment'])} "
                f"{r['burn_fast']:10.2f} {r['burn_slow']:10.2f}  "
                f"{'BREACH' if r['breach'] else 'ok'}")
    if summary.get("replicas"):
        lines.append("  replica       tok/s   goodput  served  "
                     "attain  queue  clk_off_s")
        for name, b in summary["replicas"].items():
            if "error" in b:
                lines.append(f"  {name:<12} ERROR {b['error']}")
                continue
            lines.append(
                f"  {name:<12} {b['throughput_tps']:7.2f} "
                f"{b['goodput_tps']:9.2f} {b['served']:7}  "
                f"{_fmt_ratio(b['attainment'])} "
                f"{b['queue_depth']:6} {b['clock_offset_s']:10.6f}")
    return "\n".join(lines)


def fetch(url: str, timeout: float = 10.0) -> dict:
    """One ``GET <url>/stats/history`` poll (the URL may also point
    straight at the endpoint)."""
    if not url.rstrip("/").endswith("/stats/history"):
        url = url.rstrip("/") + "/stats/history"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="live/offline SLO & goodput view over "
                    "GET /stats/history")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--url", help="replica or router base URL "
                     "(e.g. http://127.0.0.1:8501)")
    src.add_argument("--file", help="offline: render a dumped "
                     "/stats/history payload (or an slo_burn "
                     "bundle's history_tail wrapped as "
                     "{'samples': [...]})")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll cadence in seconds (live mode)")
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = until Ctrl-C; "
                    "--file always renders exactly one)")
    ap.add_argument("--window", type=float, default=0.0,
                    help="rate/attainment window in seconds "
                    "(0 = the whole ring)")
    ap.add_argument("--json", action="store_true",
                    help="emit the computed summary as JSON instead "
                    "of the text frame")
    args = ap.parse_args(argv)
    window_s = args.window or None

    def emit(payload) -> None:
        s = compute_summary(payload, window_s=window_s)
        print(json.dumps(s) if args.json else render(s), flush=True)

    if args.file:
        with open(args.file) as f:
            emit(json.load(f))
        return 0
    frames = 0
    try:
        while True:
            emit(fetch(args.url))
            frames += 1
            if args.frames and frames >= args.frames:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
