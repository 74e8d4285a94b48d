"""The port's ``obs`` modules held to the reference's on the same inputs:
Prometheus text byte for byte, snapshot merges, the time-series window
queries and the SLO evaluation over fabricated histories with hand-driven
clocks, ``traceparent`` parsing, and the flight recorder's bundle layout
and per-cause rate limit. Every comparison here is exact: the modules are
standard-library copies, so equal inputs give equal outputs."""

import json
import os

import pytest
import torch

from distributed_tensorflow_example_tpu.obs import flightrec as ref_flightrec
from distributed_tensorflow_example_tpu.obs import prom as ref_prom
from distributed_tensorflow_example_tpu.obs import registry as ref_registry
from distributed_tensorflow_example_tpu.obs import slo as ref_slo
from distributed_tensorflow_example_tpu.obs import timeseries as ref_ts
from distributed_tensorflow_example_tpu.obs import trace as ref_trace
from distributed_tensorflow_example_tpu_torch.obs import flightrec
from distributed_tensorflow_example_tpu_torch.obs import prom
from distributed_tensorflow_example_tpu_torch.obs import registry
from distributed_tensorflow_example_tpu_torch.obs import slo
from distributed_tensorflow_example_tpu_torch.obs import timeseries as ts
from distributed_tensorflow_example_tpu_torch.obs import trace

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

BUCKETS = registry.SERVING_LATENCY_BUCKETS


def _drive(reg_mod, *, enabled=True, namespace="serving"):
    """The same sequence of registrations and mutations on a registry of
    ``reg_mod``; returns the registry."""
    reg = reg_mod.Registry(enabled=enabled, namespace=namespace)
    c = reg.counter("serving_requests_done_total", "requests retired")
    g = reg.gauge("serving_queue_depth", "queue\\depth\nwith newline")
    h = reg.histogram("serving_request_latency_seconds", "latency",
                      buckets=BUCKETS)
    reg.counter("serving_never_moved_total", "dead counter")
    with reg.atomic():
        c.inc(3)
        g.set(7)
        g.dec(2)
    for v in (0.00005, 0.0003, 0.004, 0.02, 0.7, 3.0, 99.0):
        h.observe(v)
    c.inc(0)
    return reg


def _snapshot(done=5, depth=1, lat=(0.001, 0.02), served=None, good=None,
              failed=0):
    """A fabricated serving snapshot (port registry)."""
    reg = registry.Registry(namespace="")
    reg.counter("serving_requests_done_total", "done").inc(done)
    reg.gauge("serving_queue_depth", "depth").set(depth)
    h = reg.histogram("serving_request_latency_seconds", "lat",
                      buckets=BUCKETS)
    hi = reg.histogram("serving_latency_interactive_seconds", "lat i",
                       buckets=BUCKETS)
    for v in lat:
        h.observe(v)
        hi.observe(v)
    served = done if served is None else served
    good = served if good is None else good
    for cls in ("", "_interactive"):
        reg.counter(f"serving_slo_served{cls}_total", "s").inc(served)
        reg.counter(f"serving_slo_good{cls}_total", "g").inc(good)
    reg.counter("serving_requests_failed_total", "f").inc(failed)
    return reg.snapshot()


def _history():
    """Fabricated [(t, snapshot)] with a hand clock: a quiet stretch, then
    a burst of slow, half-bad traffic."""
    hist = [(0.0, _snapshot(done=0, lat=(), served=0, good=0))]
    done, lat, good = 0, [], 0
    for i in range(1, 25):
        n = 4 if i < 16 else 10
        done += n
        good += n if i < 16 else n // 2
        lat += [0.002] * n if i < 16 else [0.4] * (n // 2) + [2.0] * (n // 2)
        hist.append((i * 10.0, _snapshot(done=done, lat=tuple(lat),
                                         served=done, good=good,
                                         failed=0 if i < 20 else i - 19)))
    return hist


# ---------------------------------------------------------------------------
# registry and Prometheus text
# ---------------------------------------------------------------------------

def test_registry_snapshot_and_lint_match_the_reference():
    # the reference's registry unnamespaced: its process-wide name record
    # feeds the suite's telemetry banner
    ours, theirs = _drive(registry), _drive(ref_registry, namespace="")
    assert ours.snapshot() == theirs.snapshot()
    assert ours.lint_untouched() == theirs.lint_untouched() \
        == ["serving_never_moved_total"]
    names = registry.process_metric_names()
    assert names["serving_requests_done_total"] is True
    assert names["serving_never_moved_total"] is False
    assert ours in registry.all_registries()


def test_disabled_registry_moves_nothing():
    """The overhead guard by count, not by clock: a disabled registry's
    every increment leaves the snapshot at zero."""
    reg = _drive(registry, enabled=False, namespace="")
    snap = reg.snapshot()
    assert all(rec.get("value", 0) == 0 and rec.get("count", 0) == 0
               for rec in snap.values())
    assert reg.lint_untouched() == sorted(snap)


def test_prom_text_is_byte_equal_to_the_reference():
    snap = _drive(registry).snapshot()
    text = prom.render(snap)
    assert text == ref_prom.render(snap)
    assert text.encode() == ref_prom.render(
        _drive(ref_registry, namespace="").snapshot()).encode()
    assert prom.CONTENT_TYPE == ref_prom.CONTENT_TYPE
    assert prom.parse_snapshot(text) == ref_prom.parse_snapshot(text) == snap
    assert prom.parse(text) == ref_prom.parse(text)
    parsed = prom.parse(text)
    for q in (0.0, 0.5, 0.95, 1.0):
        assert prom.quantile_from_parsed(
            parsed, "serving_request_latency_seconds", q) == \
            ref_prom.quantile_from_parsed(
                parsed, "serving_request_latency_seconds", q)


def test_merge_snapshots_matches_the_reference():
    a, b = _snapshot(done=3, depth=2), _snapshot(done=4, depth=9,
                                                  lat=(0.5, 7.0, 90.0))
    assert registry.merge_snapshots(a, b) == ref_registry.merge_snapshots(
        a, b)
    merged = registry.merge_snapshots(a, b)
    assert merged["serving_requests_done_total"]["value"] == 7
    assert merged["serving_queue_depth"]["value"] == 9
    bad = {"serving_queue_depth": {"type": "counter", "value": 1,
                                   "help": ""}}
    for mod in (registry, ref_registry):
        with pytest.raises(ValueError, match="cannot merge"):
            mod.merge_snapshots(a, bad)
    odd = _snapshot()
    odd["serving_request_latency_seconds"]["buckets"] = [(1.0, 0)]
    for mod in (registry, ref_registry):
        with pytest.raises(ValueError, match="bucket bounds differ"):
            mod.merge_snapshots(a, odd)


# ---------------------------------------------------------------------------
# time series
# ---------------------------------------------------------------------------

def test_window_queries_match_the_reference():
    hist = _history()
    for seconds, now in ((None, None), (60.0, None), (30.0, 150.0),
                         (1000.0, 235.0), (0.0, 100.0)):
        win, rwin = ts.window(hist, seconds, now), ref_ts.window(
            hist, seconds, now)
        assert win == rwin
        for name in ("serving_requests_done_total", "serving_queue_depth",
                     "serving_request_latency_seconds", "missing_metric"):
            assert ts.delta(win, name) == ref_ts.delta(win, name)
            if name != "serving_request_latency_seconds":
                assert ts.rate_per_s(win, name) == ref_ts.rate_per_s(
                    win, name)
        lat = "serving_request_latency_seconds"
        for q in (0.5, 0.95, 0.99):
            assert ts.quantile(win, lat, q) == ref_ts.quantile(win, lat, q)
        for bound in (0.001, 0.003, 0.5, 1.7, float("inf")):
            assert ts.good_below(win, lat, bound) == ref_ts.good_below(
                win, lat, bound)
        assert ts.duration_s(win) == ref_ts.duration_s(win)
    payload = ts.to_payload(hist, enabled=True, process="serving")
    assert payload == ref_ts.to_payload(hist, enabled=True,
                                        process="serving")
    assert ts.parse_payload(json.loads(json.dumps(payload))) == \
        ref_ts.parse_payload(json.loads(json.dumps(payload)))
    two = {"a": hist[:12], "b": [(t + 3.0, s) for t, s in hist[5:]]}
    assert ts.rollup(two, offsets={"b": 3.0}, bin_s=10.0) == ref_ts.rollup(
        two, offsets={"b": 3.0}, bin_s=10.0)


def test_sampler_with_a_hand_clock_matches_the_reference():
    """Both samplers over the same snapshot function and injected clock:
    equal rings, equal peeks, the on_sample hook per cadence capture, and
    the ring bound."""
    clock = {"t": 100.0}
    state = {"n": 0}

    def snap():
        state["n"] += 1
        return _snapshot(done=state["n"])

    rings = []
    for mod in (ts, ref_ts):
        clock["t"], state["n"] = 100.0, 0
        seen = []
        s = mod.SnapshotSampler(snap, interval_s=5.0, max_samples=3,
                                clock=lambda: clock["t"],
                                on_sample=lambda smp: seen.append(len(smp)))
        for _ in range(4):
            s.sample()
            clock["t"] += 5.0
        peek = s.peek()
        rings.append((s.history(), peek, seen, len(s)))
    assert rings[0] == rings[1]
    hist, peek, seen, n = rings[0]
    assert n == 3 and [t for t, _ in hist] == [105.0, 110.0, 115.0]
    assert peek[0] == 120.0 and seen == [1, 2, 3, 3]
    for mod in (ts, ref_ts):
        with pytest.raises(ValueError):
            mod.SnapshotSampler(snap, interval_s=0)
        with pytest.raises(ValueError):
            mod.SnapshotSampler(snap, max_samples=1)


# ---------------------------------------------------------------------------
# SLO
# ---------------------------------------------------------------------------

GOOD_SPECS = ("interactive:p95_ms=250@0.95;all:availability=0.999",
              "interactive:hit_rate=0.99",
              " batch:p95_ms=1000 ; all:hit_rate=0.9 ;",
              "all:p95_ms=30000@0.9")
BAD_SPECS = ("", "interactive", "interactive:p95_ms", "nope:hit_rate=0.9",
             "interactive:bogus=0.9", "interactive:availability=0.9",
             "all:hit_rate=0.9@0.5", "all:hit_rate=1.5",
             "interactive:p95_ms=-1", "all:hit_rate=0.9;all:hit_rate=0.8",
             "all:hit_rate=abc")


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_slo_spec_matches_the_reference(spec):
    ours = [o.to_dict() for o in slo.parse_slo_spec(spec)]
    assert ours == [o.to_dict() for o in ref_slo.parse_slo_spec(spec)]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_slo_spec_refuses_what_the_reference_refuses(spec):
    errors = []
    for mod in (slo, ref_slo):
        with pytest.raises(ValueError) as e:
            mod.parse_slo_spec(spec)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_slo_evaluate_matches_the_reference_and_breaches():
    hist = _history()
    objs = [slo.Objective("interactive", "p95_ms", 250.0, 0.95),
            slo.Objective("interactive", "hit_rate", 0.9, 0.9),
            slo.Objective("all", "availability", 0.99, 0.99),
            slo.Objective("batch", "hit_rate", 0.9, 0.9)]
    robjs = [ref_slo.Objective(o.cls, o.kind, o.target, o.goal)
             for o in objs]
    for kw in ({}, {"now": 150.0}, {"fast_s": 30.0, "slow_s": 120.0},
               {"threshold": 10.0}):
        ours = slo.evaluate(hist, objs, **kw)
        assert ours == ref_slo.evaluate(hist, robjs, **kw)
        assert slo.summarize(ours) == ref_slo.summarize(ours)
    res = slo.evaluate(hist, objs, fast_s=30.0, slow_s=120.0)
    by = {f"{r['class']}:{r['kind']}": r for r in res}
    assert by["interactive:p95_ms"]["breach"]
    assert by["interactive:hit_rate"]["breach"]
    assert not by["batch:hit_rate"]["breach"]      # no batch traffic
    quiet = slo.evaluate(hist, objs, now=150.0, fast_s=30.0, slow_s=120.0)
    assert not any(r["breach"] for r in quiet)
    assert [o.to_dict() for o in slo.default_objectives()] == \
        [o.to_dict() for o in ref_slo.default_objectives()]
    for g, t, goal in ((8, 10, 0.95), (0, 0, 0.9), (10, 10, 0.5)):
        assert slo.burn_rate(g, t, goal) == ref_slo.burn_rate(g, t, goal)


# ---------------------------------------------------------------------------
# trace contexts and the recorder
# ---------------------------------------------------------------------------

HEADERS = (None, "", "garbage",
           "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
           "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00",
           " 00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01 ",
           "00-00000000000000000000000000000000-b7ad6b7169203331-01",
           "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
           "00-0af7651916cd43dd8448eb211c80319c-b7ad6b716920333-01",
           "00-0af7651916cd43dd8448eb211c80319g-b7ad6b7169203331-01",
           "0-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
           "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-zz",
           "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01-x")


@pytest.mark.parametrize("header", HEADERS)
def test_parse_traceparent_matches_the_reference(header):
    ours, theirs = trace.parse_traceparent(header), \
        ref_trace.parse_traceparent(header)
    if theirs is None:
        assert ours is None
        return
    assert (ours.trace_id, ours.span_id, ours.sampled) == \
        (theirs.trace_id, theirs.span_id, theirs.sampled)
    assert ours.to_traceparent() == theirs.to_traceparent()
    assert ours.span_args() == theirs.span_args()
    child = ours.child()
    assert child.trace_id == ours.trace_id and child.span_id != ours.span_id
    assert len(trace.new_trace_id()) == 32 and len(trace.new_span_id()) == 16


def test_recorder_drain_tail_and_always_on_match_the_reference():
    out = []
    for mod in (trace, ref_trace):
        rec = mod.TraceRecorder(max_events=4)
        rec.start()
        t0 = rec._t0
        for i, p in enumerate(("a", "b", "a", "b", "a")):
            rec.add(p, "lane", f"s{i}", t0 + i, t0 + i + 0.5, {"i": i})
        tail = rec.tail(2, process="a")
        drained = rec.drain(process="a")
        again = rec.drain(process="a")
        rest = rec.drain()
        out.append(([x[2] for x in tail], [x[2] for x in drained], again,
                    [x[2] for x in rest], rec.events_dropped))
    assert out[0] == out[1]
    assert out[0] == (["s2", "s4"], ["s2", "s4"], [], ["s1", "s3"], 1)
    # arm_always_on starts a disarmed ring but never clears an armed one
    old = trace.recorder()
    try:
        rec = trace.set_recorder(trace.TraceRecorder(8))
        rec.start()
        trace.add_span("kept", rec._t0, rec._t0 + 1)
        assert trace.arm_always_on(8) is rec and len(rec.tail(8)) == 1
        rec.stop()
        fresh = trace.arm_always_on(16)
        assert fresh is not rec and fresh.enabled and fresh.max_events == 16
        fresh.stop()
        with trace.span("off"):
            pass
        assert fresh.tail(16) == []             # disarmed: nothing recorded
        stats = trace.process_span_stats()
        assert stats["recorded"] >= 1 and "dropped" in stats
    finally:
        trace.set_recorder(old)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_flight_recorder_bundle_layout_and_rate_limit(tmp_path):
    """The same incidents through both recorders (hand clock): the same
    bundle keys, config fingerprint, span tail, registry snapshot and log
    tail; one bundle a cause inside the interval, suppressed ones
    counted."""
    log_path = tmp_path / "requests.jsonl"
    log_path.write_text("".join(json.dumps({"i": i}) + "\n"
                                for i in range(60)))
    config = {"max_queue": 8, "model": "gpt"}
    layouts, files = [], []
    for name, rec_mod, reg_mod, tr in (
            ("port", flightrec, registry, trace),
            ("ref", ref_flightrec, ref_registry, ref_trace)):
        old = tr.recorder()
        ring = tr.set_recorder(tr.TraceRecorder(16))
        ring.start()
        tr.add_span("decode_step", ring._t0, ring._t0 + 0.01,
                    process="serving", lane="scheduler", slots=2)
        tr.add_span("other", ring._t0, ring._t0 + 0.01, process="x")
        clock = {"t": 0.0}
        reg = reg_mod.Registry(namespace="")
        c = reg.counter("serving_incidents_total", "n")
        sup = reg.counter("serving_incidents_suppressed_total", "n")
        d = tmp_path / name
        fr = rec_mod.FlightRecorder(
            str(d), process="serving", snapshot_fn=reg.snapshot,
            config=config, request_log_path=str(log_path),
            min_interval_s=30.0, counter=c, suppressed_counter=sup,
            clock=lambda: clock["t"])
        try:
            p1 = fr.incident("watchdog_stall", "heartbeat 3s old",
                             extra={"health": {"status": "stalled"}})
            p2 = fr.incident("watchdog_stall", "again")
            p3 = fr.incident("slo_burn", "burning")
            clock["t"] = 31.0
            p4 = fr.incident("watchdog_stall", "later")
        finally:
            ring.stop()
            tr.set_recorder(old)
        assert p1 and p2 is None and p3 and p4
        assert c.value == 3 and sup.value == 1
        with open(p1) as f:
            bundle = json.load(f)
        files.append(sorted(os.listdir(d)))
        layouts.append(bundle)
    ours, theirs = layouts
    assert sorted(ours) == sorted(theirs)
    for key in ("cause", "detail", "process", "config",
                "config_fingerprint", "spans_recorded", "events_dropped",
                "tracing_enabled", "health", "request_log_tail",
                "registry"):
        assert ours[key] == theirs[key], key
    assert [s[2] for s in ours["spans"]] == [s[2] for s in theirs["spans"]] \
        == ["decode_step"]
    assert ours["request_log_tail"][-1] == json.dumps({"i": 59})
    assert len(ours["request_log_tail"]) == 50
    assert flightrec.config_fingerprint(config) == \
        ref_flightrec.config_fingerprint(config)
    for names in files:
        assert len(names) == 3
        assert sum("watchdog_stall" in n for n in names) == 2
        assert not any(n.endswith(".tmp") for n in names)
    with pytest.raises(ValueError):
        flightrec.FlightRecorder("")
