"""The port's fleet trace stitcher (``obs/stitch.py``) and
``utils/trace_summary.py --fleet`` on the CPU, case for case as the
stitch half of the reference's ``tests/test_obs_stitch.py`` (clock offsets
from injected clocks, the stitched timeline, the one-trace slice, the
offline summary), and held to the reference's functions on the same
exports: equal offsets, equal stitched JSON, equal summaries and equal
``--fleet`` text. The clocks are injected: in-process replicas share one
``perf_counter``, so their real offsets are about 0 and would not test the
correction."""

import json

import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.obs import stitch as jstitch
from distributed_tensorflow_example_tpu.utils import \
    trace_summary as jtrace_summary
from distributed_tensorflow_example_tpu_torch.obs import stitch
from distributed_tensorflow_example_tpu_torch.utils import trace_summary

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


# ------------------------------------------------------ offset estimate
def test_estimate_offset_median_from_injected_clocks():
    """offset = remote_now - probe midpoint; the median over samples
    rejects the occasional slow (asymmetric-delay) probe."""
    samples = [(t, t + 0.002, (t + 0.001) + 100.0)
               for t in (5.0, 6.0, 7.0, 8.0)]
    assert stitch.estimate_offset(samples) == pytest.approx(100.0)
    samples.append((9.0, 14.0, 9.001 + 100.0))
    assert stitch.estimate_offset(samples) == pytest.approx(100.0,
                                                            abs=1e-6)
    assert stitch.estimate_offset([]) == 0.0


def test_estimate_offset_negative_and_even_count():
    samples = [(t, t + 0.01, (t + 0.005) - 40.0) for t in (1.0, 2.0)]
    assert stitch.estimate_offset(samples) == pytest.approx(-40.0)


@pytest.mark.parametrize("seed", range(5))
def test_estimate_offset_equals_reference(seed):
    rs = np.random.RandomState(seed)
    off = float(rs.uniform(-1e3, 1e3))
    n = int(rs.randint(0, 12))
    samples = []
    for _ in range(n):
        t0 = float(rs.uniform(0, 100))
        rtt = float(rs.exponential(0.01))
        samples.append((t0, t0 + rtt, t0 + rtt * rs.rand() + off))
    assert stitch.estimate_offset(samples) == \
        jstitch.estimate_offset(samples)


# -------------------------------------------------------------- stitch
def _export(process, spans, clock=0.0):
    return {"process": process, "clock": clock,
            "spans": [list(s) for s in spans], "events_dropped": 0}


def test_stitch_corrects_clocks_and_orders_processes():
    """Two processes whose clocks differ by exactly +100 s: after
    correction the replica's span nests inside the router's request
    window, the router claims the FIRST pid (top lane), and the
    metadata records the applied offsets."""
    router = _export("router", [
        ("router", "req r1", "request", 10.0, 11.0,
         {"trace_id": "t1", "span_id": "root"})])
    replica = _export("replica0", [
        ("replica0", "slot0", "decode", 110.2, 110.9,
         {"trace_id": "t1", "parent_id": "fwd"})])
    out = stitch.stitch([router, replica],
                        offsets={"router": 0.0, "replica0": 100.0})
    assert json.loads(json.dumps(out))
    procs = {e["pid"]: e["args"]["name"]
             for e in out["traceEvents"]
             if e.get("name") == "process_name"}
    assert procs[1] == "router" and procs[2] == "replica0"
    xs = {e["name"]: e for e in out["traceEvents"] if e["ph"] == "X"}
    root, dec = xs["request"], xs["decode"]
    assert root["ts"] == 0.0
    assert root["ts"] <= dec["ts"]
    assert dec["ts"] + dec["dur"] <= root["ts"] + root["dur"]
    assert dec["args"]["parent_id"] == "fwd"
    assert out["metadata"]["clock_offsets_s"]["replica0"] == 100.0
    assert out["metadata"]["processes"] == ["router", "replica0"]


def test_spans_for_trace_and_summarize_fleet():
    router = _export("router", [
        ("router", "req r1", "request", 0.0, 1.0,
         {"trace_id": "t1"}),
        ("router", "req r2", "request", 0.5, 0.9,
         {"trace_id": "t2"})])
    replica = _export("replica0", [
        ("replica0", "slot0", "decode", 0.2, 0.8,
         {"trace_id": "t1"}),
        ("replica0", "scheduler", "decode_step", 0.2, 0.3, None)])
    out = stitch.stitch([router, replica])
    assert {e["args"]["trace_id"]
            for e in stitch.spans_for_trace(out, "t1")} == {"t1"}
    assert len(stitch.spans_for_trace(out, "t1")) == 2
    s = stitch.summarize_fleet(out)
    assert set(s["processes"]) == {"router", "replica0"}
    assert s["processes"]["replica0"]["spans"] == 2
    assert "decode_step" in s["span_names"]
    assert set(s["traces"]) == {"t1", "t2"}
    assert s["traces"]["t1"]["processes"] == ["replica0", "router"]
    assert s["traces"]["t1"]["duration_ms"] == pytest.approx(1000.0)


def _fleet_exports(seed: int):
    """A router export and three replica exports on clocks offset by a
    seeded amount each, with traced and untraced spans on several
    lanes, and the offsets that correct them."""
    rs = np.random.RandomState(seed)
    offsets = {"router": 0.0}
    exports = []
    names = ["router", "replica0", "replica1", "replica2"]
    for p in names:
        off = 0.0 if p == "router" else float(rs.uniform(-500, 500))
        offsets[p] = off
        spans = []
        for _ in range(int(rs.randint(1, 9))):
            t0 = float(rs.uniform(0, 2)) + off
            args = None
            if rs.rand() < 0.7:
                args = {"trace_id": f"t{int(rs.randint(0, 3))}",
                        "span_id": f"s{int(rs.randint(0, 1000))}",
                        "request_id": f"r{int(rs.randint(0, 3))}"}
            spans.append((p, f"lane{int(rs.randint(0, 3))}",
                          str(rs.choice(["request", "forward", "prefill",
                                         "decode", "retire"])),
                          t0, t0 + float(rs.exponential(0.1)), args))
        exports.append(_export(p, spans, clock=3.0 + off))
        exports[-1]["events_dropped"] = int(rs.randint(0, 3))
    return exports, offsets


@pytest.mark.parametrize("seed", range(4))
def test_stitch_and_summary_equal_the_references(seed):
    """The same exports and offsets through both packages: the stitched
    timeline, every trace's slice and the offline summary are equal as
    JSON."""
    exports, offsets = _fleet_exports(seed)
    mine = stitch.stitch(exports, offsets=offsets)
    ref = jstitch.stitch(exports, offsets=offsets)
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    for t in ("t0", "t1", "t2"):
        assert stitch.spans_for_trace(mine, t) == \
            jstitch.spans_for_trace(ref, t)
    assert json.dumps(stitch.summarize_fleet(mine), sort_keys=True) == \
        json.dumps(jstitch.summarize_fleet(ref), sort_keys=True)


# ------------------------------------------------- trace_summary --fleet
def test_trace_summary_fleet_mode(tmp_path, capsys):
    """``trace_summary --fleet stitched.json`` summarizes a stitched
    export offline, text and --json forms."""
    out = stitch.stitch([
        _export("router", [("router", "req r1", "request", 0.0, 1.0,
                            {"trace_id": "t1"})]),
        _export("replica0", [("replica0", "slot0", "decode", 100.3,
                              100.7, {"trace_id": "t1"})]),
    ], offsets={"replica0": 100.0})
    path = tmp_path / "stitched.json"
    path.write_text(json.dumps(out))
    assert trace_summary.main(["--fleet", str(path)]) == 0
    text = capsys.readouterr().out
    assert "process 'router'" in text and "process 'replica0'" in text
    assert "trace t1" in text and "replica0=100.0" in text
    assert trace_summary.main(["--fleet", str(path), "--json"]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["traces"]["t1"]["spans"] == 2
    assert s["clock_offsets_s"]["replica0"] == 100.0


@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
@pytest.mark.parametrize("seed", range(3))
def test_trace_summary_fleet_equals_the_references(tmp_path, capsys,
                                                   seed, as_json):
    exports, offsets = _fleet_exports(seed)
    path = tmp_path / "stitched.json"
    path.write_text(json.dumps(stitch.stitch(exports, offsets=offsets)))
    argv = ["--fleet", str(path)] + (["--json"] if as_json else [])
    assert trace_summary.main(argv) == 0
    mine = capsys.readouterr().out
    assert jtrace_summary.main(argv) == 0
    ref = capsys.readouterr().out
    assert mine == ref and mine.strip()
