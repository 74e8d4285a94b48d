"""``utils/trace_summary.py`` on the port's traces: a hand-written Chrome
trace with overlapping events (the interval union against the naive sum,
the kernel families by name, the paged combine kernel attributed to its
split), a server's ``/trace/export`` payload, a real CPU ``torch.profiler``
capture, and the CLI."""

import json
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from distributed_tensorflow_example_tpu_torch.obs import trace
from distributed_tensorflow_example_tpu_torch.utils import trace_summary as ts

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


def _x(name, ts_us, dur, pid=1, tid=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts_us, "dur": dur}


HAND = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "gpu"}},
    {"ph": "M", "name": "thread_name", "pid": 1, "tid": 7,
     "args": {"name": "stream 7"}},
    # stream 7: [0, 10) and [5, 20) overlap -> union 20, naive 25
    _x("void flash_fwd_kernel<64>(...)", 0, 10),
    _x("void paged::split_kernel<64, false>(...)", 5, 15),
    _x("void paged::combine_kernel<64>(...)", 30, 2),
    _x("void paged::split_kernel<64, true>(...)", 40, 4),
    _x("void paged::combine_kernel<64>(...)", 45, 1),
    _x("nvjet_tst_64x8_64x16_4x1_v_bz_NNT", 50, 6),
    _x("void at::native::vectorized_elementwise_kernel<4>(...)", 60, 3),
    _x("Memcpy HtoD (Pageable -> Device)", 70, 2, cat="gpu_memcpy"),
    _x("void (anonymous namespace)::score_kernel<64>(...)", 80, 1),
    _x("void flash_bwd_dq_kernel<64>(...)", 90, 1),
    _x("void flash_bwd_dkv_kernel<64>(...)", 92, 1),
    _x("void flash_bwd_fused_kernel<64>(...)", 94, 1),
    _x("void at::native::reduce_kernel<512, 1>(...)", 96, 2),
    # a host lane: nested CPU ops
    _x("aten::matmul", 0, 100, pid=2, tid=3, cat="cpu_op"),
    _x("aten::mm", 10, 50, pid=2, tid=3, cat="cpu_op"),
]}


def test_hand_trace_union_families_and_top_ops():
    s = ts.summarize_trace(HAND, top=3)
    lanes = {r["lane"]: r for r in s["lanes"]}
    gpu = lanes["gpu/stream 7"]
    assert gpu["events"] == 13
    assert gpu["naive_ms"] == pytest.approx(0.049)
    assert gpu["busy_ms"] == pytest.approx(0.044)        # [0, 20) once
    host = lanes["2/3"]
    assert host["busy_ms"] == pytest.approx(0.1)
    assert host["naive_ms"] == pytest.approx(0.15)
    dev = s["device"]
    assert dev["families_count"] == {"B1": 1, "B2a": 1, "B2b": 1, "B3": 1,
                                     "B4": 1, "B5": 2, "B6": 2, "gemm": 1,
                                     "elementwise": 1, "copy": 1,
                                     "other": 1}
    assert dev["families_ms"]["B5"] == pytest.approx(0.017)
    assert dev["families_ms"]["B6"] == pytest.approx(0.005)
    assert dev["total_ms"] == pytest.approx(0.049)
    assert dev["busy_ms"] == pytest.approx(0.044)
    assert sum(dev["families_share"].values()) == pytest.approx(1.0, abs=1e-5)
    assert [o["op"] for o in s["top_ops"]] == [
        "void paged::split_kernel<64, false>(...)",
        "void flash_fwd_kernel<64>(...)",
        "nvjet_tst_64x8_64x16_4x1_v_bz_NNT"]
    for spans, want_us in (([], 0), ([(0, 5)], 5),
                           ([(0, 5), (5, 10), (2, 3)], 10),
                           ([(6, 10), (0, 6)], 10), ([(0, 2), (3, 4)], 3)):
        assert ts.union_ms(spans) == pytest.approx(want_us / 1e3)


def test_trace_export_payload():
    """A server's ``/trace/export`` rows: lanes are (process, lane),
    seconds become milliseconds, no device section."""
    payload = {"process": "serving", "spans": [
        ["serving", "scheduler", "decode_step", 1.0, 1.010, {"slots": 2}],
        ["serving", "scheduler", "decode_step", 1.005, 1.020, None],
        ["serving", "slot0", "prefill", 0.990, 1.000, None]]}
    s = ts.summarize_trace(payload)
    assert s["source"] == "trace_export" and "device" not in s
    lanes = {r["lane"]: r for r in s["lanes"]}
    assert lanes["serving/scheduler"]["busy_ms"] == pytest.approx(20.0)
    assert lanes["serving/scheduler"]["naive_ms"] == pytest.approx(25.0)
    assert s["top_ops"][0]["op"] == "decode_step"
    assert s["top_ops"][0]["count"] == 2


def test_recorder_chrome_dump_and_real_cpu_profile(tmp_path):
    """The span ring's own Chrome dump (``/trace/stop``), and a real
    ``torch.profiler`` capture on the CPU (``ProfilerHook``'s format):
    lanes named by their metadata, busy no more than the naive sum, the
    matmuls among the top ops."""
    rec = trace.TraceRecorder(16)
    rec.start()
    rec.add("serving", "scheduler", "decode_step", rec._t0, rec._t0 + 0.002)
    rec.add("serving", "scheduler", "decode_step", rec._t0 + 0.001,
            rec._t0 + 0.004)
    s = ts.summarize_trace(rec.to_chrome())
    assert s["lanes"][0]["lane"] == "serving/scheduler"
    assert s["lanes"][0]["busy_ms"] == pytest.approx(4.0, rel=1e-3)

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            torch.relu(a @ a)
    path = str(tmp_path / "cpu_trace.json")
    prof.export_chrome_trace(path)
    out = ts.summarize(path, top=10)
    assert list(out) == ["cpu_trace.json"]
    s = out["cpu_trace.json"]
    assert s["source"] == "chrome" and s["events"] > 6
    assert all(r["busy_ms"] <= r["naive_ms"] + 1e-9 for r in s["lanes"])
    ops = {o["op"]: o["count"] for o in s["top_ops"]}
    assert ops.get("aten::mm") == 3 and ops.get("aten::relu") == 3
    assert "device" not in s                    # no kernel on the CPU


def test_cli_text_and_json(tmp_path):
    path = tmp_path / "hand.json"
    path.write_text(json.dumps(HAND))
    run = [sys.executable, "-m",
           "distributed_tensorflow_example_tpu_torch.utils.trace_summary",
           str(tmp_path)]
    text = subprocess.run(run + ["--top", "2"], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    assert "lane 'gpu/stream 7'" in text and "B5" in text
    js = json.loads(subprocess.run(run + ["--json"], capture_output=True,
                                   text=True, timeout=120,
                                   check=True).stdout)
    assert js["hand.json"]["device"]["families_count"]["B6"] == 2
    with pytest.raises(FileNotFoundError):
        ts.summarize(str(tmp_path / "nothing_here"))
