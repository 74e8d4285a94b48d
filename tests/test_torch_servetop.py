"""The port's ``tools/servetop.py`` on the CPU, case for case as the
reference's ``tests/test_servetop.py`` (``compute_summary`` on fabricated
payloads, the windowed and fleet views, the text frame, the offline
``--file`` mode), held to the reference's ``tools/servetop.py`` on the
same payloads, and one frame taken live off a port router's
``/stats/history``."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu_torch.experiments import \
    serving_chaos as sc
from distributed_tensorflow_example_tpu_torch.obs.registry import Registry
from distributed_tensorflow_example_tpu_torch.serving_router import \
    InProcessFleet
from distributed_tensorflow_example_tpu_torch.tools import servetop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import servetop as jservetop  # noqa: E402

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


def _snap(interactive=(0, 0), best_effort=(0, 0), tokens=0,
          goodput=0, shed_be=0, queue=0, pressure=0):
    reg = Registry()
    for cls, (served, good) in (("interactive", interactive),
                                ("batch", (0, 0)),
                                ("best_effort", best_effort)):
        reg.counter(f"serving_slo_served_{cls}_total").inc(served)
        reg.counter(f"serving_slo_good_{cls}_total").inc(good)
        reg.histogram(f"serving_latency_{cls}_seconds",
                      buckets=(0.1, 1.0))
    reg.counter("serving_slo_served_total").inc(
        interactive[0] + best_effort[0])
    reg.counter("serving_slo_good_total").inc(
        interactive[1] + best_effort[1])
    reg.counter("serving_tokens_out_total").inc(tokens)
    reg.counter("serving_goodput_tokens_total").inc(goodput)
    reg.counter("serving_shed_total").inc(shed_be)
    reg.counter("serving_shed_interactive_total")
    reg.counter("serving_shed_batch_total")
    reg.counter("serving_shed_best_effort_total").inc(shed_be)
    reg.gauge("serving_queue_depth").set(queue)
    reg.gauge("serving_queue_age_seconds").set(0.0)
    reg.gauge("serving_pressure_level").set(pressure)
    return reg.snapshot()


@pytest.fixture
def payload():
    return {
        "enabled": True, "process": "serving", "clock": 20.0,
        "interval_s": 10.0,
        "samples": [
            [0.0, _snap()],
            [10.0, _snap(interactive=(4, 4), tokens=40, goodput=40)],
            [20.0, _snap(interactive=(8, 7), best_effort=(4, 2),
                         tokens=100, goodput=80, shed_be=2,
                         queue=3, pressure=1)],
        ],
        "slo": {"results": [
            {"class": "best_effort", "kind": "hit_rate",
             "target": 0.9, "goal": 0.9, "attainment": 0.5,
             "burn_fast": 5.0, "burn_slow": 5.0, "breach": True}]},
    }


def test_compute_summary_is_exact(payload):
    s = servetop.compute_summary(payload)
    assert s["enabled"] and s["samples"] == 3
    assert s["window_s"] == 20.0
    assert s["throughput_tps"] == pytest.approx(5.0)
    assert s["goodput_tps"] == pytest.approx(4.0)
    assert s["served"] == 12 and s["good"] == 9
    assert s["goodput_tokens"] == 80 and s["tokens"] == 100
    assert s["queue_depth"] == 3
    assert s["pressure"] == "shed_best_effort"
    ci = s["classes"]["interactive"]
    assert (ci["served"], ci["good"], ci["shed"]) == (8, 7, 0)
    assert ci["attainment"] == pytest.approx(7 / 8)
    cb = s["classes"]["best_effort"]
    assert (cb["served"], cb["good"], cb["shed"]) == (4, 2, 2)
    assert s["classes"]["batch"]["attainment"] is None
    assert s["slo"][0]["breach"] is True


def test_compute_summary_windowed(payload):
    s = servetop.compute_summary(payload, window_s=10.0)
    assert s["served"] == 8 and s["tokens"] == 60
    assert s["classes"]["interactive"]["served"] == 4


def test_compute_summary_fleet_breakdown(payload):
    payload["process"] = "router"
    payload["replicas"] = {
        "replica0": {"enabled": True, "clock_offset_s": 0.000123,
                     "samples": payload["samples"]},
        "replica1": {"error": "ConnectionRefusedError: dead"},
    }
    s = servetop.compute_summary(payload)
    r0 = s["replicas"]["replica0"]
    assert r0["served"] == 12
    assert r0["attainment"] == pytest.approx(9 / 12)
    assert r0["clock_offset_s"] == 0.000123
    assert "error" in s["replicas"]["replica1"]


def test_render_frame_mentions_the_story(payload):
    payload["replicas"] = {
        "replica0": {"enabled": True, "clock_offset_s": 0.0,
                     "samples": payload["samples"]}}
    text = servetop.render(servetop.compute_summary(payload))
    for needle in ("goodput", "interactive", "best_effort",
                   "BREACH", "replica0", "shed_best_effort"):
        assert needle in text, needle
    off = servetop.render(servetop.compute_summary(
        {"enabled": False, "process": "serving", "samples": []}))
    assert "--history_interval_s" in off


def test_main_offline_file_mode(tmp_path, capsys, payload):
    p = tmp_path / "hist.json"
    p.write_text(json.dumps(payload))
    assert servetop.main(["--file", str(p)]) == 0
    out = capsys.readouterr().out
    assert "servetop — serving" in out
    assert servetop.main(["--file", str(p), "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["served"] == 12
    assert servetop.main(["--file", str(p), "--json",
                          "--window", "10"]) == 0
    assert json.loads(capsys.readouterr().out)["served"] == 8


def _random_payload(seed: int) -> dict:
    """A seeded history of monotone counters over uneven sample times,
    with a fleet breakdown (one replica failing)."""
    rs = np.random.RandomState(seed)
    t, acc, samples = 0.0, np.zeros(6, int), []
    for _ in range(int(rs.randint(2, 9))):
        acc += rs.randint(0, 5, 6)
        inter = (int(acc[0] + acc[1]), int(acc[0]))
        be = (int(acc[2] + acc[3]), int(acc[2]))
        samples.append([t, _snap(interactive=inter, best_effort=be,
                                 tokens=int(acc[4] * 7),
                                 goodput=int(acc[4] * 5),
                                 shed_be=int(acc[5]),
                                 queue=int(rs.randint(0, 9)),
                                 pressure=int(rs.randint(0, 4)))])
        t += float(rs.uniform(0.5, 4.0))
    return {"enabled": True, "process": "router", "clock": t,
            "samples": samples,
            "replicas": {"replica0": {"enabled": True,
                                      "clock_offset_s": float(rs.rand()),
                                      "samples": samples[1:]},
                         "replica1": {"error": "URLError: refused"}}}


@pytest.mark.parametrize("window", [None, 3.0], ids=["ring", "window"])
@pytest.mark.parametrize("seed", range(4))
def test_summary_and_frame_equal_the_references(seed, window):
    """The same payload through both packages' ``compute_summary`` and
    ``render``: equal summaries, equal text frames."""
    payload = _random_payload(seed)
    mine = servetop.compute_summary(payload, window_s=window)
    ref = jservetop.compute_summary(payload, window_s=window)
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    assert servetop.render(mine) == jservetop.render(ref)


def test_live_frame_off_a_port_router(tmp_path, capsys):
    """One ``--frames 1`` frame off a 2-replica port router's
    ``/stats/history``: the fleet rollup and both replicas' rows."""
    sc._RUN.update(device="cpu", kv_cache_dtype=None)
    d = str(tmp_path / "fleet")
    vocab = sc.build_chaos_export(d, seed=0)
    prompts = sc.seeded_prompts(2, 3, vocab)
    with InProcessFleet(d, 2, server_kw={"device": "cpu",
                                         "history_interval_s": 0.05},
                        probe_interval_s=0.05) as fleet:
        from distributed_tensorflow_example_tpu_torch.experiments import \
            fleet_chaos
        for p in prompts:
            fleet_chaos.router_post(fleet, p, max_new=3)
        url = f"http://127.0.0.1:{fleet.port}"
        assert servetop.main(["--url", url, "--frames", "1"]) == 0
        frame = capsys.readouterr().out
        assert servetop.main(["--url", url, "--frames", "1",
                              "--json"]) == 0
        s = json.loads(capsys.readouterr().out)
    assert frame.startswith("servetop — router")
    assert "replica0" in frame and "replica1" in frame
    assert s["process"] == "router" and s["samples"] >= 1
    assert set(s["replicas"]) == {"replica0", "replica1"}
    assert sum(r["served"] for r in s["replicas"].values()) <= len(prompts)
