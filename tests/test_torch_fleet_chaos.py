"""The port's fleet chaos drills
(``distributed_tensorflow_example_tpu_torch/experiments/fleet_chaos.py``) on
the CPU: every scenario of the reference's ``tests/test_fleet_chaos.py``
over one shared export, again over int8 pools, the fleet seams' armed-but-
silent inertness, the flight recorder's armed-vs-plain parity, and the
CLI. Every scenario holds the survivors' bytes to the port's own
undisturbed engine run of the same export."""

import json
import os
import subprocess
import sys

import pytest
import torch

from distributed_tensorflow_example_tpu_torch.experiments import \
    fleet_chaos as fc
from distributed_tensorflow_example_tpu_torch.experiments import \
    serving_chaos as sc
from distributed_tensorflow_example_tpu_torch.runtime import faults

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=[None, "int8"],
                ids=["bf16_or_f32", "int8"])
def fleet_dir(request, tmp_path_factory):
    """(kv_cache_dtype, ONE ample-pool paged export, vocab), built once a
    pool dtype."""
    kv = request.param
    sc._RUN.update(device="cpu", kv_cache_dtype=kv)
    d = str(tmp_path_factory.mktemp("fleet"))
    vocab = sc.build_chaos_export(d, seed=0)
    return kv, d, vocab


def _run(fleet_dir, names):
    kv, d, vocab = fleet_dir
    results = fc.run_scenarios(names, seed=0, export_dir=d, vocab=vocab,
                               device="cpu", kv_cache_dtype=kv)
    bad = [r for r in results if not r["ok"]]
    assert not bad, f"fleet scenario(s) failed: {bad}"
    assert faults.active() is None            # no registry leaks forward
    return results


def test_fleet_kill_replica_mid_decode(fleet_dir):
    """Killing one of three replicas mid-wave: zero client-visible
    failures, bytes equal to an undisturbed run, the router retried."""
    (res,) = _run(fleet_dir, ["kill_replica_mid_decode"])
    assert res["metrics"]["router_retries_total"] >= 1
    assert "6/6 requests served to byte parity" in res["detail"]


def test_fleet_wedge_one_replica_watchdog(fleet_dir):
    """A wedged replica is demoted and routed around; its stalled
    watchdog writes exactly one incident bundle (from the wedged
    replica, asserted inside the scenario) whose registry snapshot
    matches its live /metrics page, with all three watchdogs at 0.2 s."""
    (res,) = _run(fleet_dir, ["wedge_one_replica_watchdog"])
    assert "one incident bundle" in res["detail"]
    assert "matches /metrics" in res["detail"]
    assert res["metrics"]["router_replica_healthy"] == 2


def test_fleet_breaker_trip_and_recover(fleet_dir):
    (res,) = _run(fleet_dir, ["breaker_trip_and_recover"])
    assert res["metrics"]["router_breaker_open_total"] >= 1
    assert res["metrics"]["router_incidents_total"] >= 2


def test_fleet_drain_under_load(fleet_dir):
    (res,) = _run(fleet_dir, ["drain_one_replica_under_load"])
    assert res["metrics"]["router_replica_healthy"] == 2


def test_fleet_hedge_cancels_loser(fleet_dir):
    """The hedged request's loser is cancelled (its blocks come back,
    asserted inside), and ``GET /trace/fleet`` is one stitched timeline
    in which the hedge span parents both attempts."""
    (res,) = _run(fleet_dir, ["hedge_cancels_loser"])
    assert res["metrics"]["router_hedges_total"] == 1
    assert res["metrics"]["router_hedge_wins_total"] == 1
    assert "stitched fleet trace" in res["detail"]
    assert "hedge parents both attempts" in res["detail"]


def test_router_seams_inert_when_silent(fleet_dir):
    """A fault registry whose fleet rules never fire leaves the fleet
    byte-identical to no registry, with zero retries, hedges, breaker
    opens and failovers."""
    kv, d, vocab = fleet_dir
    sc._RUN.update(device="cpu", kv_cache_dtype=kv)
    prompts = sc.seeded_prompts(3, 17, vocab)

    def run(spec):
        if spec:
            faults.install(faults.parse_spec(spec, seed=0))
        try:
            fleet = fc.make_fleet(d, 2)
            try:
                outs, _, errors = fc._drive_wave(fleet, prompts,
                                                 max_new=3)
                assert not errors, errors
                met = fc.router_counters(fleet)
                return outs, (met["router_retries_total"],
                              met["router_hedges_total"],
                              met["router_breaker_open_total"],
                              met["router_failovers_total"])
            finally:
                fleet.close()
        finally:
            faults.install(None)

    plain = run(None)
    armed = run("router.probe:step=999999;router.forward:step=999999;"
                "replica.crash:step=999999")
    assert plain == armed
    assert plain[1] == (0, 0, 0, 0)


def test_flight_recorder_off_is_byte_and_dispatch_identical(fleet_dir,
                                                            tmp_path):
    """A quiet fleet with the flight recorder on (ring + incident_dir)
    serves byte- and dispatch-identically to one with it off, and
    writes no bundle."""
    kv, d, vocab = fleet_dir
    sc._RUN.update(device="cpu", kv_cache_dtype=kv)
    prompts = sc.seeded_prompts(3, 23, vocab)
    inc_dir = str(tmp_path / "incidents")

    def run(server_kw, router_kw):
        fleet = fc.make_fleet(d, 2, server_kw=server_kw, **router_kw)
        try:
            # SEQUENTIAL requests: the idle least-outstanding tie-break
            # routes deterministically, so per-replica dispatch counts
            # compare across the two runs
            outs = [fc.router_post(fleet, p, max_new=3)["generations"][0]
                    for p in prompts]
            dispatch = []
            for i in range(2):
                g = fc.replica_stats(fleet, i)
                dispatch.append((g["decode_steps"], g["prefills"],
                                 g["requests_done"]))
            return outs, dispatch
        finally:
            fleet.close()

    armed = run({"incident_dir": inc_dir}, {"incident_dir": inc_dir})
    plain = run({"flight_recorder": False}, {"flight_recorder": False})
    assert armed[0] == plain[0], "flight recorder changed greedy bytes"
    assert armed[1] == plain[1], "flight recorder changed dispatch counts"
    assert not (os.path.isdir(inc_dir) and os.listdir(inc_dir)), \
        "a quiet run wrote incident bundles"


def test_cli_runs_and_reports():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m",
         "distributed_tensorflow_example_tpu_torch.experiments.fleet_chaos",
         "--device", "cpu", "--smoke", "--scenario",
         "hedge_cancels_loser,drain_one_replica_under_load"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    assert [r["scenario"] for r in lines[:-1]] == [
        "hedge_cancels_loser", "drain_one_replica_under_load"]
    assert all(r["ok"] for r in lines[:-1])
    assert lines[-1] == {"summary": True, "scenarios": 2, "failed": 0,
                         "max_new_cap": sc.MAX_NEW, "smoke": True}
    bad = subprocess.run(
        [sys.executable, "-m",
         "distributed_tensorflow_example_tpu_torch.experiments.fleet_chaos",
         "--device", "cpu", "--scenario", "nope"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode == 2 and "unknown scenario" in bad.stderr
