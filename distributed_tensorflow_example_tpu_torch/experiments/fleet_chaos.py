"""Fleet chaos drills on the port: seeded replica-level failures against
the router with asserted fleet-healing invariants (a port copy of
``experiments/fleet_chaos.py``, the fleet twin of
``experiments/serving_chaos.py``).

Each scenario starts a real in-process fleet (N
:class:`~..serving_http.PredictServer` replicas over ONE tiny seeded paged
export of the port behind one :class:`~..serving_router.ReplicaRouter`),
injects one replica-level failure through the :mod:`~..runtime.faults`
fleet seams (``router.probe`` / ``router.forward`` / ``replica.crash``) or
the fleet's own control surface (kill, wedge, drain, hedge), and asserts
the reference's contract:

- ``kill_replica_mid_decode``   — a seeded ``replica.crash`` hard-kills
                                  one replica while the wave is in
                                  flight: zero client-visible failures,
                                  every response byte-equal to an
                                  undisturbed single-engine run, the
                                  router retried or failed over, exactly
                                  one replica ends dead.
- ``wedge_one_replica_watchdog``— one replica's decode dispatch wedges:
                                  its /healthz flips stalled, the prober
                                  demotes it to degraded, the wave lands
                                  on the survivors to byte parity, the
                                  released replica is re-admitted, and
                                  the stalled watchdog writes exactly ONE
                                  ``watchdog_stall`` incident bundle (from
                                  the wedged replica) whose registry
                                  snapshot matches its live /metrics page.
- ``breaker_trip_and_recover``  — a crashed replica's breaker opens off
                                  the probe cadence (no client request
                                  eaten), traffic heals on the survivor,
                                  and after a restart the half-open probe
                                  closes the breaker; the router's flight
                                  recorder bundles ``breaker_open`` and
                                  ``replica_death``.
- ``drain_one_replica_under_load`` — a SIGTERM-equivalent drain of one
                                  replica mid-wave: its in-flight requests
                                  finish, new admissions route around the
                                  503 pushback without charging the retry
                                  budget, zero drops, bytes to parity, the
                                  drained replica ends dead.
- ``hedge_cancels_loser``       — a wedged primary makes the hedged second
                                  attempt win; the loser is cancelled
                                  through POST /cancel/<rid>, so the
                                  victim's ``blocks_free`` returns to
                                  baseline; the router's ``GET
                                  /trace/fleet`` is ONE stitched timeline
                                  in which the hedge span parents both
                                  attempts, each replica's engine spans
                                  sit in its own process group inside the
                                  router's window, and the loser's
                                  ``cancel`` span carries the request id.

The replicas run on ``--device`` (the card by default: bf16 weights, the
flash kernel's prefill and the paged decode kernel; ``cpu`` runs f32 and
the plain paths); ``--kv_cache_dtype int8`` runs them over int8 pools (the
int8 paged decode kernel on the card). Every replica is warmed under the
default watchdog threshold before a scenario tightens it, so a first
dispatch's kernel build and load cannot read as a stall.

Usage::

    python -m distributed_tensorflow_example_tpu_torch.experiments.\\
fleet_chaos [--scenario all] [--seed 0] [--device cpu] [--smoke]

One JSON line per scenario plus a summary line; exits nonzero on any
failed invariant.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import threading
import urllib.request

from ..runtime import faults
from .serving_chaos import (_RUN, MAX_NEW, _wait, build_chaos_export,
                            reference_run, seeded_prompts)


def _post(port: int, name: str, prompt, *, max_new: int, rid=None,
          timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:generate",
        data=json.dumps({"inputs": {"input_ids": [prompt.tolist()]},
                         "max_new": max_new}).encode(),
        headers={"Content-Type": "application/json",
                 **({"X-Request-Id": rid} if rid else {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def make_fleet(d: str, n: int, *, server_kw=None, **router_kw):
    """A started fleet on the run's device with chaos-friendly cadences:
    fast probes, fast dead-marking, prefix cache off (the scenarios
    assert EXACT ``blocks_free`` recovery, and cached prefixes
    legitimately retain block references)."""
    from ..serving_router import InProcessFleet
    router_kw.setdefault("probe_interval_s", 0.05)
    router_kw.setdefault("dead_after_probes", 2)
    router_kw.setdefault("retry_budget", 3)
    skw = dict(server_kw or {})
    skw.setdefault("prefix_cache", False)
    skw.setdefault("device", _RUN["device"])
    return InProcessFleet(d, n, server_kw=skw, **router_kw)


def router_post(fleet, prompt, *, max_new: int, rid=None, timeout=120):
    return _post(fleet.port, fleet.name, prompt, max_new=max_new,
                 rid=rid, timeout=timeout)


def replica_stats(fleet, i: int) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{fleet.servers[i].port}/stats",
            timeout=30) as r:
        return json.loads(r.read())["generate"]


def router_counters(fleet) -> dict:
    snap = fleet.router.registry.snapshot()
    return {k: rec["value"] for k, rec in snap.items()
            if rec["type"] in ("counter", "gauge")}


def _drive_wave(fleet, prompts, max_new: int):
    """Concurrent client wave via the router; returns (generations,
    served_by, errors) index-aligned with ``prompts``."""
    outs: list = [None] * len(prompts)
    served: list = [None] * len(prompts)
    errors: list = []

    def client(i):
        try:
            resp = router_post(fleet, prompts[i], max_new=max_new,
                               rid=f"wave-{i}")
            outs[i] = resp["generations"][0]
            served[i] = resp.get("served_by")
        except Exception as e:     # noqa: BLE001 — the invariant IS
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs, served, errors


# ---------------------------------------------------------------------------
# scenarios — each returns (detail, metrics)
# ---------------------------------------------------------------------------

def scenario_kill_replica_mid_decode(d: str, seed: int, vocab: int):
    prompts = seeded_prompts(6, seed + 10, vocab)
    ref = reference_run(d, prompts, max_new=8)
    # one-shot: the 3rd forwarded request's target replica is KILLED
    # (listener torn down, engine failed fast) while the rest of the
    # wave is in flight on it
    faults.install(faults.parse_spec("replica.crash:step=3", seed=seed))
    try:
        fleet = make_fleet(d, 3)
        try:
            outs, served, errors = _drive_wave(fleet, prompts,
                                               max_new=8)
            assert not errors, f"client-visible failures: {errors}"
            assert outs == ref, \
                "failover changed greedy bytes vs the undisturbed run"
            met = router_counters(fleet)
            assert met["router_retries_total"] >= 1, met
            _wait(lambda: list(
                fleet.router.replica_states().values()).count("dead")
                == 1, what="exactly one replica marked dead")
            dead = [n for n, s in
                    fleet.router.replica_states().items()
                    if s == "dead"]
            return (f"replica {dead[0]} killed mid-wave; 6/6 requests "
                    f"served to byte parity with "
                    f"{met['router_retries_total']} retry(ies), "
                    f"{met['router_failovers_total']} failover(s)",
                    met)
        finally:
            fleet.close()
    finally:
        faults.install(None)


def scenario_wedge_one_replica_watchdog(d: str, seed: int, vocab: int):
    prompts = seeded_prompts(4, seed + 11, vocab)
    ref = reference_run(d, prompts, max_new=6)
    # incident_dir arms the flight recorder's bundle writer: the stalled
    # watchdog must auto-dump exactly one bundle without anyone POSTing
    # /trace/start
    incident_dir = tempfile.mkdtemp(prefix="fleet-incidents-")
    fleet = make_fleet(d, 3, server_kw={"prefix_cache": False,
                                        "incident_dir": incident_dir})
    # warm every replica first: the FIRST prefill/decode dispatch pays
    # the kernels' build and load on the card (seconds), which a tight
    # watchdog would misread as a stall (and the flight recorder would
    # dutifully bundle) — so the fleet warms under the default 10 s
    # threshold,
    # THEN the watchdog tightens to 0.2 s so the wedge below is
    # detected fast (set_stall_after re-parks the idle wait and
    # settles the heartbeat before the tighter threshold applies)
    for srv in fleet.servers:
        _post(srv.port, srv.name, prompts[0], max_new=2)
    for srv in fleet.servers:
        srv.engine.set_stall_after(0.2)
    wedged, release = threading.Event(), threading.Event()
    srv0 = fleet.servers[0]
    orig = srv0.engine.sw.decode

    def wedge(feats):
        wedged.set()
        release.wait(timeout=60)
        return orig(feats)

    srv0.engine.sw.decode = wedge
    try:
        # wedge replica0 with a DIRECT request (an external actor —
        # the router never saw it), then prove the fleet routes around
        # the stalled watchdog
        direct: dict = {}

        def direct_post():
            try:
                direct["out"] = _post(srv0.port, srv0.name,
                                      prompts[0], max_new=6)
            except Exception as e:   # noqa: BLE001 — recorded
                direct["err"] = f"{type(e).__name__}: {e}"

        th = threading.Thread(target=direct_post)
        th.start()
        assert wedged.wait(timeout=30), "decode never dispatched"
        _wait(lambda: fleet.router.replica_states()["replica0"]
              == "degraded",
              what="prober demoting the wedged replica")
        outs, served, errors = _drive_wave(fleet, prompts, max_new=6)
        assert not errors, f"client-visible failures: {errors}"
        assert outs == ref, "survivor routing changed greedy bytes"
        assert set(filter(None, served)) <= {"replica1", "replica2"}, \
            f"a request landed on the wedged replica: {served}"
        _wait(lambda: router_counters(fleet)["router_replica_healthy"]
              == 2, what="gauge settling at 2 healthy survivors")
        # ---- flight recorder: the stalled watchdog must
        # have AUTO-written exactly one incident bundle for replica0
        # (cause=watchdog_stall, rate-limited past the probe cadence),
        # nobody having armed tracing via /trace/start
        _wait(lambda: glob.glob(os.path.join(incident_dir,
                                             "incident-*.json")),
              what="the watchdog-stall incident bundle appearing")
        bundles = sorted(glob.glob(os.path.join(incident_dir,
                                                "incident-*.json")))
        assert len(bundles) == 1, \
            f"expected exactly one bundle, got {bundles}"
        with open(bundles[0]) as f:
            bundle = json.load(f)
        assert bundle["cause"] == "watchdog_stall", bundle["cause"]
        assert bundle["process"] == "replica0", bundle["process"]
        assert bundle["spans"], "bundle carries no span history"
        assert bundle["health"]["status"] == "stalled", bundle["health"]
        # the bundle's registry snapshot must MATCH the wedged
        # replica's live /metrics page: the engine is frozen
        # mid-dispatch, so every serving_* counter/gauge is stable
        # between the bundle write and this scrape
        from ..obs import prom
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv0.port}/metrics",
                timeout=30) as r:
            page = prom.parse(r.read().decode())
        snap = bundle["registry"]
        compared = 0
        for name, rec in snap.items():
            if not name.startswith("serving_") \
                    or rec["type"] not in ("counter", "gauge"):
                continue
            if name.startswith("serving_incidents"):
                # the rate-limit suppression counter keeps moving with
                # every later probe of the still-stalled replica — the
                # one legitimately-live metric between bundle and scrape
                continue
            assert page.get(name) == rec["value"], \
                (name, rec["value"], page.get(name))
            compared += 1
        assert compared >= 10, f"only {compared} metrics compared"
        met = router_counters(fleet)
        release.set()
        th.join(timeout=60)
        assert direct.get("out") is not None, direct
        _wait(lambda: fleet.router.replica_states()["replica0"]
              == "healthy", what="released replica re-admitted")
        return (f"wedged replica0 demoted to degraded in-probe; 4/4 "
                f"requests served by survivors to byte parity; "
                "released replica re-admitted as healthy; watchdog "
                "stall auto-wrote one incident bundle whose registry "
                f"snapshot matches /metrics ({compared} metrics)", met)
    finally:
        release.set()
        fleet.close()
        shutil.rmtree(incident_dir, ignore_errors=True)


def scenario_breaker_trip_and_recover(d: str, seed: int, vocab: int):
    prompts = seeded_prompts(3, seed + 12, vocab)
    ref = reference_run(d, prompts, max_new=4)
    # the ROUTER's flight recorder rides this scenario — a
    # breaker opening and a replica death are incident causes, so the
    # crash below must auto-write router-side bundles
    incident_dir = tempfile.mkdtemp(prefix="router-incidents-")
    fleet = make_fleet(d, 2, breaker_threshold=2,
                       breaker_cooldown_s=0.2,
                       incident_dir=incident_dir)
    try:
        warm = router_post(fleet, prompts[0], max_new=4)
        assert warm["generations"][0] == ref[0]
        fleet.crash(0)
        rep0 = fleet.router.replicas[0]
        _wait(lambda: rep0.breaker.state == "open",
              what="breaker opening off the probe cadence")
        _wait(lambda: fleet.router.replica_states()["replica0"]
              == "dead", what="crashed replica marked dead")
        met = router_counters(fleet)
        assert met["router_breaker_open_total"] >= 1, met
        outs, served, errors = _drive_wave(fleet, prompts, max_new=4)
        assert not errors, f"failures while breaker open: {errors}"
        assert outs == ref, "survivor bytes diverged"
        assert set(filter(None, served)) == {"replica1"}, served
        fleet.restart(0)
        _wait(lambda: fleet.router.replica_states()["replica0"]
              == "healthy" and rep0.breaker.state == "closed",
              what="half-open probe closing the breaker")
        outs2, served2, errors2 = _drive_wave(fleet, prompts,
                                              max_new=4)
        assert not errors2 and outs2 == ref, (errors2, "parity")
        assert "replica0" in set(served2), \
            f"recovered replica took no traffic: {served2}"
        met = router_counters(fleet)
        # router flight recorder: the breaker open and the replica
        # death each wrote one bundle (distinct causes), counted in
        # the router registry
        bundles = sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(incident_dir, "incident-router-*.json")))
        causes = {b.split("-")[2] for b in bundles}
        assert {"breaker_open", "replica_death"} <= causes, bundles
        assert met["router_incidents_total"] == len(bundles) >= 2, \
            (met, bundles)
        return (f"crash opened replica0's breaker via probes "
                f"(opens={met['router_breaker_open_total']}); "
                "survivor served the wave to parity; restart + "
                "half-open probe closed the breaker and replica0 "
                "serves again; router flight recorder bundled "
                f"{sorted(causes)}", met)
    finally:
        fleet.close()
        shutil.rmtree(incident_dir, ignore_errors=True)


def scenario_drain_one_replica_under_load(d: str, seed: int,
                                          vocab: int):
    prompts = seeded_prompts(9, seed + 13, vocab)
    ref = reference_run(d, prompts, max_new=4)
    fleet = make_fleet(d, 3,
                       server_kw={"drain_timeout_s": 60.0,
                                  "prefix_cache": False})
    try:
        outs: list = [None] * len(prompts)
        errors: list = []

        def client(i):
            try:
                outs[i] = router_post(fleet, prompts[i],
                                      max_new=4)["generations"][0]
            except Exception as e:   # noqa: BLE001 — recorded
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads[:4]:
            t.start()
        # SIGTERM-equivalent mid-wave: replica0 drains gracefully
        # (listener up answering 503 while its in-flight work finishes)
        drainer = threading.Thread(
            target=lambda: fleet.servers[0].stop(drain=True))
        drainer.start()
        for t in threads[4:]:
            t.start()
        for t in threads:
            t.join()
        drainer.join(timeout=120)
        assert not errors, f"dropped requests under drain: {errors}"
        assert outs == ref, "drain changed greedy bytes"
        _wait(lambda: fleet.router.replica_states()["replica0"]
              == "dead", what="drained replica leaving the fleet")
        # the gauge is set once a probe sweep ends, after the states
        _wait(lambda: router_counters(fleet)["router_replica_healthy"]
              == 2, what="gauge settling at 2 healthy survivors")
        met = router_counters(fleet)
        assert met["router_replica_healthy"] == 2, met
        return ("9/9 requests to byte parity across a mid-wave "
                "graceful drain; drained replica excluded then dead; "
                "2 replicas left healthy", met)
    finally:
        fleet.close()


def scenario_hedge_cancels_loser(d: str, seed: int, vocab: int):
    prompts = seeded_prompts(1, seed + 14, vocab)
    ref = reference_run(d, prompts, max_new=4)
    fleet = make_fleet(d, 2, hedge_after_ms=60)
    wedged, release = threading.Event(), threading.Event()
    srv0 = fleet.servers[0]
    orig = srv0.engine.sw.decode

    def wedge(feats):
        wedged.set()
        release.wait(timeout=60)
        return orig(feats)

    try:
        free0 = replica_stats(fleet, 0)["blocks_free"]
        srv0.engine.sw.decode = wedge
        # both replicas idle -> the tie-break picks replica0, which
        # wedges; the hedge fires at 60 ms and replica1 wins
        resp = router_post(fleet, prompts[0], max_new=4,
                           rid="hedge-rid")
        assert wedged.is_set(), "primary never reached replica0"
        assert resp["generations"][0] == ref[0], \
            "hedged response diverged from the undisturbed run"
        assert resp["served_by"] == "replica1", resp["served_by"]
        assert resp["request_ids"] == ["hedge-rid"], \
            resp["request_ids"]
        met = router_counters(fleet)
        assert met["router_hedges_total"] == 1, met
        assert met["router_hedge_wins_total"] == 1, met
        # ---- the stitched fleet timeline: ONE Perfetto
        # trace in which the hedge span parents BOTH replica attempts,
        # each replica renders as its own process group with the
        # request's engine spans clock-corrected into the router's
        # window, and the loser's cancellation span carries the same
        # request id
        trace_id = resp["trace_id"]
        # the loser's "cancel" span is recorded by the router's
        # fire-and-forget cancel thread AFTER its POST resolves —
        # /trace/fleet DRAINS, so wait (non-destructively, via the
        # in-process ring) for the span to land before the one fetch
        from ..obs import trace as obs_trace
        _wait(lambda: any(
            s[2] == "cancel" for s in
            obs_trace.recorder().tail(256, process="router")),
            what="the loser's cancel span landing in the ring")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fleet.port}/trace/fleet",
                timeout=30) as r:
            stitched = json.loads(r.read())
        trace_detail = _assert_stitched_hedge(stitched, trace_id,
                                              "hedge-rid")
        release.set()
        # the loser was cancelled through POST /cancel/<rid>: its slot
        # and cache blocks must come back — NOT decode to max_new
        _wait(lambda: replica_stats(fleet, 0)["blocks_free"] == free0,
              what="loser replica's blocks_free returning to baseline")
        s0 = replica_stats(fleet, 0)
        assert s0["cancelled"] == 1, s0
        assert s0["requests_done"] == 0, s0
        return (f"hedge won on replica1 (bytes to parity, same "
                f"request id end-to-end); loser cancelled on "
                f"replica0 — blocks_free back to {free0}, "
                f"cancelled=1, requests_done=0; stitched fleet trace: "
                f"{trace_detail}", met)
    finally:
        release.set()
        fleet.close()


def _assert_stitched_hedge(stitched: dict, trace_id: str,
                           rid: str) -> str:
    """Structural contract of the hedge scenario's stitched timeline;
    returns a one-line description."""
    events = stitched["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    procs = {e["pid"]: e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    by_name = {name: pid for pid, name in procs.items()}
    assert {"router", "replica0", "replica1"} <= set(by_name), procs
    # router lane on top: the anchor export claims the first pid
    assert by_name["router"] < by_name["replica0"] \
        and by_name["router"] < by_name["replica1"], procs
    mine = [e for e in xs
            if (e.get("args") or {}).get("trace_id") == trace_id]
    assert mine, f"no spans for trace {trace_id}"

    def named(n):
        return [e for e in mine if e["name"] == n]

    root = named("request")
    assert len(root) == 1 and root[0]["pid"] == by_name["router"], root
    hedge = named("hedge")
    assert len(hedge) == 1, hedge
    hedge_sid = hedge[0]["args"]["span_id"]
    assert hedge[0]["args"]["parent_id"] == root[0]["args"]["span_id"]
    # the hedge span parents BOTH replica attempts: the launch markers
    # are the guaranteed-visible half (the wedged loser's completed
    # "forward" span only lands once its cancellation resolves — after
    # this fetch), and the winner's completed span must be there too
    launches = [e for e in named("forward_launch")
                if e["args"].get("parent_id") == hedge_sid]
    assert len(launches) == 2, launches
    assert {e["args"]["replica"] for e in launches} \
        == {"replica0", "replica1"}, launches
    done = [e for e in named("forward")
            if e["args"].get("parent_id") == hedge_sid]
    assert [e["args"]["replica"] for e in done] == ["replica1"], done
    assert done[0]["args"]["status"] == 200, done
    fwd_sids = {e["args"]["replica"]: e["args"]["span_id"]
                for e in launches}
    # each replica's engine spans land in ITS process group, parented
    # under that replica's forward attempt (the propagated traceparent)
    for rep in ("replica0", "replica1"):
        rep_spans = [e for e in mine if e["pid"] == by_name[rep]]
        assert rep_spans, f"no {rep} spans under trace {trace_id}"
        assert all(e["args"].get("parent_id") == fwd_sids[rep]
                   for e in rep_spans), (rep, rep_spans)
        assert all(e["args"].get("request_id") == rid
                   for e in rep_spans), (rep, rep_spans)
        # clock correction put the replica's spans inside the router's
        # request window (generous slack: the in-process offset
        # estimate is bounded by probe RTT)
        lo = root[0]["ts"] - 50_000            # µs
        hi = root[0]["ts"] + root[0]["dur"] + 50_000
        for e in rep_spans:
            assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, \
                (rep, e, root[0])
    # the winner retired; the loser (cancelled mid-decode) did not
    winner_names = {e["name"] for e in mine
                    if e["pid"] == by_name["replica1"]}
    assert "retire" in winner_names, winner_names
    # the loser's cancellation is visible with the SAME request id
    cancels = [e for e in named("cancel")
               if e["args"].get("request_id") == rid]
    assert cancels and cancels[0]["args"]["parent_id"] == hedge_sid \
        and cancels[0]["args"]["replica"] == "replica0", cancels
    offs = stitched["metadata"]["clock_offsets_s"]
    assert {"replica0", "replica1"} <= set(offs), offs
    assert all(abs(v) < 0.1 for v in offs.values()), offs
    return (f"{len(mine)} spans across {len(procs)} process groups, "
            f"hedge parents both attempts, cancel visible "
            f"(offsets {offs})")


SCENARIOS = {
    "kill_replica_mid_decode": scenario_kill_replica_mid_decode,
    "wedge_one_replica_watchdog": scenario_wedge_one_replica_watchdog,
    "breaker_trip_and_recover": scenario_breaker_trip_and_recover,
    "drain_one_replica_under_load": scenario_drain_one_replica_under_load,
    "hedge_cancels_loser": scenario_hedge_cancels_loser,
}


def run_scenarios(names, *, seed: int, export_dir: str | None = None,
                  vocab: int | None = None, device=None,
                  kv_cache_dtype: str | None = None) -> list[dict]:
    """Build the shared ample-pool export (unless the caller passes a
    pre-built one, made with the same ``device`` and ``kv_cache_dtype``),
    run ``names`` on ``device`` (the card by default), and return one
    result dict per scenario."""
    from ..runtime.device import resolve_device
    _RUN.update(device=str(resolve_device(device)),
                kv_cache_dtype=kv_cache_dtype)
    results = []
    with tempfile.TemporaryDirectory() as scratch:
        d = export_dir
        if d is None:
            d = os.path.join(scratch, "fleet")
            vocab = build_chaos_export(d, seed=seed)
        assert vocab is not None, \
            "pass vocab= alongside a pre-built export dir"
        for name in names:
            try:
                detail, met = SCENARIOS[name](d, seed, vocab)
                results.append({"scenario": name, "ok": True,
                                "detail": detail, "metrics": met})
            except Exception as e:   # a failed invariant is the signal
                results.append({"scenario": name, "ok": False,
                                "detail": f"{type(e).__name__}: {e}",
                                "metrics": {}})
            finally:
                faults.install(None)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="all",
                    help="comma-separated scenario names, or 'all': "
                         + ", ".join(SCENARIOS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's flag (the fleets are already "
                    "tiny; --smoke changes nothing today)")
    ap.add_argument("--device", default=None,
                    help="torch device of the replicas (default cuda; "
                    "cpu runs without a GPU)")
    ap.add_argument("--kv_cache_dtype", choices=("auto", "int8"),
                    default="auto",
                    help="the export's KV pool dtype: auto (the model's) "
                    "or int8 pools with f32 scales")
    args = ap.parse_args(argv)
    names = (list(SCENARIOS) if args.scenario == "all"
             else [s.strip() for s in args.scenario.split(",")
                   if s.strip()])
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        ap.error(f"unknown scenario(s) {unknown}; have {list(SCENARIOS)}")
    results = run_scenarios(names, seed=args.seed, device=args.device,
                            kv_cache_dtype=(None if args.kv_cache_dtype
                                            == "auto" else "int8"))
    for r in results:
        print(json.dumps(r), flush=True)
    failed = sum(1 for r in results if not r["ok"])
    print(json.dumps({"summary": True, "scenarios": len(results),
                      "failed": failed, "max_new_cap": MAX_NEW,
                      "smoke": bool(args.smoke)}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
