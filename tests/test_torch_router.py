"""The port's replica router (``serving_router.py``) on the CPU, case for
case as the reference's ``tests/test_serving_router.py``: the breaker
state machine (injected clock), the routing policy, request ids across a
failover, pushback, hedging, the fleet's ``/metrics``, ``/stats`` and
``/healthz``, and the CLI. The router's pure host logic is also held to
the reference's directly (the same event sequence, replica states and
seed through both packages), and a 2-replica port fleet's greedy bytes
to the port's single server's and, on bridged weights, to the reference
engine's."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import serving as jserving
from distributed_tensorflow_example_tpu import serving_batch as jbatch
from distributed_tensorflow_example_tpu import serving_router as jrouter
from distributed_tensorflow_example_tpu.ckpt.checkpoint import _flatten
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu_torch import serving_router
from distributed_tensorflow_example_tpu_torch.experiments import \
    serving_chaos as sc
from distributed_tensorflow_example_tpu_torch.models.gpt import (
    GPT, GPTConfig, params_from_numpy)
from distributed_tensorflow_example_tpu_torch.obs import prom
from distributed_tensorflow_example_tpu_torch.obs import trace as obs_trace
from distributed_tensorflow_example_tpu_torch.obs.registry import (
    Registry, merge_snapshots)
from distributed_tensorflow_example_tpu_torch.runtime import faults
from distributed_tensorflow_example_tpu_torch.serving import export_generator
from distributed_tensorflow_example_tpu_torch.serving_http import \
    PredictServer
from distributed_tensorflow_example_tpu_torch.serving_router import (
    CircuitBreaker, ForwardError, InProcessFleet, Replica, ReplicaRouter)

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def fleet_dir(tmp_path_factory):
    """ONE tiny paged export shared by every HTTP-level router test."""
    sc._RUN.update(device="cpu", kv_cache_dtype=None)
    d = str(tmp_path_factory.mktemp("router"))
    vocab = sc.build_chaos_export(d, seed=0)
    return d, vocab


def _fleet(d, n, **kw):
    return InProcessFleet(d, n, server_kw=dict(CPU), **kw)


def _wait(pred, timeout=30.0, what="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def _post(port, name, payload, request_id=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json",
                 **({"X-Request-Id": request_id} if request_id
                    else {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# the breaker state machine, deterministic through an injected clock
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_breaker_opens_on_consecutive_threshold():
    clk = FakeClock()
    b = CircuitBreaker(threshold=3, cooldown_s=5.0, clock=clk)
    assert b.state == "closed" and b.allow()
    assert b.record_failure() is False
    assert b.record_failure() is False
    assert b.record_failure() is True        # 3rd consecutive: opens
    assert b.state == "open"
    assert not b.allow()                     # cooling down
    # a success resets the consecutive count while closed
    b2 = CircuitBreaker(threshold=3, cooldown_s=5.0, clock=clk)
    b2.record_failure()
    b2.record_failure()
    b2.record_success()
    assert b2.record_failure() is False and b2.state == "closed"


def test_breaker_opens_on_error_rate():
    clk = FakeClock()
    b = CircuitBreaker(threshold=100, error_rate=0.5, window=8,
                       min_samples=6, cooldown_s=5.0, clock=clk)
    opened = False
    for _ in range(4):
        b.record_success()
        opened = b.record_failure() or opened
    assert opened and b.state == "open"


def test_breaker_half_open_single_probe_then_close():
    clk = FakeClock()
    b = CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clk)
    assert b.record_failure() is True and b.state == "open"
    assert not b.allow()                     # cooldown not elapsed
    clk.advance(5.1)
    assert b.allow()                         # THE half-open probe
    assert b.state == "half_open"
    assert not b.allow()                     # single probe at a time
    b.record_success()
    assert b.state == "closed" and b.allow()


def test_breaker_reopens_on_probe_failure():
    clk = FakeClock()
    b = CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clk)
    b.record_failure()
    clk.advance(5.1)
    assert b.allow() and b.state == "half_open"
    assert b.record_failure() is True        # probe failed: re-open
    assert b.state == "open" and not b.allow()
    clk.advance(5.1)                         # cooldown restarted
    assert b.allow() and b.state == "half_open"


def test_breaker_rejects_bad_params():
    with pytest.raises(ValueError, match="threshold"):
        CircuitBreaker(threshold=0)
    with pytest.raises(ValueError, match="error_rate"):
        CircuitBreaker(error_rate=1.5)


def _events(seed: int, n: int = 60) -> list:
    """A seeded sequence of breaker events: outcomes, allow() calls and
    clock advances."""
    rs = np.random.RandomState(seed)
    return [("ok", "fail", "allow", "tick")[int(rs.choice(
        4, p=[0.3, 0.35, 0.2, 0.15]))] for _ in range(n)]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("params", [
    dict(threshold=3, cooldown_s=1.0),
    dict(threshold=100, error_rate=0.5, window=8, min_samples=6,
         cooldown_s=0.5),
    dict(threshold=1, cooldown_s=0.0)], ids=["consecutive", "rate",
                                             "hair_trigger"])
def test_breaker_matches_reference_event_for_event(params, seed):
    """The same event sequence through both packages' breakers gives the
    same return values and states after every event."""
    clocks = (FakeClock(), FakeClock())
    mine = CircuitBreaker(clock=clocks[0], **params)
    ref = jrouter.CircuitBreaker(clock=clocks[1], **params)
    trail = ([], [])
    for ev in _events(seed):
        for i, b in enumerate((mine, ref)):
            if ev == "ok":
                out = b.record_success()
            elif ev == "fail":
                out = b.record_failure()
            elif ev == "allow":
                out = b.allow()
            else:
                clocks[i].advance(0.6)
                out = None
            trail[i].append((ev, out, b.state))
    assert trail[0] == trail[1]


# ---------------------------------------------------------------------------
# the measured Retry-After of a predict-only replica
# ---------------------------------------------------------------------------

def test_microbatcher_retry_after_seeded_from_first_batch(tmp_path):
    """A replica that only serves ``:predict`` must not answer the 1.0
    pre-signal default forever: the estimator seeds from the first
    completed micro-batch, so a later 429 carries the measured
    estimate."""
    from distributed_tensorflow_example_tpu_torch.config import \
        TrainConfig
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.serving import (
        export_model, load_servable)
    from distributed_tensorflow_example_tpu_torch.serving_batch import (
        MicroBatcher, QueueFullError)
    d = str(tmp_path / "predict")
    m = get_model("mlp", TrainConfig(model="mlp"))
    params = m.init(0, device="cpu")
    export_model(m, params, {}, d)
    x = np.random.RandomState(0).rand(4, 784).astype(np.float32)
    mb = MicroBatcher(load_servable(d, device="cpu"), batch_max_size=1,
                      batch_max_wait_ms=1.0, max_queue=2).start()
    try:
        assert not mb._retry.seeded
        mb.submit({"x": x[:1]}, 1).result(timeout=60)
        _wait(lambda: mb._retry.seeded, what="estimator seeding")
        ema = mb._retry.ema_step_s
        assert ema is not None and ema > 0
        wedged, release = threading.Event(), threading.Event()
        inner = mb.servable

        def wedge(cols):
            wedged.set()
            release.wait(timeout=60)
            return inner(cols)

        mb.servable = wedge
        try:
            futs = [mb.submit({"x": x[:1]}, 1)]
            assert wedged.wait(timeout=30)
            futs += [mb.submit({"x": x[:1]}, 1) for _ in range(2)]
            with pytest.raises(QueueFullError) as e:
                mb.submit({"x": x[:1]}, 1)
            expect = round(mb._retry.estimate(
                1.0, queue_ahead=2, slots=1), 2)
            assert e.value.retry_after == expect, \
                "429 hint is not the measured estimate"
        finally:
            release.set()
            for f in futs:
                f.result(timeout=60)
    finally:
        mb.close()


def test_replica_estimator_feeds_from_any_forward():
    r = Replica("http://127.0.0.1:9", name="p")
    assert r.wait_hint_s(outstanding=5) == 0.0     # no signal: admit
    r.observe(0.2)                                 # first completion
    assert r.retry.seeded
    assert r.wait_hint_s(outstanding=0) == pytest.approx(0.2)
    assert r.wait_hint_s(outstanding=3) == pytest.approx(0.8)


# ---------------------------------------------------------------------------
# routing policy units (no fleet, no start())
# ---------------------------------------------------------------------------

def _bare_router(n=3, package=serving_router, **kw):
    reps = [package.Replica(f"http://127.0.0.1:{i + 1}", name=f"r{i}")
            for i in range(n)]
    router = package.ReplicaRouter(reps, name="m", **kw)
    for rep in reps:
        router._states[rep.name] = "healthy"
    return router, reps


def test_pick_least_outstanding_tie_breaks_by_order():
    router, reps = _bare_router(3)
    try:
        router._outstanding = {"r0": 2, "r1": 0, "r2": 1}
        assert router._pick(set(), None) is reps[1]
        router._outstanding = {"r0": 0, "r1": 0, "r2": 0}
        assert router._pick(set(), None) is reps[0]
        assert router._pick({"r0"}, None) is reps[1]
    finally:
        router.close()


def test_pick_skips_inadmissible_states_and_open_breakers():
    router, reps = _bare_router(3)
    try:
        router._states.update({"r0": "dead", "r1": "draining"})
        assert router._pick(set(), None) is reps[2]
        reps[2].breaker._state = "open"
        reps[2].breaker._opened_at = reps[2].breaker.clock()
        assert router._pick(set(), None) is None
        reps[2].breaker._opened_at -= 100.0
        assert router._pick(set(), None) is reps[2]
        assert reps[2].breaker.state == "half_open"
    finally:
        router.close()


def test_pick_is_deadline_aware():
    router, reps = _bare_router(2)
    try:
        reps[0].observe(0.5)                  # 500 ms measured wave
        router._outstanding = {"r0": 1, "r1": 3}
        assert router._pick(set(), 200.0) is reps[1]
        assert router._pick(set(), None) is reps[0]
        reps[1].observe(0.5)
        assert router._pick(set(), 200.0) is None
    finally:
        router.close()


STATES = ("unknown", "healthy", "degraded", "saturated", "draining",
          "dead")


@pytest.mark.parametrize("seed", range(8))
def test_pick_matches_reference(seed):
    """The same replica states, breaker states, outstanding counts,
    measured waves, exclusions and deadlines give the same pick in both
    packages."""
    rs = np.random.RandomState(seed)
    routers = [_bare_router(4, package=p, flight_recorder=False)
               for p in (serving_router, jrouter)]
    try:
        for _ in range(25):
            states = [STATES[int(i)] for i in rs.randint(0, 6, 4)]
            breakers = [("closed", "open", "open_cool")[int(i)]
                        for i in rs.choice(3, 4, p=[0.6, 0.2, 0.2])]
            outstanding = rs.randint(0, 4, 4)
            waves = [None if rs.rand() < 0.4 else float(rs.rand())
                     for _ in range(4)]
            excluded = {f"r{i}" for i in range(4) if rs.rand() < 0.2}
            remaining = None if rs.rand() < 0.5 else float(
                rs.uniform(50, 2000))
            picks = []
            for router, reps in routers:
                for i, rep in enumerate(reps):
                    router._states[rep.name] = states[i]
                    b = rep.breaker
                    b._state = ("closed" if breakers[i] == "closed"
                                else "open")
                    b._probe_inflight = False
                    b._opened_at = b.clock() - (
                        100.0 if breakers[i] == "open_cool" else 0.0)
                    rep.retry = type(rep.retry)()
                    if waves[i] is not None:
                        rep.observe(waves[i])
                router._outstanding = {f"r{i}": int(outstanding[i])
                                       for i in range(4)}
                got = router._pick(set(excluded), remaining)
                picks.append((None if got is None else got.name,
                              [r.breaker.state for r in reps]))
            assert picks[0] == picks[1]
    finally:
        for router, _ in routers:
            router.close()


def test_backoff_matches_reference(monkeypatch):
    """The same seed gives the same capped, jittered backoff sleeps in
    both packages, and a deadline cuts a sleep short."""
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    out = []
    for package in (serving_router, jrouter):
        router, _ = _bare_router(2, package=package, seed=7,
                                 flight_recorder=False,
                                 backoff_base_ms=20.0,
                                 backoff_cap_ms=500.0)
        try:
            slept.clear()
            for attempt in range(8):
                router._backoff(attempt, None)
            out.append(list(slept))
        finally:
            router.close()
    assert out[0] == out[1]
    assert len(out[0]) == 8 and max(out[0]) <= 0.5
    assert 0.01 <= out[0][0] <= 0.02          # base 20 ms, jitter x[.5, 1)
    router, _ = _bare_router(2)
    try:
        slept.clear()
        router._backoff(5, time.perf_counter() + 0.001)
        assert not slept or slept[0] <= 0.001
    finally:
        router.close()


GEN_PATH = "/v1/models/m:generate"
GEN_PAYLOAD = {"inputs": {"input_ids": [[1, 2]]}}


def test_half_open_trial_pushback_releases_probe_slot():
    router, reps = _bare_router(1)
    try:
        rep = reps[0]
        rep.breaker = CircuitBreaker(threshold=1, cooldown_s=0.0)
        rep.breaker.record_failure()              # open, cooldown 0
        router._forward = lambda r, path, body, rid, t, trace=None: (
            429, {"Retry-After": "2"}, b'{"error": "full"}')
        st, headers, _ = router._serve(GEN_PATH, dict(GEN_PAYLOAD),
                                       "rid-po", True)
        assert st == 429 and headers["Retry-After"] == "2"
        assert rep.breaker.state == "closed"
        router._forward = lambda r, path, body, rid, t, trace=None: (
            200, {}, b'{"generations": [[9]]}')
        st, _, body = router._serve(GEN_PATH, dict(GEN_PAYLOAD),
                                    "rid-po2", True)
        assert st == 200
        assert json.loads(body)["served_by"] == "r0"
    finally:
        router.close()


def test_hedged_double_failure_excludes_both_replicas():
    router, reps = _bare_router(3, hedge_after_ms=10, retry_budget=2,
                                backoff_base_ms=1.0, backoff_cap_ms=2.0)
    try:
        calls = []

        def fake_forward(r, path, body, rid, timeout_s, trace=None):
            calls.append(r.name)
            if r.name == "r0":
                time.sleep(0.05)
                raise ForwardError(r, "conn reset")
            if r.name == "r1":
                raise ForwardError(r, "conn refused")
            return 200, {}, b'{"generations": [[7]]}'

        router._forward = fake_forward
        st, _, body = router._serve(GEN_PATH, dict(GEN_PAYLOAD),
                                    "rid-h2", True)
        assert st == 200
        assert json.loads(body)["served_by"] == "r2"
        assert sorted(calls) == ["r0", "r1", "r2"], calls
        snap = router.registry.snapshot()
        assert snap["router_retries_total"]["value"] == 1
        assert snap["router_hedges_total"]["value"] == 1
    finally:
        router.close()


def test_float_deadline_ms_honored_and_decremented_on_failover():
    router, _ = _bare_router(2, retry_budget=2, backoff_base_ms=1.0,
                             backoff_cap_ms=2.0)
    try:
        seen = []

        def fake_forward(r, path, body, rid, timeout_s, trace=None):
            seen.append(json.loads(body)["deadline_ms"])
            if len(seen) == 1:
                time.sleep(0.05)
                raise ForwardError(r, "conn reset")
            return 200, {}, b'{"generations": [[2]]}'

        router._forward = fake_forward
        st, _, _ = router._serve(
            GEN_PATH, {**GEN_PAYLOAD, "deadline_ms": 5000.0},
            "rid-fd", True)
        assert st == 200
        assert all(isinstance(d, int) for d in seen), seen
        assert seen[0] <= 5000
        assert seen[1] <= seen[0] - 50, seen
    finally:
        router.close()


def test_hedge_pushback_waits_for_sibling_never_cancels():
    router, reps = _bare_router(2, hedge_after_ms=10)
    try:
        cancels, calls = [], []
        router._cancel_on = lambda r, rids, ctx=None, parent_id=None: \
            cancels.append(r.name)

        def fake_forward(r, path, body, rid, timeout_s, trace=None):
            calls.append(r.name)
            if r.name == "r0":
                time.sleep(0.05)
                return 429, {"Retry-After": "2"}, b'{"error": "full"}'
            time.sleep(0.15)
            return 200, {}, b'{"generations": [[3]]}'

        router._forward = fake_forward
        st, _, body = router._serve(GEN_PATH, dict(GEN_PAYLOAD),
                                    "rid-hp", True)
        assert st == 200
        assert json.loads(body)["served_by"] == "r1"
        assert sorted(calls) == ["r0", "r1"], calls
        assert cancels == []
        assert reps[0].breaker.state == "closed"
    finally:
        router.close()


def test_hedge_winner_observes_its_own_wall_time():
    router, reps = _bare_router(2, hedge_after_ms=20)
    try:
        def fake_forward(r, path, body, rid, timeout_s, trace=None):
            time.sleep(0.3 if r.name == "r0" else 0.01)
            return 200, {}, b'{"generations": [[1]]}'

        router._forward = fake_forward
        st, _, body = router._serve(GEN_PATH, dict(GEN_PAYLOAD),
                                    "rid-hw", True)
        assert st == 200
        assert json.loads(body)["served_by"] == "r1"
        assert router.registry.snapshot()[
            "router_hedges_total"]["value"] == 1
        assert reps[1].retry.ema_step_s < 0.15
        assert reps[0].retry.ema_step_s is None
    finally:
        router.close()


def test_router_close_gives_back_the_span_ring():
    """A router armed the always-on span ring with its flight recorder;
    closing it gives the hold back, so nothing records after the last
    holder is gone (a ring armed by someone else stays armed)."""
    rec = obs_trace.recorder()
    rec.stop()
    router, _ = _bare_router(1)
    assert obs_trace.recorder().enabled
    router.close()
    assert not obs_trace.recorder().enabled
    plain, _ = _bare_router(1, flight_recorder=False)
    try:
        assert not obs_trace.recorder().enabled
    finally:
        plain.close()


# ---------------------------------------------------------------------------
# X-Request-Id end to end, surviving a failover
# ---------------------------------------------------------------------------

def test_request_id_survives_failover_retry(fleet_dir):
    d, vocab = fleet_dir
    p = sc.seeded_prompts(1, 4, vocab)[0]
    faults.install(faults.parse_spec("router.forward:step=1", seed=0))
    try:
        with _fleet(d, 2, probe_interval_s=0.05) as fleet:
            out = _post(fleet.port, fleet.name,
                        {"inputs": {"input_ids": [p.tolist()]},
                         "max_new": 3}, request_id="rid-failover")
            assert out["request_ids"] == ["rid-failover"]
            assert out["served_by"] == "replica1"
            snap = fleet.router.registry.snapshot()
            assert snap["router_retries_total"]["value"] == 1
            assert snap["router_failovers_total"]["value"] == 1
            assert fleet.router.replicas[0].breaker.state == "closed"
    finally:
        faults.install(None)


def test_failover_bytes_match_direct_single_replica(fleet_dir):
    d, vocab = fleet_dir
    prompts = sc.seeded_prompts(2, 5, vocab)
    ref = sc.reference_run(d, prompts, max_new=4)
    faults.install(faults.parse_spec("router.forward:step=2", seed=0))
    try:
        with _fleet(d, 2, probe_interval_s=0.05) as fleet:
            outs = [_post(fleet.port, fleet.name,
                          {"inputs": {"input_ids": [p.tolist()]},
                           "max_new": 4})["generations"][0]
                    for p in prompts]
            assert outs == ref
    finally:
        faults.install(None)


# ---------------------------------------------------------------------------
# pushback and fleet observability
# ---------------------------------------------------------------------------

def test_pushback_propagates_with_min_retry_after(fleet_dir):
    from distributed_tensorflow_example_tpu_torch.serving_batch import \
        QueueFullError
    d, _ = fleet_dir
    with _fleet(d, 2, probe_interval_s=0.05) as fleet:
        def full_26(payload, request_id=None, trace=None):
            raise QueueFullError("full", retry_after=2.6)

        def full_71(payload, request_id=None, trace=None):
            raise QueueFullError("full", retry_after=7.1)

        fleet.servers[0].generate = full_26
        fleet.servers[1].generate = full_71
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(fleet.port, fleet.name,
                  {"inputs": {"input_ids": [[1, 2]]}})
        assert e.value.code == 429
        assert e.value.headers.get("Retry-After") == "3"   # min(2.6, 7.1)
        assert "pushed back" in json.loads(e.value.read())["error"]


def test_fleet_metrics_merge_replica_pages(fleet_dir):
    d, vocab = fleet_dir
    prompts = sc.seeded_prompts(3, 6, vocab)
    with _fleet(d, 2, probe_interval_s=0.05) as fleet:
        out = _post(fleet.port, fleet.name,
                    {"inputs": {"input_ids": [prompts[0].tolist()]},
                     "max_new": 2}, request_id="rid-e2e")
        assert out["request_ids"] == ["rid-e2e"]
        assert out["timings"][0]["request_id"] == "rid-e2e"
        assert out["served_by"] in ("replica0", "replica1")
        for p in prompts[1:]:
            _post(fleet.port, fleet.name,
                  {"inputs": {"input_ids": [p.tolist()]}, "max_new": 2})
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fleet.port}/metrics",
                timeout=30) as r:
            merged = prom.parse(r.read().decode())
        assert merged["serving_requests_done_total"] == 3
        assert merged["router_requests_total"] == 3
        assert merged["router_replica_healthy"] == 2
        assert merged["serving_request_latency_seconds_count"] == 3
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fleet.port}/stats",
                timeout=30) as r:
            stats = json.loads(r.read())
        assert set(stats["replicas"]) == {"replica0", "replica1"}
        done = sum(rep["generate"]["requests_done"]
                   for rep in stats["replicas"].values())
        assert done == 3
        assert stats["router"]["requests"] == 3


def test_prom_parse_snapshot_roundtrip():
    reg = Registry()
    reg.counter("rt_probe_total", "help text").inc(3)
    reg.gauge("rt_probe_depth").set(7)
    h = reg.histogram("rt_probe_seconds", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    snap = reg.snapshot()
    parsed = prom.parse_snapshot(prom.render(snap))
    assert parsed["rt_probe_total"] == {
        "type": "counter", "value": 3, "help": "help text"}
    assert parsed["rt_probe_depth"]["value"] == 7
    assert parsed["rt_probe_seconds"]["buckets"] == [(0.1, 1), (1.0, 1)]
    assert parsed["rt_probe_seconds"]["inf"] == 1
    assert parsed["rt_probe_seconds"]["count"] == 3
    merged = merge_snapshots(snap, parsed)
    assert merged["rt_probe_total"]["value"] == 6
    assert merged["rt_probe_depth"]["value"] == 7
    assert merged["rt_probe_seconds"]["count"] == 6
    prom.render(merged)


def test_router_healthz_reflects_fleet(fleet_dir):
    d, _ = fleet_dir
    with _fleet(d, 2, probe_interval_s=0.05,
                dead_after_probes=2) as fleet:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fleet.port}/healthz",
                timeout=30) as r:
            assert r.status == 200
            body = json.loads(r.read())
        assert body["status"] == "live"
        assert {rep["state"] for rep in body["replicas"].values()} \
            == {"healthy"}
        fleet.crash(0)
        fleet.crash(1)
        _wait(lambda: all(
            s == "dead"
            for s in fleet.router.replica_states().values()),
            what="whole fleet marked dead")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://127.0.0.1:{fleet.port}/healthz", timeout=30)
        assert e.value.code == 503
        assert json.loads(e.value.read())["status"] == "unserved"


def test_replicas_label_their_own_spans_and_history(fleet_dir):
    """``PredictServer(process_name=)``: each in-process replica drains
    only its own spans through ``/trace/export`` and labels its history;
    the default label stays ``serving``."""
    d, vocab = fleet_dir
    p = sc.seeded_prompts(1, 8, vocab)[0]
    with _fleet(d, 2, probe_interval_s=0.05) as fleet:
        out = _post(fleet.port, fleet.name,
                    {"inputs": {"input_ids": [p.tolist()]}, "max_new": 2})
        served = out["served_by"]
        other = ({"replica0", "replica1"} - {served}).pop()
        exports = {}
        for i, srv in enumerate(fleet.servers):
            assert srv.process_name == f"replica{i}"
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/trace/export",
                    timeout=30) as r:
                exports[f"replica{i}"] = json.loads(r.read())
            assert srv.stats_history()["process"] == f"replica{i}"
        assert exports[served]["process"] == served
        assert exports[served]["spans"]
        assert {s[0] for s in exports[served]["spans"]} == {served}
        assert not exports[other]["spans"]
    with PredictServer(d, **CPU) as srv:
        assert srv.process_name == "serving"
        assert srv.trace_export()["process"] == "serving"


def test_router_cli_requires_replicas(capsys):
    with pytest.raises(SystemExit):
        serving_router.main([])
    assert "--replica" in capsys.readouterr().err


def test_router_rejects_bad_config():
    with pytest.raises(ValueError, match="at least one"):
        ReplicaRouter([], name="m")
    with pytest.raises(ValueError, match="duplicate"):
        ReplicaRouter([Replica("http://a", name="x"),
                       Replica("http://b", name="x")], name="m")
    with pytest.raises(ValueError, match="retry_budget"):
        ReplicaRouter([Replica("http://a")], retry_budget=-1)
    with pytest.raises(ValueError, match="hedge_after_ms"):
        ReplicaRouter([Replica("http://a")], hedge_after_ms=-5)


def test_router_cli_routes_to_replica_servers(fleet_dir):
    """The production shape: the router CLI in its own process in front
    of two servers, a routed ``:generate`` answered with ``served_by``
    and equal to a direct request's bytes."""
    d, vocab = fleet_dir
    p = sc.seeded_prompts(1, 9, vocab)[0]
    payload = {"inputs": {"input_ids": [p.tolist()]}, "max_new": 3}
    with PredictServer(d, **CPU) as a, PredictServer(d, **CPU) as b:
        direct = _post(a.port, a.name, payload)["generations"]
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "distributed_tensorflow_example_tpu_torch.serving_router",
             "--replica", f"http://127.0.0.1:{a.port}",
             "--replica", f"http://127.0.0.1:{b.port}",
             "--name", a.name, "--port", "0",
             "--probe_interval_s", "0.05"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        try:
            line = proc.stdout.readline()
            assert line.startswith("routing 2 replica(s) on "), line
            port = int(line.rsplit(":", 2)[1].split("/")[0])

            def live():
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/healthz",
                            timeout=5) as r:
                        return r.status == 200
                except OSError:
                    return False

            # the listener opens before the first probe sweep lands
            _wait(live, what="the router's first probe sweep")
            out = _post(port, a.name, payload, request_id="cli-rid")
            assert out["generations"] == direct
            assert out["request_ids"] == ["cli-rid"]
            assert out["served_by"] == f"127.0.0.1:{a.port}"
        finally:
            proc.terminate()
            proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# a port fleet against the port's single server and the reference engine
# ---------------------------------------------------------------------------

PROMPT_LEN, MAX_NEW, SLOTS, BLOCK = 8, 5, 4, 4


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """The reference's GPT-tiny init, its engine's greedy tokens for 8
    ragged requests over its own paged export, and the port's paged
    export of the same weights."""
    jm = JGPT(JGPTConfig.tiny())
    jp = jm.init(jax.random.key(0))
    tm = GPT(GPTConfig.tiny())
    tp = params_from_numpy(tm, _flatten(jp), device="cpu")
    kw = dict(prompt_len=PROMPT_LEN, max_new_tokens=MAX_NEW, batch_size=1,
              ragged=True, stepwise=True, slots=SLOTS, paged=True,
              block_size=BLOCK, num_blocks=48)
    rs = np.random.RandomState(10)
    prompts = [rs.randint(0, 1000, (int(rs.randint(1, PROMPT_LEN + 1)),))
               .astype(np.int32) for _ in range(2 * SLOTS)]
    jd = str(tmp_path_factory.mktemp("ref_paged"))
    jserving.export_generator(jm, jp, jd, platforms=("cpu",), **kw)
    eng = jbatch.GenerationEngine(jserving.load_stepwise(jd))
    futs = [eng.submit(p) for p in prompts]
    eng.start()
    try:
        ref = [f.result(timeout=120) for f in futs]
    finally:
        eng.close()
    td = str(tmp_path_factory.mktemp("port_paged"))
    export_generator(tm, tp, td, **kw)
    return prompts, ref, td


def _wave(port, name, prompts):
    outs = [None] * len(prompts)

    def client(i):
        outs[i] = _post(port, name,
                        {"inputs": {"input_ids": [prompts[i].tolist()]}})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs


def test_fleet_greedy_equals_single_server_and_reference_engine(bridged):
    """8 concurrent ragged requests through a 2-replica port fleet return
    the port's single server's bytes and the reference engine's greedy
    tokens on the same (bridged) weights, and every request is counted
    once at the router and once at a replica."""
    prompts, ref, d = bridged
    with PredictServer(d, **CPU) as srv:
        single = [o["generations"][0]
                  for o in _wave(srv.port, srv.name, prompts)]
    with _fleet(d, 2, probe_interval_s=0.05) as fleet:
        outs = _wave(fleet.port, fleet.name, prompts)
        snap = fleet.router.registry.snapshot()
        done = sum(s.engine.stats()["requests_done"]
                   for s in fleet.servers)
    fleet_gens = [o["generations"][0] for o in outs]
    assert single == ref
    assert fleet_gens == ref
    assert {o["served_by"] for o in outs} <= {"replica0", "replica1"}
    assert snap["router_requests_total"]["value"] == len(prompts)
    assert done == len(prompts)
