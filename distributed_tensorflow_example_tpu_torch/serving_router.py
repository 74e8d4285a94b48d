"""Fleet front end: a replica router with health-driven failover (a copy
of ``distributed_tensorflow_example_tpu/serving_router.py`` over the
port's servers).

One :class:`~.serving_http.PredictServer` is one wedged scheduler or one
killed process away from taking every user down. This module puts N
replica endpoints (in-process servers for the tests and the chaos drills,
``--replica http://host:port`` URLs in production) behind ONE
client-facing address:

- **Health-driven replica states.** A probe thread polls each replica's
  ``GET /healthz`` and runs a state machine per replica. A 200 probe whose
  body says ``saturated: true`` (the replica's own brownout ladder at
  shed_batch or deeper) demotes a live replica to ``saturated``: routed
  to last, not refused, so one overloaded backend drains while the rest
  carry its traffic, and a fleet-wide overload still reaches the
  replicas' own class ladders instead of a blanket router 503::

        unknown ──200──> healthy <──────────────┐
           │               │  ▲                 │ probe 200
           │      healthz 503  │ 200            │
           │  (stalled/dead    ▼                │
           │     engine)   degraded             │
           │               │                    │
           │   draining:true in /healthz        │
           ├──────────> draining                │
           │               │ listener closes    │
           └──conn fail────┴──> dead ───────────┘
               × dead_after_probes

  Only ``healthy`` replicas take new admissions; ``draining`` (a replica
  mid-SIGTERM) finishes its in-flight work untouched. Passive signals
  (forward timeouts, connection errors, 5xx) feed the same replica's
  circuit breaker, so a backend can be ejected between probes too.
- **Deadline-aware least-outstanding routing.** A request goes to the
  admissible replica with the fewest router-side in-flight requests,
  except one whose measured queue wave (a per-replica
  :class:`~.serving_batch.RetryAfterEstimator` EMA of forward wall time ×
  outstanding) already exceeds the request's remaining ``deadline_ms``.
  Every completed forward feeds the estimator, ``:predict`` included.
- **Retries with capped backoff and jitter.** A failed forward
  (connection error, timeout, 5xx) retries on a DIFFERENT replica (the
  failed one is excluded for the request's lifetime) after capped
  exponential backoff with seeded jitter, bounded by both the request's
  ``retry_budget`` and its remaining deadline. Greedy output is
  byte-identical whichever replica serves: every replica serves the same
  artifact and a retry restarts the whole generation.
- **Circuit breakers.** Consecutive-failure and windowed error-rate
  thresholds trip a per-replica breaker (closed → open), so a poisoned
  backend stops eating retry budget; after ``cooldown_s`` the prober
  makes the half-open probe (one trial: success closes, failure
  re-opens), and routing grants a half-open trial request when no
  closed-breaker replica is left.
- **Hedging.** With ``--hedge_after_ms N``, a ``:generate`` request still
  unanswered after N ms launches a second attempt on another replica;
  the first response wins and the loser is cancelled through ``POST
  /cancel/<rid>``, so its slot and cache blocks return to the pool (the
  fleet chaos drill checks ``blocks_free``).
- **Pushback.** A replica's 429/503 + ``Retry-After`` is not a failure:
  the router tries the remaining replicas without charging the retry
  budget, and only when every admissible replica pushed back does the
  client see it, with the SMALLEST ``Retry-After`` observed.
- **Fleet observability.** ``GET /metrics`` scrapes every replica's page,
  parses it back into snapshot form (:func:`~.obs.prom.parse_snapshot`)
  and merges it with the router's registry
  (:func:`~.obs.registry.merge_snapshots`); ``GET /stats`` nests each
  replica's stats beside the router's counters (``router_retries_total``,
  ``router_hedges_total``, ``router_breaker_open_total``,
  ``router_failovers_total``, ``router_probes_total``,
  ``router_requests_total`` and the ``router_replica_healthy`` gauge);
  ``GET /stats/history`` rolls every replica's metric time series into
  one fleet history, clock-corrected with the probe-estimated offsets and
  merged per time bin (:meth:`ReplicaRouter.stats_history`: what
  ``tools/servetop.py`` renders as the fleet view).

``X-Request-Id``: the router makes one request id per client request (or
adopts the client's header), and the SAME id rides every attempt
(primary, failover retries, the hedged second attempt), so the id in the
replica's response, request log and trace is stable end to end; the
``served_by`` response field names the replica that answered.

- **Distributed tracing and the flight recorder.** Every client request
  opens a root trace context (trace id, root span id and the
  ``--trace_sample`` sampled flag); each routing decision (pick, each
  attempt's launch marker and completed span, a retry with its reason, a
  pushback skip, the hedge wave whose span parents both attempts, the
  hedge launch, the loser's cancellation) is a child span, and the
  ``traceparent`` header forwards each attempt's child context so the
  replicas parent their engine spans under it. ``GET /trace/fleet``
  stitches the router's drain with every replica's ``GET /trace/export``
  into ONE Perfetto timeline (router lane on top, one process group per
  replica, clock offsets estimated from the probe stamps and ``/healthz``
  ``mono_now``). The router's own flight recorder bundles
  ``breaker_open`` and ``replica_death`` incidents to ``--incident_dir``.

Fault seams (:mod:`~.runtime.faults`, inert ``None`` checks by default):
``router.probe`` (a health probe fails), ``router.forward`` (a forwarded
request drops on the network floor), ``replica.crash`` (the forward path
hard-kills its in-process target and surfaces a connection error: the
kill-mid-decode drill). The probe thread's state carries the same
``@scheduler_owned`` / ``@scheduler_thread`` / ``@snapshot_view``
markers as the generation engine's.

The router is host code: it calls no ``torch`` (only
:class:`InProcessFleet` builds the port's servers, on the card unless
``server_kw`` names another device).
"""

from __future__ import annotations

import contextlib
import json
import random
import threading
import time
from collections import deque
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Any

from .obs import prom as obs_prom
from .obs import stitch as obs_stitch
from .obs import timeseries as obs_ts
from .obs import trace as obs_trace
from .obs.flightrec import FlightRecorder
from .obs.registry import (SERVING_LATENCY_BUCKETS, Registry,
                           merge_snapshots)
from .obs.trace import TraceContext, add_span, new_span_id, new_trace_id
from .runtime import faults
from .serving_batch import (RetryAfterEstimator, scheduler_owned,
                            scheduler_thread, snapshot_view)
from .utils.logging import get_logger

log = get_logger("router")

#: replica states a request may be routed to
ADMISSIBLE_STATES = ("healthy",)

#: live-but-brownout replicas (healthz ``saturated: true``): routed to
#: ONLY when no healthy replica is left, so a single
#: saturated backend drains while the rest carry its traffic, but a
#: fleet-wide overload degrades by CLASS at the replicas' own ladders
#: instead of becoming a blanket router 503 for everyone
LAST_RESORT_STATES = ("saturated",)


class ForwardError(Exception):
    """A forward attempt died below HTTP (connection refused/reset,
    timeout, injected network fault) — the retryable class, as opposed
    to a status-coded replica response."""

    def __init__(self, replica: "Replica", msg: str):
        super().__init__(f"replica {replica.name}: {msg}")
        self.replica = replica


class CircuitBreaker:
    """Per-replica circuit breaker: closed → open on consecutive
    failures (``threshold``) or a windowed error rate (``error_rate``
    over the last ``window`` outcomes, once ``min_samples`` exist);
    open → half-open after ``cooldown_s`` (ONE probe in flight at a
    time); half-open closes on probe success and re-opens on probe
    failure. ``clock`` is injectable so the state machine unit-tests
    deterministically, with no ``time.sleep``."""

    def __init__(self, *, threshold: int = 3, error_rate: float = 0.5,
                 window: int = 16, min_samples: int = 8,
                 cooldown_s: float = 2.0, clock=time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if not 0.0 < error_rate <= 1.0:
            raise ValueError(f"error_rate must be in (0, 1], got "
                             f"{error_rate}")
        self.threshold = threshold
        self.error_rate = error_rate
        self.window = window
        self.min_samples = min_samples
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._outcomes: list[bool] = []      # rolling window
        self._opened_at = 0.0
        self._probe_inflight = False

    @property
    def state(self) -> str:
        """closed / open / half_open. Reading rolls open → half_open
        visibility only through :meth:`allow` (the transition takes
        the probe slot)."""
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a request/probe go to this replica RIGHT NOW? closed:
        always. open: once ``cooldown_s`` elapsed, transitions to
        half_open and grants THE single probe slot. half_open: only
        if the probe slot is free (one trial at a time)."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self.clock() - self._opened_at < self.cooldown_s:
                    return False
                self._state = "half_open"
                self._probe_inflight = True
                return True
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._state = "closed"
            self._consecutive = 0
            self._probe_inflight = False
            self._push(True)

    def record_failure(self) -> bool:
        """Returns True when THIS call opened (or re-opened) the
        breaker — the caller advances ``router_breaker_open_total``."""
        with self._lock:
            self._push(False)
            self._consecutive += 1
            if self._state == "half_open":
                # the half-open probe failed: straight back to open,
                # cooldown restarts
                self._state = "open"
                self._opened_at = self.clock()
                self._probe_inflight = False
                return True
            if self._state == "open":
                return False
            rate_tripped = (len(self._outcomes) >= self.min_samples
                            and (self._outcomes.count(False)
                                 / len(self._outcomes))
                            >= self.error_rate)
            if self._consecutive >= self.threshold or rate_tripped:
                self._state = "open"
                self._opened_at = self.clock()
                return True
            return False

    def _push(self, ok: bool) -> None:
        self._outcomes.append(ok)
        if len(self._outcomes) > self.window:
            del self._outcomes[0]


class Replica:
    """Router-side record of one backend endpoint. ``crash_fn`` is the
    in-process harness's kill switch (the ``replica.crash`` seam calls
    it); production replicas crash on their own just fine."""

    def __init__(self, url: str, *, name: str | None = None,
                 breaker: CircuitBreaker | None = None,
                 crash_fn=None):
        self.url = url.rstrip("/")
        self.name = name or self.url.split("//", 1)[-1]
        self.breaker = breaker
        # measured service signal: EMA over COMPLETED forward wall
        # times, either verb — a predict-only replica seeds from its
        # first micro-batch completion instead of holding the 1.0
        # pre-signal default forever
        self.retry = RetryAfterEstimator()
        self.crash_fn = crash_fn

    def observe(self, wall_s: float) -> None:
        self.retry.observe(wall_s)

    def wait_hint_s(self, outstanding: int) -> float:
        """Estimated seconds a NEW request would wait here: measured
        forward EMA × the queue wave the router-side outstanding count
        represents. 0.0 before any signal — no signal beats a fake
        one, and an unmeasured replica must stay admissible."""
        ema = self.retry.ema_step_s
        return 0.0 if ema is None else ema * (1.0 + outstanding)

    def crash(self) -> None:
        if self.crash_fn is not None:
            self.crash_fn()


@scheduler_owned("_states", "_probe_failures", "_clock_samples")
class ReplicaRouter:
    """One client-facing address over N replicas (module docstring).

    Thread model: ThreadingHTTPServer handler threads route/forward
    concurrently (peer state: ``_outstanding`` under ``_lock``,
    breakers with their own locks); ONE probe thread owns the replica
    state machine — the ``@scheduler_owned`` fields above, written
    only from ``@scheduler_thread`` methods and read cross-thread
    through ``@snapshot_view`` copies, the same THR01 discipline the
    generation engine declares."""

    def __init__(self, replicas, *, name: str = "model",
                 host: str = "127.0.0.1", port: int = 0,
                 retry_budget: int = 2, hedge_after_ms: int = 0,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 2.0,
                 breaker_window: int = 16,
                 breaker_error_rate: float = 0.5,
                 probe_interval_s: float = 0.25,
                 probe_timeout_s: float = 2.0,
                 dead_after_probes: int = 2,
                 forward_timeout_s: float = 300.0,
                 backoff_base_ms: float = 20.0,
                 backoff_cap_ms: float = 500.0,
                 seed: int = 0, metrics: bool = True,
                 trace_sample: float = 1.0,
                 flight_recorder: bool = True,
                 incident_dir: str | None = None):
        self.replicas = [r if isinstance(r, Replica) else Replica(r)
                         for r in replicas]
        if not self.replicas:
            raise ValueError("a router needs at least one --replica")
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        if retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, got "
                             f"{retry_budget}")
        if hedge_after_ms < 0:
            raise ValueError(f"hedge_after_ms must be >= 0 (0 = no "
                             f"hedging), got {hedge_after_ms}")
        self.name = name
        self.retry_budget = int(retry_budget)
        self.hedge_after_ms = int(hedge_after_ms)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.dead_after_probes = int(dead_after_probes)
        self.forward_timeout_s = float(forward_timeout_s)
        self.backoff_base_s = backoff_base_ms / 1e3
        self.backoff_cap_s = backoff_cap_ms / 1e3
        for r in self.replicas:
            if r.breaker is None:
                r.breaker = CircuitBreaker(
                    threshold=breaker_threshold,
                    error_rate=breaker_error_rate,
                    window=breaker_window,
                    cooldown_s=breaker_cooldown_s)
        # snapshot_view methods hold this context manager while
        # reading probe-owned fields (no runtime sanitizer on the
        # router — the marker discipline is checked statically)
        self._san_view_cm = contextlib.nullcontext()
        self._lock = threading.Lock()
        self._outstanding = {r.name: 0 for r in self.replicas}
        self._rng = random.Random(seed)
        if not 0.0 <= trace_sample <= 1.0:
            raise ValueError(f"trace_sample must be in [0, 1], got "
                             f"{trace_sample}")
        self.trace_sample = float(trace_sample)
        # ---- probe-thread-owned state (THR01) -----------------------
        self._states: dict[str, str] = {r.name: "unknown"
                                        for r in self.replicas}
        self._probe_failures: dict[str, int] = {r.name: 0
                                                for r in self.replicas}
        # per-replica (t_send, t_recv, remote mono_now) probe stamps —
        # the clock-offset estimator's input (obs/stitch.py); the probe
        # thread appends, /trace/fleet reads a snapshot copy
        self._clock_samples: dict[str, deque] = {
            r.name: deque(maxlen=32) for r in self.replicas}
        self._stop = threading.Event()
        self._probed_once = threading.Event()
        self._probe_thread: threading.Thread | None = None
        # ---- telemetry ----------------------------------------------
        self.registry = Registry(enabled=metrics, namespace="router")
        reg = self.registry
        self._c_requests = reg.counter(
            "router_requests_total",
            "client requests entering the router")
        self._c_retries = reg.counter(
            "router_retries_total",
            "forward attempts retried after a replica failure "
            "(pushback exclusions are not retries)")
        self._c_failovers = reg.counter(
            "router_failovers_total",
            "requests ultimately answered by a different replica than "
            "first picked")
        self._c_hedges = reg.counter(
            "router_hedges_total",
            "hedged second attempts launched after hedge_after_ms")
        self._c_breaker_open = reg.counter(
            "router_breaker_open_total",
            "circuit-breaker open transitions across all replicas")
        self._c_probes = reg.counter(
            "router_probes_total", "health probes dispatched")
        self._g_replica_healthy = reg.gauge(
            "router_replica_healthy",
            "replicas currently in the healthy state")
        self._c_hedge_wins = reg.counter(
            "router_hedge_wins_total",
            "hedged second attempts that answered before the primary")
        self._h_request = reg.histogram(
            "router_request_seconds",
            "client-visible request wall time at the router (all "
            "attempts, retries and hedges included)",
            buckets=SERVING_LATENCY_BUCKETS)
        self._c_incidents = reg.counter(
            "router_incidents_total",
            "incident bundles written by the router's flight recorder")
        self._c_incidents_suppressed = reg.counter(
            "router_incidents_suppressed_total",
            "router incident bundles suppressed by the per-cause rate "
            "limit")
        # flight recorder: always-on ring + auto bundles on breaker-open /
        # replica-death, mirroring the replica side; close() gives the
        # ring's hold back
        self._ring_hold = (obs_trace.arm_always_on() if flight_recorder
                           else None)
        self._flightrec = None
        if flight_recorder and incident_dir:
            self._flightrec = FlightRecorder(
                incident_dir, process="router",
                snapshot_fn=self.registry.snapshot,
                config={"name": name, "replicas":
                        [r.url for r in self.replicas],
                        "retry_budget": retry_budget,
                        "hedge_after_ms": hedge_after_ms,
                        "breaker_threshold": breaker_threshold,
                        "probe_interval_s": probe_interval_s,
                        "dead_after_probes": dead_after_probes,
                        "trace_sample": trace_sample},
                counter=self._c_incidents,
                suppressed_counter=self._c_incidents_suppressed)
        self._httpd = ThreadingHTTPServer((host, port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        self._http_thread: threading.Thread | None = None

    # ---- probe thread: the replica state machine ---------------------
    @scheduler_thread
    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            for r in self.replicas:
                self._probe_one(r)
            self._g_replica_healthy.set(
                sum(1 for s in self._states.values() if s == "healthy"))
            self._probed_once.set()
            self._stop.wait(self.probe_interval_s)

    @scheduler_thread
    def _probe_one(self, r: Replica) -> None:
        self._c_probes.inc()
        t_send = time.perf_counter()
        try:
            faults.inject("router.probe", detail=r.name)
            status, body = self._get_json(r, "/healthz",
                                          timeout=self.probe_timeout_s)
        except Exception as e:
            n = self._probe_failures[r.name] = \
                self._probe_failures[r.name] + 1
            if n >= self.dead_after_probes:
                self._set_state(r, "dead")
            # a probe-level failure feeds the breaker too: a crashed
            # replica's breaker opens deterministically off the probe
            # cadence instead of eating client requests first; in
            # half_open this IS the failed recovery probe (re-opens)
            if r.breaker.state == "closed" or r.breaker.allow():
                if r.breaker.record_failure():
                    self._c_breaker_open.inc()
                    log.warning("breaker OPEN for %s (%s)", r.name, e)
                    if self._flightrec is not None:
                        self._flightrec.incident(
                            "breaker_open",
                            detail=f"replica {r.name}: probe failure "
                                   f"({e})",
                            extra={"replica": r.name,
                                   "breakers": self._breaker_states()})
            return
        self._probe_failures[r.name] = 0
        # the replica's /healthz carries its own monotonic clock — one
        # (t_send, t_recv, remote_now) sample per successful probe
        # feeds the fleet stitcher's per-replica offset estimate
        if isinstance(body.get("mono_now"), (int, float)):
            self._clock_samples[r.name].append(
                (t_send, time.perf_counter(), float(body["mono_now"])))
        if body.get("draining"):
            # graceful shutdown in progress: in-flight work finishes,
            # new admissions belong elsewhere — and this is NOT a
            # breaker-worthy failure
            self._set_state(r, "draining")
            return
        if status == 200 and body.get("saturated"):
            # the replica is LIVE but its own pressure
            # ladder says it is deep in brownout (queue-age/depth
            # saturation fields in /healthz) — demote to SATURATED so
            # new admissions prefer other replicas BEFORE this one has
            # to mass-shed them. Distinct from "degraded" (engine
            # stalled/dead behind a live listener): a saturated
            # replica still SERVES, so it stays the last-resort tier
            # in _pick — under fleet-wide overload interactive traffic
            # keeps flowing to the replicas' own class ladders instead
            # of collapsing into a blanket router 503. NOT a
            # breaker-worthy failure; the next unsaturated 200 probe
            # re-admits it.
            if r.breaker.state != "closed" and r.breaker.allow():
                r.breaker.record_success()
            self._set_state(r, "saturated")
            return
        if status == 200:
            # the half-open recovery probe: a live replica after the
            # cooldown closes its breaker (forward failures re-open)
            if r.breaker.state != "closed" and r.breaker.allow():
                r.breaker.record_success()
                log.warning("breaker closed for %s (recovery probe)",
                            r.name)
            self._set_state(r, "healthy")
        else:
            # listener up, engine stalled/dead behind it
            self._set_state(r, "degraded")

    @scheduler_thread
    def _set_state(self, r: Replica, state: str) -> None:
        prev = self._states[r.name]
        if prev != state:
            log.warning("replica %s: %s -> %s", r.name, prev, state)
            if state == "dead" and self._flightrec is not None:
                self._flightrec.incident(
                    "replica_death",
                    detail=f"replica {r.name}: {prev} -> dead after "
                           f"{self.dead_after_probes} failed probe(s)",
                    extra={"replica": r.name,
                           "states": dict(self._states),
                           "breakers": self._breaker_states()})
        self._states[r.name] = state

    def _breaker_states(self) -> dict[str, str]:
        return {r.name: r.breaker.state for r in self.replicas}

    @snapshot_view
    def replica_states(self) -> dict[str, str]:
        """Cross-thread copy of the probe thread's state map."""
        return dict(self._states)

    @snapshot_view
    def clock_samples(self) -> dict[str, list]:
        """Cross-thread copy of the probe thread's per-replica
        (t_send, t_recv, remote_now) stamps — the stitcher's offset
        input."""
        return {name: list(d) for name, d in
                self._clock_samples.items()}

    # ---- routing -----------------------------------------------------
    def _pick(self, excluded: set[str],
              remaining_ms: float | None) -> Replica | None:
        """The admissible replica with the fewest outstanding
        forwards; ``None`` when nothing is admissible. Deadline-aware:
        a replica whose measured queue wave already exceeds the
        request's remaining budget is never picked. A replica whose
        breaker is open joins only as the half-open trial carrier —
        preferred LAST, and its probe slot is consumed only when it
        is actually picked. SATURATED replicas (live, brownout) are
        the tier after that: picked only when no healthy replica is
        left, so fleet-wide overload still reaches the replicas' own
        class ladders instead of 503ing every request at the
        router."""
        states = self.replica_states()
        with self._lock:
            outstanding = dict(self._outstanding)
        closed, trial, last_resort = [], [], []
        for i, r in enumerate(self.replicas):
            if r.name in excluded:
                continue
            state = states.get(r.name)
            if state not in ADMISSIBLE_STATES \
                    and state not in LAST_RESORT_STATES:
                continue
            if remaining_ms is not None and \
                    r.wait_hint_s(outstanding[r.name]) * 1e3 \
                    > remaining_ms:
                continue
            bucket = (last_resort if state in LAST_RESORT_STATES
                      else closed if r.breaker.state == "closed"
                      else trial)
            bucket.append((outstanding[r.name], i, r))
        if closed:
            return min(closed)[2]
        for _, _, r in sorted(trial):
            if r.breaker.allow():         # takes the half-open slot
                return r
        for _, _, r in sorted(last_resort):
            if r.breaker.state == "closed" or r.breaker.allow():
                return r
        return None

    # ---- forwarding --------------------------------------------------
    def _forward(self, r: Replica, path: str, body: bytes, rid: str,
                 timeout_s: float,
                 trace: TraceContext | None = None
                 ) -> tuple[int, dict, bytes]:
        """One forward attempt: ``(status, headers, body)`` for ANY
        HTTP-level response (4xx/5xx included); :class:`ForwardError`
        for failures below HTTP. ``trace`` (this attempt's child
        context) rides the ``traceparent`` header so the replica
        parents its slot-lane spans under the attempt. The
        ``replica.crash`` seam fires FIRST — an armed rule hard-kills
        the target (in-process fleets) and surfaces the connection
        error a mid-request crash produces."""
        try:
            faults.inject("replica.crash", detail=r.name)
        except Exception as e:
            log.warning("replica.crash seam: killing %s", r.name)
            r.crash()
            raise ForwardError(r, f"replica crashed mid-request "
                               f"({e})") from e
        try:
            faults.inject("router.forward", detail=r.name)
            headers = {"Content-Type": "application/json",
                       "X-Request-Id": rid}
            if trace is not None:
                headers["traceparent"] = trace.to_traceparent()
            req = urllib.request.Request(
                r.url + path, data=body, headers=headers)
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()
        except Exception as e:
            raise ForwardError(
                r, f"{type(e).__name__}: {e}") from e

    def _get_json(self, r: Replica, path: str, *,
                  timeout: float) -> tuple[int, dict]:
        try:
            with urllib.request.urlopen(r.url + path,
                                        timeout=timeout) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def _get_text(self, r: Replica, path: str, *,
                  timeout: float) -> str:
        with urllib.request.urlopen(r.url + path,
                                    timeout=timeout) as resp:
            return resp.read().decode()

    def _note_failure(self, r: Replica) -> None:
        if r.breaker.record_failure():
            self._c_breaker_open.inc()
            log.warning("breaker OPEN for %s (forward failures)",
                        r.name)
            if self._flightrec is not None:
                self._flightrec.incident(
                    "breaker_open",
                    detail=f"replica {r.name}: forward failures",
                    extra={"replica": r.name,
                           "breakers": self._breaker_states()})

    def _inc_outstanding(self, r: Replica, n: int) -> None:
        with self._lock:
            self._outstanding[r.name] += n

    @staticmethod
    def _rids_for(rid: str, payload: dict) -> list[str]:
        """The per-row request ids a replica assigns under this
        ``X-Request-Id`` (serving_http: row i of a multi-row request
        gets ``<rid>-<i>``) — the hedging loser-cancellation targets."""
        rows = None
        if isinstance(payload.get("inputs"), dict):
            rows = payload["inputs"].get("input_ids")
        elif isinstance(payload.get("instances"), list):
            rows = payload["instances"]
        n = len(rows) if isinstance(rows, list) else 1
        return [rid] if n <= 1 else [f"{rid}-{i}" for i in range(n)]

    def _cancel_on(self, r: Replica, rids: list[str],
                   ctx: TraceContext | None = None,
                   parent_id: str | None = None) -> None:
        """Fire-and-forget cancellation of the hedging loser's rows —
        best-effort by design (the loser may retire first; a dead
        loser has nothing to cancel). Each cancellation records a
        "cancel" span under the hedge wave's span, carrying the SAME
        request id — the stitched timeline's proof the loser was told
        to stop."""
        def go():
            for one in rids:
                t0 = time.perf_counter()
                try:
                    req = urllib.request.Request(
                        f"{r.url}/cancel/{one}", data=b"")
                    urllib.request.urlopen(req, timeout=5).close()
                    outcome = "acknowledged"
                except Exception as e:   # noqa: BLE001 — best-effort
                    outcome = f"{type(e).__name__}"
                if ctx is not None and ctx.sampled:
                    add_span("cancel", t0, time.perf_counter(),
                             process="router", lane=f"req {one}",
                             trace_id=ctx.trace_id, request_id=one,
                             parent_id=parent_id, replica=r.name,
                             outcome=outcome)
        threading.Thread(target=go, name="hedge-cancel",
                         daemon=True).start()

    def _backoff(self, attempt: int,
                 deadline_t: float | None) -> None:
        base = min(self.backoff_cap_s,
                   self.backoff_base_s * (2 ** attempt))
        with self._lock:
            sleep_s = base * (0.5 + self._rng.random() / 2.0)
        if deadline_t is not None:
            sleep_s = min(sleep_s,
                          max(0.0, deadline_t - time.perf_counter()))
        if sleep_s > 0:
            time.sleep(sleep_s)

    # ---- the request path --------------------------------------------
    def _rspan(self, ctx: TraceContext | None, rid: str, name: str,
               t0: float, t1: float, **args) -> None:
        """One router-lane span under the request's trace context — a
        no-op for unsampled requests (the ``--trace_sample`` draw), so
        sampling out a request costs one branch. Request-scoped spans
        share a per-rid lane, so concurrent requests tile instead of
        interleaving on one row."""
        if ctx is None or not ctx.sampled:
            return
        add_span(name, t0, t1, process="router", lane=f"req {rid}",
                 trace_id=ctx.trace_id, request_id=rid, **args)

    def _serve(self, path: str, payload: dict, rid: str,
               is_generate: bool) -> tuple[int, dict, bytes]:
        """Route one client request with fleet semantics; returns
        ``(status, extra_headers, body_bytes)``. Opens the request's
        ROOT trace context (trace id + root span id + the
        ``--trace_sample`` sampled flag) — every routing decision and
        forward attempt below records a child span, and the
        ``traceparent`` header forwards the context so replicas parent
        their slot lanes under it."""
        self._c_requests.inc()
        t0 = time.perf_counter()
        # the all-or-nothing endpoints skip the lock AND the draw —
        # only a fractional trace_sample pays the (locked, shared-rng)
        # draw per request
        if self.trace_sample >= 1.0:
            sampled = True
        elif self.trace_sample <= 0.0:
            sampled = False
        else:
            with self._lock:
                sampled = self._rng.random() < self.trace_sample
        ctx = TraceContext(new_trace_id(), new_span_id(), sampled)
        status = None
        try:
            status, headers, body = self._route(
                path, payload, rid, is_generate, ctx, t0)
        finally:
            t1 = time.perf_counter()
            self._h_request.observe(t1 - t0)
            self._rspan(ctx, rid, "request", t0, t1,
                        span_id=ctx.span_id, path=path, status=status)
        if status < 400 and ctx.sampled:
            body = self._stamp_trace(body, ctx)
        return status, headers, body

    @staticmethod
    def _stamp_trace(resp: bytes, ctx: TraceContext) -> bytes:
        """Stamp the trace id into a successful JSON response (beside
        ``request_ids``/``served_by``) so a client can pull the
        stitched ``/trace/fleet`` timeline for exactly this request.
        A ``:generate`` replica already stamped the SAME id (it comes
        from the propagated traceparent) — skip the re-serialization
        then; this path pays the dumps only for bodies that lack it
        (``:predict``, older replicas)."""
        try:
            out = json.loads(resp)
        except ValueError:
            return resp
        if not isinstance(out, dict) or "trace_id" in out:
            return resp
        out["trace_id"] = ctx.trace_id
        return json.dumps(out).encode()

    def _route(self, path: str, payload: dict, rid: str,
               is_generate: bool, ctx: TraceContext,
               t0: float) -> tuple[int, dict, bytes]:
        """The routing loop body (see :meth:`_serve`)."""
        deadline_ms = payload.get("deadline_ms")
        # ints AND floats, the replica knob's own convention — a float
        # deadline silently ignored here would let every failover
        # restart the client's full budget
        deadline_t = (t0 + deadline_ms / 1e3
                      if isinstance(deadline_ms, (int, float))
                      and not isinstance(deadline_ms, bool)
                      and deadline_ms > 0 else None)
        budget = self.retry_budget
        excluded: set[str] = set()
        pushback: list[tuple[int, float]] = []
        first: Replica | None = None
        last_5xx: tuple[int, dict, bytes] | None = None
        last_err: ForwardError | None = None
        attempt = 0
        while True:
            remaining_ms = None
            if deadline_t is not None:
                remaining_ms = (deadline_t - time.perf_counter()) * 1e3
                if remaining_ms <= 0:
                    return self._json(504, {
                        "error": f"request {rid} missed its "
                                 f"{deadline_ms} ms deadline at the "
                                 "router (every forward attempt "
                                 "consumed it)"})
            t_pick = time.perf_counter()
            r = self._pick(excluded, remaining_ms)
            self._rspan(ctx, rid, "pick", t_pick, time.perf_counter(),
                        parent_id=ctx.span_id, attempt=attempt,
                        replica=r.name if r is not None else None,
                        excluded=sorted(excluded),
                        breaker_open=sorted(
                            x.name for x in self.replicas
                            if x.breaker.state != "closed"))
            if r is None:
                return self._no_replica(rid, pushback, last_5xx,
                                        last_err)
            if first is None:
                first = r
            body = payload
            if deadline_t is not None:
                # the replica enforces deadline_ms from ITS admission:
                # hand it only what is left, or a failover would
                # silently restart the client's budget
                body = dict(payload)
                body["deadline_ms"] = max(1, int(remaining_ms))
            data = json.dumps(body).encode()
            timeout_s = self.forward_timeout_s
            if remaining_ms is not None:
                timeout_s = min(timeout_s, remaining_ms / 1e3 + 5.0)
            self._inc_outstanding(r, 1)
            fwd_wall = None
            try:
                if (attempt == 0 and self.hedge_after_ms
                        and is_generate):
                    # the hedged path measures (and feeds) each
                    # attempt's own wall time — timing from here would
                    # charge the winner with the hedge delay plus the
                    # primary's wait, training a FAST replica's EMA
                    # toward hedge_after_ms
                    winner, st, hdrs, resp = self._forward_hedged(
                        r, path, data, rid, payload, excluded,
                        timeout_s, ctx)
                else:
                    winner = r
                    t_fwd = time.perf_counter()
                    st, hdrs, resp = self._forward_traced(
                        r, path, data, rid, timeout_s, ctx,
                        ctx.span_id, attempt)
                    fwd_wall = time.perf_counter() - t_fwd
            except ForwardError as e:
                last_err = e
                self._note_failure(e.replica)
                excluded.add(e.replica.name)
                if budget <= 0:
                    return self._json(502, {
                        "error": f"request {rid}: every replica "
                                 f"failed within the retry budget "
                                 f"({self.retry_budget}); last: {e}"})
                budget -= 1
                self._c_retries.inc()
                t_rb = time.perf_counter()
                self._backoff(attempt, deadline_t)
                self._rspan(ctx, rid, "retry", t_rb,
                            time.perf_counter(),
                            parent_id=ctx.span_id, attempt=attempt,
                            retry_reason="conn_error",
                            replica=e.replica.name)
                attempt += 1
                continue
            finally:
                self._inc_outstanding(r, -1)
            if st < 500 or st == 504:
                # ANY HTTP-level response proves the replica's
                # transport and engine are answering — record the
                # breaker success even for pushback and client-fault
                # statuses, so a half-open trial slot granted by
                # _pick is always released (a trial that happened to
                # hit queue-full must not quarantine the replica
                # forever)
                winner.breaker.record_success()
            if st in (429, 503):
                # pushback, not failure: Retry-After propagates if the
                # whole fleet is saturated; budget is not charged
                try:
                    ra = float(hdrs.get("Retry-After", 1))
                except ValueError:
                    ra = 1.0
                pushback.append((st, ra))
                excluded.add(winner.name)
                t_pb = time.perf_counter()
                self._rspan(ctx, rid, "pushback_skip", t_pb, t_pb,
                            parent_id=ctx.span_id, attempt=attempt,
                            replica=winner.name, status=st,
                            retry_after=ra)
                attempt += 1
                continue
            if st >= 500 and st != 504:
                last_5xx = (st, hdrs, resp)
                self._note_failure(winner)
                excluded.add(winner.name)
                if budget <= 0:
                    return st, {}, resp
                budget -= 1
                self._c_retries.inc()
                t_rb = time.perf_counter()
                self._backoff(attempt, deadline_t)
                self._rspan(ctx, rid, "retry", t_rb,
                            time.perf_counter(),
                            parent_id=ctx.span_id, attempt=attempt,
                            retry_reason=f"http_{st}",
                            replica=winner.name)
                attempt += 1
                continue
            # success (or a client-fault 4xx / deadline 504 that no
            # other replica would answer differently): propagate
            if st < 400:
                if fwd_wall is not None:
                    winner.observe(fwd_wall)
                if winner is not first:
                    self._c_failovers.inc()
                resp = self._annotate(resp, winner)
            return st, {}, resp

    def _forward_traced(self, r: Replica, path: str, data: bytes,
                        rid: str, timeout_s: float,
                        ctx: TraceContext | None, parent_id: str | None,
                        attempt: int) -> tuple[int, dict, bytes]:
        """One forward attempt with its own child span: a fresh span id
        rides the ``traceparent`` header (the replica's engine spans
        parent under it) and the attempt span — success OR failure —
        lands on the router lane annotated with the replica and
        outcome."""
        child = ctx.child() if ctx is not None else None
        t0 = time.perf_counter()
        # launch-time point span: a complete ("X") event only exists
        # once the attempt RESOLVES, so a wedged/cancelled attempt
        # would otherwise be invisible in a timeline fetched while it
        # is still in flight — the launch marker is the attempt's
        # guaranteed-visible half
        self._rspan(ctx, rid, "forward_launch", t0, t0,
                    parent_id=parent_id, attempt=attempt,
                    replica=r.name,
                    span_id=child.span_id if child else None)
        try:
            st, hdrs, resp = self._forward(r, path, data, rid,
                                           timeout_s, trace=child)
        except ForwardError as e:
            self._rspan(ctx, rid, "forward", t0, time.perf_counter(),
                        parent_id=parent_id, attempt=attempt,
                        replica=r.name,
                        span_id=child.span_id if child else None,
                        error=f"{e}")
            raise
        self._rspan(ctx, rid, "forward", t0, time.perf_counter(),
                    parent_id=parent_id, attempt=attempt,
                    replica=r.name,
                    span_id=child.span_id if child else None,
                    status=st)
        return st, hdrs, resp

    def _forward_hedged(self, primary: Replica, path: str, data: bytes,
                        rid: str, payload: dict, excluded: set[str],
                        timeout_s: float,
                        ctx: TraceContext | None = None):
        """First-response-wins hedging: the primary gets
        ``hedge_after_ms`` to answer before ONE second attempt
        launches on a different replica (same request id). The losing
        in-flight attempt is cancelled through the replicas'
        ``POST /cancel/<rid>`` so its slot and cache blocks return to
        the pool instead of decoding for nobody. The whole wave records
        ONE "hedge" span (child of the request root) that PARENTS both
        attempts' forward spans — a hedge race renders as two parallel
        replica lanes under one parent in the stitched timeline."""
        results: Queue = Queue()
        # the wave's span id exists UP FRONT so the primary's attempt
        # span (launched before the hedge decision) already parents
        # under it; the wave span itself is recorded at the end
        hedge_span_id = new_span_id() if ctx is not None else None
        t_wave = time.perf_counter()

        def run(rep: Replica, attempt: int):
            t0 = time.perf_counter()
            try:
                out = self._forward_traced(rep, path, data, rid,
                                           timeout_s, ctx,
                                           hedge_span_id, attempt)
                results.put((rep, out, None,
                             time.perf_counter() - t0))
            except ForwardError as e:
                results.put((rep, None, e, 0.0))
            except Exception as e:       # noqa: BLE001 — see below
                # an INTERNAL failure (a bug, not a network one) must
                # still resolve this attempt: a worker thread dying
                # without posting would park the wave on
                # results.get(timeout_s + 10) — a 5-minute stall for
                # what should be an immediate error
                log.exception("hedged forward to %s failed "
                              "internally", rep.name)
                results.put((rep, None,
                             ForwardError(rep, f"internal error: "
                                          f"{type(e).__name__}: {e}"),
                             0.0))

        def continuing(st: int) -> bool:
            # statuses the outer retry loop would act on (pushback or
            # retryable 5xx): a hedged wave keeps waiting for its
            # sibling instead of surfacing one of these while the
            # other attempt might still win outright
            return st in (429, 503) or (st >= 500 and st != 504)

        inflight = [primary]
        resolved: list[Replica] = []
        threading.Thread(target=run, args=(primary, 0),
                         name="fwd-primary", daemon=True).start()
        try:
            try:
                rep, out, err, wall = results.get(
                    timeout=self.hedge_after_ms / 1e3)
            except Empty:
                hedge = self._pick(excluded | {primary.name}, None)
                if hedge is not None:
                    self._c_hedges.inc()
                    self._inc_outstanding(hedge, 1)
                    inflight.append(hedge)
                    t_h = time.perf_counter()
                    self._rspan(ctx, rid, "hedge_launch", t_h, t_h,
                                parent_id=hedge_span_id,
                                replica=hedge.name,
                                hedge_after_ms=self.hedge_after_ms)
                    threading.Thread(target=run, args=(hedge, 1),
                                     name="fwd-hedge",
                                     daemon=True).start()
                rep, out, err, wall = results.get(
                    timeout=timeout_s + 10)
            fallback = None
            last_err: ForwardError | None = None
            while True:
                resolved.append(rep)
                if err is None and not continuing(out[0]):
                    break                   # terminal response: wins
                if err is not None:
                    # feeds the breaker AND the exclusion set — the
                    # retry loop must not re-pick a replica that just
                    # failed its hedged attempt
                    self._note_failure(rep)
                    excluded.add(rep.name)
                    last_err = err
                else:
                    # pushback / retryable 5xx: remember it, give the
                    # sibling the chance to win outright; the replica
                    # answered (release any half-open trial slot) but
                    # is excluded so the outer loop can never
                    # re-submit the SAME rid to a replica whose
                    # attempt is or was in flight
                    rep.breaker.record_success()
                    excluded.add(rep.name)
                    fallback = (rep, out)
                if len(resolved) >= len(inflight):
                    if fallback is not None:
                        rep, out = fallback
                        break
                    raise last_err
                rep, out, err, wall = results.get(
                    timeout=timeout_s + 10)
            if out[0] < 400:
                # each attempt's OWN wall time (measured in run()) —
                # never the hedge delay plus the primary's wait
                rep.observe(wall)
                if rep is not primary:
                    self._c_hedge_wins.inc()
            # cancel ONLY a loser still in flight under a terminal
            # winner (the wave is over — _serve returns, the rid is
            # never reused); on the fallback path every attempt has
            # already resolved, so the async cancel can never race a
            # same-rid retry
            for loser in inflight:
                if loser is not rep and loser not in resolved:
                    self._cancel_on(loser, self._rids_for(rid, payload),
                                    ctx=ctx, parent_id=hedge_span_id)
            return rep, out[0], out[1], out[2]
        finally:
            self._rspan(ctx, rid, "hedge", t_wave, time.perf_counter(),
                        parent_id=ctx.span_id if ctx else None,
                        span_id=hedge_span_id,
                        hedge_after_ms=self.hedge_after_ms,
                        attempts=len(inflight))
            for x in inflight:
                if x is not primary:
                    self._inc_outstanding(x, -1)

    def _no_replica(self, rid, pushback, last_5xx, last_err):
        """Nothing admissible is left for this request."""
        if pushback:
            status = (429 if all(st == 429 for st, _ in pushback)
                      else 503)
            ra = min(ra for _, ra in pushback)
            return self._json(status, {
                "error": f"request {rid}: every admissible replica "
                         "pushed back — retry after the hint"},
                headers={"Retry-After": str(int(ra + 0.5))})
        if last_5xx is not None:
            return last_5xx[0], {}, last_5xx[2]
        if last_err is not None:
            return self._json(502, {
                "error": f"request {rid}: no replica left to retry "
                         f"on; last failure: {last_err}"})
        return self._json(503, {
            "error": "no admissible replica (all dead, draining, "
                     "degraded, or breaker-open)"},
            headers={"Retry-After": "1"})

    @staticmethod
    def _json(status: int, obj: dict,
              headers: dict | None = None) -> tuple[int, dict, bytes]:
        return status, headers or {}, json.dumps(obj).encode()

    @staticmethod
    def _annotate(resp: bytes, winner: Replica) -> bytes:
        """Stamp the serving replica into a successful JSON response —
        the ``served_by`` field tests and operators correlate with
        ``request_ids``."""
        try:
            out = json.loads(resp)
        except ValueError:
            return resp
        if not isinstance(out, dict):
            return resp
        out["served_by"] = winner.name
        return json.dumps(out).encode()

    # ---- observability -----------------------------------------------
    def fleet_health(self) -> dict:
        """``GET /healthz``: 200-worthy while at least one replica is
        admissible; ``saturated`` (503 — upstream pushback) while only
        last-resort replicas remain, though requests still route to
        them."""
        states = self.replica_states()
        with self._lock:
            outstanding = dict(self._outstanding)
        live = sum(1 for s in states.values() if s in ADMISSIBLE_STATES)
        saturated = sum(1 for s in states.values()
                        if s in LAST_RESORT_STATES)
        return {
            "status": ("live" if live
                       else "saturated" if saturated else "unserved"),
            "replicas": {
                r.name: {"url": r.url, "state": states[r.name],
                         "breaker": r.breaker.state,
                         "outstanding": outstanding[r.name]}
                for r in self.replicas}}

    def stats(self) -> dict:
        """``GET /stats``: the router's own counters next to every
        replica's ``/stats`` payload (a dead replica's slot carries
        the fetch error instead)."""
        snap = self.registry.snapshot()

        def c(name):
            return snap[name]["value"]

        out: dict[str, Any] = {
            "model": self.name,
            "router": {
                "replicas": len(self.replicas),
                "requests": c("router_requests_total"),
                "retries": c("router_retries_total"),
                "failovers": c("router_failovers_total"),
                "hedges": c("router_hedges_total"),
                "hedge_wins": c("router_hedge_wins_total"),
                "breaker_opens": c("router_breaker_open_total"),
                "probes": c("router_probes_total"),
                "replica_healthy": c("router_replica_healthy"),
                "incidents": c("router_incidents_total"),
            },
            "replicas": {}}
        scraped = self._scrape_replicas(
            lambda r: self._get_json(r, "/stats",
                                     timeout=self.probe_timeout_s)[1])
        for name, (ok, val) in scraped.items():
            out["replicas"][name] = (val if ok else {
                "error": f"{type(val).__name__}: {val}"})
        return out

    def _scrape_replicas(self, fetch) -> dict[str, tuple[bool, Any]]:
        """Run ``fetch(replica)`` against every replica CONCURRENTLY
        under the probe timeout: one wedged replica (listener up,
        engine stalled — the exact class the prober demotes) must not
        stall the whole fleet observability page for
        ``N × forward-timeout`` seconds."""
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(
                max_workers=min(16, len(self.replicas))) as ex:
            futs = [(r.name, ex.submit(fetch, r))
                    for r in self.replicas]
            out: dict[str, tuple[bool, Any]] = {}
            for name, f in futs:
                try:
                    out[name] = (True, f.result())
                except Exception as e:
                    out[name] = (False, e)
        return out

    def metrics_text(self) -> str:
        """``GET /metrics``: the fleet page — every reachable
        replica's exposition parsed back to snapshot form and merged
        with the router's own registry through ``merge_snapshots``
        (counters/histograms sum across replicas; a dead or wedged
        replica's page is simply absent from the merge)."""
        scraped = self._scrape_replicas(
            lambda r: obs_prom.parse_snapshot(
                self._get_text(r, "/metrics",
                               timeout=self.probe_timeout_s)))
        snaps = [self.registry.snapshot()] + [
            val for ok, val in scraped.values() if ok]
        return obs_prom.render(merge_snapshots(*snaps))

    def stats_history(self) -> dict:
        """``GET /stats/history``: the FLEET metric time-series — every
        reachable replica's ``/stats/history`` ring with its timestamps
        corrected into the router's clock (per-replica offsets
        estimated NTP-style from the probe clock samples,
        :func:`~.obs.stitch.estimate_offset` — the same rule the fleet
        trace stitcher applies), plus one MERGED history
        (:func:`~.obs.timeseries.rollup` over
        :func:`~.obs.registry.merge_snapshots`): samples binned on the
        smallest replica cadence, only bins every live replica covers,
        so fleet counter series stay monotonic. servetop renders the
        merged samples as the fleet view and the per-replica payloads
        as the breakdown."""
        now = time.perf_counter()
        samples_by = self.clock_samples()
        # the history payload is a whole ring (default 600 snapshots —
        # low MBs of JSON), not a tiny probe: bounding it by the 2 s
        # probe timeout would intermittently drop healthy-but-loaded
        # replicas from the rollup (and with them whole fleet bins)
        scrape_timeout = max(10.0, 5.0 * self.probe_timeout_s)
        scraped = self._scrape_replicas(
            lambda r: self._get_json(r, "/stats/history",
                                     timeout=scrape_timeout)[1])
        replicas: dict[str, dict] = {}
        hists: dict[str, list] = {}
        offsets: dict[str, float] = {}
        intervals: list[float] = []
        for r in self.replicas:
            ok, val = scraped.get(r.name, (False, None))
            if not ok or not isinstance(val, dict):
                replicas[r.name] = {"error": f"{type(val).__name__}: "
                                             f"{val}"}
                continue
            off = obs_stitch.estimate_offset(
                samples_by.get(r.name, ()))
            offsets[r.name] = round(off, 9)
            corrected = [[float(t) - off, snap]
                         for t, snap in val.get("samples", ())]
            replicas[r.name] = dict(val, process=r.name,
                                    samples=corrected,
                                    clock_offset_s=round(off, 9))
            if val.get("enabled") and corrected:
                hists[r.name] = [(t, snap) for t, snap in corrected]
                if val.get("interval_s"):
                    intervals.append(float(val["interval_s"]))
        merged = obs_ts.rollup(hists, bin_s=min(intervals)
                               if intervals else 1.0)
        return obs_ts.to_payload(
            merged, enabled=bool(hists), process="router", clock=now,
            interval_s=min(intervals) if intervals else None,
            clock_offsets_s=offsets, replicas=replicas)

    def fleet_trace(self) -> dict:
        """``GET /trace/fleet``: ONE stitched Perfetto timeline — the
        router's own span drain on top, one process-group per replica
        (each replica's ``GET /trace/export`` drain relabeled with its
        fleet-side name), with per-replica clock-offset correction
        estimated from the probe clock samples (obs/stitch.py). A dead
        replica's export is simply absent; its router-side spans still
        tell the story."""
        rec = obs_trace.recorder()
        exports: list[dict] = [{
            "process": "router", "clock": time.perf_counter(),
            "spans": [list(s) for s in rec.drain(process="router")],
            "events_dropped": rec.events_dropped}]
        offsets: dict[str, float] = {"router": 0.0}
        samples = self.clock_samples()
        scraped = self._scrape_replicas(
            lambda r: self._get_json(r, "/trace/export",
                                     timeout=self.probe_timeout_s)[1])
        for r in self.replicas:
            ok, val = scraped.get(r.name, (False, None))
            if not ok or not isinstance(val, dict):
                continue
            # the router's replica NAME wins over the export's own
            # process label ("serving" on a standalone server), so
            # process groups match the routing spans' replica= args
            val = dict(val)
            val["process"] = r.name
            exports.append(val)
            offsets[r.name] = obs_stitch.estimate_offset(
                samples.get(r.name, ()))
        return obs_stitch.stitch(exports, offsets=offsets)

    def cancel(self, rid: str) -> bool:
        """``POST /cancel/<rid>`` broadcast: True when ANY replica
        acknowledged the id."""
        ok = False
        for r in self.replicas:
            try:
                req = urllib.request.Request(f"{r.url}/cancel/{rid}",
                                             data=b"")
                urllib.request.urlopen(req, timeout=10).close()
                ok = True
            except Exception:
                continue
        return ok

    # ---- HTTP surface ------------------------------------------------
    def _make_handler(self):
        router = self

        class Handler(BaseHTTPRequestHandler):
            timeout = 30

            def log_message(self, *a):
                pass

            def _send(self, status: int, headers: dict,
                      body: bytes, ctype="application/json") -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, status: int, obj: dict,
                           headers: dict | None = None) -> None:
                self._send(status, headers or {},
                           json.dumps(obj).encode())

            def do_GET(self):
                p = self.path
                scoped = f"/v1/models/{router.name}"
                if p == scoped:
                    h = router.fleet_health()
                    ok = h["status"] == "live"
                    self._send_json(200 if ok else 503, {
                        "model_version_status": [{
                            "version": "1",
                            "state": "AVAILABLE" if ok
                            else "UNAVAILABLE",
                            "status": {"error_code": "OK" if ok
                                       else "UNAVAILABLE",
                                       "error_message": ""
                                       if ok else "no admissible "
                                       "replica"}}]})
                elif p in ("/healthz", f"{scoped}/healthz"):
                    h = router.fleet_health()
                    self._send_json(
                        200 if h["status"] == "live" else 503, h)
                elif p in ("/stats", f"{scoped}/stats"):
                    self._send_json(200, router.stats())
                elif p in ("/stats/history", f"{scoped}/stats/history"):
                    self._send_json(200, router.stats_history())
                elif p in ("/metrics", f"{scoped}/metrics"):
                    self._send(200, {},
                               router.metrics_text().encode(),
                               ctype=obs_prom.CONTENT_TYPE)
                elif p in ("/trace/fleet", f"{scoped}/trace/fleet"):
                    self._send_json(200, router.fleet_trace())
                else:
                    self._send_json(404,
                                    {"error": f"unknown path {p}"})

            def do_POST(self):
                p = self.path
                if p.startswith("/cancel/"):
                    rid = p[len("/cancel/"):]
                    if router.cancel(rid):
                        self._send_json(200, {"cancelled": rid})
                    else:
                        self._send_json(404, {
                            "error": f"no replica acknowledged "
                                     f"request {rid!r}"})
                    return
                routes = {f"/v1/models/{router.name}:generate": True,
                          f"/v1/models/{router.name}:predict": False}
                if p not in routes:
                    self._send_json(404,
                                    {"error": f"unknown path {p}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > 1 << 30:
                        self._send_json(413,
                                        {"error": "request too large"})
                        return
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(payload, dict):
                        raise ValueError("payload must be a JSON "
                                         "object")
                except (ValueError, TimeoutError, OSError) as e:
                    self._send_json(400,
                                    {"error": f"bad request: {e}"})
                    return
                rid = (self.headers.get("X-Request-Id")
                       or f"r-{uuid.uuid4().hex[:12]}")
                try:
                    status, headers, body = router._serve(
                        p, payload, rid, is_generate=routes[p])
                except Exception as e:     # router-internal fault
                    self._send_json(500, {
                        "error": f"router: {type(e).__name__}: {e}"})
                    return
                self._send(status, headers, body)

        return Handler

    # ---- lifecycle ---------------------------------------------------
    def start(self, wait_probe_s: float = 10.0) -> "ReplicaRouter":
        """Launch the probe thread and the listener; blocks (up to
        ``wait_probe_s``) until the first probe sweep completes so the
        first routed request sees real replica states, not
        ``unknown``."""
        if self._probe_thread is not None:
            return self
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="router-probe", daemon=True)
        self._probe_thread.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="router-http",
            daemon=True)
        self._http_thread.start()
        self._probed_once.wait(timeout=wait_probe_s)
        return self

    def serve(self) -> None:
        """Blocking serve loop (the CLI path)."""
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.close()

    def close(self) -> None:
        self._stop.set()
        if self._ring_hold is not None:
            obs_trace.release_always_on(self._ring_hold)
            self._ring_hold = None
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
            self._probe_thread = None
        if self._http_thread is not None:
            # shutdown() handshakes with a RUNNING serve_forever loop;
            # on a never-started router it would wait forever
            self._httpd.shutdown()
            self._http_thread.join(timeout=5)
            self._http_thread = None
        self._httpd.server_close()

    def __enter__(self) -> "ReplicaRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


class InProcessFleet:
    """N in-process :class:`~.serving_http.PredictServer` replicas over
    ONE export dir behind one :class:`ReplicaRouter`: the fleet the
    tests, the chaos drills and the load harness's router leg drive.
    Each replica's ``crash_fn`` wires the ``replica.crash`` seam to a
    hard :meth:`~.serving_http.PredictServer.kill`. ``server_kw`` goes
    to every server (``device="cpu"`` serves without a card; the
    default is the card). The replicas share the process, so on one
    card they share its context and their engines' dispatches
    serialize on the device."""

    def __init__(self, export_dir: str, n: int, *,
                 server_kw: dict | None = None, **router_kw):
        from .serving_http import PredictServer
        if n < 1:
            raise ValueError(f"a fleet needs >= 1 replica, got {n}")
        self.export_dir = export_dir
        self._server_kw = dict(server_kw or {})
        self.servers: list[PredictServer] = []
        reps: list[Replica] = []
        for i in range(n):
            # each replica gets its own trace-lane process label so the
            # shared in-process ring's per-replica /trace/export drains
            # (and incident bundle filenames) segregate
            srv = PredictServer(export_dir,
                                process_name=f"replica{i}",
                                **self._server_kw).start()
            self.servers.append(srv)
            reps.append(Replica(f"http://127.0.0.1:{srv.port}",
                                name=f"replica{i}",
                                crash_fn=srv.kill))
        router_kw.setdefault("name", self.servers[0].name)
        self.router = ReplicaRouter(reps, **router_kw).start()
        self.port = self.router.port
        self.name = self.router.name

    def crash(self, i: int) -> None:
        """Hard-kill replica ``i`` (listener torn down, engine failed
        fast) — the externally-triggered twin of the seam path."""
        self.servers[i].kill()

    def restart(self, i: int) -> None:
        """Bring replica ``i`` back on a FRESH server (new port, same
        artifact) — the prober re-admits it and the half-open probe
        closes its breaker."""
        from .serving_http import PredictServer
        srv = PredictServer(self.export_dir,
                            process_name=f"replica{i}",
                            **self._server_kw).start()
        self.servers[i] = srv
        rep = self.router.replicas[i]
        rep.url = f"http://127.0.0.1:{srv.port}"
        rep.crash_fn = srv.kill

    def close(self) -> None:
        self.router.close()
        for srv in self.servers:
            try:
                srv.stop(drain=False)
            except Exception:     # an already-crashed replica is fine
                pass

    def __enter__(self) -> "InProcessFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def main(argv=None) -> int:
    """``python -m distributed_tensorflow_example_tpu_torch.serving_router
    --replica URL [--replica URL ...]`` — one fleet address until
    interrupted."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--replica", action="append", required=True,
                    help="replica base URL (repeatable), e.g. "
                    "http://10.0.0.2:8501")
    ap.add_argument("--name", default="model",
                    help="model name in the client-facing route "
                    "(/v1/models/<name>:generate)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--retry_budget", type=int, default=2,
                    help="failed forwards retried per request, each on "
                    "a DIFFERENT replica (0 = fail on first error)")
    ap.add_argument("--hedge_after_ms", type=int, default=0,
                    help="launch a hedged second :generate attempt on "
                    "another replica after this many ms without a "
                    "response; first response wins, the loser is "
                    "cancelled via POST /cancel/<rid> (0 = off)")
    ap.add_argument("--breaker_threshold", type=int, default=3,
                    help="consecutive forward/probe failures that trip "
                    "a replica's circuit breaker open")
    ap.add_argument("--breaker_cooldown_s", type=float, default=2.0,
                    help="seconds an open breaker waits before the "
                    "half-open recovery probe")
    ap.add_argument("--probe_interval_s", type=float, default=0.25,
                    help="health-probe cadence per replica")
    ap.add_argument("--dead_after_probes", type=int, default=2,
                    help="consecutive failed probes before a replica "
                    "is marked dead")
    ap.add_argument("--forward_timeout_s", type=float, default=300.0,
                    help="per-forward HTTP timeout")
    ap.add_argument("--metrics", choices=("on", "off"), default="on",
                    help="router registry behind GET /metrics and "
                    "/stats (replica pages merge in either way)")
    ap.add_argument("--trace_sample", type=float, default=1.0,
                    help="fraction of client requests opened as "
                    "distributed traces (root span + traceparent "
                    "propagation to the replicas); 1.0 = every "
                    "request, 0.0 = ids only, no spans")
    ap.add_argument("--flight_recorder", choices=("on", "off"),
                    default="on",
                    help="always-on span ring + auto incident bundles "
                    "at the router (breaker_open / replica_death); "
                    "off = ring armed on demand only")
    ap.add_argument("--incident_dir", default=None,
                    help="directory for router incident bundles "
                    "(unset = none written even with the recorder on)")
    ap.add_argument("--fault_spec", default=None,
                    help="arm the fleet fault seams (router.probe / "
                    "router.forward / replica.crash) — chaos drills "
                    "only")
    ap.add_argument("--fault_seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.fault_spec:
        faults.install(faults.parse_spec(args.fault_spec,
                                         seed=args.fault_seed))
    router = ReplicaRouter(
        args.replica, name=args.name, host=args.host, port=args.port,
        retry_budget=args.retry_budget,
        hedge_after_ms=args.hedge_after_ms,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        probe_interval_s=args.probe_interval_s,
        dead_after_probes=args.dead_after_probes,
        forward_timeout_s=args.forward_timeout_s,
        metrics=args.metrics == "on",
        trace_sample=args.trace_sample,
        flight_recorder=args.flight_recorder == "on",
        incident_dir=args.incident_dir)
    print(f"routing {len(router.replicas)} replica(s) on "
          f"http://{args.host}:{router.port}/v1/models/"
          f"{router.name}:generate", flush=True)
    router.serve()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
