"""REST predict server over an export (port of
``distributed_tensorflow_example_tpu/serving_http.py``: the single server,
without the fleet router in front of it).

Routes (the TF Serving REST shapes, as in the reference)::

    POST /v1/models/<name>:predict               # forward exports
    {"instances": [{"x": [...]}, ...]}           # row format, or
    {"inputs": {"x": [[...], ...]}}              # columnar format
    -> {"predictions": [[...], ...]}

    POST /v1/models/<name>:generate              # generator exports
    {"inputs": {"input_ids": [[...]], "prompt_mask": [[...]]}, "seed": 7}
    -> {"generations": [[token ids], ...]}

    GET  /v1/models/<name>                       # status probe
    GET  /healthz  /stats  /stats/history  /metrics  /trace/export
    POST /trace/start  /trace/stop  /cancel/<request_id>

A forward export (``serving.export_model``, or ``cli/train.py
--export_dir``) answers ``:predict``; a generator export answers
``:generate``; each refuses the other route with a 400 naming the right
one. Both run on the server's device (``cuda`` by default).

Scheduling: with ``scheduler="on"`` (``"auto"`` turns it on for a
generator export that carries the ``stepwise`` block; a forward export
stays on the plain path unless asked) ``:generate`` rides the
continuous-batching :class:`~.serving_batch.GenerationEngine` and
``:predict`` the :class:`~.serving_batch.MicroBatcher` (up to
``batch_max_size`` rows or ``batch_max_wait_ms``, power-of-two buckets).
A full queue answers 429 with ``Retry-After``. ``scheduler="off"`` runs
one call per request behind a single-flight lock: the parity oracle.
Client mistakes answer 400, a failure while running the model 500.

The engine's knobs, as in the reference: ``--spec_tokens K`` and
``--prefill_chunk_tokens C`` arm speculative decoding and chunked prefill
over an export that carries them (auto-off with a warning otherwise, and
clamped to the export's width); ``deadline_ms`` (or
``--default_deadline_ms``) bounds a request (expiry 504); ``priority``
orders admission; ``--shed_policy auto`` sheds 429 with a measured
``Retry-After``. On an H100 a prefill chunk, like the whole prefill, is
bound by its host launches, so chunking does not yet cut the stall of
live decoders there.

Operator surface (one :class:`~.obs.registry.Registry` shared by the
server, its engine and its batcher):

- ``GET /metrics`` renders the same atomic snapshot ``/stats`` reads as
  Prometheus text, so the two cannot drift; ``--metrics off`` turns
  every increment into one branch.
- ``POST /trace/start`` arms the span ring (clearing it), ``POST
  /trace/stop`` disarms it and returns its Chrome trace-event JSON, and
  ``GET /trace/export`` DRAINS this server's spans (its process label):
  a second export is empty. A ``traceparent`` header on ``:generate``
  parents the engine's spans (``trace_id`` in the response).
- ``--history_interval_s S`` samples the snapshot into a ring every S
  seconds for ``GET /stats/history`` (a poll adds a fresh sample), and
  evaluates ``--slo_spec`` objectives over it: attainment and fast/slow
  burn rates, an advisory ``slo`` block on ``/healthz``, and a
  rate-limited ``slo_burn`` incident bundle on a multi-window breach.
- The flight recorder (``--flight_recorder on``, the default) runs the
  span ring always-on, and the failure seams (a stalled watchdog here;
  an engine-fatal rebuild or a poison eviction in the engine; an SLO
  burn) write incident bundles to ``--incident_dir``. Off, and with
  ``--metrics off``, serving is byte- and dispatch-identical.
- ``POST /cancel/<rid>`` cancels a queued or live request (200/404; its
  own waiter gets 409), returning its cache blocks at the next step.
- ``stop()`` (and SIGTERM) drains: new admissions answer 503 with
  ``Retry-After`` while queued and in-flight requests finish under
  ``--drain_timeout_s``; ``stop(drain=False)`` fails them fast;
  :meth:`PredictServer.kill` drops the listener at once, as a crash.
- ``--request_log PATH`` writes one JSONL event per retired request;
  ``--fault_spec`` arms the engine seams and the ``http.read`` seam.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from .obs import prom as obs_prom
from .obs import slo as obs_slo
from .obs import timeseries as obs_ts
from .obs import trace as obs_trace
from .obs.flightrec import FlightRecorder
from .obs.registry import Registry
from .runtime import faults
from .serving import has_stepwise, load_servable, load_stepwise, read_meta
from .serving_batch import (DeadlineExceededError, DrainingError,
                            EngineStalledError, GenerationEngine,
                            MicroBatcher, QueueFullError,
                            RequestCancelledError)
from .utils.logging import get_logger

log = get_logger("serving")

# the default trace-lane process label of a server's spans, incidents
# and history payloads (``process_name`` overrides it: in-process fleet
# replicas each take their own)
PROCESS = "serving"


class _ServerFault(Exception):
    """A failure while running the model (device error, out of memory,
    ...): a 500 even when the underlying type is ValueError/TypeError, the
    types the request-validation path maps to 400."""


class _Listener(ThreadingHTTPServer):
    """The stdlib threading server with a deeper accept backlog: at the
    stdlib's 5, a burst of concurrent clients overflows it, and each
    dropped connection attempt costs its client a 1 s retransmit."""

    request_queue_size = 128


def _effective_width(flag: str, asked: int, exported: int, export_dir: str,
                     what: str, knob: str) -> int:
    """The reference's auto-off and clamp rules for an engine knob that
    asks for an optimization: an export without the step serves with the
    knob off, one narrower than asked serves at its own width, each with
    a warning (the knob is an optimization, not a contract)."""
    if asked and not exported:
        log.warning("%s %d requested but %r carries no %s — it is "
                    "disabled for this server; re-export with "
                    "export_generator(..., %s) to enable it", flag, asked,
                    export_dir, what, knob)
        return 0
    if asked > exported:
        log.warning("%s %d exceeds this export's width %d — clamping to "
                    "%d", flag, asked, exported, exported)
        return exported
    return asked


class PredictServer:
    """Serve one export directory over HTTP.

    >>> srv = PredictServer(export_dir, device="cpu").start()
    >>> ... POST http://127.0.0.1:{srv.port}/v1/models/<name>:predict
    >>> srv.stop()
    """

    def __init__(self, export_dir: str, *, name: str | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 scheduler: str = "auto", device=None,
                 batch_max_size: int = 8, batch_max_wait_ms: float = 5.0,
                 max_queue: int = 64, prefix_cache: bool = True,
                 metrics: bool = True, trace_buffer_events: int = 65536,
                 request_log: str | None = None,
                 thread_sanitizer: bool = False,
                 default_deadline_ms: int = 0,
                 drain_timeout_s: float = 30.0,
                 stall_after_s: float = 10.0, spec_tokens: int = 0,
                 prefill_chunk_tokens: int = 0,
                 default_priority: str = "interactive",
                 shed_policy: str = "auto",
                 priority_aging_ms: int = 2000,
                 flight_recorder: bool = True,
                 incident_dir: str | None = None,
                 history_interval_s: float = 0.0,
                 history_samples: int = 600,
                 slo_spec: str | None = None,
                 slo_fast_window_s: float = obs_slo.FAST_WINDOW_S,
                 slo_slow_window_s: float = obs_slo.SLOW_WINDOW_S,
                 slo_burn_threshold: float = obs_slo.BURN_THRESHOLD,
                 process_name: str | None = None):
        if scheduler not in ("auto", "on", "off"):
            raise ValueError(f"scheduler must be auto/on/off, got "
                             f"{scheduler!r}")
        meta = read_meta(export_dir)
        is_gen = meta.get("kind") == "generator"
        stepwise = has_stepwise(export_dir)
        if scheduler == "auto":
            # on exactly for a stepwise generator; a forward export stays
            # on the plain path, a pure parity tool, unless asked
            scheduler = "on" if (is_gen and stepwise) else "off"
        if scheduler == "on" and is_gen and not stepwise:
            # as the reference: a monolithic generator has no stepwise
            # programs for the continuous-batching engine to drive
            raise ValueError(
                f"scheduler='on' needs stepwise generator artifacts in "
                f"{export_dir!r} — re-export with export_generator(..., "
                "stepwise=True), or serve with scheduler='off'")
        if thread_sanitizer and not (scheduler == "on" and is_gen):
            # checked before anything starts: a raise must not leave a
            # running batcher behind
            raise ValueError(
                "thread_sanitizer=True guards the GenerationEngine's "
                "scheduler-owned fields, but this server would run the "
                f"{'predict/MicroBatcher' if not is_gen else 'plain'} "
                f"path (scheduler {scheduler!r}, kind "
                f"{meta.get('kind')!r}) where nothing is guarded — drop "
                "the flag or serve stepwise generator artifacts with "
                "scheduler on/auto")
        if history_interval_s < 0:
            raise ValueError(f"history_interval_s must be >= 0 (0 = "
                             f"sampler off), got {history_interval_s}")
        if slo_spec and not history_interval_s:
            raise ValueError(
                "--slo_spec declares objectives but --history_interval_s "
                "is 0 — burn rates are windowed over the history ring; "
                "arm the sampler to evaluate them")
        self.scheduler = scheduler
        self.kind = meta.get("kind")
        self.process_name = process_name or PROCESS
        # one registry for the whole server (engine/batcher counters and
        # the HTTP-level ones); metrics=False disables every increment
        self.registry = Registry(enabled=metrics, namespace="serving")
        self._c_http_requests = self.registry.counter(
            "http_requests_total", "HTTP requests handled")
        self._c_http_errors = self.registry.counter(
            "http_errors_total", "HTTP responses with status >= 400")
        self._c_quant_fallback = self.registry.counter(
            "serving_quant_fallback_total",
            "generator artifacts loaded without quant metadata "
            "(exported before the quant schema — no quantized paths)")
        if is_gen and meta.get("quant_schema") is None:
            self._c_quant_fallback.inc()
        self._request_logger = None
        if request_log:
            from .utils.metrics import MetricsLogger
            self._request_logger = MetricsLogger(request_log)
        self._c_incidents = self.registry.counter(
            "serving_incidents_total",
            "incident bundles written by the flight recorder")
        self._c_incidents_suppressed = self.registry.counter(
            "serving_incidents_suppressed_total",
            "incident bundles suppressed by the per-cause rate limit")
        self._flightrec = None
        if flight_recorder and incident_dir:
            self._flightrec = FlightRecorder(
                incident_dir, process=self.process_name,
                snapshot_fn=self._metrics_snapshot,
                config={"scheduler": scheduler, "max_queue": max_queue,
                        "prefix_cache": prefix_cache, "metrics": metrics,
                        "trace_buffer_events": trace_buffer_events,
                        "default_deadline_ms": default_deadline_ms,
                        "drain_timeout_s": drain_timeout_s,
                        "stall_after_s": stall_after_s,
                        "spec_tokens": spec_tokens,
                        "prefill_chunk_tokens": prefill_chunk_tokens,
                        "default_priority": default_priority,
                        "shed_policy": shed_policy,
                        "batch_max_size": batch_max_size,
                        "batch_max_wait_ms": batch_max_wait_ms,
                        "export_dir": export_dir,
                        "model": name or meta.get("model", "model")},
                request_log_path=request_log,
                counter=self._c_incidents,
                suppressed_counter=self._c_incidents_suppressed)
        # SLO observability: off by default (no sampler exists and no
        # request-path code looks for one); the sampler only reads the
        # registry on its own thread, so arming it changes no byte
        self.slo_fast_window_s = float(slo_fast_window_s)
        self.slo_slow_window_s = float(slo_slow_window_s)
        self.slo_burn_threshold = float(slo_burn_threshold)
        self._slo_objectives: list[obs_slo.Objective] = []
        self._slo_lock = threading.Lock()
        self._slo_results: list[dict] | None = None
        self._sampler = None
        if history_interval_s:
            self._slo_objectives = (obs_slo.parse_slo_spec(slo_spec)
                                    if slo_spec
                                    else obs_slo.default_objectives())
            # a p95_ms target beyond the latency histograms' finite
            # buckets cannot be evaluated: refuse it at arm time
            from .obs.registry import SERVING_LATENCY_BUCKETS
            top_ms = max(SERVING_LATENCY_BUCKETS) * 1e3
            for o in self._slo_objectives:
                if o.kind == "p95_ms" and o.target > top_ms:
                    raise ValueError(
                        f"slo_spec objective {o.key()}: target "
                        f"{o.target:g} ms exceeds the latency "
                        f"histograms' largest finite bucket "
                        f"({top_ms:g} ms) — observations beyond it are "
                        "indistinguishable, so this objective cannot be "
                        "evaluated; lower the target")
            self._sampler = obs_ts.SnapshotSampler(
                self._metrics_snapshot, interval_s=history_interval_s,
                max_samples=history_samples,
                on_sample=self._on_history_sample)
        # the single-flight lock of the plain path: handler threads must
        # not race the model (the scheduler paths serialize by design)
        self._exec_lock = threading.Lock()
        self.engine: GenerationEngine | None = None
        self.batcher: MicroBatcher | None = None
        self.servable = None
        if scheduler == "on" and is_gen:
            sw = load_stepwise(export_dir, device)
            self.meta, self.device = sw.meta, sw.device
            spec_tokens = _effective_width(
                "--spec_tokens", spec_tokens, sw.spec_tokens, export_dir,
                "verify step", "spec_tokens=K")
            prefill_chunk_tokens = _effective_width(
                "--prefill_chunk_tokens", prefill_chunk_tokens,
                sw.prefill_chunk_tokens, export_dir, "chunked prefill",
                "prefill_chunk=C")
            self.engine = GenerationEngine(
                sw, max_queue=max_queue, prefix_cache=prefix_cache,
                registry=self.registry,
                metrics_logger=self._request_logger,
                thread_sanitizer=thread_sanitizer,
                default_deadline_ms=default_deadline_ms,
                drain_timeout_s=drain_timeout_s,
                stall_after_s=stall_after_s, spec_tokens=spec_tokens,
                prefill_chunk_tokens=prefill_chunk_tokens,
                default_priority=default_priority, shed_policy=shed_policy,
                priority_aging_ms=priority_aging_ms,
                process=self.process_name,
                flight_recorder=self._flightrec).start()
            if self._flightrec is not None:
                # the bundle must name the knobs that actually run, after
                # the auto-off and clamp rules
                self._flightrec.config.update({
                    "spec_tokens": self.engine.spec_tokens,
                    "prefill_chunk_tokens":
                        self.engine.prefill_chunk_tokens})
        else:
            self.servable = load_servable(export_dir, device)
            self.meta, self.device = self.servable.meta, self.servable.device
            if scheduler == "on":
                self.batcher = MicroBatcher(
                    self.servable, batch_max_size=batch_max_size,
                    batch_max_wait_ms=batch_max_wait_ms,
                    max_queue=max_queue, registry=self.registry,
                    process=self.process_name).start()
        self.name = name or self.meta.get("model", "model")
        self._httpd = _Listener((host, port), self._make_handler())
        self.port = self._httpd.server_address[1]
        # the flight recorder runs the ring always-on (without clearing a
        # capture someone else armed) until stop()/kill() give it back;
        # off, the ring is armed on demand. Armed last: a constructor
        # that raises leaves no hold behind
        self._ring_hold = None
        if flight_recorder:
            self._ring_hold = obs_trace.arm_always_on(trace_buffer_events)
        else:
            obs_trace.ensure_capacity(trace_buffer_events)
        self._thread: threading.Thread | None = None
        # serve_forever ran (or is about to): only then may shutdown()
        # be called, which otherwise waits forever
        self._serving = False

    # -- request plumbing ----------------------------------------------
    def _feature_arrays(self, payload: dict, sig: dict | None = None
                        ) -> tuple[dict[str, np.ndarray], int]:
        if sig is None:
            sig = self.meta["input_signature"]
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        if "instances" in payload:
            rows = payload["instances"]
            if not isinstance(rows, list) or not rows:
                raise ValueError("'instances' must be a non-empty list")
            if not isinstance(rows[0], dict):
                if len(sig) != 1:
                    raise ValueError(
                        f"bare instances need a single-input model; "
                        f"this one takes {sorted(sig)}")
                only = next(iter(sig))
                rows = [{only: r} for r in rows]
            keys = set(rows[0])
            for i, r in enumerate(rows):
                if not isinstance(r, dict) or set(r) != keys:
                    # a key present only in later rows would vanish from
                    # the columns below: the dropped-feature failure
                    got = (sorted(r) if isinstance(r, dict)
                           else type(r).__name__)
                    raise ValueError(
                        f"instance {i} keys {got} differ from instance 0 "
                        f"keys {sorted(keys)}")
            cols = {k: [r[k] for r in rows] for k in keys}
        elif "inputs" in payload:
            cols = payload["inputs"]
            if not isinstance(cols, dict):
                if len(sig) != 1:
                    raise ValueError(
                        f"bare inputs need a single-input model; this "
                        f"one takes {sorted(sig)}")
                cols = {next(iter(sig)): cols}
        else:
            raise ValueError("request needs 'instances' or 'inputs'")
        missing = set(sig) - set(cols)
        if missing:
            raise ValueError(f"missing model inputs {sorted(missing)} "
                             f"(want {sorted(sig)})")
        unknown = set(cols) - set(sig)
        if unknown:
            # a silently dropped feature is worse than an error: a
            # prompt_mask POSTed to a non-ragged export would otherwise
            # decode the pad ids as real prompt tokens
            raise ValueError(f"unknown model inputs {sorted(unknown)} "
                             f"(this artifact takes {sorted(sig)})")
        out, counts = {}, set()
        for key, spec in sig.items():
            arr = np.asarray(cols[key], dtype=np.dtype(spec["dtype"]))
            want_tail = tuple(spec["shape"][1:])
            if arr.shape[1:] != want_tail:
                raise ValueError(
                    f"input {key!r} has per-instance shape "
                    f"{arr.shape[1:]}, model wants {want_tail}")
            counts.add(arr.shape[0])
            out[key] = arr
        if len(counts) != 1:
            raise ValueError(
                f"inputs disagree on instance count: {sorted(counts)}")
        n = counts.pop()
        if n == 0:
            raise ValueError("request contains zero instances")
        if not self.meta.get("batch_polymorphic", True):
            # static-batch artifact (a generator export): pad up to the
            # exported batch
            # (repeating the first instance) and truncate the answer;
            # more instances than the export's batch is the client's error
            b_exp = next(iter(sig.values()))["shape"][0]
            if n > b_exp:
                raise ValueError(
                    f"this artifact was exported with a static batch of "
                    f"{b_exp} instances; got {n} (requests up to {b_exp} "
                    "are padded server-side)")
            if n < b_exp:
                out = {k: np.concatenate([v, np.repeat(v[:1], b_exp - n,
                                                       0)])
                       for k, v in out.items()}
        return out, n

    def _execute(self, feats, seed=None) -> np.ndarray:
        try:
            with self._exec_lock:
                return np.asarray(self.servable(feats, seed=seed))
        except Exception as e:
            raise _ServerFault(f"{type(e).__name__}: {e}") from e

    def predict(self, payload: dict, request_id: str | None = None,
                trace: obs_trace.TraceContext | None = None) -> dict:
        """The forward route: feature rows -> ``{"predictions": logits}``,
        through the micro-batcher when the scheduler is on."""
        if self.kind != "forward":
            raise ValueError(
                "this artifact is a generator — POST to :generate")
        if self.batcher is not None:
            feats, n = self._feature_arrays(payload)
            preds = self.batcher.submit(feats, n).result(timeout=300)
            return {"predictions": np.asarray(preds).tolist()}
        feats, n = self._feature_arrays(payload)
        logits = self._execute(feats)
        return {"predictions": logits[:n].tolist()}

    def _prompt_limit(self) -> int | None:
        """The exported prompt capacity (explicit metadata; the input
        signature's second dim otherwise)."""
        pl = self.meta.get("prompt_len")
        if pl is not None:
            return int(pl)
        spec = self.meta["input_signature"].get("input_ids")
        return int(spec["shape"][1]) if spec else None

    def _check_prompt_lengths(self, payload: dict) -> None:
        """A prompt longer than the export's capacity is a 400 naming the
        limit, not an opaque shape error."""
        limit = self._prompt_limit()
        if limit is None:
            return
        rows = None
        if isinstance(payload.get("inputs"), dict):
            rows = payload["inputs"].get("input_ids")
        elif isinstance(payload.get("instances"), list):
            rows = [r.get("input_ids") for r in payload["instances"]
                    if isinstance(r, dict)]
        if not isinstance(rows, list):
            return                     # malformed: canonical checks handle
        for i, row in enumerate(rows):
            if isinstance(row, (list, np.ndarray)) and len(row) > limit:
                raise ValueError(
                    f"prompt {i} has {len(row)} tokens, which exceeds "
                    f"this artifact's exported prompt capacity {limit} "
                    "(prompt_len in export.json; re-export with a "
                    "larger prompt_len to serve longer prompts)")

    def _generate_scheduled(self, payload: dict,
                            request_id: str | None = None,
                            trace: obs_trace.TraceContext | None = None
                            ) -> dict:
        """:generate via the continuous-batching engine: each instance
        row becomes one engine request (row i samples under ``seed + i``
        so rows stay independent). Rows may be SHORTER than the exported
        prompt capacity; a ``prompt_mask`` row keeps its nonzero
        positions. Every row gets a request id (the client's
        ``X-Request-Id``, suffixed per row, or an engine-generated one);
        the response carries ``request_ids`` and the per-request
        ``timings`` beside ``generations``, and ``trace_id`` under a
        propagated ``traceparent``."""
        self._check_prompt_lengths(payload)
        rows = masks = None
        if isinstance(payload.get("inputs"), dict):
            rows = payload["inputs"].get("input_ids")
            masks = payload["inputs"].get("prompt_mask")
        elif isinstance(payload.get("instances"), list):
            inst = payload["instances"]
            if not all(isinstance(r, dict) for r in inst):
                raise ValueError("generate instances must be dicts with "
                                 "'input_ids'")
            bad_keys = set().union(*[set(r) for r in inst]) \
                - {"input_ids", "prompt_mask"}
            if bad_keys:
                raise ValueError(
                    f"unknown model inputs {sorted(bad_keys)} (the "
                    "scheduler takes input_ids and prompt_mask)")
            rows = [r.get("input_ids") for r in inst]
            masks = ([r.get("prompt_mask") for r in inst]
                     if any("prompt_mask" in r for r in inst) else None)
        else:
            raise ValueError("request needs 'instances' or 'inputs'")
        if not isinstance(rows, list) or not rows or any(
                r is None for r in rows):
            raise ValueError("generate needs non-empty 'input_ids' rows")
        if masks is not None and len(masks) != len(rows):
            raise ValueError("prompt_mask row count != input_ids rows")
        unknown = (set(payload.get("inputs", {}))
                   - {"input_ids", "prompt_mask"}
                   if isinstance(payload.get("inputs"), dict) else set())
        if unknown:
            raise ValueError(f"unknown model inputs {sorted(unknown)} "
                             "(the scheduler takes input_ids and "
                             "prompt_mask)")

        def knob(name, conv):
            v = payload.get(name)
            if v is None:
                return None
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"{name!r} must be a number, got {v!r}")
            return conv(v)

        kw = {"max_new": knob("max_new", int),
              "temperature": knob("temperature", float),
              "top_k": knob("top_k", int),
              "top_p": knob("top_p", float),
              # per-request latency budget (ms; the engine's default when
              # absent): expiry retires the slot between steps, a 504
              "deadline_ms": knob("deadline_ms", int),
              # per-request speculative width: 0 opts out of drafting,
              # 2..--spec_tokens caps it (> 0 on a spec-off server: 400)
              "spec_tokens": knob("spec_tokens", int)}
        prio = payload.get("priority")
        if prio is not None:
            # the class set is validated by the engine on this thread
            if not isinstance(prio, str):
                raise ValueError(
                    f"'priority' must be a string, got {prio!r}")
            kw["priority"] = prio
        stop = payload.get("stop_sequences")
        if stop is not None:
            # shape/type validation happens in the engine's _make_request
            # (on this handler thread), so a bad list is a clean 400
            kw["stop_sequences"] = stop
        seed = payload.get("seed", 0)
        if isinstance(seed, bool) or not isinstance(seed, int):
            raise ValueError(f"'seed' must be an integer, got {seed!r}")
        prompts = []
        for i, row in enumerate(rows):
            prompt = np.asarray(row, np.int32).reshape(-1)
            if masks is not None and masks[i] is not None:
                mask = np.asarray(masks[i]).reshape(-1)
                if mask.shape != prompt.shape:
                    raise ValueError(
                        f"prompt_mask row {i} shape {mask.shape} != "
                        f"input_ids row shape {prompt.shape}")
                if not np.any(mask != 0):
                    raise ValueError("every prompt_mask row needs at "
                                     "least one real token")
                prompt = prompt[mask != 0]
            prompts.append(prompt)
        rids = None
        if request_id:
            rids = ([request_id] if len(prompts) == 1 else
                    [f"{request_id}-{i}" for i in range(len(prompts))])
        # a propagated traceparent parents the engine's slot-lane spans;
        # an unsampled context contributes nothing
        trace_args = trace.span_args() if trace is not None else {}
        # validates EVERY row before queueing ANY, and the enqueue is
        # atomic: a 400/429 on row k leaves no rows generating for nobody
        handles = self.engine.submit_many(prompts, seed=seed,
                                          request_ids=rids,
                                          trace=trace_args or None, **kw)
        try:
            gens = [h.result(timeout=300) for h in handles]
        except BaseException as e:
            # one row's failure fails the whole response: cancel the
            # siblings still running instead of decoding for nobody
            for h in handles:
                if not h.done():
                    h.cancel()
            if isinstance(e, (DeadlineExceededError, RequestCancelledError)):
                raise                  # the handler maps these to 504/409
            if isinstance(e, (TimeoutError, RuntimeError)):
                raise _ServerFault(f"{type(e).__name__}: {e}") from e
            raise
        out = {"generations": gens,
               "request_ids": [h.request_id for h in handles],
               "timings": [h.timings for h in handles]}
        if trace is not None:
            out["trace_id"] = trace.trace_id
        return out

    def generate(self, payload: dict, request_id: str | None = None,
                 trace: obs_trace.TraceContext | None = None) -> dict:
        """The decode route: ``{"inputs": {"input_ids": [[...]], ...},
        "seed": 7}`` -> ``{"generations": [[token ids]]}``. With the
        scheduler on, each row rides the engine (per-request sampling
        knobs in the payload; see :meth:`_generate_scheduled`); off, the
        sampling generator is seeded server-side from the request's
        integer ``seed`` (default 0)."""
        if self.kind != "generator":
            raise ValueError(
                "this artifact is not a generator — POST to :predict "
                "(export with export_generator for a decode artifact)")
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        if self.engine is not None:
            return self._generate_scheduled(payload, request_id, trace)
        for knob in ("stop_sequences", "spec_tokens", "deadline_ms",
                     "priority"):
            if payload.get(knob) is not None:
                raise ValueError(
                    f"{knob!r} requires the continuous-batching "
                    "scheduler (this server runs scheduler='off'; the "
                    "monolithic generator cannot honor it)")
        self._check_prompt_lengths(payload)
        feats, n = self._feature_arrays(payload)
        pm = feats.get("prompt_mask")
        if pm is not None and not np.all(np.sum(pm != 0, axis=1) > 0):
            # an all-masked row would prefill over an empty key set and
            # return arbitrary tokens with a 200
            raise ValueError(
                "every prompt_mask row needs at least one real token")
        seed = None
        if self.meta["temperature"] > 0.0:
            seed = payload.get("seed", 0)
            # bool is an int subclass (true would silently mean seed 1)
            if isinstance(seed, bool) or not isinstance(seed, int) \
                    or not -(2 ** 63) <= seed < 2 ** 63:
                raise ValueError(f"'seed' must be an int64-range integer, "
                                 f"got {seed!r}")
        toks = self._execute(feats, seed)
        return {"generations": toks[:n].tolist()}

    # -- operator surface ----------------------------------------------
    def _metrics_snapshot(self) -> dict:
        """The one atomic registry snapshot both ``/stats`` and
        ``/metrics`` render, gauges freshened (the engine and batcher
        share ``self.registry``)."""
        if self.engine is not None:
            return self.engine.metrics_snapshot()
        if self.batcher is not None:
            return self.batcher.metrics_snapshot()
        return self.registry.snapshot()

    def metrics_text(self) -> str:
        """``GET /metrics``: Prometheus text exposition."""
        return obs_prom.render(self._metrics_snapshot())

    def _on_history_sample(self, sampler) -> None:
        """Runs after every cadence capture; ``GET /stats/history`` polls
        evaluate separately over the ring and their fresh sample."""
        self._evaluate_slo(sampler.history())

    def _evaluate_slo(self, history) -> list[dict] | None:
        """Evaluate the objectives over ``history``, publish the results
        for ``/healthz`` and ``/stats/history``, and turn a multi-window
        burn breach into a rate-limited ``slo_burn`` incident bundle.
        Never raises into its caller."""
        try:
            results = obs_slo.evaluate(
                history, self._slo_objectives,
                fast_s=self.slo_fast_window_s,
                slow_s=self.slo_slow_window_s,
                threshold=self.slo_burn_threshold)
        except Exception as e:          # noqa: BLE001 — see docstring
            log.warning("slo evaluation failed: %s", e)
            return None
        with self._slo_lock:
            self._slo_results = results
        breaching = [r for r in results if r["breach"]]
        if breaching and self._flightrec is not None:
            worst = max(breaching, key=lambda r: r["burn_fast"])
            tail = list(history)[-8:]
            self._flightrec.incident(
                "slo_burn",
                detail=(f"{worst['class']}:{worst['kind']} burning "
                        f"{worst['burn_fast']}x fast / "
                        f"{worst['burn_slow']}x slow (goal "
                        f"{worst['goal']}, attainment "
                        f"{worst['attainment']})"),
                extra={"slo": results,
                       "slo_windows": {
                           "fast_s": self.slo_fast_window_s,
                           "slow_s": self.slo_slow_window_s,
                           "threshold": self.slo_burn_threshold},
                       "history_tail": [[t, snap] for t, snap in tail]})
        return results

    def stats_history(self) -> dict:
        """``GET /stats/history``: the time-series ring as JSON (``[t,
        snapshot]`` samples in this process's perf_counter clock), the
        declared objectives and the latest burn-rate results. The poll
        adds an ephemeral fresh sample (never stored, so pollers cannot
        erode the ring) and evaluates over ring + it. Sampler off:
        ``{"enabled": false}`` with no samples, still a 200."""
        if self._sampler is None:
            return {"enabled": False, "process": self.process_name,
                    "clock": time.perf_counter(), "samples": [],
                    "slo": None}
        history = self._sampler.history() + [self._sampler.peek()]
        results = self._evaluate_slo(history)
        if results is None:
            with self._slo_lock:
                results = self._slo_results
        return obs_ts.to_payload(
            history, enabled=True, process=self.process_name,
            clock=time.perf_counter(), interval_s=self._sampler.interval_s,
            max_samples=self._sampler.max_samples,
            slo={"objectives": [o.to_dict()
                                for o in self._slo_objectives],
                 "results": results,
                 "fast_window_s": self.slo_fast_window_s,
                 "slow_window_s": self.slo_slow_window_s,
                 "burn_threshold": self.slo_burn_threshold})

    def trace_start(self) -> dict:
        """``POST /trace/start``: arm the span recorder (clearing any
        previous capture)."""
        rec = obs_trace.recorder()
        rec.start()
        return {"tracing": True, "max_events": rec.max_events}

    def trace_stop(self) -> dict:
        """``POST /trace/stop``: disarm and return the capture as
        chrome://tracing / Perfetto trace-event JSON."""
        rec = obs_trace.recorder()
        rec.stop()
        return rec.to_chrome()

    def trace_export(self) -> dict:
        """``GET /trace/export``: DRAIN this server's spans (its own
        process label) as ``[process, lane, name, t0, t1, args]`` rows,
        with the local perf_counter clock beside them. A second export
        returns only what was recorded since."""
        rec = obs_trace.recorder()
        spans = rec.drain(process=self.process_name)
        return {"process": self.process_name,
                "clock": time.perf_counter(),
                "spans": [[p, lane, name, t0, t1, args]
                          for p, lane, name, t0, t1, args in spans],
                "events_dropped": rec.events_dropped,
                "enabled": rec.enabled}

    def health(self) -> dict:
        """``GET /healthz``: the engine's watchdog view (live / stalled /
        dead, with the heartbeat age) when the scheduler runs; without a
        scheduler thread, the server answering at all is the liveness
        signal. A stalled watchdog fires the flight recorder (cause
        ``watchdog_stall``, rate-limited). ``mono_now`` is this process's
        perf_counter; the SLO summary rides along as an advisory field."""
        if self.engine is not None:
            h = self.engine.health()
            if h["status"] == "stalled" and self._flightrec is not None:
                self._flightrec.incident(
                    "watchdog_stall",
                    detail=f"heartbeat {h['heartbeat_age_s']}s old "
                           f"(stall_after_s {h['stall_after_s']})",
                    extra={"health": h})
        else:
            h = {"status": "live"}
        h.update(scheduler=self.scheduler, device=str(self.device),
                 mono_now=time.perf_counter())
        if self._sampler is not None:
            with self._slo_lock:
                results = self._slo_results
            if results is not None:
                h["slo"] = obs_slo.summarize(results)
        return h

    def cancel(self, request_id: str) -> bool:
        """``POST /cancel/<request_id>``: cancel a queued or live
        ``:generate`` request. False (404) when the id is unknown, already
        retired, or there is no engine."""
        if self.engine is None:
            return False
        return self.engine.cancel(request_id)

    def stats(self) -> dict:
        """``GET /stats``: the scheduler mode plus the engine's and the
        batcher's counters, views of the snapshot ``/metrics`` renders."""
        out: dict[str, Any] = {"model": self.name,
                               "scheduler": self.scheduler}
        snap = self._metrics_snapshot()
        if self.engine is not None:
            out["generate"] = self.engine.stats(snap)
        if self.batcher is not None:
            out["predict"] = self.batcher.stats(snap)
        return out

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # a Content-Length larger than the body would otherwise block
            # rfile.read for the connection's lifetime
            timeout = 30

            def log_message(self, *a):      # quiet: tests/CLI own stdout
                pass

            def _send(self, code: int, obj: Any,
                      headers: dict | None = None) -> None:
                body = json.dumps(obj).encode()
                server._c_http_requests.inc()
                if code >= 400:
                    server._c_http_errors.inc()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_text(self, code: int, text: str,
                           content_type: str) -> None:
                body = text.encode()
                server._c_http_requests.inc()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _route(self, *paths: str) -> bool:
                return self.path in paths or self.path in tuple(
                    f"/v1/models/{server.name}{p}" for p in paths)

            def do_GET(self):
                if self.path == f"/v1/models/{server.name}":
                    self._send(200, {"model_version_status": [{
                        "version": "1", "state": "AVAILABLE",
                        "status": {"error_code": "OK",
                                   "error_message": ""}}]})
                elif self._route("/stats"):
                    self._send(200, server.stats())
                elif self._route("/stats/history"):
                    self._send(200, server.stats_history())
                elif self._route("/metrics"):
                    self._send_text(200, server.metrics_text(),
                                    obs_prom.CONTENT_TYPE)
                elif self._route("/healthz"):
                    # 200 only while live: a wedged or dead scheduler
                    # thread fails load-balancer probes
                    h = server.health()
                    self._send(200 if h["status"] == "live" else 503, h)
                elif self._route("/trace/export"):
                    self._send(200, server.trace_export())
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path == "/trace/start":
                    self._send(200, server.trace_start())
                    return
                if self.path == "/trace/stop":
                    self._send(200, server.trace_stop())
                    return
                if self.path.startswith("/cancel/"):
                    rid = self.path[len("/cancel/"):]
                    if server.cancel(rid):
                        self._send(200, {"cancelled": rid})
                    else:
                        self._send(404, {
                            "error": f"no queued or live request "
                                     f"{rid!r} (already retired, or "
                                     "never submitted)"})
                    return
                routes = {f"/v1/models/{server.name}:predict":
                          server.predict,
                          f"/v1/models/{server.name}:generate":
                          server.generate}
                route = routes.get(self.path)
                if route is None:
                    self._send(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > 1 << 30:
                        self._send(413, {"error": "request too large"})
                        return
                    # chaos seam: a dropped request body (one None-check
                    # while no fault registry is installed)
                    faults.inject("http.read", detail=self.path)
                    body = self.rfile.read(n)
                    if len(body) != n:
                        self._send(400, {"error": "truncated body"})
                        return
                    payload = json.loads(body or b"{}")
                except (ValueError, TimeoutError, OSError) as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                try:
                    self._send(200, route(
                        payload, self.headers.get("X-Request-Id") or None,
                        obs_trace.parse_traceparent(
                            self.headers.get("traceparent"))))
                except QueueFullError as e:
                    # bounded admission or a shed (ShedError): tell the
                    # client WHEN to come back, from the measured rate
                    self._send(429, {"error": str(e)},
                               headers={"Retry-After":
                                        str(int(e.retry_after + 0.5))})
                except DrainingError as e:
                    # graceful shutdown in progress: in-flight requests
                    # finish, new ones belong elsewhere
                    self._send(503, {"error": str(e)},
                               headers={"Retry-After":
                                        str(int(e.retry_after + 0.5))})
                except DeadlineExceededError as e:
                    # the request's own deadline_ms budget expired; its
                    # slot and blocks are already back in the pool
                    self._send(504, {"error": str(e)})
                except RequestCancelledError as e:
                    self._send(409, {"error": str(e)})
                except _ServerFault as e:
                    self._send(500, {"error": str(e)})
                except (ValueError, KeyError, TypeError) as e:
                    self._send(400, {"error": str(e)})   # client's fault
                except Exception as e:
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler

    # -- lifecycle ------------------------------------------------------
    def serve(self) -> None:
        """Blocking serve loop (the CLI path); Ctrl-C drains."""
        if self._sampler is not None:
            self._sampler.start()
        self._serving = True
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            self.stop()

    def start(self) -> "PredictServer":
        if self._sampler is not None:
            # the first capture lands at once: the server's zero baseline
            self._sampler.start()
        self._serving = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="predict-server", daemon=True)
        self._thread.start()
        return self

    def _close_listener(self) -> None:
        if self._serving:
            self._httpd.shutdown()
            self._serving = False
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def stop(self, drain: bool = True) -> None:
        """Shut down. ``drain=True`` (the default, and the SIGTERM path)
        is graceful: the engine stops admitting (new ``:generate``
        answer 503 + Retry-After; the listener stays up to say so),
        queued and in-flight requests finish under ``drain_timeout_s``,
        the request log flushes, THEN the listener closes.
        ``drain=False`` is fail-fast: queued and live requests fail
        loudly. Both raise :class:`~.serving_batch.EngineStalledError`
        when the scheduler thread never parks."""
        if self._sampler is not None:
            self._sampler.stop()
        try:
            if self.engine is not None and drain:
                self.engine.drain()
        finally:
            # the listener comes down even when drain() raises: a wedged
            # scheduler must not keep the socket up refusing everything
            self._close_listener()
            try:
                if self.engine is not None and not drain:
                    self.engine.close()
                if self.batcher is not None:
                    self.batcher.close()
            finally:
                self._release_ring()
                if self._request_logger is not None:
                    self._request_logger.close()

    def _release_ring(self) -> None:
        if self._ring_hold is not None:
            obs_trace.release_always_on(self._ring_hold)
            self._ring_hold = None

    def kill(self) -> None:
        """A simulated crash: the listener down NOW, the scheduler and
        batcher failed fast, no drain and no request-log flush. A wedged
        scheduler is tolerated silently (a real crash takes the wedged
        thread with it)."""
        if self._sampler is not None:
            self._sampler.stop()
        self._close_listener()
        try:
            if self.engine is not None:
                self.engine.close(timeout=5)
            if self.batcher is not None:
                self.batcher.close(timeout=5)
        except EngineStalledError:
            pass
        self._release_ring()
        if self._request_logger is not None:
            self._request_logger.close()

    def __enter__(self) -> "PredictServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv=None) -> int:
    """``python -m distributed_tensorflow_example_tpu_torch.serving_http
    --export_dir D [--port P] [--device cpu]`` — serve until interrupted
    (SIGTERM drains; Ctrl-C too)."""
    import argparse
    import signal
    ap = argparse.ArgumentParser()
    ap.add_argument("--export_dir", required=True)
    ap.add_argument("--name", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8501)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default cuda; pass "
                    "cpu to run without a GPU)")
    ap.add_argument("--scheduler", choices=("auto", "on", "off"),
                    default="auto",
                    help="continuous batching / micro-batching (auto = on "
                    "when the artifact is a stepwise generator); off = "
                    "the single-flight parity path")
    ap.add_argument("--batch_max_size", type=int, default=8,
                    help=":predict micro-batch row cap")
    ap.add_argument("--batch_max_wait_ms", type=float, default=5.0,
                    help=":predict admission window per micro-batch")
    ap.add_argument("--max_queue", type=int, default=64,
                    help="admission queue bound (full -> 429)")
    ap.add_argument("--prefix_cache", choices=("on", "off"), default="on",
                    help="paged exports: reuse cached prompt-prefix blocks")
    ap.add_argument("--metrics", choices=("on", "off"), default="on",
                    help="telemetry registry behind GET /metrics and "
                    "/stats (off = every counter increment reduces to one "
                    "branch; /stats serves zeros)")
    ap.add_argument("--trace_buffer_events", type=int, default=65536,
                    help="span ring-buffer bound (oldest events drop "
                    "first)")
    ap.add_argument("--request_log", default=None,
                    help="append one JSONL event per retired :generate "
                    "request (request_id + queue/prefill/decode ms) to "
                    "this path")
    ap.add_argument("--thread_sanitizer", action="store_true",
                    help="debug: assert the scheduler thread-ownership "
                    "discipline on every guarded engine attribute access")
    ap.add_argument("--default_deadline_ms", type=int, default=0,
                    help="latency budget of :generate requests that carry "
                    "no deadline_ms of their own (0 = none); expiry "
                    "retires the slot between steps, frees its cache "
                    "blocks, and answers 504")
    ap.add_argument("--drain_timeout_s", type=float, default=30.0,
                    help="graceful-drain budget on SIGTERM/stop(): new "
                    "admissions 503 while queued/in-flight requests "
                    "finish; a scheduler still running past it raises "
                    "EngineStalledError")
    ap.add_argument("--spec_tokens", type=int, default=0,
                    help="speculative decoding: verify up to K-1 "
                    "self-drafted tokens per shared dispatch (needs an "
                    "export with export_generator(..., spec_tokens=K); "
                    "auto-off with a warning when the export lacks the "
                    "verify step). Greedy output stays equal; 0 = off. "
                    "A request's `spec_tokens` opts out (0) or caps lower")
    ap.add_argument("--prefill_chunk_tokens", type=int, default=0,
                    help="chunked prefill: feed cold prompts to the engine "
                    "in block-aligned chunks of this many tokens, one a "
                    "scheduler iteration between shared decode steps "
                    "(needs an export with export_generator(..., "
                    "prefill_chunk=C); auto-off with a warning without "
                    "it). On an H100 a chunk, like a whole prompt's "
                    "prefill, is bound by its host launches, so chunking "
                    "does not yet cut the stall of live decoders. 0 = off")
    ap.add_argument("--default_priority",
                    choices=("interactive", "batch", "best_effort"),
                    default="interactive",
                    help="admission class of :generate requests that carry "
                    "no 'priority' of their own: orders the queue (class, "
                    "earliest deadline, FIFO, with aging) and names the "
                    "brownout rung that sheds the request")
    ap.add_argument("--shed_policy", choices=("auto", "off"),
                    default="auto",
                    help="'auto': the pressure ladder (healthy -> "
                    "shed_best_effort -> shed_batch -> interactive_only; "
                    "429 + measured Retry-After per shed class) and the "
                    "deadline-feasibility shed; 'off': only the blunt "
                    "queue-full 429")
    ap.add_argument("--stall_after_s", type=float, default=10.0,
                    help="GET /healthz reports 'stalled' (503) once the "
                    "scheduler heartbeat is older than this")
    ap.add_argument("--flight_recorder", choices=("on", "off"),
                    default="on",
                    help="always-on span ring + incident bundles (on: the "
                    "ring records without POST /trace/start so failures "
                    "have history; off: byte- and dispatch-identical "
                    "serving with the ring armed on demand only)")
    ap.add_argument("--history_interval_s", type=float, default=0.0,
                    help="metric time-series: capture the registry "
                    "snapshot into a bounded ring every this many "
                    "seconds, served by GET /stats/history (rates, window "
                    "quantiles, SLO burn); 0 = off")
    ap.add_argument("--history_samples", type=int, default=600,
                    help="history ring bound (oldest samples drop first); "
                    "size it to cover the slow burn window: samples >= "
                    "slow_window_s / history_interval_s")
    ap.add_argument("--slo_spec", default=None,
                    help="per-class objectives, 'class:kind=target[@goal]' "
                    "joined with ';' — kinds: hit_rate (deadline hit "
                    "rate; =X is the goal), p95_ms (latency bound in ms, "
                    "@goal default 0.95), availability (class 'all' only). "
                    "Example: 'interactive:p95_ms=250@0.95;interactive:"
                    "hit_rate=0.99;all:availability=0.999'. Needs "
                    "--history_interval_s; unset = the default objectives")
    ap.add_argument("--slo_fast_window_s", type=float,
                    default=obs_slo.FAST_WINDOW_S,
                    help="SLO burn: the fast window (seconds)")
    ap.add_argument("--slo_slow_window_s", type=float,
                    default=obs_slo.SLOW_WINDOW_S,
                    help="SLO burn: the slow window (seconds)")
    ap.add_argument("--slo_burn_threshold", type=float,
                    default=obs_slo.BURN_THRESHOLD,
                    help="SLO burn rate both windows must exceed for a "
                    "breach")
    ap.add_argument("--incident_dir", default=None,
                    help="directory for flight-recorder incident bundles "
                    "(engine-fatal rebuild, watchdog stall, poison "
                    "eviction, SLO burn), one timestamped JSON per "
                    "incident, rate-limited per cause; unset = no bundles")
    ap.add_argument("--fault_spec", default=None,
                    help="arm the serving fault seams (engine.prefill / "
                    "engine.decode_step / engine.admit / pool.alloc / "
                    "http.read) with this ;-separated rule spec — chaos "
                    "drills only; unset = every seam is an inert None-"
                    "check")
    ap.add_argument("--fault_seed", type=int, default=0,
                    help="seed for p= fault rules in --fault_spec")
    args = ap.parse_args(argv)
    if args.fault_spec:
        faults.install(faults.parse_spec(args.fault_spec,
                                         seed=args.fault_seed))
    srv = PredictServer(
        args.export_dir, name=args.name, host=args.host, port=args.port,
        scheduler=args.scheduler, device=args.device,
        batch_max_size=args.batch_max_size,
        batch_max_wait_ms=args.batch_max_wait_ms, max_queue=args.max_queue,
        prefix_cache=args.prefix_cache == "on",
        metrics=args.metrics == "on",
        trace_buffer_events=args.trace_buffer_events,
        request_log=args.request_log,
        thread_sanitizer=args.thread_sanitizer,
        default_deadline_ms=args.default_deadline_ms,
        drain_timeout_s=args.drain_timeout_s,
        stall_after_s=args.stall_after_s, spec_tokens=args.spec_tokens,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        default_priority=args.default_priority,
        shed_policy=args.shed_policy,
        flight_recorder=args.flight_recorder == "on",
        incident_dir=args.incident_dir,
        history_interval_s=args.history_interval_s,
        history_samples=args.history_samples, slo_spec=args.slo_spec,
        slo_fast_window_s=args.slo_fast_window_s,
        slo_slow_window_s=args.slo_slow_window_s,
        slo_burn_threshold=args.slo_burn_threshold)

    drainer: list[threading.Thread] = []

    def _graceful(signum, frame):
        # stop() must run off the serve_forever thread; the drain keeps
        # the listener up answering 503 until in-flight work finishes
        t = threading.Thread(target=srv.stop, name="sigterm-drain",
                             daemon=True)
        drainer.append(t)
        t.start()

    signal.signal(signal.SIGTERM, _graceful)
    route = "generate" if srv.kind == "generator" else "predict"
    print(f"serving {srv.name!r} on http://{args.host}:{srv.port}"
          f"/v1/models/{srv.name}:{route}", flush=True)
    srv.serve()
    for t in drainer:
        # the listener is down; the batcher and the request log close
        # before the process exits
        t.join(timeout=60)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
