"""HTTP serving of a generator export (port of the ``:generate`` path of
``distributed_tensorflow_example_tpu/serving_http.py``).

Routes:

- ``POST /v1/models/<name>:generate`` with ``{"inputs": {"input_ids":
  [[...]], "prompt_mask": [[...]]}, "seed": N}`` (or ``"instances"``)
  -> ``{"generations": [[token ids]]}``;
- ``GET /healthz`` -> ``{"status": "live", ...}`` (503 unless live);
- ``GET /stats`` -> the engine's counters (scheduler on);
- ``GET /v1/models/<name>`` -> the model status.

Scheduling: with ``scheduler="on"`` (``"auto"`` turns it on when the
export carries the ``stepwise`` block) ``:generate`` routes through the
continuous-batching :class:`~.serving_batch.GenerationEngine`: each
instance row is one engine request, concurrent requests share decode
steps over one cache pool, prompts may be shorter than the exported
capacity, per-request ``max_new``/``temperature``/``top_k``/``top_p``/
``seed``/``stop_sequences`` ride the payload, the response carries
``request_ids`` and ``timings``, and a full admission queue answers 429
with ``Retry-After``. ``scheduler="off"`` runs one ``generate`` per
request behind a single-flight lock: the parity oracle of the engine.
Both run on the server's device (``cuda`` by default). Client mistakes
answer 400, a failure while generating 500.

The engine's knobs, as in the reference:

- ``--spec_tokens K`` arms speculative decoding over an export with the
  verify step (``export_generator(..., spec_tokens=K)``); over one
  without it the server warns and serves spec-off, and a K wider than the
  export's is clamped to it. The payload's ``spec_tokens`` opts one
  request out (0) or caps it lower.
- ``--prefill_chunk_tokens C`` arms chunked prefill over an export with
  ``prefill_chunk`` (auto-off and clamp the same way). On an H100 a
  chunk, like the whole prefill, is bound by its host launches, and it
  stalls live decoders as long as the whole flash-kernel prefill or
  longer, so chunking does not yet cut the stall there.
- ``deadline_ms`` in the payload (or ``--default_deadline_ms``) bounds a
  request: expiry answers 504. ``priority`` (``interactive`` | ``batch``
  | ``best_effort``, default ``--default_priority``) orders admission,
  with aging (``priority_aging_ms``). Under ``--shed_policy auto`` the
  brownout ladder and the deadline-feasibility shed answer 429 with a
  measured ``Retry-After`` (``ShedError`` is a ``QueueFullError``).
- ``GET /healthz`` carries the saturation fields (``queue_age_s``,
  ``queue_limit``, ``pressure``, ``saturated``); ``--stall_after_s``
  sets when it reports ``stalled``.

Under ``scheduler="off"`` the engine-only payload knobs answer 400.
``:predict``, ``/metrics``, the tracing routes, drain and ``/cancel``
arrive with the HTTP/observability slice.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from .serving import has_stepwise, load_servable, load_stepwise
from .serving_batch import (DeadlineExceededError, GenerationEngine,
                            QueueFullError, RequestCancelledError)
from .utils.logging import get_logger

log = get_logger("serving")


class _ServerFault(Exception):
    """A failure while generating (device error, out of memory, ...): a
    500 even when the underlying type is ValueError/TypeError, the types
    the request-validation path maps to 400."""


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
    """Serve one generator export directory over HTTP.

    >>> srv = PredictServer(export_dir, device="cpu").start()
    >>> ... POST http://127.0.0.1:{srv.port}/v1/models/<name>:generate
    >>> srv.stop()
    """

    def __init__(self, export_dir: str, *, scheduler: str = "auto",
                 port: int = 0, device=None, host: str = "127.0.0.1",
                 name: str | None = None, max_queue: int = 64,
                 prefix_cache: bool = True, default_deadline_ms: int = 0,
                 stall_after_s: float = 10.0, spec_tokens: int = 0,
                 prefill_chunk_tokens: int = 0,
                 default_priority: str = "interactive",
                 shed_policy: str = "auto",
                 priority_aging_ms: int = 2000):
        if scheduler not in ("auto", "on", "off"):
            raise ValueError(f"scheduler must be auto/on/off, got "
                             f"{scheduler!r}")
        stepwise = has_stepwise(export_dir)
        if scheduler == "auto":
            scheduler = "on" if stepwise else "off"
        if scheduler == "on" and not stepwise:
            # as the reference: a monolithic generator has no stepwise
            # programs for the continuous-batching engine to drive
            raise ValueError(
                f"scheduler='on' needs stepwise generator artifacts in "
                f"{export_dir!r} — re-export with export_generator(..., "
                "stepwise=True), or serve with scheduler='off'")
        self.scheduler = scheduler
        self.engine: GenerationEngine | None = None
        self.servable = None
        if scheduler == "on":
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
                default_deadline_ms=default_deadline_ms,
                stall_after_s=stall_after_s, spec_tokens=spec_tokens,
                prefill_chunk_tokens=prefill_chunk_tokens,
                default_priority=default_priority, shed_policy=shed_policy,
                priority_aging_ms=priority_aging_ms).start()
        else:
            self.servable = load_servable(export_dir, device)
            self.meta, self.device = self.servable.meta, self.servable.device
        self.name = name or self.meta.get("model", "model")
        self._exec_lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # -- request plumbing ----------------------------------------------
    def _feature_arrays(self, payload: dict, sig: dict
                        ) -> tuple[dict[str, np.ndarray], int]:
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
                    raise ValueError(
                        f"instance {i} keys differ from instance 0 keys "
                        f"{sorted(keys)}")
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
        # static-batch artifact: pad up to the exported batch (repeating
        # the first instance) and truncate the answer; more instances
        # than the export's batch is the client's error
        b_exp = next(iter(sig.values()))["shape"][0]
        if n > b_exp:
            raise ValueError(
                f"this artifact was exported with a static batch of "
                f"{b_exp} instances; got {n} (requests up to {b_exp} "
                "are padded server-side)")
        if n < b_exp:
            out = {k: np.concatenate([v, np.repeat(v[:1], b_exp - n, 0)])
                   for k, v in out.items()}
        return out, n

    def _check_prompt_lengths(self, payload: dict) -> None:
        """A prompt longer than the export's capacity is a 400 naming the
        limit, not an opaque shape error."""
        limit = int(self.meta["prompt_len"])
        rows = None
        if isinstance(payload.get("inputs"), dict):
            rows = payload["inputs"].get("input_ids")
        elif isinstance(payload.get("instances"), list):
            rows = [r.get("input_ids") for r in payload["instances"]
                    if isinstance(r, dict)]
        if not isinstance(rows, list):
            return                     # malformed: canonical checks handle
        for i, row in enumerate(rows):
            if isinstance(row, list) and len(row) > limit:
                raise ValueError(
                    f"prompt {i} has {len(row)} tokens, which exceeds "
                    f"this artifact's exported prompt capacity {limit} "
                    "(prompt_len in export.json; re-export with a "
                    "larger prompt_len to serve longer prompts)")

    def _execute(self, feats, seed) -> np.ndarray:
        try:
            with self._exec_lock:
                return self.servable(feats, seed=seed)
        except Exception as e:
            raise _ServerFault(f"{type(e).__name__}: {e}") from e

    def _generate_scheduled(self, payload: dict,
                            request_id: str | None = None) -> dict:
        """:generate via the continuous-batching engine: each instance
        row becomes one engine request (row i samples under ``seed + i``
        so rows stay independent). Rows may be SHORTER than the exported
        prompt capacity; a ``prompt_mask`` row keeps its nonzero
        positions. Every row gets a request id (the client's
        ``X-Request-Id``, suffixed per row, or an engine-generated one);
        the response carries ``request_ids`` and the per-request
        ``timings`` beside ``generations``."""
        self._check_prompt_lengths(payload)
        rows = None
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
        # validates EVERY row before queueing ANY, and the enqueue is
        # atomic: a 400/429 on row k leaves no rows generating for nobody
        handles = self.engine.submit_many(prompts, seed=seed,
                                          request_ids=rids, **kw)
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
        return {"generations": gens,
                "request_ids": [h.request_id for h in handles],
                "timings": [h.timings for h in handles]}

    def generate(self, payload: dict, request_id: str | None = None) -> dict:
        """The decode route: ``{"inputs": {"input_ids": [[...]], ...},
        "seed": 7}`` -> ``{"generations": [[token ids]]}``. With the
        scheduler on, each row rides the engine (per-request sampling
        knobs in the payload; see :meth:`_generate_scheduled`); off, the
        sampling generator is seeded server-side from the request's
        integer ``seed`` (default 0)."""
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        if self.engine is not None:
            return self._generate_scheduled(payload, request_id)
        for knob in ("stop_sequences", "spec_tokens", "deadline_ms",
                     "priority"):
            if payload.get(knob) is not None:
                raise ValueError(
                    f"{knob!r} requires the continuous-batching "
                    "scheduler (this server runs scheduler='off'; the "
                    "monolithic generator cannot honor it)")
        self._check_prompt_lengths(payload)
        feats, n = self._feature_arrays(payload,
                                        self.servable.input_signature)
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

    def health(self) -> dict:
        """``GET /healthz``: the engine's watchdog view (live / stalled /
        dead, with the heartbeat age) when the scheduler runs; without a
        scheduler thread, the server answering at all is the liveness
        signal."""
        h = (self.engine.health() if self.engine is not None
             else {"status": "live"})
        h.update(scheduler=self.scheduler, device=str(self.device),
                 mono_now=time.perf_counter())
        return h

    def stats(self) -> dict:
        """``GET /stats``: the scheduler mode plus the engine's counters
        (one atomic registry snapshot)."""
        out: dict[str, Any] = {"model": self.name,
                               "scheduler": self.scheduler}
        if self.engine is not None:
            out["generate"] = self.engine.stats()
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
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == f"/v1/models/{server.name}":
                    self._send(200, {"model_version_status": [{
                        "version": "1", "state": "AVAILABLE",
                        "status": {"error_code": "OK",
                                   "error_message": ""}}]})
                elif self.path in ("/stats",
                                   f"/v1/models/{server.name}/stats"):
                    self._send(200, server.stats())
                elif self.path in ("/healthz",
                                   f"/v1/models/{server.name}/healthz"):
                    # 200 only while live: a wedged or dead scheduler
                    # thread fails load-balancer probes
                    h = server.health()
                    self._send(200 if h["status"] == "live" else 503, h)
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path != f"/v1/models/{server.name}:generate":
                    self._send(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > 1 << 30:
                        self._send(413, {"error": "request too large"})
                        return
                    body = self.rfile.read(n)
                    if len(body) != n:
                        self._send(400, {"error": "truncated body"})
                        return
                    payload = json.loads(body or b"{}")
                except (ValueError, TimeoutError, OSError) as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                try:
                    self._send(200, server.generate(
                        payload, self.headers.get("X-Request-Id") or None))
                except QueueFullError as e:
                    # bounded admission or a shed (ShedError): tell the
                    # client WHEN to come back, from the measured rate
                    self._send(429, {"error": str(e)},
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
        """Blocking serve loop (the CLI path); Ctrl-C stops cleanly."""
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            self.stop()

    def start(self) -> "PredictServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="predict-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Listener down first, then the engine (fail-fast: queued and
        live requests fail loudly; graceful drain arrives with a later
        slice)."""
        # shutdown() waits for serve_forever, which only a started server
        # ever runs
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()
        if self.engine is not None:
            self.engine.close()

    def __enter__(self) -> "PredictServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv=None) -> int:
    """``python -m distributed_tensorflow_example_tpu_torch.serving_http
    --export_dir D [--port P] [--device cpu]`` — serve until
    interrupted (SIGTERM or Ctrl-C)."""
    import argparse
    import signal
    ap = argparse.ArgumentParser()
    ap.add_argument("--export_dir", required=True)
    ap.add_argument("--name", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8501)
    ap.add_argument("--scheduler", choices=("auto", "on", "off"),
                    default="auto",
                    help="on: the continuous-batching engine over a "
                    "stepwise export; off: one request, one generate; "
                    "auto: on exactly when the export is stepwise")
    ap.add_argument("--max_queue", type=int, default=64,
                    help="engine admission queue bound (429 past it)")
    ap.add_argument("--prefix_cache", choices=("on", "off"), default="on",
                    help="paged exports: reuse cached prompt-prefix blocks")
    ap.add_argument("--default_deadline_ms", type=int, default=0,
                    help="latency budget of :generate requests that carry "
                    "no deadline_ms of their own (0 = none); expiry "
                    "retires the slot between steps, frees its cache "
                    "blocks, and answers 504")
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
                    "scheduler iteration between shared decode steps, so "
                    "a long prompt stalls live decoders one chunk at a "
                    "time (needs an export with export_generator(..., "
                    "prefill_chunk=C); auto-off with a warning without "
                    "it). On an H100 a chunk, like a whole prompt's "
                    "prefill, is bound by its host launches and runs more "
                    "of them than the flash-kernel prefill, so it stalls "
                    "live decoders as long as the whole prefill or "
                    "longer: chunking does not yet cut the stall. "
                    "0 = off")
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
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default cuda; pass "
                    "cpu to run without a GPU)")
    args = ap.parse_args(argv)
    srv = PredictServer(args.export_dir, scheduler=args.scheduler,
                        port=args.port, device=args.device, host=args.host,
                        name=args.name, max_queue=args.max_queue,
                        prefix_cache=args.prefix_cache == "on",
                        default_deadline_ms=args.default_deadline_ms,
                        stall_after_s=args.stall_after_s,
                        spec_tokens=args.spec_tokens,
                        prefill_chunk_tokens=args.prefill_chunk_tokens,
                        default_priority=args.default_priority,
                        shed_policy=args.shed_policy)

    def _graceful(signum, frame):
        # stop() must run off the serve_forever thread
        threading.Thread(target=srv._httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    print(f"serving {srv.name!r} on http://{args.host}:{srv.port}"
          f"/v1/models/{srv.name}:generate", flush=True)
    srv.serve()
    srv.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
