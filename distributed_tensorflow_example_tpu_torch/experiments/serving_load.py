"""Closed-loop load generator for the port's serving path (a port copy of
``experiments/serving_load.py``): continuous batching (scheduler on)
against one-request-one-program (scheduler off), and the fleet leg.

Builds a seeded GPT, exports a stepwise generator artifact, starts the
REST server in-process, and drives it with N closed-loop clients × M
``:generate`` requests each (every client posts, waits, posts again, so
offered load tracks service rate). Prompt and ``max_new`` lengths are
drawn per request from a seeded RNG. Each mode's row reports:

- ``tokens_per_s`` / ``requests_per_s``: wall-clock throughput over the
  whole matrix;
- ``latency_p50/p95/p99_ms``: client-observed per-request latency;
- ``decode_steps`` / ``prefills`` / ``steps_shared``: the dispatch counts
  from ``/stats`` (scheduler on: K concurrent requests cost about
  max(max_new) shared decode dispatches a wave, not the per-request
  sum; scheduler off reports one monolithic program a request).

The greedy outputs of the two modes are asserted byte-identical per
request unless ``--no_parity`` (on the CPU: on the card the monolithic
path runs the slab decode kernel and the engine the paged one, each in
bf16, so hold the card's legs to each other by agreement, or compare
scheduler-on legs only).

``--paged`` (+ ``--block_size`` / ``--num_blocks``) serves the
block-paged stepwise artifacts, and ``--prefix_mode shared|cold`` shapes
the workload: ``shared`` prepends one seeded system prefix to every
prompt (the prefix-cache case), ``cold`` keeps random prompts. Paged rows
also report ``prefix_cache_hits`` / ``prefill_tokens_saved`` /
``cow_copies``. Scheduler-on rows carry a ``breakdown_ms`` block
(queue-wait, prefill and decode p50/p95/p99 from each response's
``timings``) and a ``registry`` block (``GET /metrics`` parsed back, the
snapshot ``/stats`` renders; :func:`run_mode` asserts the two agree once
the matrix is quiesced). ``--router N`` adds the fleet leg
(:func:`run_router_mode`): N in-process replicas behind
``serving_router``'s :class:`~..serving_router.ReplicaRouter`, byte
parity with the single-replica row asserted.

Usage::

    python -m distributed_tensorflow_example_tpu_torch.experiments.\\
serving_load --smoke --device cpu
    python -m distributed_tensorflow_example_tpu_torch.experiments.\\
serving_load --model gpt --clients 8 --requests 4 --slots 8 \\
        --prompt_len 128 --max_new 64 --paged --block_size 16 --router 2

The models run on ``--device`` (the card by default: ``gpt`` is GPT-small
in bf16 with the flash prefill; ``cpu`` runs f32 and the plain paths).

``--smoke`` is the CPU configuration (2 clients × 2 requests, the tiny
model) and also runs: the paged cold and shared legs (paged-vs-slab and
shared-vs-cold byte parity, fewer shared prefills, a validated scheduler
trace); a chunked-prefill leg; the overload leg (best_effort shed with
429 + Retry-After, interactive protected); the ``slo_report`` leg (the
registry's attainment and goodput reconciled exactly with the harness
ledger and the request-log replay through ``tools/servetop``, one
rate-limited ``slo_burn`` bundle); an int8 leg (drift bound and
equal-bytes capacity); the thread-ownership sanitizer leg (armed byte
and dispatch parity, a seeded cross-thread violation caught); a
``chaos_on`` leg (a one-shot transient decode fault healed to byte and
dispatch parity); the spec legs (exact, accept rate > 0, fewer
dispatches); flight recorder off and SLO sampler on (byte and dispatch
parity); the 2-replica router leg; and the decode-stall probe. Prints one
JSON line per mode and a ``summary`` line with every check.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from ..obs import prom as prom_mod

#: the run's device, set by :func:`main` (the card by default), and
#: whether :func:`run_mode` drives its clients in lockstep (``--smoke``)
_RUN = {"device": "cuda", "lockstep": False}


def _lockstep(engine, matrix, one) -> None:
    """``--smoke``'s deterministic closed loop. Its legs compare the
    decode-step counts of two runs over one matrix (armed against plain,
    spec on against off), and a count depends on which scheduler
    iteration admits each request: with free-running clients, a CPU
    dispatch of ~1-3 ms raced each client's next request, and the counts
    varied from run to run. Here round r posts every client's r-th
    request, in client order, each once the one before it is queued; the
    engine's admission waits (bounded) until the whole round is queued,
    so one ``_admit`` takes it; the round ends when all of it answered."""
    real_admit = engine._admit
    gate = {"expect": 0}

    def queued() -> int:
        return engine.health()["queue_depth"]

    def gated_admit():
        if gate["expect"]:
            t0 = time.monotonic()
            while queued() < gate["expect"] \
                    and time.monotonic() - t0 < 60.0:
                time.sleep(0.001)
            gate["expect"] = 0
        real_admit()

    failed: set[int] = set()

    def run(ci, prompt, m):
        if not one(ci, prompt, m):
            failed.add(ci)

    engine._admit = gated_admit
    try:
        for r in range(max(len(rows) for rows in matrix)):
            batch = [(ci, rows[r]) for ci, rows in enumerate(matrix)
                     if r < len(rows) and ci not in failed]
            gate["expect"] = len(batch)
            threads = []
            for k, (ci, (prompt, m)) in enumerate(batch):
                t = threading.Thread(target=run, args=(ci, prompt, m))
                t.start()
                threads.append(t)
                while queued() < k + 1 and t.is_alive() \
                        and gate["expect"]:
                    time.sleep(0.001)
            for t in threads:
                t.join()
    finally:
        del engine._admit


@contextlib.contextmanager
def _storm_at_the_bound(engine, ladder_up: threading.Event,
                        answered: threading.Event):
    """The overload legs' storm, held at the queue's bound. Their checks
    need a best_effort request to meet the ladder above healthy. With
    free-running clients that was a race: four interactive clients on
    two slots held the 3-deep queue at 2 or more only between a wave's
    re-posts and the next admission, a few ms that a loaded host's
    client threads could miss, so no best_effort post met the ladder up
    and nothing was shed. Here the engine's first admission waits
    (bounded) until the interactive clients have filled the queue to its
    bound and admits nothing, so the engine's next pressure tick reads a
    full queue; its second admission releases the best_effort poster
    (``ladder_up``) and waits (bounded) for that poster's first answer
    (``answered``) before it admits. The storm then runs free."""
    real_admit = engine._admit
    calls = [0]

    def gated_admit():
        calls[0] += 1
        t0 = time.monotonic()
        if calls[0] == 1:
            while (engine.health()["queue_depth"] < engine.max_queue
                   and time.monotonic() - t0 < 60.0):
                time.sleep(0.001)
            return
        if calls[0] == 2:
            ladder_up.set()
            answered.wait(60.0)
        real_admit()

    engine._admit = gated_admit
    try:
        yield
    finally:
        del engine._admit
        ladder_up.set()


#: documented greedy-drift gate for the int8 legs: token-level
#: agreement with the float oracle over the seeded prompt matrix must
#: stay at or above this bound (the reference's bound)
INT8_MIN_AGREEMENT = 0.75


def token_agreement(gens_a, gens_b) -> float:
    """Token-level agreement between two [client][request][tokens]
    generation matrices of identical shape: matching positions /
    compared positions (1.0 when empty)."""
    agree = total = 0
    for row_a, row_b in zip(gens_a, gens_b):
        for ga, gb in zip(row_a, row_b):
            total += len(ga)
            agree += sum(int(a == b) for a, b in zip(ga, gb))
    return agree / total if total else 1.0


def _post(port, name, verb, payload, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:{verb}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _stats(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                timeout=30) as r:
        return json.loads(r.read())


def _prom(port):
    """GET /metrics parsed into {sample_name: value} — the registry
    snapshot in Prometheus clothing; the rows source their counters
    from THIS instead of re-deriving them."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        return prom_mod.parse(r.read().decode())


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _get_text(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read().decode()


def _trace(port, verb):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/trace/{verb}",
                                 data=b"{}")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _validate_trace(tr, want_request_ids):
    """A captured scheduler trace must be loadable chrome trace-event
    JSON: complete events carry ts/dur/pid/tid/name, per-slot lanes
    exist with prefill/decode spans, and every served request's id
    appears in span args. Returns the X-event count."""
    xs = [e for e in tr["traceEvents"] if e.get("ph") == "X"]
    assert xs, "trace captured no spans"
    for e in xs:
        for k in ("ts", "dur", "pid", "tid", "name"):
            assert k in e, f"X event missing {k}: {e}"
    lanes = {e["args"]["name"] for e in tr["traceEvents"]
             if e.get("name") == "thread_name"}
    assert any(ln.startswith("slot") for ln in lanes), lanes
    names = {e["name"] for e in xs}
    assert {"prefill", "decode_step", "queue_wait", "retire"} <= names, \
        sorted(names)
    span_rids = {e["args"]["request_id"] for e in xs
                 if e.get("args", {}).get("request_id")}
    missing = set(want_request_ids) - span_rids
    assert not missing, f"request ids absent from trace: {missing}"
    return len(xs)


def saturated_histograms(parsed: dict) -> list[str]:
    """Histogram names whose top FINITE bucket is saturated: more than
    1% of observations overflowed into +Inf (i.e. p99 lives above the
    largest finite bound, where percentile queries degenerate). The
    bucket-audit gate: no default-registered histogram may saturate in
    the --smoke run."""
    names = {k.split("_bucket{le=", 1)[0] for k in parsed
             if "_bucket{le=" in k}
    bad = []
    for h in sorted(names):
        count = parsed.get(f"{h}_count", 0)
        if not count:
            continue
        finite = [v for k, v in parsed.items()
                  if k.startswith(f'{h}_bucket{{le="')
                  and not k.endswith('le="+Inf"}')]
        top_finite_cum = max(finite) if finite else 0
        if (count - top_finite_cum) / count > 0.01:
            bad.append(h)
    return bad


def _pctls(samples_ms):
    """{p50,p95,p99} of a millisecond sample list (zeros when empty) —
    the same nearest-rank rule /stats uses."""
    from ..serving_batch import percentile
    return {f"p{q}": round(percentile(samples_ms, q), 2)
            for q in (50, 95, 99)}


def build_export(out_dir: str, *, prompt_len: int, max_new: int,
                 slots: int, seed: int = 0, model_name: str = "gpt_tiny",
                 device=None, paged: bool = False,
                 block_size: int = 16, num_blocks=None,
                 weight_quant: str = "off",
                 kv_cache_dtype: str = "auto", pool_bytes=None,
                 spec_tokens: int = 0, prefill_chunk: int = 0,
                 model=None):
    """Seeded GPT stepwise export (ragged monolithic artifact too, so
    the off path serves the same mixed prompt lengths) of the registry's
    ``model_name`` (or of ``model``, a GPT built for ``device``) on
    ``device`` (the run's by default: on the card bf16 with the flash
    prefill, on the CPU f32 with the plain attention);
    ``paged=True`` exports the block-paged stepwise pair instead of the
    slab pool. ``weight_quant``/``kv_cache_dtype``/``pool_bytes`` pass
    straight through to ``export_generator`` (the int8 legs)."""
    import torch

    from ..config import TrainConfig
    from ..models import get_model
    from ..serving import export_generator

    device = _RUN["device"] if device is None else device
    if model is None:
        kw = ({"dtype": "bfloat16", "attention_impl": "flash"}
              if torch.device(device).type == "cuda" else {})
        model = get_model(model_name, TrainConfig(model=model_name, **kw))
    params = model.init(seed, device=device)
    export_generator(model, params, out_dir, prompt_len=prompt_len,
                     max_new_tokens=max_new, batch_size=1, ragged=True,
                     stepwise=True, slots=slots, paged=paged,
                     block_size=block_size, num_blocks=num_blocks,
                     weight_quant=weight_quant,
                     kv_cache_dtype=kv_cache_dtype,
                     pool_bytes=pool_bytes, spec_tokens=spec_tokens,
                     prefill_chunk=prefill_chunk)
    return model.cfg.vocab_size


def make_requests(clients: int, requests: int, *, prompt_len: int,
                  max_new: int, vocab: int, seed: int,
                  prefix_mode: str = "cold", block_size: int = 16):
    """The seeded request matrix: [client][request] -> (prompt ids,
    max_new). Mixed lengths, identical across modes (same seed).

    ``prefix_mode="shared"`` models the millions-of-users shape: every
    prompt starts with ONE seeded system prefix (length = the largest
    ``block_size`` multiple that leaves suffix room, at least
    ``block_size``) followed by a short random user suffix — the
    workload the paged engine's prefix cache exists for.
    ``"cold"`` keeps fully random prompts (every admission misses)."""
    if prefix_mode not in ("cold", "shared"):
        raise ValueError(f"prefix_mode must be cold/shared, got "
                         f"{prefix_mode!r}")
    rs = np.random.RandomState(seed)
    sys_prefix = None
    if prefix_mode == "shared":
        sys_len = max(block_size,
                      (prompt_len - 1) // block_size * block_size)
        if sys_len >= prompt_len:
            raise ValueError(
                f"prompt_len {prompt_len} leaves no suffix room after a "
                f"{sys_len}-token shared prefix (block_size "
                f"{block_size}) — raise prompt_len or shrink block_size")
        sys_prefix = rs.randint(0, vocab, (sys_len,)).astype(np.int32)
    matrix = []
    for _ in range(clients):
        rows = []
        for _ in range(requests):
            if sys_prefix is None:
                p = int(rs.randint(1, prompt_len + 1))
                prompt = rs.randint(0, vocab, (p,)).astype(np.int32)
            else:
                s = int(rs.randint(1, prompt_len - sys_prefix.size + 1))
                prompt = np.concatenate(
                    [sys_prefix,
                     rs.randint(0, vocab, (s,)).astype(np.int32)])
            m = int(rs.randint(1, max_new + 1))
            rows.append((prompt, m))
        matrix.append(rows)
    return matrix


def make_repetitive_requests(clients: int, requests: int, *,
                             prompt_len: int, max_new: int, vocab: int,
                             seed: int, period: int = 3):
    """The speculative-decoding workload: every prompt is one seeded
    ``period``-token pattern tiled to a seeded length, so the
    prompt-lookup drafter's suffix n-grams recur from token one — and
    greedy decode of a fixed model drifts into its own repetitive
    fixed points, which the drafter then mines from the GENERATED
    context too. Same [client][request] -> (prompt, max_new) shape as
    :func:`make_requests`."""
    rs = np.random.RandomState(seed)
    pattern = rs.randint(0, vocab, (period,)).astype(np.int32)
    matrix = []
    for _ in range(clients):
        rows = []
        for _ in range(requests):
            p = int(rs.randint(max(2, period), prompt_len + 1))
            prompt = np.tile(pattern, -(-p // period))[:p]
            rows.append((prompt, max_new))
        matrix.append(rows)
    return matrix


def run_mode(export_dir: str, matrix, *, scheduler: str,
             prompt_len: int, mode_name: str | None = None,
             prefix_cache: bool = True, trace: bool = False,
             thread_sanitizer: bool = False,
             spec_tokens: int = 0,
             server_kw: dict | None = None) -> dict:
    """Drive one server mode with the closed-loop client matrix;
    returns the result row (and stashes per-request generations under
    ``_gens`` for the parity check). ``thread_sanitizer=True`` arms the
    engine's THR01 runtime ownership checks for the whole leg — a
    cross-thread touch of a scheduler-owned field fails the run
    loudly, and the row must stay byte- and dispatch-identical to the
    unarmed leg (asserted by the --smoke checks). The server runs on
    the run's device unless ``server_kw`` names one."""
    from ..serving_http import PredictServer

    server_kw = {"device": _RUN["device"], **(server_kw or {})}

    clients = len(matrix)
    lat: list[list[float]] = [[] for _ in range(clients)]
    gens: list[list[list[int]]] = [[] for _ in range(clients)]
    timings: list[dict] = []             # scheduler on: one per request
    request_ids: list[str] = []
    errors: list[str] = []
    with PredictServer(export_dir, scheduler=scheduler,
                       prefix_cache=prefix_cache,
                       thread_sanitizer=thread_sanitizer,
                       spec_tokens=spec_tokens,
                       **server_kw) as srv:
        def one(ci, prompt, m) -> bool:
            if scheduler == "on":
                payload = {"inputs": {"input_ids": [prompt.tolist()]},
                           "max_new": m}
            else:
                # the monolithic artifact is static-shape: pad to the
                # exported prompt + mask; it always generates its
                # exported max_new — truncate client-side so both modes
                # compare the same m tokens
                ids = np.zeros((prompt_len,), np.int32)
                ids[:prompt.size] = prompt
                mask = np.zeros((prompt_len,), np.int32)
                mask[:prompt.size] = 1
                payload = {"inputs": {"input_ids": [ids.tolist()],
                                      "prompt_mask": [mask.tolist()]}}
            t0 = time.perf_counter()
            try:
                out = _post(srv.port, srv.name, "generate", payload)
            except Exception as e:          # noqa: BLE001 — recorded
                errors.append(f"client {ci}: {type(e).__name__}: {e}")
                return False
            lat[ci].append(time.perf_counter() - t0)
            gens[ci].append(out["generations"][0][:m])
            if "timings" in out:
                timings.extend(out["timings"])
                request_ids.extend(out["request_ids"])
            return True

        def client(ci):
            for prompt, m in matrix[ci]:
                if not one(ci, prompt, m):
                    return

        if trace:
            _trace(srv.port, "start")
        t_start = time.perf_counter()
        if _RUN["lockstep"] and srv.engine is not None:
            _lockstep(srv.engine, matrix, one)
        else:
            threads = [threading.Thread(target=client, args=(ci,))
                       for ci in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        wall = time.perf_counter() - t_start
        stats = _stats(srv.port)
        registry = _prom(srv.port) if scheduler == "on" else {}
        trace_events = None
        if trace:
            trace_events = _validate_trace(_trace(srv.port, "stop"),
                                           request_ids)

    flat_lat = sorted(x for row in lat for x in row)
    n_req = len(flat_lat)
    n_tok = sum(len(g) for row in gens for g in row)

    def pctl(q):
        if not flat_lat:
            return 0.0
        i = min(n_req - 1, int(round(q / 100 * (n_req - 1))))
        return flat_lat[i] * 1e3

    g = stats.get("generate", {})
    if registry:
        # /stats is a view of the registry snapshot /metrics renders —
        # with the server quiesced (all closed-loop clients joined) the
        # two must agree EXACTLY; a mismatch means the one-source-of-
        # truth contract broke
        for stat_key, prom_key in (
                ("decode_steps", "serving_decode_steps_total"),
                ("prefills", "serving_prefills_total"),
                ("requests_done", "serving_requests_done_total"),
                ("tokens_out", "serving_tokens_out_total")):
            if g.get(stat_key) != registry.get(prom_key):
                errors.append(
                    f"/stats {stat_key}={g.get(stat_key)} disagrees "
                    f"with /metrics {prom_key}={registry.get(prom_key)}")
    row = {
        "mode": mode_name or f"scheduler_{scheduler}",
        "clients": clients,
        "requests": n_req,
        "errors": errors,
        "wall_s": round(wall, 3),
        "tokens_per_s": round(n_tok / wall, 2) if wall else 0.0,
        "requests_per_s": round(n_req / wall, 3) if wall else 0.0,
        "latency_p50_ms": round(pctl(50), 2),
        "latency_p95_ms": round(pctl(95), 2),
        "latency_p99_ms": round(pctl(99), 2),
        # off path: every request is one monolithic decode dispatch
        "decode_steps": g.get("decode_steps", n_req),
        "prefills": g.get("prefills", n_req),
        "steps_shared": g.get("steps_shared", 1.0),
        "_gens": gens,
    }
    if timings:
        # per-request latency breakdown from the engine's `timings`
        # field: WHERE the time went (admission queue vs prefill vs
        # shared decode), not just how much there was
        row["breakdown_ms"] = {
            "queue": _pctls([t["queue_ms"] for t in timings]),
            "prefill": _pctls([t["prefill_ms"] for t in timings]),
            "decode": _pctls([t["decode_ms"] for t in timings]),
        }
    if registry:
        # the registry snapshot itself (counters/gauges only — bucket
        # series stay on /metrics): the serving counters come from here
        # instead of being re-derived
        row["registry"] = {k: v for k, v in sorted(registry.items())
                           if "_bucket{" not in k}
        # the bucket-audit observable: histograms whose top
        # finite bucket saturated (p99 above the largest bound) —
        # --smoke gates this list empty
        row["saturated_histograms"] = saturated_histograms(registry)
        # the server's own request-latency p95, beside the router leg's
        # fleet_registry_p95_ms
        row["registry_p95_ms"] = round(prom_mod.quantile_from_parsed(
            registry, "serving_request_latency_seconds", 0.95) * 1e3, 2)
    if trace_events is not None:
        row["trace_events"] = trace_events
    if g.get("paged"):
        row.update({
            "prefix_cache_hits": g["prefix_cache_hits"],
            "prefix_cache_misses": g["prefix_cache_misses"],
            "prefill_tokens_saved": g["prefill_tokens_saved"],
            "blocks_total": g["blocks_total"],
            "cow_copies": g["cow_copies"],
        })
    if g.get("spec_tokens"):
        # speculative-decoding observability: the accept-rate story
        # and the dispatch-count win live on the row itself
        row.update({
            "spec_tokens": g["spec_tokens"],
            "verify_steps": g["verify_steps"],
            "spec_proposed": g["spec_proposed"],
            "spec_accepted": g["spec_accepted"],
            "spec_emitted": g["spec_emitted"],
            "accept_rate": g["accept_rate"],
        })
    return row


def run_router_mode(export_dir: str, matrix, *, replicas: int = 2,
                    mode_name: str = "router_on",
                    **router_kw) -> dict:
    """Drive the closed-loop client matrix through a replica ROUTER
    fronting ``replicas`` in-process servers over the same export —
    the fleet leg: tps/p95 next to the single-replica rows, fleet
    counters from the merged ``/metrics`` page, and the same ``_gens``
    stash for the byte-parity check (greedy output must not depend on
    which replica serves). ``router_kw`` may carry ``server_kw`` for
    the replicas; they run on the run's device unless it names one."""
    from ..serving_router import InProcessFleet

    router_kw["server_kw"] = {"device": _RUN["device"],
                              **(router_kw.get("server_kw") or {})}

    clients = len(matrix)
    lat: list[list[float]] = [[] for _ in range(clients)]
    gens: list[list[list[int]]] = [[] for _ in range(clients)]
    # per-client rows, aggregated after join — a shared dict's
    # read-modify-write would race across client threads
    served_rows: list[list[str]] = [[] for _ in range(clients)]
    errors: list[str] = []
    fleet = InProcessFleet(export_dir, replicas, **router_kw)
    try:
        def client(ci):
            for prompt, m in matrix[ci]:
                payload = {"inputs": {"input_ids": [prompt.tolist()]},
                           "max_new": m}
                t0 = time.perf_counter()
                try:
                    out = _post(fleet.port, fleet.name, "generate",
                                payload)
                except Exception as e:      # noqa: BLE001 — recorded
                    errors.append(f"client {ci}: {type(e).__name__}: "
                                  f"{e}")
                    return
                lat[ci].append(time.perf_counter() - t0)
                gens[ci].append(out["generations"][0][:m])
                served_rows[ci].append(out.get("served_by", "?"))

        t_start = time.perf_counter()
        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_start
        # a hedge's loser decodes on until its cancel lands: the fleet's
        # counters are read once every replica has gone quiet
        _quiesce(fleet.servers)
        registry = _prom(fleet.port)        # fleet-merged /metrics
    finally:
        fleet.close()

    served: dict[str, int] = {}
    for row in served_rows:
        for by in row:
            served[by] = served.get(by, 0) + 1
    flat_lat = sorted(x for row in lat for x in row)
    n_req = len(flat_lat)
    n_tok = sum(len(g) for row in gens for g in row)

    def pctl(q):
        if not flat_lat:
            return 0.0
        i = min(n_req - 1, int(round(q / 100 * (n_req - 1))))
        return flat_lat[i] * 1e3

    return {
        "mode": mode_name,
        "replicas": replicas,
        "clients": clients,
        "requests": n_req,
        "errors": errors,
        "wall_s": round(wall, 3),
        "tokens_per_s": round(n_tok / wall, 2) if wall else 0.0,
        "requests_per_s": round(n_req / wall, 3) if wall else 0.0,
        "latency_p50_ms": round(pctl(50), 2),
        "latency_p95_ms": round(pctl(95), 2),
        "latency_p99_ms": round(pctl(99), 2),
        "served_by": dict(sorted(served.items())),
        # fleet-level counters: replica registries + the router's own,
        # merged by the /metrics page itself
        "decode_steps": int(registry.get("serving_decode_steps_total",
                                         0)),
        "prefills": int(registry.get("serving_prefills_total", 0)),
        # every copy a replica admitted: the requests plus the hedged
        # and retried copies that reached a prefill before their cancel
        "admissions": int(registry.get("serving_admissions_total", 0)),
        "router_requests": int(registry.get("router_requests_total",
                                            0)),
        "router_retries": int(registry.get("router_retries_total", 0)),
        "router_hedges": int(registry.get("router_hedges_total", 0)),
        "router_hedge_wins": int(registry.get(
            "router_hedge_wins_total", 0)),
        "router_failovers": int(registry.get(
            "router_failovers_total", 0)),
        # percentile sourced from the MERGED registry's
        # router_request_seconds histogram (not a client stopwatch)
        "fleet_registry_p95_ms": round(
            prom_mod.quantile_from_parsed(
                registry, "router_request_seconds", 0.95) * 1e3, 2),
        "saturated_histograms": saturated_histograms(registry),
        "_gens": gens,
    }


def _quiesce(servers, timeout_s: float = 60.0) -> None:
    """Wait (bounded) until no engine of ``servers`` holds a queued or
    in-flight request."""
    def quiet(srv) -> bool:
        if srv.engine is None:
            return True
        h = srv.engine.health()
        return h["inflight"] == 0 and h["queue_depth"] == 0

    t0 = time.monotonic()
    while not all(quiet(s) for s in servers) \
            and time.monotonic() - t0 < timeout_s:
        time.sleep(0.005)


def int8_capacity_check(*, prompt_len: int, max_new: int, seed: int,
                        block_size: int) -> tuple[int, int]:
    """THE equal-bytes capacity probe: export a bf16 and an int8 paged
    artifact at the SAME K/V pool byte budget, offer each engine a wave
    of distinct short prompts, and count concurrent admissions. int8
    halves the per-block payload, so its pool holds 2x the blocks and
    must admit strictly more requests. Returns ``(bf16_admitted,
    int8_admitted)``."""
    from ..serving import load_stepwise
    from ..serving_batch import GenerationEngine

    total = prompt_len + max_new
    bps = -(-total // block_size)
    slots = 16
    rs = np.random.RandomState(seed + 999)
    # distinct 2-token prompts (1 block each) — prefix cache off, so
    # admission counts are pure block-capacity observations
    prompts = [np.array([i, int(rs.randint(0, 1000))], np.int32)
               for i in range(slots)]
    counts = {}
    pool_bytes = None
    for dtype in ("bf16", "int8"):
        with tempfile.TemporaryDirectory() as d:
            build_export(d, prompt_len=prompt_len, max_new=max_new,
                         slots=slots, seed=seed, paged=True,
                         block_size=block_size,
                         kv_cache_dtype=dtype,
                         num_blocks=(1 + 2 * bps) if pool_bytes is None
                         else None,
                         pool_bytes=pool_bytes)
            sw = load_stepwise(d, _RUN["device"])
            if pool_bytes is None:
                # the bf16 pool's K/V byte budget = the int8 export's
                # pool_bytes (block_bytes is pure payload for bf16)
                m = sw.step_meta
                pool_bytes = (int(m["num_blocks"]) - 1) \
                    * int(m["block_bytes"])
            eng = GenerationEngine(sw, prefix_cache=False)
            for p in prompts:
                # max_new=2: a slot stays LIVE after its admission
                # prefill (max_new=1 retires on the prefill logits),
                # so len(_live) counts concurrent residency
                eng.submit(p, max_new=2)
            eng._admit()
            counts[dtype] = len(eng._live)
            eng.close()
    return counts["bf16"], counts["int8"]


def chunk_stall_probe(*, seed: int = 0, prompt_len: int = 512,
                      block_size: int = 32, max_new: int = 16,
                      storms: int = 2) -> dict:
    """THE decode-stall-under-long-prompt probe: a
    long-context GPT (the tiny smoke model's prefill is too cheap to
    stall anything) serves a live short decoder while full-length
    prompts admit mid-stream, chunked OFF vs ON over the same export.
    Measures the gap between consecutive shared decode dispatches as
    the live decoder experiences it (direct engine drive, warmed
    first — a first dispatch's setup must not masquerade as stall) and returns
    both modes' p95/max-stall plus wall time. The gated figure is the
    WORST-CASE stall: monolithic admission stalls the decoder for one
    whole prompt forward, chunked for at most one chunk dispatch —
    the structural bound chunked prefill exists for. ``storms`` runs
    per mode take the min-of-max (OS jitter must not fail the gate).
    Byte parity between the modes is asserted inside."""
    import tempfile as _tf

    import torch

    from ..models.gpt import GPT, GPTConfig
    from ..serving import export_generator, load_stepwise
    from ..serving_batch import GenerationEngine, percentile

    device = _RUN["device"]
    cfg = GPTConfig(vocab_size=512, hidden=128, layers=2, heads=4,
                    intermediate=256,
                    max_len=prompt_len + max(max_new, 192))
    model = (GPT(cfg, dtype=torch.bfloat16, attention_impl="flash")
             if torch.device(device).type == "cuda" else GPT(cfg))
    params = model.init(seed, device=device)
    rs = np.random.RandomState(seed)
    long_prompts = [rs.randint(0, cfg.vocab_size,
                               (prompt_len,)).astype(np.int32)
                    for _ in range(3)]
    short = rs.randint(0, cfg.vocab_size, (4,)).astype(np.int32)
    with _tf.TemporaryDirectory() as d:
        export_generator(model, params, d, prompt_len=prompt_len,
                         max_new_tokens=192, batch_size=1,
                         ragged=True, stepwise=True, slots=4,
                         paged=True, block_size=block_size,
                         prefill_chunk=block_size)

        def run(chunk):
            # prefix cache OFF: the warmup request would otherwise
            # cache the long prompt and turn the storm's admissions
            # into prefill-free cache hits — the A/B must measure the
            # PREFILL stall it exists to compare
            eng = GenerationEngine(load_stepwise(d, device),
                                   prefix_cache=False,
                                   prefill_chunk_tokens=chunk).start()
            od = eng.sw.decode
            gaps: list[float] = []
            last = [0.0]

            def wrapped(feats):
                t = time.perf_counter()
                if last[0]:
                    gaps.append(t - last[0])
                out = od(feats)
                last[0] = time.perf_counter()
                return out

            try:
                # warm every program (prefill or chunks + decode)
                eng.submit(long_prompts[0],
                           max_new=2).result(timeout=600)
                # the witness decoder: deep enough max_new to stay
                # live through every storm — its inter-dispatch gaps
                # ARE the stall measurement
                witness = eng.submit(short, max_new=192)
                t_w = time.monotonic()
                while eng.stats()["live_slots"] < 1 \
                        and time.monotonic() - t_w < 60:
                    time.sleep(0.002)
                eng.sw.decode = wrapped
                # gaps accumulate across every storm: the witness
                # keeps decoding between storms, so inter-storm gaps
                # are ordinary ~ms decode cadence, not idle time
                gaps.clear()
                last[0] = 0.0
                outs, wall, lived = [], 0.0, True
                t_all = time.perf_counter()
                for _ in range(storms):
                    hs = [eng.submit(p, max_new=2)
                          for p in long_prompts]
                    outs = [h.result(timeout=600) for h in hs]
                    lived = lived and not witness.done()
                wall = time.perf_counter() - t_all
                witness.cancel()
                return {"outs": outs,
                        "witness_lived": lived,
                        "stall_p95_ms": round(
                            percentile(gaps, 95) * 1e3, 2),
                        "stall_max_ms": round(
                            (max(gaps) if gaps else 0.0) * 1e3, 2),
                        "wall_s": round(wall, 3)}
            finally:
                eng.close()

        off, on = run(0), run(block_size)
    parity = (off.pop("outs") == on.pop("outs")
              and off.pop("witness_lived") and on.pop("witness_lived"))
    return {"off": off, "on": on, "parity": parity,
            "prompt_len": prompt_len, "chunk": block_size}


def run_overload(export_dir: str, *, vocab: int, seed: int,
                 prompt_len: int, max_new: int = 4,
                 max_queue: int = 3,
                 interactive_clients: int = 4, requests: int = 3,
                 deadline_ms: int = 60_000) -> dict:
    """The overload leg: ~2x sustainable offered load — a
    closed-loop INTERACTIVE base load that keeps the small admission
    queue deep, plus a best_effort poster hammering beside it. The
    brownout ladder must shed the best_effort traffic with 429 + a
    Retry-After header while EVERY admitted interactive request
    finishes inside its (generous) deadline with zero client-visible
    failures — shed requests are told when to come back, never left
    to time out."""
    from ..serving_http import PredictServer

    rs = np.random.RandomState(seed)
    lat: list[float] = []
    errors: list[str] = []
    shed_429: list[str] = []          # Retry-After header per SHED 429
    queue_full_429 = [0]              # blunt-bound 429s (not sheds)
    missing_retry_after = [0]
    with PredictServer(export_dir, max_queue=max_queue,
                       device=_RUN["device"]) as srv:
        stop = threading.Event()

        def interactive(ci):
            for _ in range(requests):
                prompt = rs.randint(0, vocab,
                                    (prompt_len,)).astype(np.int32)
                t0 = time.perf_counter()
                for _attempt in range(100):
                    try:
                        _post(srv.port, srv.name, "generate",
                              {"inputs": {"input_ids":
                                          [prompt.tolist()]},
                               "max_new": max_new,
                               "deadline_ms": deadline_ms,
                               "priority": "interactive"})
                        lat.append(time.perf_counter() - t0)
                        break
                    except urllib.error.HTTPError as e:
                        if e.code == 429:
                            # queue-full pushback: a closed-loop
                            # client honors Retry-After and retries —
                            # interactive is never CLASS-shed, so
                            # this is the blunt bound, not the ladder
                            try:
                                ra = float(e.headers.get(
                                    "Retry-After", 0) or 0)
                            except ValueError:
                                ra = 0.0
                            e.read()
                            time.sleep(min(max(ra, 0.005), 0.05))
                            continue
                        errors.append(f"interactive {ci}: http "
                                      f"{e.code}")
                        return
                    except Exception as e:  # noqa: BLE001 — recorded
                        errors.append(f"interactive {ci}: "
                                      f"{type(e).__name__}: {e}")
                        return
                else:
                    errors.append(f"interactive {ci}: retry budget "
                                  "exhausted on 429s")
                    return

        def best_effort():
            # hammer until the ladder sheds (bounded): a 429 carrying
            # Retry-After is the success condition here
            ladder_up.wait(60.0)
            for _ in range(200):
                if stop.is_set():
                    return
                try:
                    _post(srv.port, srv.name, "generate",
                          {"inputs": {"input_ids": [[1, 2]]},
                           "max_new": 2, "priority": "best_effort"})
                except urllib.error.HTTPError as e:
                    if e.code == 429:
                        ra = e.headers.get("Retry-After")
                        body = e.read().decode(errors="replace")
                        # a class SHED names itself ("shedding ... /
                        # shed while queued"); a blunt queue-full 429
                        # is the plain queue bound, not a shed — the
                        # registry's serving_shed_total only counts
                        # the former, so the client ledger must too
                        if "shed" not in body:
                            queue_full_429[0] += 1
                        elif ra is None:
                            missing_retry_after[0] += 1
                        else:
                            shed_429.append(ra)
                    else:
                        errors.append(f"best_effort: http {e.code}")
                except Exception as e:      # noqa: BLE001 — recorded
                    errors.append(f"best_effort: {type(e).__name__}: "
                                  f"{e}")
                answered.set()
                time.sleep(0.002)

        threads = [threading.Thread(target=interactive, args=(ci,))
                   for ci in range(interactive_clients)]
        be = threading.Thread(target=best_effort)
        ladder_up, answered = threading.Event(), threading.Event()
        with _storm_at_the_bound(srv.engine, ladder_up, answered):
            for t in threads:
                t.start()
            be.start()
            for t in threads:
                t.join()
            stop.set()
            be.join()
        stats = _stats(srv.port)["generate"]
        registry = _prom(srv.port)
    n = len(lat)
    lat.sort()

    def pctl(q):
        if not lat:
            return 0.0
        return lat[min(n - 1, int(round(q / 100 * (n - 1))))] * 1e3

    return {
        "mode": "overload",
        "interactive_requests": n,
        "interactive_expected": interactive_clients * requests,
        "errors": errors,
        "latency_p95_ms": round(pctl(95), 2),
        "deadline_ms": deadline_ms,
        "shed_429": len(shed_429),
        "queue_full_429": queue_full_429[0],
        "missing_retry_after": missing_retry_after[0],
        "shed_total": int(registry.get("serving_shed_total", 0)),
        "shed_best_effort": int(registry.get(
            "serving_shed_best_effort_total", 0)),
        "deadline_expired": int(registry.get(
            "serving_deadline_expired_total", 0)),
        "pressure_transitions": int(registry.get(
            "serving_pressure_transitions_total", 0)),
        "pressure_final": stats["pressure"],
    }


def run_slo_report(export_dir: str, *, vocab: int, seed: int,
                   prompt_len: int, max_new: int = 4,
                   max_queue: int = 3,
                   interactive_clients: int = 4, requests: int = 3,
                   deadline_ms: int = 60_000) -> dict:
    """The ``slo_report`` leg: the overload-shaped
    mixed-class workload against a server with the history sampler +
    SLO objectives armed, reconciled THREE ways — the registry-derived
    attainment/goodput (what ``servetop`` computes from
    ``GET /stats/history``) must EXACTLY equal the harness's own
    per-request outcome ledger AND a replay of the ``--request_log``
    JSONL events. The induced best_effort burn must produce exactly
    ONE rate-limited ``slo_burn`` incident bundle whose registry
    snapshot agrees with the live ``/metrics`` page.

    Determinism without sleeps: ``history_interval_s`` is set far
    beyond the leg's lifetime, so the ring holds exactly the samples
    this harness forces — the zero baseline ``start()`` captures and
    one forced sample per ``GET /stats/history`` poll. No sample
    lands mid-traffic, so the breach evaluates exactly twice, both
    after quiesce: the first poll writes THE bundle (quiesced
    snapshot == live page), the second is suppressed by the per-cause
    rate limit."""
    from ..serving_http import PredictServer
    from ..tools import servetop

    rs = np.random.RandomState(seed)
    errors: list[str] = []
    # the harness ledger: per-class terminal outcomes as the CLIENT
    # saw them (the ground truth the registry and the request log
    # must reconcile against)
    ledger = {cls: {"ok": 0, "good": 0, "shed": 0, "tokens": 0,
                    "goodput_tokens": 0}
              for cls in ("interactive", "batch", "best_effort")}
    ledger_lock = threading.Lock()
    with tempfile.TemporaryDirectory() as d:
        req_log = os.path.join(d, "requests.jsonl")
        inc_dir = os.path.join(d, "incidents")
        srv = PredictServer(
            export_dir, max_queue=max_queue, request_log=req_log,
            incident_dir=inc_dir,
            history_interval_s=3600.0, history_samples=64,
            slo_spec=("interactive:hit_rate=0.9;"
                      "interactive:p95_ms=60000@0.9;"
                      "best_effort:hit_rate=0.9"),
            slo_fast_window_s=7200.0, slo_slow_window_s=7200.0,
            slo_burn_threshold=1.0, device=_RUN["device"])
        srv.start()
        try:
            stop = threading.Event()

            def record(cls: str, out: dict) -> None:
                t = out["timings"][0]
                with ledger_lock:
                    ledger[cls]["ok"] += 1
                    ledger[cls]["tokens"] += t["tokens"]
                    if t["slo_good"]:
                        ledger[cls]["good"] += 1
                        ledger[cls]["goodput_tokens"] += t["tokens"]

            def interactive(ci):
                for _ in range(requests):
                    prompt = rs.randint(0, vocab,
                                        (prompt_len,)).astype(np.int32)
                    for _attempt in range(100):
                        try:
                            out = _post(
                                srv.port, srv.name, "generate",
                                {"inputs": {"input_ids":
                                            [prompt.tolist()]},
                                 "max_new": max_new,
                                 "deadline_ms": deadline_ms,
                                 "priority": "interactive"})
                            record("interactive", out)
                            break
                        except urllib.error.HTTPError as e:
                            if e.code == 429:
                                # interactive is never ladder-shed:
                                # this is the blunt queue-full bound,
                                # which the SLO counters exclude — the
                                # closed-loop client retries it
                                try:
                                    ra = float(e.headers.get(
                                        "Retry-After", 0) or 0)
                                except ValueError:
                                    ra = 0.0
                                e.read()
                                time.sleep(min(max(ra, 0.005), 0.05))
                                continue
                            errors.append(f"interactive {ci}: http "
                                          f"{e.code}")
                            return
                        except Exception as e:  # noqa: BLE001
                            errors.append(f"interactive {ci}: "
                                          f"{type(e).__name__}: {e}")
                            return
                    else:
                        errors.append(f"interactive {ci}: retry "
                                      "budget exhausted on 429s")
                        return

            def best_effort():
                ladder_up.wait(60.0)
                for _ in range(200):
                    if stop.is_set():
                        return
                    try:
                        out = _post(srv.port, srv.name, "generate",
                                    {"inputs": {"input_ids": [[1, 2]]},
                                     "max_new": 2,
                                     "priority": "best_effort"})
                        record("best_effort", out)
                    except urllib.error.HTTPError as e:
                        if e.code == 429:
                            body = e.read().decode(errors="replace")
                            # only a class SHED enters the SLO served
                            # counters; the blunt queue-full 429 is a
                            # pre-admission refusal the client retries
                            if "shed" in body:
                                with ledger_lock:
                                    ledger["best_effort"]["shed"] += 1
                        else:
                            errors.append(f"best_effort: http "
                                          f"{e.code}")
                    except Exception as e:      # noqa: BLE001
                        errors.append(f"best_effort: "
                                      f"{type(e).__name__}: {e}")
                    answered.set()
                    time.sleep(0.002)

            threads = [threading.Thread(target=interactive, args=(ci,))
                       for ci in range(interactive_clients)]
            be = threading.Thread(target=best_effort)
            ladder_up, answered = threading.Event(), threading.Event()
            with _storm_at_the_bound(srv.engine, ladder_up, answered):
                for t in threads:
                    t.start()
                be.start()
                for t in threads:
                    t.join()
                stop.set()
                be.join()
            # ---- quiesced: poll #1 forces the breach evaluation ----
            hist1 = _get_json(srv.port, "/stats/history")
            bundles = sorted(os.listdir(inc_dir))
            burn_bundles = [b for b in bundles if "-slo_burn-" in b]
            bundle_matches = False
            if burn_bundles:
                with open(os.path.join(inc_dir, burn_bundles[0])) as f:
                    bundle = json.load(f)
                # the bundle snapshot must agree with the live page —
                # rendered through the same exposition path; only the
                # http_* counters may differ (each poll advances them
                # at response time, after the incident landed)
                def page(text):
                    return "\n".join(
                        ln for ln in text.splitlines()
                        if "http_requests_total" not in ln
                        and "http_errors_total" not in ln)

                live = _get_text(srv.port, "/metrics")
                bundle_matches = (
                    page(prom_mod.render(bundle["registry"]))
                    == page(live))
            # poll #2: still breaching, must be rate-limit suppressed
            # (the re-count AFTER it is what proves suppression — the
            # first count alone could not see a second bundle land)
            hist2 = _get_json(srv.port, "/stats/history")
            burn_bundles = [b for b in sorted(os.listdir(inc_dir))
                            if "-slo_burn-" in b]
            registry = _prom(srv.port)
            healthz = _get_json(srv.port, "/healthz")
        finally:
            srv.stop()
        # ---- the three-way reconciliation ---------------------------
        summary = servetop.compute_summary(hist2)
        replay = {cls: {"ok": 0, "good": 0, "shed": 0,
                        "goodput_tokens": 0}
                  for cls in ("interactive", "batch", "best_effort")}
        with open(req_log) as f:
            for line in f:
                ev = json.loads(line)
                if ev.get("event") != "generate":
                    continue
                cls = ev["priority"]
                if ev["outcome"] == "ok":
                    replay[cls]["ok"] += 1
                    if ev["slo_good"]:
                        replay[cls]["good"] += 1
                        replay[cls]["goodput_tokens"] += ev["tokens"]
                elif ev["outcome"] == "shed":
                    replay[cls]["shed"] += 1
        diffs: list[str] = []

        def must_eq(what, *vals):
            if len({json.dumps(v, sort_keys=True)
                    for v in vals}) != 1:
                diffs.append(f"{what}: {vals}")

        for cls in ("interactive", "best_effort"):
            led, rep = ledger[cls], replay[cls]
            stc = summary["classes"][cls]
            must_eq(f"{cls} served", led["ok"] + led["shed"],
                    rep["ok"] + rep["shed"], stc["served"],
                    int(registry.get(
                        f"serving_slo_served_{cls}_total", 0)))
            must_eq(f"{cls} good", led["good"], rep["good"],
                    stc["good"],
                    int(registry.get(
                        f"serving_slo_good_{cls}_total", 0)))
            must_eq(f"{cls} shed", led["shed"], rep["shed"],
                    stc["shed"],
                    int(registry.get(f"serving_shed_{cls}_total", 0)))
        total_goodput = sum(c["goodput_tokens"]
                            for c in ledger.values())
        must_eq("goodput tokens", total_goodput,
                sum(c["goodput_tokens"] for c in replay.values()),
                summary["goodput_tokens"],
                int(registry.get("serving_goodput_tokens_total", 0)))
        slo_block = (healthz.get("slo") or {})
        return {
            "mode": "slo_report",
            "errors": errors,
            "interactive_ok": ledger["interactive"]["ok"],
            "interactive_expected": interactive_clients * requests,
            "best_effort_shed": ledger["best_effort"]["shed"],
            "goodput_tokens": total_goodput,
            "tokens": int(registry.get("serving_tokens_out_total",
                                       0)),
            "goodput_tps": summary["goodput_tps"],
            "throughput_tps": summary["throughput_tps"],
            "attainment_interactive":
                summary["classes"]["interactive"]["attainment"],
            "attainment_best_effort":
                summary["classes"]["best_effort"]["attainment"],
            "reconciled": not diffs,
            "reconcile_diff": diffs,
            "burn_bundles": len(burn_bundles),
            "bundle_matches_metrics": bundle_matches,
            "burn_suppressed": int(registry.get(
                "serving_incidents_suppressed_total", 0)),
            "healthz_breaching": slo_block.get("breaching", []),
            "history_samples": len(hist2.get("samples", ())),
            "history_samples_first_poll":
                len(hist1.get("samples", ())),
        }


def thread_sanitizer_check(export_dir: str, prompt) -> tuple[bool, str]:
    """The seeded THR01 violation probe: arm an engine's runtime
    thread sanitizer, let the scheduler thread take ownership (one
    request through the fully legal path first), then touch a
    scheduler-owned field from THIS thread — the exact cross-thread
    mutation class the single-flight design forbids. Returns
    ``(caught, message)``: ``caught`` is True only when the sanitizer
    raised :class:`ThreadOwnershipError` naming both the field and the
    offending thread."""
    from ..serving import load_stepwise
    from ..serving_batch import GenerationEngine, ThreadOwnershipError

    eng = GenerationEngine(load_stepwise(export_dir, _RUN["device"]),
                           thread_sanitizer=True).start()
    try:
        # legal traffic first: the armed engine must serve it clean
        eng.submit(prompt, max_new=2).result(timeout=120)
        try:
            eng._live            # noqa: B018 — the seeded violation
        except ThreadOwnershipError as e:
            msg = str(e)
            named = ("_live" in msg
                     and threading.current_thread().name in msg)
            return named, msg
        return False, "cross-thread read of _live went unchallenged"
    finally:
        eng.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per client (closed loop)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt_len", type=int, default=16)
    ap.add_argument("--max_new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="export/serve the block-paged stepwise "
                    "artifacts (block pool + prefix cache) instead of "
                    "the slab pool")
    ap.add_argument("--block_size", type=int, default=16,
                    help="paged: tokens per physical cache block")
    ap.add_argument("--num_blocks", type=int, default=None,
                    help="paged: physical blocks in the pool (default: "
                    "slab-equivalent capacity + the null block)")
    ap.add_argument("--pool_bytes", type=int, default=None,
                    help="paged: size the block pool in BYTES instead "
                    "of blocks (int8 then holds 2x the bf16 block "
                    "count at the same budget)")
    ap.add_argument("--weight_quant", choices=("off", "int8"),
                    default="off",
                    help="decode weights: 'int8' bakes per-output-"
                    "channel int8 + scales into every decode program "
                    "(LOSSY — gated by the drift bound, not byte "
                    "parity)")
    ap.add_argument("--kv_cache_dtype", choices=("auto", "bf16", "int8"),
                    default="auto",
                    help="KV-cache pool storage: 'auto' keeps the "
                    "model dtype (the bitwise no-op), 'int8' stores "
                    "quantized blocks + per-row scales (requires "
                    "--paged)")
    ap.add_argument("--spec_tokens", type=int, default=0,
                    help="speculative decoding: export the K-token "
                    "verify program and serve the scheduler-on leg "
                    "with --spec_tokens K (greedy byte parity vs the "
                    "off leg still asserted — speculation is exact); "
                    "needs --paged. --smoke runs its own spec legs")
    ap.add_argument("--prefix_mode", choices=("cold", "shared"),
                    default="cold",
                    help="workload shape: 'shared' prepends one seeded "
                    "system prefix to every prompt (the prefix-cache "
                    "case); 'cold' keeps fully random prompts")
    ap.add_argument("--smoke", action="store_true",
                    help="CPU config: 2 clients x 2 requests, "
                    "tiny shapes; runs the slab on/off pair PLUS the "
                    "paged cold/shared legs, an int8 leg (drift "
                    "bound + equal-bytes capacity), a THR01 "
                    "thread-sanitizer leg (armed byte/dispatch parity "
                    "+ seeded cross-thread violation probe), a "
                    "chaos_on leg (one-shot transient decode fault "
                    "healed to byte/dispatch parity), and a router_on "
                    "leg (2-replica fleet behind serving_router, byte "
                    "parity with the single-replica row), asserting "
                    "paged-vs-slab parity and shared-mode prefill "
                    "savings")
    ap.add_argument("--router", type=int, default=0,
                    help="also run a fleet leg: N in-process replicas "
                    "over the same export behind serving_router's "
                    "ReplicaRouter (tps/p95 vs the single-replica "
                    "rows, byte parity asserted); 0 = off (--smoke "
                    "always runs a 2-replica leg)")
    ap.add_argument("--no_parity", action="store_true",
                    help="skip the on-vs-off byte-identity assertion")
    ap.add_argument("--thread_sanitizer", action="store_true",
                    help="arm the engine's THR01 runtime ownership "
                    "checks on every scheduler-on leg (debug; --smoke "
                    "always runs its own armed leg + seeded-violation "
                    "probe)")
    ap.add_argument("--model", default="gpt_tiny",
                    help="registry name of the served GPT (gpt_tiny, or "
                    "gpt: GPT-small)")
    ap.add_argument("--device", default=None,
                    help="torch device of the servers (default cuda; cpu "
                    "runs without a GPU)")
    args = ap.parse_args(argv)
    from ..runtime.device import resolve_device
    _RUN["device"] = str(resolve_device(args.device))
    if args.smoke and (args.weight_quant != "off"
                       or args.kv_cache_dtype != "auto"):
        ap.error("--smoke already runs its own fully quantized int8 "
                 "leg (int8 weights + int8 paged pool, drift bound + "
                 "capacity probe) — drop --weight_quant/"
                 "--kv_cache_dtype, or run a full-matrix quant leg "
                 "without --smoke")
    if args.kv_cache_dtype == "int8" and not args.paged:
        ap.error("--kv_cache_dtype int8 quantizes the block-paged "
                 "pool — add --paged")
    if args.smoke and args.thread_sanitizer:
        ap.error("--smoke already runs its own armed tsan_on leg AND "
                 "needs rows[0] unarmed for the armed-vs-unarmed "
                 "parity/zero-dispatch checks — arming every leg would "
                 "make them vacuous; drop --thread_sanitizer")
    if args.router and args.smoke:
        ap.error("--smoke already runs its own 2-replica router leg — "
                 "drop --router, or run a full-matrix fleet leg "
                 "without --smoke")
    if args.router and (args.weight_quant != "off"
                        or args.kv_cache_dtype != "auto"):
        ap.error("--router compares the fleet leg byte-for-byte "
                 "against the single-replica scheduler-on row, which "
                 "the LOSSY quant legs cannot satisfy — run them "
                 "separately")
    if args.router < 0:
        ap.error(f"--router takes a replica count >= 0, got "
                 f"{args.router}")
    if args.spec_tokens:
        if args.smoke:
            ap.error("--smoke already runs its own spec_on/spec_off "
                     "legs (repetitive workload, accept-rate and "
                     "dispatch-win assertions) — drop --spec_tokens, "
                     "or run a full-matrix spec leg without --smoke")
        if not args.paged:
            ap.error("--spec_tokens exports the verify program over "
                     "the block-paged stepwise pair — add --paged")
        if args.spec_tokens < 2:
            ap.error(f"--spec_tokens must be >= 2 (anchor + at least "
                     f"one draft lane), got {args.spec_tokens}")
    _RUN["lockstep"] = args.smoke
    if args.smoke:
        args.clients, args.requests = 2, 2
        args.slots, args.prompt_len, args.max_new = 2, 8, 4
        args.block_size = min(args.block_size, 4)
    quant = args.weight_quant == "int8" or args.kv_cache_dtype == "int8"

    model = args.model

    def matrix_for(vocab, prefix_mode):
        return make_requests(args.clients, args.requests,
                             prompt_len=args.prompt_len,
                             max_new=args.max_new, vocab=vocab,
                             seed=args.seed, prefix_mode=prefix_mode,
                             block_size=args.block_size)

    rows = []
    checks = []          # (description, bool) pairs for the summary
    extra_summary = {}   # measured (non-gate) figures for the summary
    with tempfile.TemporaryDirectory() as d:
        # the plain export: the "on" leg when quant is off, and ALWAYS
        # the scheduler-off bf16 oracle (a quant export's monolithic
        # artifact rides int8 weights too, so it cannot be the drift
        # oracle)
        vocab = build_export(d, prompt_len=args.prompt_len,
                             model_name=model,
                             max_new=args.max_new, slots=args.slots,
                             seed=args.seed,
                             paged=args.paged and not quant,
                             block_size=args.block_size,
                             num_blocks=None if quant
                             else args.num_blocks,
                             pool_bytes=None if quant
                             else args.pool_bytes,
                             spec_tokens=(0 if quant
                                          else args.spec_tokens))
        matrix = matrix_for(vocab, args.prefix_mode)
        # the exported dir always holds the monolithic artifact too,
        # so scheduler=off is the oracle for slab AND paged runs
        if quant:
            with tempfile.TemporaryDirectory() as dq:
                build_export(dq, prompt_len=args.prompt_len,
                             model_name=model,
                             max_new=args.max_new, slots=args.slots,
                             seed=args.seed, paged=args.paged,
                             block_size=args.block_size,
                             num_blocks=args.num_blocks,
                             pool_bytes=args.pool_bytes,
                             weight_quant=args.weight_quant,
                             kv_cache_dtype=args.kv_cache_dtype,
                             spec_tokens=args.spec_tokens)
                rows = [run_mode(dq, matrix, scheduler="on",
                                 prompt_len=args.prompt_len,
                                 mode_name="int8_on",
                                 thread_sanitizer=args.thread_sanitizer,
                                 spec_tokens=args.spec_tokens)]
            rows.append(run_mode(d, matrix, scheduler="off",
                                 prompt_len=args.prompt_len))
        else:
            rows = [run_mode(d, matrix, scheduler="on",
                             prompt_len=args.prompt_len,
                             mode_name=("spec_on" if args.spec_tokens
                                        else "paged_on" if args.paged
                                        else "scheduler_on"),
                             thread_sanitizer=args.thread_sanitizer,
                             spec_tokens=args.spec_tokens),
                    run_mode(d, matrix, scheduler="off",
                             prompt_len=args.prompt_len)]
        if args.smoke:
            with tempfile.TemporaryDirectory() as dp:
                # the paged smoke export also carries the chunked-
                # prefill program: paged_cold serves it with the knob
                # OFF (the bitwise-no-op leg), chunked_on with it ON
                build_export(dp, prompt_len=args.prompt_len,
                             model_name=model,
                             max_new=args.max_new, slots=args.slots,
                             seed=args.seed, paged=True,
                             block_size=args.block_size,
                             prefill_chunk=args.block_size,
                             num_blocks=1 + 4 * args.slots
                             * -(-(args.prompt_len + args.max_new)
                                 // args.block_size))
                # the cold leg must be genuinely cold even when the
                # main matrix was built with --prefix_mode shared —
                # and its parity oracle must run the SAME matrix
                if args.prefix_mode == "cold":
                    cold, cold_off_gens = matrix, rows[1]["_gens"]
                else:
                    cold = matrix_for(vocab, "cold")
                    cold_off_gens = run_mode(
                        dp, cold, scheduler="off",
                        prompt_len=args.prompt_len,
                        mode_name="cold_off")["_gens"]
                paged_cold = run_mode(dp, cold, scheduler="on",
                                      prompt_len=args.prompt_len,
                                      mode_name="paged_cold")
                shared = matrix_for(vocab, "shared")
                # trace=True: the smoke run doubles as the scheduler-
                # timeline gate — the captured Perfetto JSON is
                # validated (per-slot prefill/decode spans, request-id
                # correlation) inside run_mode
                paged_shared = run_mode(dp, shared, scheduler="on",
                                        prompt_len=args.prompt_len,
                                        mode_name="paged_shared",
                                        trace=True)
                shared_off = run_mode(dp, shared, scheduler="off",
                                      prompt_len=args.prompt_len,
                                      mode_name="shared_off")
                # chunked-prefill leg : same cold matrix,
                # chunking ON — byte parity with the scheduler-off
                # oracle, chunk dispatches replacing every cold
                # monolithic prefill
                chunked_on = run_mode(
                    dp, cold, scheduler="on",
                    prompt_len=args.prompt_len,
                    mode_name="chunked_on",
                    server_kw={"prefill_chunk_tokens":
                               args.block_size})
                # overload leg : 2x offered load against a
                # 4-deep queue — interactive protected, best_effort
                # shed with 429 + Retry-After, shed accounting exact
                overload_row = run_overload(
                    dp, vocab=vocab, seed=args.seed,
                    prompt_len=args.prompt_len,
                    max_new=args.max_new)
                # slo_report leg : the same overload shape
                # with the history sampler + objectives armed —
                # servetop-computed attainment/goodput must reconcile
                # EXACTLY with the harness ledger and the request-log
                # replay, and the induced best_effort burn must write
                # exactly one rate-limited slo_burn bundle agreeing
                # with live /metrics
                slo_report_row = run_slo_report(
                    dp, vocab=vocab, seed=args.seed,
                    prompt_len=args.prompt_len,
                    max_new=args.max_new)
            # the int8 leg: same cold matrix against a fully quantized
            # export (int8 weights + int8 KV pool) — gated on the
            # documented drift bound vs the bf16 oracle, plus the
            # equal-bytes capacity probe
            with tempfile.TemporaryDirectory() as di:
                total = args.prompt_len + args.max_new
                bps = -(-total // args.block_size)
                build_export(di, prompt_len=args.prompt_len,
                             model_name=model,
                             max_new=args.max_new, slots=args.slots,
                             seed=args.seed, paged=True,
                             block_size=args.block_size,
                             num_blocks=1 + 4 * args.slots * bps,
                             weight_quant="int8",
                             kv_cache_dtype="int8")
                int8_row = run_mode(di, cold, scheduler="on",
                                    prompt_len=args.prompt_len,
                                    mode_name="int8_on")
            agreement = token_agreement(int8_row["_gens"],
                                        cold_off_gens)
            int8_row["int8_agreement"] = round(agreement, 4)
            cap_bf16, cap_int8 = int8_capacity_check(
                prompt_len=args.prompt_len, max_new=args.max_new,
                seed=args.seed, block_size=args.block_size)
            int8_row["capacity_bf16"] = cap_bf16
            int8_row["capacity_int8"] = cap_int8
            # THR01 runtime-sanitizer legs: the ARMED engine must
            # serve the same matrix byte- and dispatch-identically to
            # the plain leg (rows[0] — so the disabled default
            # provably adds/loses zero dispatches), and the seeded
            # cross-thread violation probe must be caught with the
            # field + thread named in the error
            tsan_row = run_mode(d, matrix, scheduler="on",
                                prompt_len=args.prompt_len,
                                mode_name="tsan_on",
                                thread_sanitizer=True)
            tsan_caught, _tsan_msg = thread_sanitizer_check(
                d, matrix[0][0][0])
            tsan_row["tsan_violation_caught"] = tsan_caught
            # chaos_on leg : the SAME matrix with a one-shot
            # transient decode fault armed through the runtime/faults
            # seams — the engine's bounded re-dispatch must heal it
            # INVISIBLY: byte parity with the fault-disabled leg
            # (rows[0]), identical dispatch counts (the retry repeats
            # a dispatch but no scheduler step), exactly one
            # re-dispatch counted, zero failed requests
            from ..runtime import faults as _faults
            _faults.install(_faults.parse_spec(
                "engine.decode_step:step=2", seed=args.seed))
            try:
                chaos_row = run_mode(d, matrix, scheduler="on",
                                     prompt_len=args.prompt_len,
                                     mode_name="chaos_on")
            finally:
                _faults.install(None)
            # spec legs: self-drafting speculative decoding on a
            # REPETITIVE workload (the drafter's food) against a
            # verify-step export — byte parity vs the spec-off oracle
            # over the same export, accept_rate > 0, strictly fewer
            # verify dispatches than emitted tokens, and a real
            # dispatch-count win (the emitted-tokens-per-dispatch > 1
            # gate). max_new is raised so greedy decode has room to
            # settle into the repetitive fixed points the drafter
            # mines. The model is the chaos drills' GPT (vocabulary 64),
            # whose random greedy output repeats: the tiny registry GPT's
            # (vocabulary 1000) seldom follows its prompt's pattern, so
            # its drafts are rejected and no dispatch is saved (accept
            # rate 0.09, equal dispatch counts, on seed 0)
            from .serving_chaos import chaos_model
            spec_max_new = max(args.max_new, 12)
            spec_k = 4
            with tempfile.TemporaryDirectory() as dsp:
                spec_vocab = build_export(
                    dsp, prompt_len=args.prompt_len,
                    max_new=spec_max_new, slots=args.slots,
                    seed=args.seed, paged=True,
                    block_size=args.block_size,
                    num_blocks=1 + 4 * args.slots
                    * -(-(args.prompt_len + spec_max_new)
                        // args.block_size),
                    spec_tokens=spec_k,
                    model=chaos_model(_RUN["device"]))
                rep = make_repetitive_requests(
                    args.clients, args.requests,
                    prompt_len=args.prompt_len, max_new=spec_max_new,
                    vocab=spec_vocab, seed=args.seed)
                spec_off_row = run_mode(dsp, rep, scheduler="on",
                                        prompt_len=args.prompt_len,
                                        mode_name="spec_off")
                spec_row = run_mode(dsp, rep, scheduler="on",
                                    prompt_len=args.prompt_len,
                                    mode_name="spec_on",
                                    spec_tokens=spec_k)
            sreg = spec_row["registry"]
            # flightrec_off leg : rows[0] runs with the
            # flight recorder's always-on ring (the default); turning
            # it OFF must be byte- and dispatch-identical — the ring's
            # cost is observability only — and the tps ratio is
            # reported so a card run can baseline the (absence
            # of) overhead
            flightrec_off_row = run_mode(
                d, matrix, scheduler="on", prompt_len=args.prompt_len,
                mode_name="flightrec_off",
                server_kw={"flight_recorder": False})
            # slo_on leg : the SAME matrix with the history
            # sampler + SLO objectives armed — the sampler is a pure
            # registry reader, so the leg must stay byte- AND
            # dispatch-identical to rows[0] (armed-vs-plain parity,
            # the flight-recorder pattern)
            slo_on_row = run_mode(
                d, matrix, scheduler="on", prompt_len=args.prompt_len,
                mode_name="slo_on",
                server_kw={"history_interval_s": 3600.0,
                           "slo_spec": "interactive:hit_rate=0.99"})
            # router leg : the same matrix through a
            # 2-replica fleet — greedy bytes must not depend on which
            # replica serves (or on the router being in the path)
            router_row = run_router_mode(d, matrix, replicas=2)
            # the decode-stall probe : long-context A/B,
            # chunked stall bounded at one chunk dispatch
            stall = chunk_stall_probe(seed=args.seed)
            extra_summary["chunk_stall_off_ms"] = \
                stall["off"]["stall_max_ms"]
            extra_summary["chunk_stall_on_ms"] = \
                stall["on"]["stall_max_ms"]
            extra_summary["chunk_stall_p95_off_ms"] = \
                stall["off"]["stall_p95_ms"]
            extra_summary["chunk_stall_p95_on_ms"] = \
                stall["on"]["stall_p95_ms"]
            # wall ratio reported, not gated: the per-dispatch overhead
            # that dominates the tiny CPU probe amortizes away at real
            # model sizes; the card measures the tps side
            extra_summary["chunk_wall_ratio"] = round(
                stall["on"]["wall_s"] / stall["off"]["wall_s"], 3) \
                if stall["off"]["wall_s"] else None
            rows += [paged_cold, paged_shared, shared_off, chunked_on,
                     overload_row, slo_report_row, int8_row,
                     tsan_row, chaos_row, spec_off_row, spec_row,
                     flightrec_off_row, slo_on_row, router_row]
            # always-on tps / recorder-off tps: ~1.0 expected (the
            # ring's per-span cost is µs against ms-scale dispatches);
            # reported, not gated — CPU smoke noise would make a
            # strict bound flaky, the card measures it
            extra_summary["flightrec_on_tps_ratio"] = round(
                rows[0]["tokens_per_s"]
                / flightrec_off_row["tokens_per_s"], 3) \
                if flightrec_off_row["tokens_per_s"] else None
            checks += [
                # gates: chunked prefill is exact and a
                # provable no-op when off; overload degrades by class
                # with honest pushback; the worst-case decode stall
                # under a long-prompt storm is chunk-bounded
                ("chunked_parity_with_off",
                 chunked_on["_gens"] == cold_off_gens),
                ("chunked_prefill_dispatches",
                 chunked_on["registry"].get(
                     "serving_prefill_chunks_total", 0) > 0),
                ("chunk_noop_when_off",
                 paged_cold["registry"].get(
                     "serving_prefill_chunks_total", 0) == 0),
                ("overload_interactive_zero_failures",
                 not overload_row["errors"]
                 and overload_row["interactive_requests"]
                 == overload_row["interactive_expected"]),
                ("overload_interactive_no_deadline_misses",
                 overload_row["deadline_expired"] == 0),
                ("overload_sheds_with_retry_after",
                 overload_row["shed_429"] > 0
                 and overload_row["missing_retry_after"] == 0),
                ("overload_shed_accounting",
                 overload_row["shed_total"]
                 == overload_row["shed_429"] > 0),
                ("overload_recovers_healthy",
                 overload_row["pressure_final"] == "healthy"),
                ("overload_p95_within_deadline",
                 overload_row["latency_p95_ms"]
                 <= overload_row["deadline_ms"]),
                # gates: the measurement half of the SLO
                # story — exact three-way reconciliation, exactly one
                # rate-limited slo_burn bundle agreeing with the live
                # page, goodput visible and bounded by throughput,
                # and the armed sampler a provable no-op
                ("slo_report_reconciles",
                 slo_report_row["reconciled"]
                 and not slo_report_row["errors"]),
                ("slo_report_interactive_all_served",
                 slo_report_row["interactive_ok"]
                 == slo_report_row["interactive_expected"]),
                ("slo_report_sheds_best_effort",
                 slo_report_row["best_effort_shed"] > 0),
                ("slo_burn_exactly_one_bundle",
                 slo_report_row["burn_bundles"] == 1),
                ("slo_burn_rate_limited",
                 slo_report_row["burn_suppressed"] >= 1),
                ("slo_burn_bundle_matches_metrics",
                 slo_report_row["bundle_matches_metrics"]),
                ("slo_burn_advisory_on_healthz",
                 "best_effort:hit_rate"
                 in slo_report_row["healthz_breaching"]),
                ("slo_goodput_positive_and_bounded",
                 0 < slo_report_row["goodput_tokens"]
                 <= slo_report_row["tokens"]),
                ("slo_on_parity_with_plain",
                 slo_on_row["_gens"] == rows[0]["_gens"]),
                ("slo_on_dispatch_parity",
                 (slo_on_row["decode_steps"], slo_on_row["prefills"])
                 == (rows[0]["decode_steps"], rows[0]["prefills"])),
                ("chunk_stall_parity", stall["parity"]),
                ("chunk_stall_bounded_below_monolithic",
                 stall["on"]["stall_max_ms"]
                 < stall["off"]["stall_max_ms"]),
                ("chunk_stall_p95_drops",
                 stall["on"]["stall_p95_ms"]
                 < stall["off"]["stall_p95_ms"]),
                ("router_parity_with_single_replica",
                 router_row["_gens"] == rows[0]["_gens"]),
                ("router_zero_client_failures",
                 not router_row["errors"]),
                ("router_counts_every_request",
                 router_row["router_requests"]
                 == router_row["requests"]),
                ("router_registry_p95_positive",
                 router_row["fleet_registry_p95_ms"] > 0),
                # gates: tracing-always-on parity and the
                # bucket audit (no default-registered histogram may
                # saturate its top finite bucket under the smoke load)
                ("flightrec_off_parity_with_on",
                 flightrec_off_row["_gens"] == rows[0]["_gens"]),
                ("flightrec_off_dispatch_parity",
                 (flightrec_off_row["decode_steps"],
                  flightrec_off_row["prefills"])
                 == (rows[0]["decode_steps"], rows[0]["prefills"])),
                ("no_saturated_histograms",
                 not any(r.get("saturated_histograms")
                         for r in [rows[0], paged_cold, paged_shared,
                                   router_row])),
                ("tsan_parity_with_unarmed",
                 tsan_row["_gens"] == rows[0]["_gens"]),
                ("tsan_zero_dispatch_delta",
                 (tsan_row["decode_steps"], tsan_row["prefills"])
                 == (rows[0]["decode_steps"], rows[0]["prefills"])),
                ("tsan_catches_cross_thread", tsan_caught),
                ("paged_vs_slab_parity",
                 paged_cold["_gens"] == cold_off_gens),
                ("shared_vs_cold_admission_parity",
                 paged_shared["_gens"] == shared_off["_gens"]),
                ("shared_prefills_below_cold",
                 paged_shared["prefills"] < paged_cold["prefills"]),
                ("scheduler_trace_valid",
                 paged_shared.get("trace_events", 0) > 0),
                ("int8_drift_within_bound",
                 agreement >= INT8_MIN_AGREEMENT),
                ("int8_admits_more_than_bf16", cap_int8 > cap_bf16),
                ("chaos_parity_with_fault_disabled",
                 chaos_row["_gens"] == rows[0]["_gens"]),
                ("chaos_dispatch_count_parity",
                 (chaos_row["decode_steps"], chaos_row["prefills"])
                 == (rows[0]["decode_steps"], rows[0]["prefills"])),
                ("chaos_exactly_one_redispatch",
                 chaos_row["registry"].get(
                     "serving_redispatches_total") == 1),
                ("chaos_zero_failed_requests",
                 chaos_row["registry"].get(
                     "serving_requests_failed_total") == 0),
                # spec gates: exactness, a real accept rate,
                # and the dispatch-count win speculation exists for
                ("spec_parity_with_off",
                 spec_row["_gens"] == spec_off_row["_gens"]),
                ("spec_accept_rate_positive",
                 sreg.get("serving_spec_accepted_total", 0) > 0
                 and spec_row.get("accept_rate", 0) > 0),
                ("spec_verify_dispatches_below_emitted_tokens",
                 sreg["serving_verify_steps_total"]
                 < sreg["serving_tokens_out_total"]),
                ("spec_emitted_per_verify_dispatch_above_one",
                 sreg["serving_verify_steps_total"] > 0
                 and sreg["serving_spec_emitted_total"]
                 > sreg["serving_verify_steps_total"]),
                ("spec_total_dispatch_win",
                 sreg["serving_decode_steps_total"]
                 + sreg["serving_verify_steps_total"]
                 < spec_off_row["registry"][
                     "serving_decode_steps_total"]),
                ("spec_off_zero_verify_dispatches",
                 spec_off_row["registry"][
                     "serving_verify_steps_total"] == 0),
            ]
        elif args.router:
            # the full-matrix fleet leg: N replicas, same matrix,
            # byte parity against the single-replica scheduler-on row
            router_row = run_router_mode(d, matrix,
                                         replicas=args.router)
            rows.append(router_row)
            checks += [
                ("router_parity_with_single_replica",
                 router_row["_gens"] == rows[0]["_gens"]),
                ("router_zero_client_failures",
                 not router_row["errors"]),
            ]

    parity = agreement = None
    if quant:
        # int8 vs the bf16 oracle: byte parity is not the contract —
        # the documented token-agreement bound is
        agreement = round(token_agreement(rows[0]["_gens"],
                                          rows[1]["_gens"]), 4)
    elif not args.no_parity:
        parity = rows[0]["_gens"] == rows[1]["_gens"]
    ok = (all(not r["errors"] for r in rows)
          and parity is not False
          and (agreement is None or agreement >= INT8_MIN_AGREEMENT)
          and all(v for _, v in checks))
    for row in rows:
        row.pop("_gens", None)      # the overload row carries none
        print(json.dumps(row))
    on, off = rows[0], rows[1]
    summary = {
        "summary": True,
        "ok": ok,
        "greedy_parity": parity,
        "speedup_tokens_per_s": round(
            on["tokens_per_s"] / off["tokens_per_s"], 3)
        if off["tokens_per_s"] else None,
        "dispatch_ratio": round(
            off["decode_steps"] / on["decode_steps"], 3)
        if on["decode_steps"] else None,
    }
    if agreement is not None:
        summary["int8_agreement"] = agreement
        summary["int8_agreement_bound"] = INT8_MIN_AGREEMENT
    summary.update(extra_summary)
    summary.update({name: v for name, v in checks})
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
