"""Serving chaos soak on the port: seeded failure scenarios against the
continuous-batching engine with asserted self-healing invariants (a port
copy of ``experiments/serving_chaos.py``, driving the port's engine over
a tiny paged export that the port's ``export_generator`` writes).

Each scenario builds a real engine over a seeded paged GPT export, injects
one failure class through the :mod:`~..runtime.faults` seams
(``engine.prefill`` / ``engine.decode_step`` / ``engine.admit`` /
``pool.alloc``) or the engine's own control surface (cancel, drain,
deadlines), and asserts the reference's contract, holding every survivor
to the port's own undisturbed run of the same prompts:

- ``deadline_storm``   — 1 ms-deadline requests race loose ones: every
                         tight request fails (expired 504-class or shed
                         429-class), every loose request matches the
                         undisturbed run, ``blocks_free`` recovers exactly.
- ``poison_step``      — a shared decode step fails twice at the same
                         invocation: the newest admission is evicted,
                         survivors match, ``redispatches >= 2``.
- ``blocks_cancel``    — an over-committed pool: exhaustion fails the
                         starved request loudly, cancelling a live
                         neighbor frees its blocks at once, the pool
                         recovers to the exact free count.
- ``drain_under_load`` — drain() with the queue full: nothing dropped,
                         new admissions refused with DrainingError.
- ``flaky_dispatch``   — a one-shot decode fault healed by one
                         re-dispatch.
- ``watchdog_trip``    — a wedged decode dispatch: health flips to
                         stalled, close() raises EngineStalledError, the
                         released engine parks clean.
- ``queue_full_retry`` — clients retry a 2-deep queue on 429 until every
                         request lands.
- ``spec_verify_fault``— a decode-step fault during a speculative verify
                         dispatch: a transient heals, a repeat evicts.
- ``overload_storm``   — ~2x sustainable load: interactive requests
                         finish, best_effort is shed with a measured
                         Retry-After, pressure recovers.
- ``long_prompt_storm``— chunked prefill interleaves decode steps between
                         a long prompt's chunks, bytes equal chunk-off.

The engine runs on ``--device`` (the card by default: bf16 weights, the
flash kernel's prefill and the paged decode kernel; ``cpu`` runs f32 and
the plain paths). ``--kv_cache_dtype int8`` runs the scenarios over int8
pools (the int8 paged decode kernel on the card).

Usage::

    python -m distributed_tensorflow_example_tpu_torch.experiments.\\
serving_chaos [--scenario all] [--seed 0] [--device cpu] [--smoke]

Prints one JSON line per scenario (``{"scenario", "ok", "detail",
"metrics"}``, the metrics being the engine registry's self-healing
counters) and a summary line; exits nonzero if any scenario fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

from ..runtime import faults

# one tiny seeded export shared by all scenarios (built once per run);
# per-request max_new stays well under the exported depth so scenarios
# pick short runs for speed and long runs where they need a live window
PROMPT_LEN = 8
MAX_NEW = 16
SLOTS = 4
BLOCK = 4

#: the run's device and pool dtype, set by :func:`run_scenarios`
_RUN = {"device": "cuda", "kv_cache_dtype": None}

#: the least wall time of a shared dispatch: the tiny model's CPU step
#: takes ~1 ms, and a scenario's window (a queue that must fill, a
#: request that must still be live when cancelled or drained) must
#: outlast its client threads' scheduling on a loaded host; a card's
#: step takes longer than this already
MIN_STEP_S = 0.005


def _bps() -> int:
    """Blocks per full-depth slot at the shared export shapes."""
    return -(-(PROMPT_LEN + MAX_NEW) // BLOCK)


def chaos_model(device):
    """The scenarios' GPT: two layers of width 128 with head dim 64 (the
    paged decode kernel's smallest), on the card bf16 with the flash
    prefill, on the CPU f32. A 64-token vocabulary makes the random
    model's greedy output repeat, so prompt lookup drafts and verify
    dispatches accept."""
    import torch
    from ..models.gpt import GPT, GPTConfig
    cfg = GPTConfig(vocab_size=64, hidden=128, layers=2, heads=2,
                    intermediate=256, max_len=128)
    if torch.device(device).type == "cuda":
        return GPT(cfg, dtype=torch.bfloat16, attention_impl="flash")
    return GPT(cfg)


def build_export(out_dir: str, *, prompt_len: int, max_new: int,
                 slots: int, seed: int = 0, paged: bool = True,
                 block_size: int = BLOCK, num_blocks=None,
                 spec_tokens: int = 0, prefill_chunk: int = 0) -> int:
    """A seeded paged stepwise export of :func:`chaos_model` on the run's
    device and pool dtype; returns the vocabulary size."""
    from ..serving import export_generator
    device = _RUN["device"]
    model = chaos_model(device)
    params = model.init(seed, device=device)
    export_generator(model, params, out_dir, prompt_len=prompt_len,
                     max_new_tokens=max_new, batch_size=1, ragged=True,
                     stepwise=True, slots=slots, paged=paged,
                     block_size=block_size, num_blocks=num_blocks,
                     kv_cache_dtype=_RUN["kv_cache_dtype"],
                     spec_tokens=spec_tokens, prefill_chunk=prefill_chunk)
    return model.cfg.vocab_size


def build_chaos_export(out_dir: str, *, seed: int,
                       num_blocks: int | None = None) -> int:
    """The scenario artifact: paged stepwise export at the module shapes
    (``num_blocks`` lets the exhaustion scenario under-provision)."""
    return build_export(
        out_dir, prompt_len=PROMPT_LEN, max_new=MAX_NEW, slots=SLOTS,
        seed=seed, paged=True, block_size=BLOCK,
        num_blocks=(1 + 4 * SLOTS * _bps()
                    if num_blocks is None else num_blocks))


def _paced(call):
    """``call`` taking at least :data:`MIN_STEP_S` of wall time."""
    def paced(feats):
        t0 = time.perf_counter()
        out = call(feats)
        rest = MIN_STEP_S - (time.perf_counter() - t0)
        if rest > 0:
            time.sleep(rest)
        return out
    return paced


def fresh_engine(export_dir: str, **kw):
    """A started engine over ``export_dir`` on the run's device, its
    shared dispatches paced at :data:`MIN_STEP_S`. Prefix cache OFF by
    default: every scenario asserts EXACT ``blocks_free`` recovery, and
    cached prefixes legitimately retain block references."""
    from ..serving import load_stepwise
    from ..serving_batch import GenerationEngine
    kw.setdefault("prefix_cache", False)
    sw = load_stepwise(export_dir, _RUN["device"])
    sw.decode, sw.verify = _paced(sw.decode), _paced(sw.verify)
    return GenerationEngine(sw, **kw).start()


def seeded_prompts(n: int, seed: int, vocab: int):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (int(rs.randint(1, PROMPT_LEN + 1)),))
            .astype(np.int32) for _ in range(n)]


def reference_run(export_dir: str, prompts, max_new: int,
                  sequential: bool = False) -> list:
    """The undisturbed oracle: the same prompts through a clean engine
    (greedy rows are computed independently, so any surviving subset of
    a chaos run must match its rows here). ``sequential`` serves one
    request at a time: the oracle of the under-provisioned pool."""
    eng = fresh_engine(export_dir)
    try:
        if sequential:
            return [eng.submit(p, max_new=max_new).result(timeout=120)
                    for p in prompts]
        handles = [eng.submit(p, max_new=max_new) for p in prompts]
        return [h.result(timeout=120) for h in handles]
    finally:
        eng.close()


def counters(eng) -> dict:
    """The scenario's published-metrics view: the self-healing counters,
    straight from the engine registry snapshot."""
    snap = eng.registry.snapshot()

    def v(name):
        m = snap.get(name)
        return (m.get("value", 0) if isinstance(m, dict) else m) or 0

    return {k: v(k) for k in (
        "serving_requests_failed_total", "serving_cancelled_total",
        "serving_deadline_expired_total", "serving_redispatches_total",
        "serving_drain_ms", "serving_shed_total",
        "serving_shed_infeasible_total", "serving_prefill_chunks_total",
        "serving_pressure_transitions_total")}


#: the least greedy token agreement on the card (bf16 weights, bf16 or
#: int8 pools) of spec on against spec off over ``spec_verify_fault``'s
#: rows, and of chunked against monolithic prefill over
#: ``long_prompt_storm``'s long rows: the verify step's wider products,
#: and the chunks' plain attention against the flash prefill, round
#: otherwise in bf16, and a near-tie flip diverges a row from there on.
#: On the CPU (f32) both are held exactly. On an H100, seeds 0-7 over
#: bf16 and int8 pools read 1.0 in all 16 runs of each (PERF.md, PR 17);
#: the limits leave one flipped token of the long rows' 8 and three of
#: the spec rows' 30, so a chunk or verify fault that moves more fails
SPEC_CARD_AGREEMENT = 0.9
CHUNK_CARD_AGREEMENT = 0.875


def token_agreement(a: list, b: list) -> float:
    """Share of equal tokens, position by position, over rows a and b."""
    pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def held_to(outs: list, ref: list, limit: float, what: str) -> str:
    """Hold ``outs`` to ``ref``: byte-equal on the CPU, greedy token
    agreement of at least ``limit`` on the card. Returns the phrase a
    scenario's detail reports."""
    agree = token_agreement(outs, ref)
    if _RUN["device"] == "cpu":
        assert outs == ref, f"{what} diverged (agreement {agree:.4f})"
        return "byte parity"
    assert agree >= limit, f"{what}: agreement {agree:.4f} < {limit}"
    return f"agreement {agree:.4f} >= {limit}"


def _wait(pred, timeout=30.0, what="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# scenarios — each returns (detail, metrics)
# ---------------------------------------------------------------------------

def scenario_deadline_storm(d: str, seed: int, vocab: int):
    """A 1 ms deadline can be SHED (429-class ShedError, deadline
    infeasible at the measured rate) instead of expiring into the
    504-class DeadlineExceededError once the engine's decode EMA has a
    signal — both are the fail-fast-and-return-blocks outcome this storm
    pins, so either counts; the accounting assertion covers their sum."""
    from ..serving_batch import (
        DeadlineExceededError, ShedError)
    prompts = seeded_prompts(2 * SLOTS, seed, vocab)
    tight, loose = prompts[::2], prompts[1::2]
    ref = reference_run(d, loose, max_new=6)
    eng = fresh_engine(d)
    try:
        free0 = eng.stats()["blocks_free"]
        handles = []
        for i in range(len(prompts)):
            if i % 2 == 0:          # the storm: 1 ms — expires queued
                handles.append(eng.submit(prompts[i], max_new=MAX_NEW,
                                          deadline_ms=1))
            else:
                handles.append(eng.submit(prompts[i], max_new=6))
        expired = shed = survived = 0
        for i, h in enumerate(handles):
            if i % 2 == 0:
                try:
                    h.result(timeout=120)
                    raise AssertionError(
                        f"1 ms-deadline request {h.request_id} was "
                        "never expired or shed")
                except ShedError:
                    shed += 1
                except DeadlineExceededError:
                    expired += 1
            else:
                toks = h.result(timeout=120)
                assert toks == ref[i // 2], \
                    f"survivor {i} diverged from the undisturbed run"
                survived += 1
        _wait(lambda: eng.stats()["blocks_free"] == free0,
              what="exact blocks_free recovery")
        met = counters(eng)
        assert met["serving_deadline_expired_total"] == expired, met
        assert met["serving_shed_infeasible_total"] == shed, met
        return (f"{expired} expired (504-class) + {shed} shed "
                f"(429-class feasibility), {survived} survivors to "
                f"byte parity, blocks_free recovered to {free0}",
                met)
    finally:
        eng.close()


def scenario_poison_step(d: str, seed: int, vocab: int):
    from ..serving_batch import \
        PoisonedRequestError
    prompts = seeded_prompts(3, seed + 1, vocab)
    ref = reference_run(d, prompts, max_new=8)
    # two rules on the SAME invocation: the retry (attempt 1) re-probes
    # index 2 and hits the second rule — the repeat failure that
    # triggers the newest-admitted eviction
    faults.install(faults.parse_spec(
        "engine.decode_step:step=2;engine.decode_step:step=2",
        seed=seed))
    try:
        eng = fresh_engine(d)
        try:
            handles = [eng.submit(p, max_new=8) for p in prompts]
            outs, poisoned = [], []
            for i, h in enumerate(handles):
                try:
                    outs.append((i, h.result(timeout=120)))
                except PoisonedRequestError:
                    poisoned.append(i)
            assert poisoned == [2], \
                f"expected exactly the newest admission evicted, got " \
                f"{poisoned}"
            for i, toks in outs:
                assert toks == ref[i], \
                    f"survivor {i} diverged after the re-dispatch"
            met = counters(eng)
            assert met["serving_redispatches_total"] >= 2, met
            assert met["serving_requests_failed_total"] == 1, met
            return (f"decode step 2 failed twice; request {poisoned[0]} "
                    f"evicted, {len(outs)} survivors to byte parity, "
                    f"{met['serving_redispatches_total']} re-dispatches",
                    met)
        finally:
            eng.close()
    finally:
        faults.install(None)


def scenario_blocks_cancel(d_tight: str, seed: int, vocab: int):
    from ..serving_batch import (
        BlocksExhaustedError, RequestCancelledError)
    rs = np.random.RandomState(seed + 2)
    # full-length prompts: 2 blocks each at admission, growing to
    # _bps() at full depth — three full-depth requests need 3*_bps()
    # blocks against a pool of 2*_bps(): one MUST starve mid-decode
    prompts = [rs.randint(0, vocab, (PROMPT_LEN,)).astype(np.int32)
               for _ in range(3)]
    ref = reference_run(d_tight, prompts, max_new=MAX_NEW,
                        sequential=True)
    eng = fresh_engine(d_tight)
    try:
        free0 = eng.stats()["blocks_free"]
        handles = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
        _wait(lambda: eng.stats()["live_slots"] >= 2,
              what="two live slots")
        # cancel the FIRST live request mid-decode: its blocks must
        # come back at the next step boundary, not at retirement
        free_before = eng.stats()["blocks_free"]
        assert handles[0].cancel(), "cancel() found nothing to cancel"
        _wait(lambda: eng.stats()["blocks_free"] > free_before,
              what="cancelled request's blocks returning to the pool")
        outcomes = {"done": 0, "exhausted": 0, "cancelled": 0}
        for i, h in enumerate(handles):
            try:
                toks = h.result(timeout=120)
                assert toks == ref[i], \
                    f"survivor {i} diverged from the undisturbed run"
                outcomes["done"] += 1
            except RequestCancelledError:
                outcomes["cancelled"] += 1
            except BlocksExhaustedError:
                outcomes["exhausted"] += 1
        assert outcomes["cancelled"] == 1, outcomes
        assert outcomes["done"] >= 1, outcomes
        _wait(lambda: eng.stats()["blocks_free"] == free0,
              what="exact blocks_free recovery")
        # the pool must still SERVE after recovery, not just count right
        probe = eng.submit(prompts[0], max_new=2).result(timeout=120)
        assert probe == ref[0][:2], "post-recovery probe diverged"
        met = counters(eng)
        return (f"{outcomes} against a {free0}-block pool; recovery "
                "exact; post-recovery probe served to parity", met)
    finally:
        eng.close()


def scenario_drain_under_load(d: str, seed: int, vocab: int):
    from ..serving_batch import \
        DrainingError
    prompts = seeded_prompts(2 * SLOTS, seed + 3, vocab)
    ref = reference_run(d, prompts, max_new=4)
    eng = fresh_engine(d, drain_timeout_s=60.0)
    try:
        handles = [eng.submit(p, max_new=4) for p in prompts]

        # drain in the background so THIS thread can probe the
        # draining window deterministically (the flag flips at
        # drain() entry; the 2*SLOTS-deep backlog keeps the window
        # open for hundreds of CPU decode steps)
        result: dict = {}
        th = threading.Thread(
            target=lambda: result.setdefault("ms", eng.drain()))
        th.start()
        _wait(lambda: eng.health()["draining"], what="drain flag")
        try:
            eng.submit(prompts[0], max_new=2)
            raise AssertionError("admission accepted during drain")
        except DrainingError as e:
            assert e.retry_after > 0, e
        th.join(timeout=120)
        drain_ms = result["ms"]
        for i, h in enumerate(handles):
            toks = h.result(timeout=1)       # drained = already done
            assert toks == ref[i], f"drained request {i} diverged"
        assert drain_ms <= 60_000, drain_ms
        assert eng.health()["status"] == "dead", eng.health()
        met = counters(eng)
        assert met["serving_drain_ms"] == drain_ms, met
        return (f"{len(handles)} in-flight requests finished to parity "
                f"under drain ({drain_ms:.0f} ms); late admission "
                "refused 503-class; engine dead after", met)
    finally:
        try:
            eng.close()
        except RuntimeError:
            pass
    return None


def scenario_flaky_dispatch(d: str, seed: int, vocab: int):
    prompts = seeded_prompts(3, seed + 4, vocab)
    ref = reference_run(d, prompts, max_new=6)
    # ONE one-shot rule: attempt 0 raises, the retry re-probes the same
    # spent rule and heals — the transient class
    faults.install(faults.parse_spec("engine.decode_step:step=2",
                                     seed=seed))
    try:
        eng = fresh_engine(d)
        try:
            handles = [eng.submit(p, max_new=6) for p in prompts]
            outs = [h.result(timeout=120) for h in handles]
            assert outs == ref, "transient retry changed greedy bytes"
            met = counters(eng)
            assert met["serving_redispatches_total"] == 1, met
            assert met["serving_requests_failed_total"] == 0, met
            return ("one-shot decode fault healed by a single "
                    "re-dispatch; all bytes to parity", met)
        finally:
            eng.close()
    finally:
        faults.install(None)


def scenario_watchdog_trip(d: str, seed: int, vocab: int):
    from ..serving_batch import \
        EngineStalledError
    eng = fresh_engine(d, stall_after_s=0.05)
    wedged, release = threading.Event(), threading.Event()
    orig = eng.sw.decode

    def wedge(feats):
        wedged.set()
        release.wait(timeout=60)
        return orig(feats)

    eng.sw.decode = wedge
    try:
        prompt = seeded_prompts(1, seed + 5, vocab)[0]
        h = eng.submit(prompt, max_new=4)
        assert wedged.wait(timeout=30), "decode never dispatched"
        assert eng.health()["status"] in ("live", "stalled")
        _wait(lambda: eng.health()["status"] == "stalled",
              what="watchdog flipping to stalled")
        age = eng.health()["heartbeat_age_s"]
        try:
            eng.close(timeout=0.2)
            raise AssertionError(
                "close() returned with the scheduler thread wedged")
        except EngineStalledError as e:
            assert "heartbeat" in str(e), e
        release.set()
        eng.close(timeout=30)               # parks clean once released
        assert eng.health()["status"] == "dead"
        try:
            h.result(timeout=1)
        except RuntimeError:
            pass                            # failed loudly by close()
        met = counters(eng)
        return (f"watchdog saw heartbeat_age {age:.2f}s > 0.05s; "
                "close() raised EngineStalledError while wedged; "
                "released engine parked clean", met)
    finally:
        release.set()
        try:
            eng.close()
        except RuntimeError:
            pass


def scenario_queue_full_retry(d: str, seed: int, vocab: int):
    from ..serving_batch import \
        QueueFullError
    n = 8
    prompts = seeded_prompts(n, seed + 6, vocab)
    ref = reference_run(d, prompts, max_new=4)
    eng = fresh_engine(d, max_queue=2)
    try:
        outs: list = [None] * n
        rejections = [0] * n                 # per-thread, no sharing

        def client(i):
            while True:
                try:
                    h = eng.submit(prompts[i], max_new=4)
                    break
                except QueueFullError as e:
                    rejections[i] += 1
                    time.sleep(min(e.retry_after, 0.02))
            outs[i] = h.result(timeout=120)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert outs == ref, "retried requests diverged from parity"
        assert sum(rejections) > 0, \
            "a 2-deep queue never refused an 8-request hammer"
        met = counters(eng)
        assert met["serving_requests_failed_total"] == 0, met
        return (f"{n} requests through a 2-deep queue with "
                f"{sum(rejections)} 429-class refusals, all to parity",
                met)
    finally:
        eng.close()


def scenario_spec_verify_fault(d: str, seed: int, vocab: int):
    """The decode-step fault seam fires DURING a speculative verify
    dispatch. Builds its own verify-step export (the shared scenario
    artifact carries none) over a repetitive workload so verify
    dispatches genuinely happen, locates the first one via a seeded
    instrumented run (everything is deterministic, so the same global
    dispatch index is a verify dispatch in every re-run), then asserts
    the re-dispatch protocol end to end on that exact dispatch. The
    faulted runs are held to the undisturbed spec-on run; that run is
    held to spec off exactly in f32 on the CPU, and by greedy token
    agreement on the card, where the verify step's wider products round
    differently in bf16."""
    from ..serving_batch import \
        PoisonedRequestError
    rs = np.random.RandomState(seed + 7)
    pattern = rs.randint(0, vocab, (3,)).astype(np.int32)
    prompts = [np.tile(pattern, 3)[:int(rs.randint(4, PROMPT_LEN + 1))]
               .astype(np.int32) for _ in range(3)]
    with tempfile.TemporaryDirectory() as ds:
        # max_new=10 (not the module MAX_NEW): the scenario's requests
        # cap at 10 tokens, and the smaller monolithic scan keeps this
        # tier-1 smoke's export cheap
        build_export(ds, prompt_len=PROMPT_LEN, max_new=10,
                     slots=SLOTS, seed=seed, paged=True,
                     block_size=BLOCK,
                     num_blocks=1 + 4 * SLOTS * _bps(), spec_tokens=4)

        def run(spec: int, wrap: bool = False):
            eng = fresh_engine(ds, spec_tokens=spec)
            order: list[str] = []
            if wrap:
                od, ov = eng.sw.decode, eng.sw.verify
                eng.sw.decode = \
                    lambda f: (order.append("decode"), od(f))[1]
                eng.sw.verify = \
                    lambda f: (order.append("verify"), ov(f))[1]
            try:
                free0 = eng.stats()["blocks_free"]
                handles = [eng.submit(p, max_new=10) for p in prompts]
                outs: list = []
                poisoned: list[str] = []
                for h in handles:
                    try:
                        outs.append(h.result(timeout=120))
                    except PoisonedRequestError:
                        outs.append(None)
                        poisoned.append(h.request_id)
                _wait(lambda: eng.stats()["blocks_free"] == free0,
                      what="exact blocks_free recovery")
                return outs, poisoned, counters(eng), eng.stats(), order
            finally:
                eng.close()

        ref, p0, _, _, _ = run(0)
        und, p1, _, s1, order = run(4, wrap=True)
        assert not p0 and not p1
        held = held_to(und, ref, SPEC_CARD_AGREEMENT,
                       "the undisturbed spec run against spec off")
        assert s1["spec_accepted"] > 0, s1
        assert "verify" in order, \
            "the repetitive workload never dispatched a verify step"
        v_idx = order.index("verify") + 1     # 1-based seam index
        # transient: one fault at exactly that verify dispatch — the
        # bounded re-dispatch heals it invisibly
        faults.install(faults.parse_spec(
            f"engine.decode_step:step={v_idx}", seed=seed))
        try:
            outs_t, pois_t, met_t, st_t, _ = run(4)
        finally:
            faults.install(None)
        assert not pois_t and outs_t == und, \
            "transient verify fault was not healed to byte parity"
        assert met_t["serving_redispatches_total"] == 1, met_t
        assert met_t["serving_requests_failed_total"] == 0, met_t
        assert st_t["verify_steps"] > 0, st_t
        # repeat failure at the SAME verify dispatch: newest-admitted
        # evicted, survivors byte-identical, per-row pos rewound
        # exactly (byte parity + the exact blocks_free recovery inside
        # run() are the rewind's observables)
        faults.install(faults.parse_spec(
            f"engine.decode_step:step={v_idx};"
            f"engine.decode_step:step={v_idx}", seed=seed))
        try:
            outs_p, pois_p, met_p, _, _ = run(4)
        finally:
            faults.install(None)
        assert len(pois_p) == 1, \
            f"expected exactly one eviction, got {pois_p}"
        survivors = [(i, o) for i, o in enumerate(outs_p)
                     if o is not None]
        assert all(o == und[i] for i, o in survivors), \
            "a survivor diverged after the verify-dispatch eviction"
        assert met_p["serving_requests_failed_total"] == 1, met_p
        assert met_p["serving_redispatches_total"] >= 2, met_p
    return (f"spec on vs off: {held}; verify dispatch {v_idx}: "
            f"transient healed to byte parity with the undisturbed spec "
            f"run (1 re-dispatch, 0 failures); repeat fault evicted "
            f"{pois_p[0]} with {len(survivors)} survivors to parity "
            "and exact pos/blocks recovery", met_p)


def scenario_overload_storm(d: str, seed: int, vocab: int):
    """The overload gate: ~2x sustainable offered load against a
    small admission queue. Every ADMITTED interactive request finishes
    within its (generous) deadline with zero client-visible failures
    and byte parity; once the pressure ladder leaves healthy,
    best_effort submissions are shed with 429-class ShedError carrying
    a measured Retry-After (never a timeout); the shed accounting is
    exact per class; and pressure returns to healthy with blocks_free
    recovered exactly once the storm drains."""
    from ..serving_batch import (
        QueueFullError, ShedError)
    prompts = seeded_prompts(3 * SLOTS, seed + 8, vocab)
    ref = reference_run(d, prompts, max_new=8)
    eng = fresh_engine(d, max_queue=3 * SLOTS)
    try:
        free0 = eng.stats()["blocks_free"]
        # the interactive base load: 3x the slot count, generous
        # deadlines — the class the ladder protects
        handles = [eng.submit(p, max_new=8, deadline_ms=120_000)
                   for p in prompts]
        _wait(lambda: eng._pressure_level >= 1,
              what="pressure ladder leaving healthy under backlog")
        shed = 0
        retry_afters = []
        probe = seeded_prompts(1, seed + 9, vocab)[0]
        probe_handles = []
        for _ in range(200):
            try:
                probe_handles.append(
                    eng.submit(probe, max_new=2,
                               priority="best_effort"))
            except ShedError as e:
                shed += 1
                retry_afters.append(e.retry_after)
                if shed >= 3:
                    break
            except QueueFullError:
                pass        # full below the ladder: plain pushback
            time.sleep(0.002)
        assert shed > 0, "the ladder never shed best_effort traffic"
        assert all(ra >= 0.0 for ra in retry_afters), retry_afters
        for i, h in enumerate(handles):
            toks = h.result(timeout=120)
            assert toks == ref[i], \
                f"interactive request {i} diverged under overload"
        for h in probe_handles:     # admitted below the ladder: fine
            try:
                h.result(timeout=120)
            except ShedError:
                # admitted at healthy, then swept by a later
                # interactive_only rung while still queued — the same
                # 429-class outcome, counted in the same ledger
                shed += 1
        _wait(lambda: eng.stats()["blocks_free"] == free0,
              what="exact blocks_free recovery")
        _wait(lambda: eng.stats()["pressure"] == "healthy",
              what="pressure returning to healthy after the storm")
        met = counters(eng)
        st = eng.stats()
        assert met["serving_shed_total"] == shed, (met, shed)
        assert st["shed_best_effort"] == shed, st
        assert met["serving_deadline_expired_total"] == 0, met
        assert met["serving_requests_failed_total"] == 0, met
        assert met["serving_pressure_transitions_total"] >= 2, met
        return (f"{len(handles)} interactive requests to byte parity "
                f"with zero failures under 2x load; {shed} "
                f"best_effort shed 429-class with measured "
                f"Retry-After; pressure healthy again, blocks "
                f"recovered to {free0}", met)
    finally:
        eng.close()


def scenario_long_prompt_storm(d_unused: str, seed: int,
                               vocab_unused: int):
    """The chunked-prefill gate: a live short decoder keeps
    decoding WHILE a wave of full-length prompts admits chunk by chunk
    — the dispatch order proves decode steps interleave between a
    single prompt's chunks (impossible with the monolithic prefill),
    greedy bytes stay byte-identical to the chunk-off engine over the
    same export (on the CPU; on the card, where the monolithic prefill
    is the flash kernel and a chunk the plain attention, the long rows
    agree on ``CHUNK_CARD_AGREEMENT`` of their tokens), the chunk
    accounting is exact, and blocks_free recovers."""
    rs = np.random.RandomState(seed + 10)
    with tempfile.TemporaryDirectory() as ds:
        # its own export: the shared scenario artifact carries no
        # chunk program; 16-token prompts over 4-token blocks = 4
        # chunks per long admission
        pl = 16
        vocab = build_export(ds, prompt_len=pl, max_new=MAX_NEW,
                             slots=SLOTS, seed=seed, paged=True,
                             block_size=BLOCK, prefill_chunk=BLOCK,
                             num_blocks=1 + 4 * SLOTS
                             * -(-(pl + MAX_NEW) // BLOCK))
        long_prompts = [rs.randint(0, vocab, (pl,)).astype(np.int32)
                        for _ in range(2)]
        short = rs.randint(0, vocab, (3,)).astype(np.int32)

        def run(chunk, wrap=False):
            eng = fresh_engine(ds, prefill_chunk_tokens=chunk)
            order: list[str] = []
            if wrap:
                od, oc = eng.sw.decode, eng.sw.prefill_chunk
                eng.sw.decode = \
                    lambda f: (order.append("decode"), od(f))[1]
                eng.sw.prefill_chunk = \
                    lambda f: (order.append("chunk"), oc(f))[1]
            try:
                free0 = eng.stats()["blocks_free"]
                h0 = eng.submit(short, max_new=MAX_NEW)
                _wait(lambda: eng.stats()["live_slots"] >= 1,
                      what="the short decoder going live")
                hs = [eng.submit(p, max_new=4) for p in long_prompts]
                outs = [h.result(timeout=120) for h in [h0, *hs]]
                _wait(lambda: eng.stats()["blocks_free"] == free0,
                      what="exact blocks_free recovery")
                return outs, counters(eng), order
            finally:
                eng.close()

        ref, met0, _ = run(0)
        outs, met1, order = run(BLOCK, wrap=True)
    # on the CPU every row byte-equal; the card's agreement is read over
    # the long rows, the ones admitted in several chunks
    held = held_to(outs[1:], ref[1:], CHUNK_CARD_AGREEMENT,
                   "chunked long prompts against the monolithic prefill")
    if _RUN["device"] == "cpu":
        assert outs[0] == ref[0], "the short decoder diverged"
    assert met0["serving_prefill_chunks_total"] == 0, met0
    # short prompt: 1 chunk; each long prompt: pl/BLOCK chunks
    want = 1 + 2 * (pl // BLOCK)
    assert met1["serving_prefill_chunks_total"] == want, (met1, want)
    first, last = order.index("chunk"), len(order) - 1 - \
        order[::-1].index("chunk")
    interleaved = "decode" in order[first:last]
    assert interleaved, \
        f"no decode step ever ran between prefill chunks: {order}"
    assert met1["serving_requests_failed_total"] == 0, met1
    return (f"long rows vs chunk-off: {held}; {want} chunk dispatches "
            f"interleaved with shared decode steps (order window "
            f"{order[first:last + 1][:12]}...), blocks recovered", met1)


SCENARIOS = {
    "deadline_storm": scenario_deadline_storm,
    "poison_step": scenario_poison_step,
    "blocks_cancel": scenario_blocks_cancel,
    "drain_under_load": scenario_drain_under_load,
    "flaky_dispatch": scenario_flaky_dispatch,
    "watchdog_trip": scenario_watchdog_trip,
    "queue_full_retry": scenario_queue_full_retry,
    "spec_verify_fault": scenario_spec_verify_fault,
    "overload_storm": scenario_overload_storm,
    "long_prompt_storm": scenario_long_prompt_storm,
}

#: scenarios that need the deliberately under-provisioned block pool
TIGHT_POOL = {"blocks_cancel"}


#: the tight-pool export's block count: 2 full-depth slots' worth
#: MINUS two blocks, so even after one of the exhaustion scenario's
#: three requests is cancelled the remaining two cannot BOTH reach
#: full depth — mid-decode exhaustion is guaranteed, not
#: timing-dependent
def tight_pool_blocks() -> int:
    return 1 + 2 * _bps() - 2


def run_scenarios(names, *, seed: int, export_dir: str | None = None,
                  tight_dir: str | None = None, vocab: int | None = None,
                  device=None, kv_cache_dtype: str | None = None
                  ) -> list[dict]:
    """Build the shared exports (unless the caller passes pre-built
    ones, made with the same ``device`` and ``kv_cache_dtype``), run
    ``names`` against them on ``device`` (the card by default), and
    return one result dict per scenario (the test harness entry)."""
    from ..runtime.device import resolve_device
    _RUN.update(device=str(resolve_device(device)),
                kv_cache_dtype=kv_cache_dtype)
    results = []
    with tempfile.TemporaryDirectory() as scratch:
        d, d_tight = export_dir, tight_dir
        if d is None and any(n not in TIGHT_POOL for n in names):
            d = os.path.join(scratch, "ample")
            vocab = build_chaos_export(d, seed=seed)
        if d_tight is None and any(n in TIGHT_POOL for n in names):
            d_tight = os.path.join(scratch, "tight")
            v = build_chaos_export(d_tight, seed=seed,
                                   num_blocks=tight_pool_blocks())
            vocab = vocab if vocab is not None else v
        assert vocab is not None, \
            "pass vocab= alongside pre-built export dirs"
        for name in names:
            export = d_tight if name in TIGHT_POOL else d
            try:
                detail, met = SCENARIOS[name](export, seed, vocab)
                results.append({"scenario": name, "ok": True,
                                "detail": detail, "metrics": met})
            except Exception as e:   # a failed invariant is the signal
                results.append({"scenario": name, "ok": False,
                                "detail": f"{type(e).__name__}: {e}",
                                "metrics": {}})
            finally:
                faults.install(None)   # never leak a registry forward
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="all",
                    help="comma-separated scenario names, or 'all': "
                         + ", ".join(SCENARIOS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's flag (the scenarios are "
                    "already tiny; --smoke changes nothing today)")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default cuda; cpu "
                    "runs without a GPU)")
    ap.add_argument("--kv_cache_dtype", choices=("auto", "int8"),
                    default="auto",
                    help="the exports' KV pool dtype: auto (the model's) "
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
                      "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
