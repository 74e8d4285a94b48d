"""The port's continuous-batching engine (``serving_batch.py`` over the
stepwise export) against the JAX package's engine, on bridged GPT-tiny
weights, f32, on the CPU.

The reference engine serves the reference's stepwise StableHLO export;
the port's engine serves the port's export of the same weights. Greedy
tokens must be EQUAL: to the reference engine's for the same requests,
and to the port's own single-request ``generate``. Around that, mirrors
of the reference's engine tests (``tests/test_serving_batch.py``,
``tests/test_paged_serving.py``) on the port: the shared-dispatch
invariant, slot reuse, EOS retirement, per-seed sampling, prefix reuse
with zero prefill dispatches, copy-on-write, block exhaustion and
pressure, the allocator units, and the HTTP layer (``:generate`` parity
with ``scheduler="off"``, 429 on a full queue, ``/stats``). The spec and
chunked-prefill paths are held in ``tests/test_torch_spec.py`` and
``tests/test_torch_slo.py``.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import serving as jserving
from distributed_tensorflow_example_tpu import serving_batch as jbatch
from distributed_tensorflow_example_tpu.ckpt.checkpoint import _flatten
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu_torch.models.gpt import (
    GPT, GPTConfig, params_from_numpy)
from distributed_tensorflow_example_tpu_torch.obs import trace
from distributed_tensorflow_example_tpu_torch.runtime import faults
from distributed_tensorflow_example_tpu_torch.serving import (
    export_generator, has_stepwise, load_stepwise)
from distributed_tensorflow_example_tpu_torch.serving_batch import (
    BlockPool, BlocksExhaustedError, GenerationEngine, PrefixCache,
    QueueFullError, RetryAfterEstimator, filter_logits_np, percentile)
from distributed_tensorflow_example_tpu_torch.serving_http import \
    PredictServer

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


PROMPT_LEN = 8
MAX_NEW = 5
SLOTS = 4
BLOCK = 4
KINDS = ("slab", "paged")


@pytest.fixture(scope="module")
def pair():
    jm = JGPT(JGPTConfig.tiny())
    jp = jm.init(jax.random.key(0))
    tm = GPT(GPTConfig.tiny())
    tp = params_from_numpy(tm, _flatten(jp), device="cpu")
    return jm, jp, tm, tp


def _export_kw(kind, **kw):
    base = dict(prompt_len=PROMPT_LEN, max_new_tokens=MAX_NEW, batch_size=1,
                ragged=True, stepwise=True, slots=SLOTS)
    if kind == "paged":
        base.update(paged=True, block_size=BLOCK, num_blocks=48)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def dirs(pair, tmp_path_factory):
    """The port's slab and paged exports (48 blocks: prefix entries are
    never evicted mid-test)."""
    _, _, tm, tp = pair
    out = {}
    for kind in KINDS:
        d = str(tmp_path_factory.mktemp(kind))
        export_generator(tm, tp, d, **_export_kw(kind))
        out[kind] = d
    return out


def _prompts(n, seed=0, lo=1, hi=PROMPT_LEN):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 1000, (int(rs.randint(lo, hi + 1)),)
                       ).astype(np.int32) for _ in range(n)]


def _oracle(tm, tp, prompt, max_new=MAX_NEW, **kw):
    """The port's single-request path: a ragged ``generate``."""
    ids = np.zeros((1, PROMPT_LEN), np.int32)
    mask = np.zeros((1, PROMPT_LEN), np.int32)
    ids[0, :prompt.size] = prompt
    mask[0, :prompt.size] = 1
    return tm.generate(tp, torch.from_numpy(ids), max_new,
                       prompt_mask=torch.from_numpy(mask),
                       **kw)[0].tolist()


def _engine(d, **kw):
    return GenerationEngine(load_stepwise(d, device="cpu"), **kw)


def _run(eng, prompts, **kw):
    """Queue every request BEFORE start (one deterministic admission
    wave), run them, close."""
    futs = [eng.submit(p, **kw) for p in prompts]
    eng.start()
    try:
        return [f.result(timeout=120) for f in futs]
    finally:
        eng.close()


def _drain(eng):
    """Drive the engine synchronously (no scheduler thread): admission +
    shared steps until idle, in a deterministic order."""
    for _ in range(10_000):
        eng._admit()
        if not eng._live:
            if not eng._queue:
                return
            continue
        eng._shared_step()
    raise AssertionError("engine did not drain")


@pytest.fixture(scope="module")
def reference_greedy(pair, tmp_path_factory):
    """The reference engine's greedy tokens for 8 concurrent ragged
    requests, over its own slab and paged stepwise exports."""
    jm, jp, _, _ = pair
    prompts = _prompts(2 * SLOTS, seed=10)
    out = {}
    for kind in KINDS:
        d = str(tmp_path_factory.mktemp(f"ref_{kind}"))
        jserving.export_generator(jm, jp, d, platforms=("cpu",),
                                  **_export_kw(kind))
        eng = jbatch.GenerationEngine(jserving.load_stepwise(d))
        out[kind] = _run(eng, prompts)
    return prompts, out


# ---------------------------------------------------------------------------
# greedy parity and the shared-step invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_cold_greedy_parity_with_reference_engine(pair, dirs,
                                                  reference_greedy, kind):
    """8 concurrent ragged requests (two admission waves over 4 slots):
    the port's engine returns exactly the reference engine's greedy
    tokens, and the port's single-request generate's."""
    _, _, tm, tp = pair
    prompts, ref = reference_greedy
    eng = _engine(dirs[kind])
    assert eng.paged == (kind == "paged")
    got = _run(eng, prompts)
    assert got == ref[kind]
    assert got == [_oracle(tm, tp, p) for p in prompts]
    assert eng.prefills == len(prompts)


@pytest.mark.parametrize("kind", KINDS)
def test_shared_dispatch_invariant(pair, dirs, kind):
    """K <= slots requests pre-loaded into the queue share decode steps:
    exactly max_new - 1 dispatches in all."""
    _, _, tm, tp = pair
    prompts = _prompts(SLOTS, seed=1)
    eng = _engine(dirs[kind])
    got = _run(eng, prompts)
    assert eng.prefills == SLOTS
    assert eng.decode_steps == MAX_NEW - 1
    assert eng.decode_slot_steps == SLOTS * (MAX_NEW - 1)
    assert got == [_oracle(tm, tp, p) for p in prompts]


@pytest.mark.parametrize("kind", KINDS)
def test_slot_reuse_after_retirement(pair, dirs, kind):
    _, _, tm, tp = pair
    n = SLOTS * 2 + 2
    prompts = _prompts(n, seed=2)
    rs = np.random.RandomState(3)
    max_news = [int(rs.randint(1, MAX_NEW + 1)) for _ in range(n)]
    eng = _engine(dirs[kind])
    futs = [eng.submit(p, max_new=mn) for p, mn in zip(prompts, max_news)]
    eng.start()
    try:
        got = [f.result(timeout=120) for f in futs]
    finally:
        eng.close()
    assert eng.requests_done == n
    assert eng.decode_steps < sum(max(mn - 1, 0) for mn in max_news)
    for p, mn, g in zip(prompts, max_news, got):
        assert g == _oracle(tm, tp, p, max_new=mn)


@pytest.mark.parametrize("kind", KINDS)
def test_eos_retires_mid_batch(pair, dirs, kind):
    _, _, tm, tp = pair
    prompts = _prompts(SLOTS, seed=4)
    eos_ids = [_oracle(tm, tp, p)[1] for p in prompts]
    eng = _engine(dirs[kind])
    futs = [eng.submit(p, eos_id=e) for p, e in zip(prompts, eos_ids)]
    eng.start()
    try:
        got = [f.result(timeout=120) for f in futs]
    finally:
        eng.close()
    for p, e, g in zip(prompts, eos_ids, got):
        assert g == _oracle(tm, tp, p, eos_id=e)
        assert len(g) == MAX_NEW                  # padded after EOS


def test_sampled_determinism_per_seed(dirs):
    """Per-request seeds make the sampled stream deterministic, whatever
    shares the batch (the host's Philox stream per request)."""
    prompt = _prompts(1, seed=5)[0]

    def run(seed, extra_load=0):
        eng = _engine(dirs["paged"])
        futs = [eng.submit(prompt, temperature=1.0, top_p=0.9, seed=seed)]
        futs += [eng.submit(p, seed=0) for p in _prompts(extra_load, seed=6)]
        eng.start()
        try:
            return [f.result(timeout=120) for f in futs][0]
        finally:
            eng.close()

    a, b, c = run(7), run(7, extra_load=2), run(8)
    assert a == b and a != c


# ---------------------------------------------------------------------------
# paged pool: prefix reuse, copy-on-write, exhaustion, pressure
# ---------------------------------------------------------------------------

def test_exact_prefix_hit_skips_prefill_and_keeps_parity(pair, dirs):
    _, _, tm, tp = pair
    prompts = _prompts(4, seed=11)
    eng = _engine(dirs["paged"])
    futs = [eng.submit(p) for p in prompts]
    eng.start()
    try:
        first = [f.result(timeout=120) for f in futs]
        pre = eng.prefills
        second = [eng.submit(p).result(timeout=120) for p in prompts]
    finally:
        eng.close()
    assert eng.prefills == pre, "repeat prompts must not prefill"
    for p, a, b in zip(prompts, first, second):
        assert a == b == _oracle(tm, tp, p)
    s = eng.stats()
    assert s["prefix_cache_hits"] >= 4 and s["prefill_tokens_saved"] > 0


def test_divergent_suffix_reuses_prefix_blocks(pair, dirs):
    _, _, tm, tp = pair
    rs = np.random.RandomState(12)
    sysp = rs.randint(0, 1000, (BLOCK,)).astype(np.int32)
    prompts = [np.concatenate([sysp, rs.randint(0, 1000, (k,)).astype(
        np.int32)]) for k in (1, 2, 3)]
    eng = _engine(dirs["paged"])
    eng.start()
    try:
        first = eng.submit(prompts[0]).result(timeout=120)
        pre = eng.prefills
        rest = [eng.submit(p).result(timeout=120) for p in prompts[1:]]
    finally:
        eng.close()
    assert eng.prefills == pre, "prefix hits must not prefill"
    for p, g in zip(prompts, [first] + rest):
        assert g == _oracle(tm, tp, p)


def test_partial_hit_prompt_gets_cached_for_exact_repeat(pair, dirs):
    _, _, tm, tp = pair
    rs = np.random.RandomState(22)
    sysp = rs.randint(0, 1000, (BLOCK,)).astype(np.int32)
    p1 = np.concatenate([sysp, rs.randint(0, 1000, (2,)).astype(np.int32)])
    p2 = np.concatenate([sysp, rs.randint(0, 1000, (3,)).astype(np.int32)])
    eng = _engine(dirs["paged"])
    eng.submit(p1)
    _drain(eng)
    f2 = eng.submit(p2)                      # partial hit on sysp
    _drain(eng)
    saved = eng.prefill_tokens_saved
    f3 = eng.submit(p2)                      # must now EXACT-hit
    _drain(eng)
    assert eng.prefill_tokens_saved - saved == p2.size - 1
    want = _oracle(tm, tp, p2)
    assert f2.result(timeout=5) == want and f3.result(timeout=5) == want
    eng.close()


def test_cow_on_divergence_protects_cached_blocks(pair, dirs):
    _, _, tm, tp = pair
    prompt = _prompts(1, seed=13, lo=5, hi=7)[0]
    assert prompt.size % BLOCK
    eng = _engine(dirs["paged"])
    f1 = eng.submit(prompt)
    _drain(eng)
    cow0 = eng.cow_copies
    f2 = eng.submit(prompt)
    _drain(eng)
    assert eng.cow_copies > cow0
    f3 = eng.submit(prompt)
    _drain(eng)
    want = _oracle(tm, tp, prompt)
    for f in (f1, f2, f3):
        assert f.result(timeout=5) == want
    eng.close()


def test_block_copy_is_in_place_on_every_layer(dirs):
    eng = _engine(dirs["paged"])
    pool = eng._pool
    for v in pool.values():
        v[:, 3] = torch.randn_like(v[:, 3])
    same = {k: v for k, v in pool.items()}
    out = eng._copy_block(pool, 3, 7)
    for k, v in out.items():
        assert v is same[k]
        assert torch.equal(v[:, 7], v[:, 3])
    eng.close()


def test_block_exhaustion_fails_one_request_loudly(pair, tmp_path):
    _, _, tm, tp = pair
    d = str(tmp_path / "tight")
    export_generator(tm, tp, d, **_export_kw(
        "paged", max_new_tokens=8, slots=2, num_blocks=6))   # 5 usable
    eng = _engine(d, prefix_cache=False)
    pa, pb = _prompts(2, seed=14, lo=4, hi=4)
    fa = eng.submit(pa, max_new=8)
    fb = eng.submit(pb, max_new=8)
    _drain(eng)
    assert fa.result(timeout=5) == _oracle(tm, tp, pa, max_new=8)
    with pytest.raises(BlocksExhaustedError, match="mid-decode"):
        fb.result(timeout=5)
    fc = eng.submit(pa, max_new=1)          # the engine still serves
    _drain(eng)
    assert fc.result(timeout=5) == _oracle(tm, tp, pa, max_new=1)
    eng.close()


def test_block_pressure_defers_admission_until_retirement(pair, tmp_path):
    _, _, tm, tp = pair
    d = str(tmp_path / "tiny_pool")
    export_generator(tm, tp, d, **_export_kw(
        "paged", max_new_tokens=2, slots=2, num_blocks=4))   # 3 usable
    eng = _engine(d, prefix_cache=False)
    big = _prompts(1, seed=15, lo=PROMPT_LEN, hi=PROMPT_LEN)[0]
    f1 = eng.submit(big, max_new=2)
    f2 = eng.submit(big, max_new=2)         # waits for f1's blocks
    eng._admit()
    assert len(eng._live) == 1 and len(eng._queue) == 1
    _drain(eng)
    assert f1.result(timeout=5) == f2.result(timeout=5) \
        == _oracle(tm, tp, big, max_new=2)
    eng.close()


def test_paged_stats_and_last_release(pair, dirs):
    """Block-level /stats, and a block shared by the prefix cache and two
    mounted slots frees only at its last release."""
    _, _, tm, tp = pair
    rs = np.random.RandomState(19)
    sysp = rs.randint(0, 1000, (BLOCK,)).astype(np.int32)
    eng = _engine(dirs["paged"])
    eng.submit(sysp, max_new=1)
    _drain(eng)
    s = eng.stats()
    assert s["paged"] is True and s["blocks_total"] == 47
    assert s["bytes_resident"] == (s["blocks_total"] - s["blocks_free"]) \
        * eng._block_bytes
    blk = next(b[0] for b, n in eng.prefix_cache._entries.values()
               if n == BLOCK)
    a = np.concatenate([sysp, rs.randint(0, 1000, (1,)).astype(np.int32)])
    b = np.concatenate([sysp, rs.randint(0, 1000, (2,)).astype(np.int32)])
    fa, fb = eng.submit(a), eng.submit(b)
    eng._admit()
    assert eng.blocks.refcount(blk) == 3
    eng.prefix_cache.evict(10 ** 9)
    assert eng.blocks.refcount(blk) == 2
    _drain(eng)
    eng.prefix_cache.evict(10 ** 9)
    assert eng.blocks.refcount(blk) == 0
    assert eng.blocks.free_count == eng.blocks.usable
    assert fa.result(timeout=5) == _oracle(tm, tp, a)
    assert fb.result(timeout=5) == _oracle(tm, tp, b)
    eng.close()


def test_bf16_export_serves_on_bf16_pools(pair, tmp_path):
    """The card's configuration: bf16 compute, so bf16 pools (a dtype
    numpy does not name), sized and reported as such."""
    _, jp, _, _ = pair
    tm = GPT(GPTConfig.tiny(), dtype=torch.bfloat16)
    tp = params_from_numpy(tm, _flatten(jp), device="cpu")
    d = str(tmp_path / "bf16")
    export_generator(tm, tp, d, **_export_kw("paged"))
    eng = _engine(d)
    assert all(v.dtype == torch.bfloat16 for v in eng._pool.values())
    c = tm.cfg
    assert eng._block_bytes == 2 * c.layers * BLOCK * c.hidden * 2
    got = _run(eng, _prompts(SLOTS, seed=23))
    assert eng.stats()["kv_cache_dtype"] == "bfloat16"
    assert all(len(g) == MAX_NEW and 0 <= min(g) and max(g) < c.vocab_size
               for g in got)
    assert got == _run(_engine(d), _prompts(SLOTS, seed=23))


# ---------------------------------------------------------------------------
# host-side units (the port's copies)
# ---------------------------------------------------------------------------

def test_block_pool_refcount_exhaustion_and_fragmentation():
    bp = BlockPool(6)                       # 5 usable + null
    run = bp.alloc(3)
    assert len(set(run)) == 3 and 0 not in run and bp.free_count == 2
    bp.retain(run[:1])
    bp.release(run)
    assert bp.free_count == 4 and bp.refcount(run[0]) == 1
    bp.release(run[:1])
    assert bp.free_count == 5
    with pytest.raises(BlocksExhaustedError):
        bp.alloc(6)
    assert bp.free_count == 5               # all-or-nothing
    with pytest.raises(AssertionError, match="double release"):
        bp.release(run[:1])
    bp = BlockPool(9)
    run = bp.alloc(8)
    bp.release(run[1::2])
    assert sorted(bp.alloc(4)) == sorted(run[1::2])


def test_prefix_cache_longest_match_and_lru_eviction():
    bp = BlockPool(10)
    pc = PrefixCache(bp, block_size=4)
    toks = np.arange(100, 110, dtype=np.int32)
    run = bp.alloc(3)
    pc.insert(toks, run)
    assert len(pc) == 3
    n, blocks = pc.lookup(toks)
    assert n == 10 and list(blocks) == run
    n, blocks = pc.lookup(np.concatenate([toks[:7], [999]]).astype(np.int32))
    assert n == 4 and list(blocks) == run[:1]
    assert pc.lookup(np.array([1, 2, 3], np.int32))[0] == 0
    assert pc.hits == 2 and pc.misses == 1
    pc.lookup(toks, record=False)
    assert pc.hits == 2
    bp.release(run)
    assert bp.free_count == 6
    pc.evict(9)
    assert bp.free_count == 9 and len(pc) == 0


def test_retry_after_estimator_percentile_and_filter():
    est = RetryAfterEstimator(alpha=0.5)
    assert est.estimate(10) == 1.0
    for x in (0.10, 0.20, 0.05):
        est.observe(x)
    assert est.ema_step_s == pytest.approx(0.10)
    assert est.estimate(4, queue_ahead=8, slots=4) == pytest.approx(1.2)
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0 and percentile([], 99) == 0
    row = np.array([1.0, 3.0, 2.0, 3.0], np.float32)
    kept = np.isfinite(filter_logits_np(row, 2, 0.0))
    assert kept.tolist() == [False, True, False, True]     # tie survives


# ---------------------------------------------------------------------------
# engine lifecycle and refusals
# ---------------------------------------------------------------------------

def test_engine_close_fails_pending_and_refuses_later_slices(dirs):
    eng = _engine(dirs["slab"])
    fut = eng.submit(_prompts(1, seed=9)[0])
    eng.close()
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(timeout=5)
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit(_prompts(1, seed=9)[0])
    # speculation and chunked prefill are served since their slice
    # landed (tests/test_torch_spec.py, test_torch_slo.py): over an export
    # without the verify or chunk step the engine refuses them, naming
    # the re-export, as the reference's engine does
    for kw, frag in ((dict(spec_tokens=2), "no verify"),
                     (dict(prefill_chunk_tokens=BLOCK), "prefill_chunk")):
        with pytest.raises(ValueError, match=frag):
            _engine(dirs["paged"], **kw)


def test_queue_full_raises(dirs):
    eng = _engine(dirs["slab"], max_queue=3)
    p = _prompts(1, seed=7)[0]
    eng.submit(p)
    eng.submit(p)
    with pytest.raises(QueueFullError):
        eng.submit_many([p, p])             # atomic: neither queued
    assert len(eng._queue) == 2
    eng.submit(p)
    with pytest.raises(QueueFullError) as e:
        eng.submit(p)
    assert e.value.retry_after >= 1.0
    eng.start()
    eng.close()


def test_decode_fault_heals_by_redispatch_and_spans_record(pair, dirs):
    """The engine's fault seams and trace spans (the port's copies of
    ``runtime/faults.py`` and ``obs/trace.py``): a one-shot decode fault
    is retried once with unchanged greedy tokens, and an armed recorder
    holds the slot lanes' spans."""
    _, _, tm, tp = pair
    prompts = _prompts(SLOTS, seed=24)
    rec = trace.recorder()
    rec.start()
    faults.install(faults.parse_spec("engine.decode_step:step=2"))
    try:
        eng = _engine(dirs["paged"])
        got = _run(eng, prompts)
    finally:
        faults.install(None)
        rec.stop()
    assert got == [_oracle(tm, tp, p) for p in prompts]
    assert eng.stats()["redispatches"] == 1
    names = {s[2] for s in rec.drain("serving")}
    assert {"queue_wait", "prefill", "decode_step", "decode",
            "retire"} <= names


@pytest.mark.parametrize("spec,match", [
    ("router.nope:step=1", "unknown fault site"),
    ("engine.prefill", "exactly one trigger"),
    ("engine.prefill:step=0", "1-based"),
    ("engine.prefill:p=2", r"\(0, 1\]"),
    ("engine.prefill:step=1:raise=KeyError", "allowed"),
    ("engine.prefill:when=1", "unknown field"),
    ("", "no rules"),
])
def test_fault_spec_grammar_is_loud(spec, match):
    with pytest.raises(faults.FaultSpecError, match=match):
        faults.parse_spec(spec)


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def _post(port, name, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("kind", KINDS)
def test_http_concurrent_greedy_parity_and_stats(dirs, kind):
    """8 concurrent :generate requests through the engine equal the
    scheduler-off path of the same export; /stats shows the shared
    steps, /healthz the engine's watchdog."""
    d = dirs[kind]
    assert has_stepwise(d)
    n = 8
    prompts = _prompts(n, seed=8)
    results: list = [None] * n
    with PredictServer(d, device="cpu") as srv:
        assert srv.scheduler == "on" and srv.engine.paged == (kind == "paged")

        def worker(i):
            body = _post(srv.port, srv.name,
                         {"inputs": {"input_ids": [prompts[i].tolist()]}})
            results[i] = body["generations"][0]
            assert len(body["request_ids"]) == 1 and body["timings"][0]

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        status, stats = _get(srv.port, "/stats")
        _, health = _get(srv.port, "/healthz")
    stats = stats["generate"]
    assert stats["requests_done"] == n and stats["prefills"] <= n
    assert stats["decode_steps"] < n * (MAX_NEW - 1)
    assert stats["steps_shared"] > 1.0
    assert health["status"] == "live" and health["scheduler"] == "on"
    assert stats.get("paged", False) == (kind == "paged")
    with PredictServer(d, device="cpu", scheduler="off") as srv:
        assert srv.engine is None
        for i, p in enumerate(prompts):
            ids = np.zeros((PROMPT_LEN,), np.int32)
            mask = np.zeros((PROMPT_LEN,), np.int32)
            ids[:p.size], mask[:p.size] = p, 1
            want = _post(srv.port, srv.name,
                         {"inputs": {"input_ids": [ids.tolist()],
                                     "prompt_mask": [mask.tolist()]}}
                         )["generations"][0]
            assert results[i] == want, f"request {i} diverged"


def test_http_429_and_validation(dirs):
    p = _prompts(1, seed=7)[0]
    with PredictServer(dirs["paged"], device="cpu") as srv:

        def full(*a, **k):
            raise QueueFullError("admission queue full", retry_after=3.0)

        srv.engine.submit_many = full
        with pytest.raises(urllib.error.HTTPError) as he:
            _post(srv.port, srv.name, {"inputs": {"input_ids": [p.tolist()]}})
        assert he.value.code == 429
        assert he.value.headers["Retry-After"] == "3"
        assert "queue full" in json.loads(he.value.read())["error"]
    with PredictServer(dirs["paged"], device="cpu") as srv:
        for payload, match in [
            ({"inputs": {"input_ids": [list(range(PROMPT_LEN + 3))]}},
             "prompt capacity"),
            ({"inputs": {"input_ids": [[1, 2]]}, "max_new": MAX_NEW + 1},
             "max_new"),
            ({"inputs": {"input_ids": [[1, 2]], "bogus": [[1]]}},
             "unknown"),
            # a spec-off engine refuses a request's spec width > 0
            ({"inputs": {"input_ids": [[1, 2]]}, "spec_tokens": 2},
             "speculative decoding is off"),
            # deadline_ms is served; the engine refuses a negative one
            ({"inputs": {"input_ids": [[1, 2]]}, "deadline_ms": -5},
             "deadline_ms"),
            ({"inputs": {"input_ids": [[1, 2]],
                         "prompt_mask": [[0, 0]]}}, "real token"),
        ]:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.port, srv.name, payload)
            assert e.value.code == 400
            assert match in json.loads(e.value.read())["error"]
