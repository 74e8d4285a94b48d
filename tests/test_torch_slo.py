"""Chunked prefill and the SLO knobs on the port: ``GPT.paged_prefill_chunk``
against the JAX package's, and the port's engine and HTTP server with
``prefill_chunk_tokens``, priorities, deadlines and shedding (mirrors of
the reference's ``tests/test_serving_slo.py`` but its router test, which
belongs to the fleet slice), on bridged GPT-tiny weights, f32, on the
CPU.

The chunk step is held to the reference's function (logits 1e-4, written
K/V 1e-5: f32, summation order only) and to the port's own monolithic
``paged_prefill``, bit for bit. The engine is held to its own
unchunked output: greedy tokens EQUAL on a float pool; an int8 pool
re-reads prior chunks dequantized and rides the drift gate.
"""

import json
import logging
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ckpt.checkpoint import _flatten
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu_torch.models.gpt import (
    GPT, GPTConfig, params_from_numpy)
from distributed_tensorflow_example_tpu_torch.serving import (
    export_generator, load_stepwise)
from distributed_tensorflow_example_tpu_torch.serving_batch import (
    PRESSURE_STATES, PRIORITIES, GenerationEngine, GenRequest,
    RequestCancelledError, RetryAfterEstimator, ShedError,
    compute_pressure_level, select_index)
from distributed_tensorflow_example_tpu_torch.serving_http import \
    PredictServer

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
PROMPT_LEN = 12
MAX_NEW = 8
SLOTS = 3
BLOCK = 4
#: the int8 drift gate (the reference's ``serving_load.INT8_MIN_AGREEMENT``)
INT8_MIN_AGREEMENT = 0.75
WAIT_S = 120                        # every engine and HTTP wait's bound


@pytest.fixture(scope="module")
def pair():
    jm = JGPT(JGPTConfig.tiny())
    jp = jm.init(jax.random.key(0))
    tm = GPT(GPTConfig.tiny())
    tp = params_from_numpy(tm, _flatten(jp), device="cpu")
    return jm, jp, tm, tp


def _export(tm, tp, d, **kw):
    base = dict(prompt_len=PROMPT_LEN, max_new_tokens=MAX_NEW, batch_size=1,
                ragged=True, stepwise=True, slots=SLOTS, paged=True,
                block_size=BLOCK)
    base.update(kw)
    export_generator(tm, tp, d, **base)
    return d


@pytest.fixture(scope="module")
def chunk_dir(pair, tmp_path_factory):
    _, _, tm, tp = pair
    return _export(tm, tp, str(tmp_path_factory.mktemp("slo")),
                   prefill_chunk=BLOCK)


def _prompts(n, seed=0, lo=1, hi=PROMPT_LEN):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 1000, (int(rs.randint(lo, hi + 1)),))
            .astype(np.int32) for _ in range(n)]


def _run_engine(d, prompts, *, max_new=6, chunk=0, **kw):
    eng = GenerationEngine(load_stepwise(d, device="cpu"),
                           prefill_chunk_tokens=chunk, **kw).start()
    try:
        handles = [eng.submit(p, max_new=max_new) for p in prompts]
        outs = [h.result(timeout=WAIT_S) for h in handles]
        return outs, eng.stats()
    finally:
        eng.close()


def _wait(pred, timeout=30.0, what="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {what}")


def _agreement(a, b):
    pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return sum(x == y for x, y in pairs) / max(1, len(pairs))


# ---------------------------------------------------------------------------
# the chunk step against the reference's and the monolithic prefill
# ---------------------------------------------------------------------------

P, C = 11, 8                        # prompt tokens, chunk width
TABLE = np.array([5, 2, 7], np.int32)          # the slot's 3 blocks
N_BLOCKS = 9


def _pools(tm, quant, seed=4):
    c = tm.cfg
    rs = np.random.RandomState(seed)
    shape = (c.layers, N_BLOCKS, BLOCK, c.heads, tm.head_dim)
    if not quant:
        return {n: rs.randn(*shape).astype(np.float32) for n in ("k", "v")}
    out = {n: rs.randint(-127, 128, shape).astype(np.int8)
           for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        out[n] = rs.uniform(0.005, 0.02, shape[:3]).astype(np.float32)
    return out


def _chunks(width):
    """(ids [1, width], mask, start, chunk_blocks) of each chunk of the
    P-token prompt: chunk blocks past the prompt's run name block 0."""
    ids = np.random.RandomState(5).randint(0, 1000, (P,)).astype(np.int32)
    out = []
    for start in range(0, P, width):
        n = min(width, P - start)
        x = np.zeros((1, width), np.int32)
        m = np.zeros((1, width), np.int32)
        x[0, :n], m[0, :n] = ids[start:start + n], 1
        cb = np.array([TABLE[start // BLOCK + j]
                       if start // BLOCK + j < len(TABLE) else 0
                       for j in range(width // BLOCK)], np.int32)
        out.append((x, m, start, cb))
    return ids, out


def _port_chunked(tm, tp, p0, width):
    pools = {n: torch.from_numpy(x.copy()) for n, x in p0.items()}
    _, chunks = _chunks(width)
    for x, m, start, cb in chunks:
        scales = ({"k_scale": pools["k_scale"], "v_scale": pools["v_scale"]}
                  if "k_scale" in pools else {})
        out = tm.paged_prefill_chunk(tp, torch.from_numpy(x),
                                     torch.from_numpy(m), start, pools["k"],
                                     pools["v"], torch.from_numpy(TABLE),
                                     torch.from_numpy(cb), **scales)
    return out[0].numpy(), pools


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_prefill_chunk_matches_reference(pair, quant):
    """Two chunks of 8 over an 11-token prompt (the second ragged, its
    second block the null block): the final chunk's logits and every
    written block of the slot's run against the reference's."""
    jm, jp, tm, tp = pair
    p0 = _pools(tm, quant)
    got_lg, got = _port_chunked(tm, tp, p0, C)
    jpools = {n: jnp.asarray(x) for n, x in p0.items()}
    _, chunks = _chunks(C)
    for x, m, start, cb in chunks:
        scales = ({"k_scale": jpools["k_scale"],
                   "v_scale": jpools["v_scale"]} if quant else {})
        out = jm.paged_prefill_chunk(jp, jnp.asarray(x), jnp.asarray(m),
                                     jnp.int32(start), jpools["k"],
                                     jpools["v"], jnp.asarray(TABLE),
                                     jnp.asarray(cb), **scales)
        jpools.update(k=out[1], v=out[2])
        if quant:
            jpools.update(k_scale=out[3], v_scale=out[4])
    np.testing.assert_allclose(got_lg, np.asarray(out[0]), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for n, x0 in p0.items():
        g, w = got[n].numpy()[:, TABLE], np.asarray(jpools[n])[:, TABLE]
        g, w = g.reshape(*g.shape[:1], -1, *g.shape[3:])[:, :P], \
            w.reshape(*w.shape[:1], -1, *w.shape[3:])[:, :P]
        if x0.dtype == np.int8:
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(g, w, rtol=CACHE_TOL, atol=CACHE_TOL)
        # blocks outside the run and the null block keep their bytes
        keep = [b for b in range(1, N_BLOCKS) if b not in TABLE]
        np.testing.assert_array_equal(got[n].numpy()[:, keep], x0[:, keep])


@pytest.mark.parametrize("width", [BLOCK, C])
def test_chunks_compose_to_the_monolithic_prefill(pair, width):
    """Chunks of 4 (three, the last ragged) or 8 give the logits and
    block bytes of one ``paged_prefill`` of the prompt on a float pool,
    bit for bit: both take the plain attention here, and the softmax over
    the wider window only adds exact zeros (on the card the monolithic
    prefill runs the flash kernel, and ``chip_smoke.py`` holds the two to
    the engine's agreement floor instead)."""
    _, _, tm, tp = pair
    p0 = _pools(tm, False)
    got_lg, got = _port_chunked(tm, tp, p0, width)
    ids, _ = _chunks(width)
    x = np.zeros((1, PROMPT_LEN), np.int32)
    m = np.zeros((1, PROMPT_LEN), np.int32)
    x[0, :P], m[0, :P] = ids, 1
    want = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    lg, _, _ = tm.paged_prefill(tp, torch.from_numpy(x), torch.from_numpy(m),
                                want["k"], want["v"], torch.from_numpy(TABLE))
    np.testing.assert_array_equal(got_lg, lg.numpy())
    for n in p0:
        g = got[n].numpy()[:, TABLE].reshape(tm.cfg.layers, -1, tm.cfg.heads,
                                             tm.head_dim)[:, :P]
        w = want[n].numpy()[:, TABLE].reshape(g.shape[0], -1,
                                              *g.shape[2:])[:, :P]
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# units: the split estimator, ordered admission, the pressure ladder
# ---------------------------------------------------------------------------

def test_estimator_decode_ema_immune_to_prefill_chunks():
    a, b = RetryAfterEstimator(alpha=0.5), RetryAfterEstimator(alpha=0.5)
    for e in (a, b):
        e.observe(0.010)
        e.observe(0.020)
    for _ in range(50):
        b.observe_prefill(0.500)
    assert b.ema_step_s == a.ema_step_s
    assert b.estimate(4.0, queue_ahead=3, slots=2) \
        == a.estimate(4.0, queue_ahead=3, slots=2)
    assert b.ema_prefill_chunk_s == pytest.approx(0.5, rel=1e-6)
    est = RetryAfterEstimator(alpha=1.0)
    assert est.time_for(10) is None
    est.observe(0.010)
    assert est.time_for(10, prefill_chunks=2) == pytest.approx(0.12)
    est.observe_prefill(0.100)
    assert est.time_for(10, prefill_chunks=2) == pytest.approx(0.30)


def _req(priority="interactive", submitted_at=0.0, deadline_t=0.0):
    r = GenRequest(prompt=np.array([1], np.int32), max_new=4,
                   temperature=0.0, top_k=0, top_p=0.0, seed=0,
                   eos_id=None, pad_id=0)
    r.priority = priority
    r.submitted_at = submitted_at
    r.deadline_t = deadline_t
    return r


def test_select_index_class_order_edf_and_aging():
    q = [_req("best_effort"), _req("batch"),
         _req("interactive", deadline_t=50.0),
         _req("interactive", deadline_t=20.0), _req("interactive")]
    for want in (3, 2, 2, 1):
        assert select_index(q, now=0.0, aging_s=0.0) == want
        del q[want]
    be, inter = (_req("best_effort", submitted_at=0.0),
                 _req("interactive", submitted_at=3.9))
    assert select_index([be, inter], now=4.0, aging_s=2.0) == 0
    assert select_index([be, inter], now=2.5, aging_s=2.0) == 1
    assert select_index([be, inter], now=1e9, aging_s=0.0) == 1
    assert select_index([_req(submitted_at=i) for i in range(5)],
                        now=100.0, aging_s=2.0) == 0


def test_no_starvation_under_sustained_interactive_stream():
    aging_s, now = 1.0, 0.0
    be = _req("best_effort", submitted_at=0.0)
    queue, served_at = [be], None
    for _ in range(100):
        queue.append(_req("interactive", submitted_at=now))
        i = select_index(queue, now, aging_s=aging_s)
        if queue[i] is be:
            served_at = now
            break
        del queue[i]
        now += 0.1
    assert served_at is not None and served_at <= len(PRIORITIES) * aging_s


def test_pressure_ladder_levels_and_hysteresis():
    for prev, score, want in ((0, 0.49, 0), (0, 0.50, 1), (0, 0.75, 2),
                              (0, 0.95, 3), (2, 0.70, 2), (2, 0.64, 1),
                              (3, 0.82, 3), (3, 0.30, 0)):
        assert compute_pressure_level(prev, score) == want
    assert len(PRESSURE_STATES) == 4


# ---------------------------------------------------------------------------
# the engine: chunked prefill and its compositions
# ---------------------------------------------------------------------------

def test_chunked_prefill_greedy_equal_and_knob_noop(chunk_dir):
    prompts = _prompts(6, seed=1)
    off, s_off = _run_engine(chunk_dir, prompts, chunk=0)
    on, s_on = _run_engine(chunk_dir, prompts, chunk=BLOCK)
    assert on == off
    assert s_off["prefill_chunks"] == 0 and s_off["prefills"] == len(prompts)
    assert s_on["prefills"] == 0
    assert s_on["prefill_chunks"] == sum(-(-int(p.size) // BLOCK)
                                         for p in prompts)
    assert s_on["tokens_out"] == s_off["tokens_out"]
    with pytest.raises(ValueError, match="multiple of block_size"):
        GenerationEngine(load_stepwise(chunk_dir, device="cpu"),
                         prefill_chunk_tokens=BLOCK + 1)
    with pytest.raises(ValueError, match="exceeds this artifact"):
        GenerationEngine(load_stepwise(chunk_dir, device="cpu"),
                         prefill_chunk_tokens=4 * BLOCK)


def test_chunk_export_validation_and_clamp(pair, tmp_path):
    _, _, tm, tp = pair
    with pytest.raises(ValueError, match="multiple of"):
        _export(tm, tp, str(tmp_path / "a"), prefill_chunk=BLOCK + 2)
    with pytest.raises(ValueError, match="paged=True"):
        export_generator(tm, tp, str(tmp_path / "b"), prompt_len=8,
                         max_new_tokens=4, stepwise=True, prefill_chunk=4)
    # wider than the prompt's 3 blocks: clamped to them
    d = _export(tm, tp, str(tmp_path / "c"), prefill_chunk=8 * BLOCK)
    sw = load_stepwise(d, device="cpu")
    assert sw.prefill_chunk_tokens == PROMPT_LEN
    with pytest.raises(ValueError, match="input_ids shape"):
        sw.prefill_chunk({**sw.make_pool(),
                          "input_ids": np.zeros((1, 4), np.int32),
                          "chunk_mask": np.zeros((1, 4), np.int32),
                          "start": 0, "table_row": np.zeros(3, np.int32),
                          "chunk_blocks": np.zeros(1, np.int32)})
    plain = load_stepwise(_export(tm, tp, str(tmp_path / "d")),
                          device="cpu")
    with pytest.raises(ValueError, match="without a chunked prefill"):
        plain.prefill_chunk({})


def test_chunked_prefill_composes_with_prefix_cache(chunk_dir):
    base = np.random.RandomState(7).randint(0, 1000, (PROMPT_LEN,)) \
        .astype(np.int32)
    eng = GenerationEngine(load_stepwise(chunk_dir, device="cpu"),
                           prefill_chunk_tokens=BLOCK).start()
    try:
        a = eng.submit(base, max_new=6).result(timeout=WAIT_S)
        chunks0 = eng.stats()["prefill_chunks"]
        b = eng.submit(base, max_new=6).result(timeout=WAIT_S)
        st = eng.stats()
        assert b == a
        assert st["prefill_chunks"] == chunks0
        assert st["prefix_cache_hits"] == 1
        assert st["prefill_tokens_saved"] > 0
    finally:
        eng.close()
    ref, _ = _run_engine(chunk_dir, [base], chunk=0)
    assert a == ref[0]


def test_chunked_prefill_composes_with_speculation(pair, tmp_path):
    _, _, tm, tp = pair
    d = _export(tm, tp, str(tmp_path), max_new_tokens=12,
                prefill_chunk=BLOCK, spec_tokens=4)
    pattern = np.random.RandomState(3).randint(0, 1000, (3,)) \
        .astype(np.int32)
    prompts = [np.tile(pattern, 4)[:n].astype(np.int32) for n in (12, 7, 9)]
    off, s_off = _run_engine(d, prompts, max_new=12, chunk=0, spec_tokens=4)
    on, s_on = _run_engine(d, prompts, max_new=12, chunk=BLOCK,
                           spec_tokens=4)
    assert on == off
    assert s_on["prefill_chunks"] > 0 and s_on["spec_accepted"] > 0
    assert s_on["spec_accepted"] == s_off["spec_accepted"]


def test_chunked_prefill_composes_with_weight_int8(pair, tmp_path):
    """int8 weights serve the decode steps only: the chunks, like the
    monolithic prefill, run the float weights, so tokens stay equal."""
    _, _, tm, tp = pair
    d = _export(tm, tp, str(tmp_path), prefill_chunk=BLOCK,
                weight_quant="int8")
    prompts = _prompts(4, seed=5)
    off, _ = _run_engine(d, prompts, chunk=0)
    on, s_on = _run_engine(d, prompts, chunk=BLOCK)
    assert on == off and s_on["prefill_chunks"] > 0


def test_chunked_prefill_kv_int8_rides_the_drift_gate(pair, tmp_path):
    _, _, tm, tp = pair
    d = _export(tm, tp, str(tmp_path), prefill_chunk=BLOCK,
                weight_quant="int8", kv_cache_dtype="int8")
    prompts = _prompts(4, seed=9)
    off, _ = _run_engine(d, prompts, chunk=0)
    on, s_on = _run_engine(d, prompts, chunk=BLOCK)
    assert s_on["prefill_chunks"] > 0
    assert _agreement(on, off) >= INT8_MIN_AGREEMENT


def test_chunked_prefill_respects_deadline_and_cancel(chunk_dir):
    """A slot mid-chunked-prefill is cancellable and deadline-bound like
    a live one: its blocks return and the engine serves on to parity."""
    long_p = np.random.RandomState(11).randint(0, 1000, (PROMPT_LEN,)) \
        .astype(np.int32)
    eng = GenerationEngine(load_stepwise(chunk_dir, device="cpu"),
                           prefix_cache=False, shed_policy="off",
                           prefill_chunk_tokens=BLOCK)
    gate, entered = threading.Event(), threading.Event()
    real = eng.sw.prefill_chunk

    def gated(feats):
        entered.set()
        gate.wait(WAIT_S)
        return real(feats)

    eng.sw.prefill_chunk = gated
    eng.start()
    try:
        free0 = eng.stats()["blocks_free"]
        h = eng.submit(long_p, max_new=MAX_NEW)
        assert entered.wait(WAIT_S)         # parked mid-prefill
        h.cancel()
        gate.set()
        with pytest.raises(RequestCancelledError):
            h.result(timeout=WAIT_S)
        _wait(lambda: eng.stats()["blocks_free"] == free0,
              what="blocks returned")
        eng.sw.prefill_chunk = real
        # a deadline shorter than the chunks take expires mid-prefill
        gate.clear()
        entered.clear()
        eng.sw.prefill_chunk = gated
        h = eng.submit(long_p, max_new=MAX_NEW, deadline_ms=50)
        assert entered.wait(WAIT_S)
        time.sleep(0.1)
        gate.set()
        with pytest.raises(TimeoutError, match="deadline"):
            h.result(timeout=WAIT_S)
        _wait(lambda: eng.stats()["blocks_free"] == free0,
              what="blocks returned after expiry")
        assert eng.stats()["deadline_expired"] == 1
        eng.sw.prefill_chunk = real
        out = eng.submit(long_p, max_new=4).result(timeout=WAIT_S)
    finally:
        gate.set()
        eng.close()
    ref, _ = _run_engine(chunk_dir, [long_p], max_new=4, chunk=0)
    assert out == ref[0]


# ---------------------------------------------------------------------------
# shedding: the ladder by class, feasibility, /healthz
# ---------------------------------------------------------------------------

def test_brownout_sheds_batch_and_best_effort_not_interactive(chunk_dir):
    prompts = _prompts(4, seed=13)
    eng = GenerationEngine(load_stepwise(chunk_dir, device="cpu"),
                           max_queue=16)
    try:
        eng._pressure_level = 1                      # shed_best_effort
        with pytest.raises(ShedError) as ei:
            eng.submit(prompts[0], max_new=2, priority="best_effort")
        assert ei.value.retry_after >= 0.0 and "pressure" in str(ei.value)
        eng.submit(prompts[0], max_new=2, priority="batch")
        eng._pressure_level = 2                      # shed_batch
        for prio in ("batch", "best_effort"):
            with pytest.raises(ShedError):
                eng.submit(prompts[1], max_new=2, priority=prio)
        eng.submit(prompts[1], max_new=2)
        h = eng.health()
        assert h["pressure"] == "shed_batch" and h["saturated"] is True
        eng._pressure_level = 3                      # interactive_only
        with pytest.raises(ShedError):
            eng.submit(prompts[2], max_new=2, priority="batch")
        eng.submit(prompts[2], max_new=2)
        st = eng.stats()
        assert (st["shed_batch"], st["shed_best_effort"],
                st["shed_interactive"], st["shed"]) == (2, 2, 0, 4)
    finally:
        eng.close()


def test_brownout_level3_sheds_queued_non_interactive(chunk_dir):
    prompts = _prompts(6, seed=31)
    eng = GenerationEngine(load_stepwise(chunk_dir, device="cpu"),
                           max_queue=4)
    try:
        inter = [eng.submit(p, max_new=2) for p in prompts[:3]]
        victim = eng.submit(prompts[3], max_new=2, priority="batch")
        eng.start()
        with pytest.raises(ShedError):
            victim.result(timeout=WAIT_S)
        assert all(h.result(timeout=WAIT_S) for h in inter)
        st = eng.stats()
        assert st["shed_batch"] == 1 and st["shed_interactive"] == 0
        _wait(lambda: eng.stats()["pressure"] == "healthy",
              what="recovery to healthy")
        assert eng.stats()["pressure_transitions"] >= 2
    finally:
        eng.close()


def test_shed_policy_off_disables_ladder_and_feasibility(chunk_dir):
    prompts = _prompts(8, seed=17)
    eng = GenerationEngine(load_stepwise(chunk_dir, device="cpu"),
                           max_queue=16, shed_policy="off").start()
    try:
        handles = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
        h = eng.submit(prompts[0], max_new=2, priority="best_effort")
        assert h.result(timeout=WAIT_S)
        for x in handles:
            x.result(timeout=WAIT_S)
        st = eng.stats()
        assert (st["shed"], st["pressure"], st["pressure_transitions"]) \
            == (0, "healthy", 0)
    finally:
        eng.close()


def test_infeasible_deadline_shed_immediately(chunk_dir):
    prompts = _prompts(3, seed=19)
    eng = GenerationEngine(load_stepwise(chunk_dir, device="cpu"))
    eng._retry.observe(10.0)        # a measured 10 s a step: infeasible
    victim = eng.submit(prompts[1], max_new=MAX_NEW, deadline_ms=5_000)
    survivor = eng.submit(prompts[2], max_new=2)
    eng.start()
    try:
        with pytest.raises(ShedError, match="deadline infeasible"):
            victim.result(timeout=WAIT_S)
        assert survivor.result(timeout=WAIT_S)
        st = eng.stats()
        assert (st["shed_infeasible"], st["shed_interactive"], st["shed"],
                st["deadline_expired"]) == (1, 1, 1, 0)
    finally:
        eng.close()


def test_healthz_carries_saturation_fields(chunk_dir):
    eng = GenerationEngine(load_stepwise(chunk_dir, device="cpu")).start()
    try:
        h = eng.health()
        assert (h["pressure"], h["saturated"], h["queue_age_s"],
                h["queue_limit"]) == ("healthy", False, 0.0, 64)
        handles = [eng.submit(p, max_new=MAX_NEW)
                   for p in _prompts(SLOTS + 3, seed=29)]
        _wait(lambda: eng.health()["queue_age_s"] > 0.0,
              what="queue age becoming visible")
        for x in handles:
            x.result(timeout=WAIT_S)
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def _post(port, name, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def test_http_priority_knob_and_default(chunk_dir):
    with PredictServer(chunk_dir, device="cpu", default_priority="batch",
                       prefill_chunk_tokens=BLOCK) as srv:
        assert srv.engine.default_priority == "batch"
        out = _post(srv.port, srv.name, {"inputs": {"input_ids": [[1, 2, 3]]},
                                         "max_new": 3,
                                         "priority": "interactive"})
        assert len(out["generations"][0]) == 3
        out = _post(srv.port, srv.name, {"inputs": {"input_ids": [[4, 5]]},
                                         "max_new": 2})
        assert len(out["generations"][0]) == 2
        for bad in ("vip", 3):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(srv.port, srv.name, {"inputs": {"input_ids": [[1]]},
                                           "priority": bad})
            assert ei.value.code == 400
            assert "priority" in json.loads(ei.value.read())["error"]
        st = _get(srv.port, "/stats")["generate"]
        assert st["prefill_chunk_tokens"] == BLOCK
        assert st["prefill_chunks"] > 0
        h = _get(srv.port, "/healthz")
        assert h["pressure"] == "healthy" and h["saturated"] is False


def test_http_deadlines_429_and_504(chunk_dir):
    """An infeasible deadline is shed as 429 with the measured
    Retry-After; a feasible one that runs out answers 504; a generous
    one is served."""
    p = [1, 2, 3, 4, 5]
    with PredictServer(chunk_dir, device="cpu",
                       prefill_chunk_tokens=BLOCK) as srv:
        body = {"inputs": {"input_ids": [p]}, "max_new": MAX_NEW}
        want = _post(srv.port, srv.name, body)["generations"]
        assert _post(srv.port, srv.name, {**body, "deadline_ms": 60_000}
                     )["generations"] == want
        srv.engine._retry.observe(10.0)     # a measured 10 s a step
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, srv.name, {**body, "deadline_ms": 5_000})
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 0
        assert "shed" in json.loads(ei.value.read())["error"]
    with PredictServer(chunk_dir, device="cpu", shed_policy="off",
                       prefill_chunk_tokens=BLOCK) as srv:
        real = srv.engine.sw.decode

        def slow(feats):
            time.sleep(0.05)
            return real(feats)

        srv.engine.sw.decode = slow
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, srv.name, {**body, "deadline_ms": 20})
        assert ei.value.code == 504
        assert "deadline" in json.loads(ei.value.read())["error"]


def test_http_healthz_shows_the_backlog(chunk_dir):
    """With the shared step held, queued requests age and /healthz
    shows them: depth, age, the limit."""
    with PredictServer(chunk_dir, device="cpu", max_queue=8) as srv:
        gate = threading.Event()
        real = srv.engine.sw.decode

        def held(feats):
            gate.wait(WAIT_S)
            return real(feats)

        srv.engine.sw.decode = held
        body = {"inputs": {"input_ids": [[1, 2, 3]]}, "max_new": 3}
        threads = [threading.Thread(target=_post,
                                    args=(srv.port, srv.name, body))
                   for _ in range(SLOTS + 2)]
        for t in threads:
            t.start()
        try:
            _wait(lambda: _get(srv.port, "/healthz")["queue_age_s"] > 0.0,
                  what="queue age on /healthz")
            h = _get(srv.port, "/healthz")
            assert h["queue_depth"] >= 1 and h["queue_limit"] == 8
            assert h["pressure"] in PRESSURE_STATES
        finally:
            gate.set()
            for t in threads:
                t.join(WAIT_S)


def test_http_chunk_knob_auto_off_without_the_step(pair, tmp_path):
    _, _, tm, tp = pair
    d = _export(tm, tp, str(tmp_path))
    records: list = []
    h = logging.Handler(logging.WARNING)
    h.emit = records.append
    logging.getLogger("dtx").addHandler(h)
    try:
        with PredictServer(d, device="cpu", prefill_chunk_tokens=BLOCK) \
                as srv:
            assert srv.engine.prefill_chunk_tokens == 0
    finally:
        logging.getLogger("dtx").removeHandler(h)
    assert any("no chunked prefill" in r.getMessage() for r in records)
    # a width above the export's is clamped to it
    with PredictServer(_export(tm, tp, str(tmp_path / "w"),
                               prefill_chunk=2 * BLOCK),
                       device="cpu", prefill_chunk_tokens=16) as srv:
        assert srv.engine.prefill_chunk_tokens == 2 * BLOCK
