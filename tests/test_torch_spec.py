"""Speculative decoding on the port: the K-token verify step
(``GPT.decode_verify_batched_paged``) against the JAX package's, and the
port's engine and HTTP server with ``spec_tokens`` (mirrors of the
reference's ``tests/test_serving_spec.py``), on bridged GPT-tiny weights,
f32, on the CPU.

The verify step is held to the reference's function (the two packages'
plain paged attention; logits 1e-4, written K/V 1e-5: f32, summation
order only). The engine is held to its own spec-off output: greedy
tokens EQUAL, as the exact rejection rule promises (the reference's own
engine-level spec parity tests fail on this tree, so its engine is no
oracle here).
"""

import contextlib
import json
import logging
import threading
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
    GenerationEngine, NgramDrafter, RetryAfterEstimator)
from distributed_tensorflow_example_tpu_torch.serving_http import \
    PredictServer

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
B, K, BS, NB = 3, 3, 4, 4           # rows, verify lanes, block size, blocks
T = BS * NB
SLOTS = 8
PROMPT_LEN = 12
MAX_NEW = 16
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
                block_size=4)
    base.update(kw)
    export_generator(tm, tp, d, **base)
    return d


@pytest.fixture(scope="module")
def spec_dir(pair, tmp_path_factory):
    _, _, tm, tp = pair
    return _export(tm, tp, str(tmp_path_factory.mktemp("spec")),
                   spec_tokens=4)


@contextlib.contextmanager
def port_warnings():
    """The port's log records at WARNING and above (its ``dtx`` logger
    does not propagate to the root logger that caplog watches)."""
    records: list = []
    h = logging.Handler(logging.WARNING)
    h.emit = records.append
    lg = logging.getLogger("dtx")
    lg.addHandler(h)
    try:
        yield records
    finally:
        lg.removeHandler(h)


def ragged_prompts(n=SLOTS, seed=7):
    """n repetitive prompts of mixed lengths (prompt lookup's workload)."""
    rs = np.random.RandomState(seed)
    pattern = rs.randint(0, 1000, (3,)).astype(np.int32)
    return [np.tile(pattern, 5)[:int(rs.randint(2, PROMPT_LEN + 1))]
            .astype(np.int32) for _ in range(n)]


def run_engine(d, prompts, *, spec, max_new=MAX_NEW, **kw):
    """Every request queued before the engine starts, so one admission
    wave takes them all and the dispatch counts do not depend on how
    the scheduler thread races the submitting one."""
    eng = GenerationEngine(load_stepwise(d, device="cpu"),
                           prefix_cache=False, spec_tokens=spec)
    try:
        handles = [eng.submit(p, max_new=max_new, **kw) for p in prompts]
        eng.start()
        outs = [h.result(timeout=WAIT_S) for h in handles]
        stats = eng.stats()
        assert eng.blocks.in_use == 0, "blocks leaked past retirement"
        return outs, stats, [h.timings for h in handles]
    finally:
        eng.close()


def solo_dispatches(d, prompts, *, spec):
    """Shared dispatches summed over one engine run a prompt: a wave of
    8 random-weight rows is as long as its least repetitive row, one row
    alone shows what drafting saves it."""
    total = 0
    for p in prompts:
        _, s, _ = run_engine(d, [p], spec=spec)
        total += s["decode_steps"] + s["verify_steps"]
    return total


@pytest.fixture(scope="module")
def oracle(spec_dir):
    """One spec-off pass over the 8 ragged prompts: the parity oracle."""
    prompts = ragged_prompts()
    outs, stats, _ = run_engine(spec_dir, prompts, spec=0)
    return prompts, outs, stats


# ---------------------------------------------------------------------------
# the verify step against the reference's
# ---------------------------------------------------------------------------

TABLES = (np.random.RandomState(1).permutation(B * NB) + 1).reshape(
    B, NB).astype(np.int32)
N_BLOCKS = 1 + B * NB
POS = np.array([5, 9, 3], np.int32)
PAD = np.array([0, 2, 0], np.int32)
ALIVE = np.array([1, 1, 0], np.int32)
N_TOK = np.array([3, 2, 3], np.int32)      # row 1 verifies 2 of K lanes
TOK = np.array([[5, 6, 7], [9, 8, 7], [1, 2, 3]], np.int32)


def _pools(tm, quant, seed=3):
    c = tm.cfg
    rs = np.random.RandomState(seed)
    shape = (c.layers, N_BLOCKS, BS, c.heads, tm.head_dim)
    if not quant:
        return {n: rs.randn(*shape).astype(np.float32) for n in ("k", "v")}
    out = {n: rs.randint(-127, 128, shape).astype(np.int8)
           for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        out[n] = rs.uniform(0.005, 0.02, shape[:3]).astype(np.float32)
    return out


def _torch(d):
    return {n: torch.from_numpy(x.copy()) for n, x in d.items()}


def _live_slots(pos, n_tok, alive, tables):
    """(row, lane, block, offset) of every lane that writes."""
    out = []
    for r in range(len(pos)):
        for j in range(int(n_tok[r]) if alive[r] else 0):
            p = int(pos[r]) + j
            out.append((r, j, int(tables[r, p // BS]), p % BS))
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_verify_matches_reference(pair, quant):
    """K = 3 lanes a row, one row verifying 2 of them, one dead row:
    the live lanes' logits and written K/V against the reference's
    function; every slot no live lane writes (the gated lanes', the dead
    row's, the null block) keeps its bytes."""
    jm, jp, tm, tp = pair
    p0 = _pools(tm, quant)
    lg, pools = tm.decode_verify_batched_paged(
        tp, tm.stack_decode_params(tp), _torch(p0),
        torch.from_numpy(TABLES), torch.from_numpy(TOK),
        torch.from_numpy(POS), torch.from_numpy(PAD),
        torch.from_numpy(ALIVE), torch.from_numpy(N_TOK))
    jlg, jpools = jm.decode_verify_batched_paged(
        jp, jm.stack_decode_params(jp),
        {n: jnp.asarray(x) for n, x in p0.items()}, jnp.asarray(TABLES),
        jnp.asarray(TOK), jnp.asarray(POS), jnp.asarray(PAD),
        jnp.asarray(ALIVE), jnp.asarray(N_TOK), decode_attention="xla")
    assert tuple(lg.shape) == (B, K, tm.cfg.vocab_size)
    live = _live_slots(POS, N_TOK, ALIVE, TABLES)
    jlg = np.asarray(jlg)
    for r, j, _, _ in live:
        np.testing.assert_allclose(lg[r, j].numpy(), jlg[r, j],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    written = np.zeros((N_BLOCKS, BS), bool)
    for _, _, blk, off in live:
        written[blk, off] = True
    for n, x0 in p0.items():
        got, want = pools[n].numpy(), np.asarray(jpools[n])
        for _, _, blk, off in live:
            if x0.dtype == np.int8:
                # one int8 step at most: the two packages' K/V differ in
                # the last f32 bits, which may move a rounding boundary
                assert np.abs(got[:, blk, off].astype(int)
                              - want[:, blk, off].astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got[:, blk, off],
                                           want[:, blk, off],
                                           rtol=CACHE_TOL, atol=CACHE_TOL)
            assert not np.array_equal(got[:, blk, off], x0[:, blk, off])
        np.testing.assert_array_equal(got[:, ~written], x0[:, ~written])


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_verify_lane_at_row_end_keeps_its_write(pair, quant):
    """A row at the last slot of its table with ``n_tok = 1`` and K = 4:
    lanes 1..3 lie past the row's capacity and clip onto lane 0's slot.
    Their gated writes must not land on it: the slot holds the bytes
    lane 0 wrote, as a single decode step writes them."""
    _, _, tm, tp = pair
    stacked = tm.stack_decode_params(tp)
    p0 = _pools(tm, quant)
    tables = torch.from_numpy(TABLES[:1])
    pos, pad, alive = (torch.tensor([T - 1], dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32),
                       torch.ones(1, dtype=torch.int32))
    tok = torch.tensor([[11, 12, 13, 14]], dtype=torch.int32)
    lg, got = tm.decode_verify_batched_paged(
        tp, stacked, _torch(p0), tables, tok, pos, pad, alive,
        torch.tensor([1], dtype=torch.int32))
    lg1, want = tm.decode_step_batched_paged(
        tp, stacked, _torch(p0), tables, tok[:, 0], pos, pad, alive)
    blk = int(TABLES[0, NB - 1])
    np.testing.assert_allclose(lg[0, 0].numpy(), lg1[0].numpy(),
                               rtol=CACHE_TOL, atol=CACHE_TOL)
    for n, x0 in p0.items():
        g, w = got[n][:, blk, BS - 1].numpy(), want[n][:, blk, BS - 1].numpy()
        assert not np.array_equal(w, x0[:, blk, BS - 1])
        if x0.dtype == np.int8:
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(g, w, rtol=CACHE_TOL, atol=CACHE_TOL)


def test_verify_lanes_equal_sequential_steps(pair):
    """Each verify lane's logits are those of the single-token steps that
    feed the same tokens in turn (the state a sequential decode leaves),
    and the pools end the same."""
    _, _, tm, tp = pair
    stacked = tm.stack_decode_params(tp)
    p0 = _pools(tm, False)
    alive = torch.ones(B, dtype=torch.int32)
    n_tok = torch.full((B,), K, dtype=torch.int32)
    args = (torch.from_numpy(TABLES),)
    lg, got = tm.decode_verify_batched_paged(
        tp, stacked, _torch(p0), *args, torch.from_numpy(TOK),
        torch.from_numpy(POS), torch.from_numpy(PAD), alive, n_tok)
    pools = _torch(p0)
    for j in range(K):
        lj, pools = tm.decode_step_batched_paged(
            tp, stacked, pools, *args, torch.from_numpy(TOK[:, j]),
            torch.from_numpy(POS + j), torch.from_numpy(PAD), alive)
        np.testing.assert_allclose(lg[:, j].numpy(), lj.numpy(),
                                   rtol=CACHE_TOL, atol=CACHE_TOL)
    for n in p0:
        np.testing.assert_allclose(got[n].numpy(), pools[n].numpy(),
                                   rtol=CACHE_TOL, atol=CACHE_TOL)


# ---------------------------------------------------------------------------
# units: the drafter and the Retry-After math (the port's copies)
# ---------------------------------------------------------------------------

def test_ngram_drafter_proposes_the_latest_continuation():
    d = NgramDrafter([1, 2, 3, 9, 1, 2, 3, 7, 1, 2])
    assert d.propose(2) == [3, 7]           # latest prior "1 2" -> 3 7
    d.extend(3)
    assert d.propose(3) == [7, 1, 2]        # "1 2 3" -> 7 ...
    assert NgramDrafter([4, 5, 6]).propose(2) == []   # nothing recurs
    assert NgramDrafter([5, 5]).propose(1) == [5]
    with pytest.raises(ValueError, match="max_ngram"):
        NgramDrafter([1], max_ngram=0)


def test_retry_after_counts_accepted_tokens_per_dispatch():
    est = RetryAfterEstimator()
    for _ in range(30):
        est.observe(0.1)
        est.observe_advance(2.5)
    # 10 row-steps at ~2.5 tokens a dispatch need ~4 dispatches
    assert est.dispatches_for(10) == pytest.approx(4.0, rel=0.05)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_engine_spec_greedy_equal_and_fewer_dispatches(spec_dir, oracle):
    prompts, off, s_off = oracle
    on, s_on, timings = run_engine(spec_dir, prompts, spec=4)
    assert on == off, "speculative greedy output diverged"
    assert s_off["verify_steps"] == 0
    assert s_on["spec_accepted"] > 0 and s_on["accept_rate"] > 0
    assert (s_on["decode_steps"] + s_on["verify_steps"]
            <= s_off["decode_steps"])
    assert solo_dispatches(spec_dir, prompts, spec=4) \
        < solo_dispatches(spec_dir, prompts, spec=0)
    assert s_on["verify_steps"] < s_on["tokens_out"]
    # drafts were rejected too, so the rewind and the trailing-block
    # release ran (run_engine checks no block leaked)
    assert s_on["spec_proposed"] > s_on["spec_accepted"]
    assert sum(t["spec_accepted"] for t in timings) == s_on["spec_accepted"]


def test_engine_spec_exact_for_sampled_requests(spec_dir):
    """Sampled requests never draft: their per-seed streams stand."""
    prompts = ragged_prompts(n=4)
    kw = dict(temperature=0.8, top_k=5, seed=11)
    off, _, _ = run_engine(spec_dir, prompts, spec=0, **kw)
    on, s_on, _ = run_engine(spec_dir, prompts, spec=4, **kw)
    assert on == off
    assert s_on["spec_proposed"] == 0 and s_on["verify_steps"] == 0


def test_engine_spec_under_int8_weights_and_kv(pair, tmp_path):
    """int8 decode weights and int8 pools: the verify step runs B6 over
    B·K rows on the card; here its plain version. Speculation on and off
    give equal greedy tokens over the same int8 export."""
    _, _, tm, tp = pair
    d = _export(tm, tp, str(tmp_path), spec_tokens=4, weight_quant="int8",
                kv_cache_dtype="int8")
    prompts = ragged_prompts()
    off, s_off, _ = run_engine(d, prompts, spec=0)
    on, s_on, _ = run_engine(d, prompts, spec=4)
    assert on == off
    assert s_on["spec_accepted"] > 0
    assert (s_on["decode_steps"] + s_on["verify_steps"]
            <= s_off["decode_steps"])
    assert solo_dispatches(d, prompts, spec=4) \
        < solo_dispatches(d, prompts, spec=0)


def test_engine_per_request_spec_optout_and_cap(spec_dir, oracle):
    prompts, off, _ = oracle
    outs, s, _ = run_engine(spec_dir, prompts[:4], spec=4, spec_tokens=0)
    assert s["spec_proposed"] == 0 and s["verify_steps"] == 0
    assert outs == off[:4]
    # a cap of 2 lanes: one draft a row a dispatch at most
    outs, s, _ = run_engine(spec_dir, prompts[:1], spec=4, spec_tokens=2)
    assert outs == off[:1]
    assert 0 < s["spec_proposed"] <= s["verify_steps"]
    eng = GenerationEngine(load_stepwise(spec_dir, device="cpu"),
                           spec_tokens=4)
    try:
        with pytest.raises(ValueError, match="exceeds"):
            eng.submit(prompts[0], spec_tokens=9)
        with pytest.raises(ValueError, match="spec_tokens"):
            eng.submit(prompts[0], spec_tokens=1)
    finally:
        eng.close()


def _expected_stopped(base, ss, pad):
    """The truncation contract recomputed on the host: each output cut
    before its first completed stop-sequence match, padded to max_new."""
    out = []
    for b in base:
        exp, done = list(b), False
        for i in range(1, len(exp) + 1):
            for s in ss:
                if i >= len(s) and exp[i - len(s):i] == list(s):
                    exp = exp[:i - len(s)] + [pad] * (MAX_NEW - (i - len(s)))
                    done = True
                    break
            if done:
                break
        out.append(exp)
    return out


def test_stop_sequences_cut_at_the_same_boundary_spec_on_and_off(
        spec_dir, oracle):
    prompts, base, _ = oracle
    pad = load_stepwise(spec_dir, device="cpu").meta.get("pad_id", 0)
    donor = max(base, key=len)
    ss = [list(map(int, donor[2:4])), list(map(int, base[0][:1]))]
    want = _expected_stopped(base, ss, pad)
    for spec in (0, 4):
        got, _, _ = run_engine(spec_dir, prompts, spec=spec,
                               stop_sequences=ss)
        assert got == want, f"stop boundary moved (spec_tokens={spec})"
    assert want[0] == [pad] * MAX_NEW


def test_spec_knob_validation(pair, spec_dir, tmp_path):
    _, _, tm, tp = pair
    kw = dict(prompt_len=8, max_new_tokens=4, stepwise=True, paged=True,
              block_size=4)
    with pytest.raises(ValueError, match="spec_tokens must be"):
        export_generator(tm, tp, str(tmp_path / "a"), spec_tokens=1, **kw)
    with pytest.raises(ValueError, match="paged=True"):
        export_generator(tm, tp, str(tmp_path / "b"), spec_tokens=3,
                         prompt_len=8, max_new_tokens=4, stepwise=True)
    sw = load_stepwise(spec_dir, device="cpu")
    assert sw.spec_tokens == 4 and sw.step_meta["spec_tokens"] == 4
    with pytest.raises(ValueError, match="spec_tokens"):
        GenerationEngine(sw, spec_tokens=1)
    with pytest.raises(ValueError, match="verify width"):
        GenerationEngine(sw, spec_tokens=9)
    with pytest.raises(ValueError, match="tok shape"):
        sw.verify({**sw.make_pool(),
                   "tok": np.zeros((SLOTS, 3), np.int32),
                   "n_tok": np.ones((SLOTS,), np.int32),
                   "block_tables": np.zeros((SLOTS, 7), np.int32)})
    plain = str(tmp_path / "plain")
    export_generator(tm, tp, plain, **kw)
    psw = load_stepwise(plain, device="cpu")
    with pytest.raises(ValueError, match="verify program"):
        GenerationEngine(psw, spec_tokens=4)
    with pytest.raises(ValueError, match="without a verify step"):
        psw.verify({})


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


def _stats(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                timeout=30) as r:
        return json.loads(r.read())["generate"]


def _serve_concurrent(d, prompts, *, spec_tokens):
    outs: list = [None] * len(prompts)
    with PredictServer(d, device="cpu", prefix_cache=False,
                       spec_tokens=spec_tokens) as srv:
        def client(i):
            outs[i] = _post(srv.port, srv.name, {
                "inputs": {"input_ids": [prompts[i].tolist()]},
                "max_new": 10})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        return outs, _stats(srv.port)


def test_http_spec_parity_and_stats(spec_dir):
    """8 concurrent :generate requests: equal generations spec on and
    off, the accept rate in /stats, spec_accepted in every timings row."""
    prompts = ragged_prompts()
    off, _ = _serve_concurrent(spec_dir, prompts, spec_tokens=0)
    on, g = _serve_concurrent(spec_dir, prompts, spec_tokens=4)
    assert [o["generations"] for o in on] == [o["generations"] for o in off]
    assert g["spec_tokens"] == 4
    assert g["spec_accepted"] > 0 and g["accept_rate"] > 0
    assert g["verify_steps"] < g["tokens_out"]
    assert sum(o["timings"][0]["spec_accepted"] for o in on) \
        == g["spec_accepted"]


def test_http_payload_spec_and_stop_knobs(spec_dir):
    p = ragged_prompts(n=1)[0].tolist()
    with PredictServer(spec_dir, device="cpu", prefix_cache=False,
                       spec_tokens=4) as srv:
        body = {"inputs": {"input_ids": [p]}, "max_new": 8}
        base = _post(srv.port, srv.name, body)["generations"][0]
        assert _post(srv.port, srv.name, {**body, "spec_tokens": 0}
                     )["generations"][0] == base
        assert _post(srv.port, srv.name, {**body, "spec_tokens": 2}
                     )["generations"][0] == base
        stop = _post(srv.port, srv.name,
                     {**body, "stop_sequences": [base[:2]]})
        assert stop["generations"][0] == [0] * 8
        for bad in ({"spec_tokens": 99}, {"spec_tokens": 1},
                    {"stop_sequences": [[]]}, {"stop_sequences": "x"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.port, srv.name, {**body, "max_new": 4, **bad})
            assert e.value.code == 400, bad


def test_http_engine_only_knobs_refused_on_scheduler_off(spec_dir):
    with PredictServer(spec_dir, device="cpu", scheduler="off") as srv:
        for bad in ({"stop_sequences": [[1, 2]]}, {"spec_tokens": 2},
                    {"deadline_ms": 1000}, {"priority": "batch"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.port, srv.name, {
                    "inputs": {"input_ids": [[1] * PROMPT_LEN]}, **bad})
            assert e.value.code == 400
            assert "scheduler" in json.loads(e.value.read())["error"]


def test_http_spec_tokens_auto_off_without_verify_step(pair, tmp_path):
    """--spec_tokens over an export without the verify step serves
    spec-off with a warning, not a refusal."""
    _, _, tm, tp = pair
    d = _export(tm, tp, str(tmp_path))
    with port_warnings() as records:
        srv = PredictServer(d, device="cpu", spec_tokens=4)
    with srv:
        assert srv.engine.spec_tokens == 0
        out = _post(srv.port, srv.name, {
            "inputs": {"input_ids": [[1, 2, 3]]}, "max_new": 2})
        assert len(out["generations"][0]) == 2
        g = _stats(srv.port)
        assert g["spec_tokens"] == 0 and g["verify_steps"] == 0
    assert any("no verify step" in r.getMessage() for r in records)


def test_http_spec_tokens_clamped_to_export_width(spec_dir):
    with port_warnings() as records:
        srv = PredictServer(spec_dir, device="cpu", spec_tokens=9)
    with srv:
        assert srv.engine.spec_tokens == 4
    assert any("clamping to 4" in r.getMessage() for r in records)
