"""The port server's operator surface on the CPU: ``/metrics`` against
``/stats`` under concurrent load and against the reference server's metric
names, the trace routes (export drains), ``/stats/history`` with an SLO
burn and its ``slo_burn`` bundle, ``/cancel``, the graceful drain and the
reference's 503, the ``http.read`` seam, a watchdog stall's incident
bundle, armed against plain serving (equal bytes, equal dispatches), the
request log, and the CLI's flags with a SIGTERM drain. Every server binds
port 0, every wait is bounded, and every server is shut down."""

import json
import os
import signal
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

from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.config import TrainConfig as JConfig
from distributed_tensorflow_example_tpu.models import get_model as jget_model
from distributed_tensorflow_example_tpu.serving import \
    export_generator as jexport_generator
from distributed_tensorflow_example_tpu.serving import \
    load_stepwise as jload_stepwise
from distributed_tensorflow_example_tpu.serving_batch import \
    GenerationEngine as JEngine
from distributed_tensorflow_example_tpu.serving_http import \
    PredictServer as JPredictServer
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.config import TrainConfig
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.obs import prom
from distributed_tensorflow_example_tpu_torch.obs import trace
from distributed_tensorflow_example_tpu_torch.runtime import faults
from distributed_tensorflow_example_tpu_torch.serving import export_generator
from distributed_tensorflow_example_tpu_torch.serving_http import \
    PredictServer

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_LEN, MAX_NEW, SLOTS, BLOCK = 8, 8, 4, 4
WAIT_S = 60                         # every HTTP, engine and thread wait


def _export_kw():
    return dict(prompt_len=PROMPT_LEN, max_new_tokens=MAX_NEW, batch_size=1,
                ragged=True, stepwise=True, slots=SLOTS, paged=True,
                block_size=BLOCK, num_blocks=48)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """(port export dir, reference export dir) of GPT-tiny on the same
    weights: the reference's init, bridged into the port."""
    jm = jget_model("gpt_tiny", JConfig(model="gpt_tiny"))
    jp = jm.init(jax.random.key(0))
    tm = get_model("gpt_tiny", TrainConfig(model="gpt_tiny"))
    tp = tckpt.from_numpy(jckpt._flatten(jax.device_get(jp)), "cpu")
    d = str(tmp_path_factory.mktemp("port"))
    export_generator(tm, tp, d, **_export_kw())
    jd = str(tmp_path_factory.mktemp("ref"))
    jexport_generator(jm, jp, jd, platforms=("cpu",), **_export_kw())
    return d, jd


def _prompts(n, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 1000, (int(rs.randint(2, PROMPT_LEN + 1)),))
            .astype(np.int32).tolist() for _ in range(n)]


def _call(port, path, payload=None, method="GET", headers=None):
    """(status, body, headers); HTTP errors are answers too."""
    data = None if payload is None else json.dumps(payload).encode()
    if method == "POST" and data is None:
        data = b""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            raw, code, hdr = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, code, hdr = e.read(), e.code, dict(e.headers)
    text = raw.decode()
    try:
        return code, json.loads(text), hdr
    except ValueError:
        return code, text, hdr


def _generate(srv, rows, headers=None, **kw):
    return _call(srv.port, f"/v1/models/{srv.name}:generate",
                 {"inputs": {"input_ids": rows}, **kw}, "POST",
                 headers=headers)


def _wait(pred, what, timeout=WAIT_S):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _slow_decode(srv, seconds=0.01):
    """Slow every decode dispatch of ``srv``'s engine (a window to act
    inside a live request), counting them; returns the counter."""
    n = {"decode": 0}
    orig = srv.engine.sw.decode

    def slow(feats):
        n["decode"] += 1
        time.sleep(seconds)
        return orig(feats)

    srv.engine.sw.decode = slow
    return n


@pytest.fixture(autouse=True)
def _quiet_ring():
    """Each test starts with the process span ring disarmed (a server's
    flight recorder arms it process-wide)."""
    trace.recorder().stop()
    yield
    trace.recorder().stop()
    faults.install(None)


# ---------------------------------------------------------------------------
# /metrics
# ---------------------------------------------------------------------------

def test_metrics_equals_stats_under_concurrent_load(exports):
    d, _ = exports
    fields = (("prefills", "serving_prefills_total"),
              ("decode_steps", "serving_decode_steps_total"),
              ("admissions", "serving_admissions_total"),
              ("requests_done", "serving_requests_done_total"),
              ("tokens_out", "serving_tokens_out_total"),
              ("slo_served", "serving_slo_served_total"),
              ("blocks_free", "serving_blocks_free"),
              ("queue_depth", "serving_queue_depth"))
    with PredictServer(d, device="cpu", prefix_cache=False) as srv:
        prompts = _prompts(12)
        out = [None] * 12
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, _generate(srv, [prompts[i]]))) for i in range(12)]
        for t in threads:
            t.start()
        pages = []
        while any(t.is_alive() for t in threads):
            code, text, hdr = _call(srv.port, "/metrics")
            assert code == 200 and hdr["Content-Type"] == prom.CONTENT_TYPE
            pages.append(prom.parse_snapshot(text))
        for t in threads:
            t.join(WAIT_S)
        assert all(o[0] == 200 for o in out)
        done = [p["serving_requests_done_total"]["value"] for p in pages]
        assert done == sorted(done)                   # monotonic under load
        for p in pages:                               # atomic snapshots
            assert p["serving_admissions_total"]["value"] >= \
                p["serving_requests_done_total"]["value"]
        _, stats, _ = _call(srv.port, "/stats")
        _, text, _ = _call(srv.port, "/metrics")
    page = prom.parse_snapshot(text)
    gen = stats["generate"]
    assert {k: gen[k] for k, _ in fields} == \
        {k: page[m]["value"] for k, m in fields}
    assert gen["requests_done"] == 12
    assert page["serving_request_latency_seconds"]["count"] == 12
    assert page["http_requests_total"]["value"] >= 12 + len(pages)


def test_metric_names_contain_the_reference_servers(exports):
    """The same scripted flow on the reference server over its export and
    on the port's: every metric the reference's /metrics names, the
    port's names too."""
    d, jd = exports
    names = []
    rows = _prompts(2, seed=1)
    for cls, kw in ((JPredictServer, {}), (PredictServer,
                                           {"device": "cpu"})):
        with cls(jd if cls is JPredictServer else d, **kw) as srv:
            code, body, _ = _generate(srv, rows)
            assert code == 200, body
            _, text, _ = _call(srv.port, "/metrics")
            _call(srv.port, "/stats/history")
        names.append({line.split()[2] for line in text.splitlines()
                      if line.startswith("# TYPE ")})
    ref, ours = names
    assert ref <= ours, sorted(ref - ours)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def test_trace_start_stop_export_and_export_drains(exports):
    d, _ = exports
    tp = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    with PredictServer(d, device="cpu") as srv:
        assert _call(srv.port, "/trace/start", method="POST")[1][
            "tracing"] is True
        code, body, _ = _generate(srv, _prompts(2, seed=2),
                                  headers={"traceparent": tp})
        assert code == 200
        assert body["trace_id"] == "0af7651916cd43dd8448eb211c80319c"
        _, chrome, _ = _call(srv.port, "/trace/stop", method="POST")
        _, first, _ = _call(srv.port, "/trace/export")
        _, second, _ = _call(srv.port, "/trace/export")
    assert any(e.get("name") == "decode_step"
               for e in chrome["traceEvents"])
    names = {s[2] for s in first["spans"]}
    assert {"queue_wait", "prefill", "decode_step", "decode",
            "retire"} <= names
    assert first["process"] == "serving" and first["enabled"] is False
    parented = [s for s in first["spans"]
                if (s[5] or {}).get("trace_id") == tp.split("-")[1]]
    assert parented and all(s[5]["parent_id"] == "b7ad6b7169203331"
                            for s in parented)
    assert second["spans"] == []                  # the first export drained


@pytest.mark.parametrize("end", ["stop", "kill"])
def test_stopped_servers_disarm_the_ring_they_armed(exports, end):
    """The flight recorder's always-on ring stays armed while any server
    that armed it lives, and the last one's stop()/kill() disarms it: a
    later phase of the process records no spans. A capture armed before
    the servers (an operator's) is never disarmed by them."""
    d, _ = exports
    with PredictServer(d, device="cpu") as a:
        b = PredictServer(d, device="cpu").start()
        try:
            assert trace.recorder().enabled
            getattr(a, end)()
            assert trace.recorder().enabled      # b still holds it
        finally:
            getattr(b, end)()
    rec = trace.recorder()
    assert not rec.enabled
    n = rec.spans_recorded
    with trace.span("after"):
        pass
    assert rec.spans_recorded == n
    rec.start()                                  # an operator's capture
    getattr(PredictServer(d, device="cpu").start(), end)()
    assert trace.recorder() is rec and rec.enabled


# ---------------------------------------------------------------------------
# /stats/history and SLO burn
# ---------------------------------------------------------------------------

def test_stats_history_slo_burn_writes_a_bundle(exports, tmp_path):
    """The ring holds only the start() baseline (a cadence longer than
    the test); a poll adds a fresh sample and evaluates: 8 good of 10
    interactive requests burns 4.0 against a 0.95 goal in both windows,
    a breach, and the flight recorder writes one ``slo_burn`` bundle."""
    d, _ = exports
    inc = str(tmp_path / "inc")
    with PredictServer(d, device="cpu", shed_policy="off",
                       incident_dir=inc, history_interval_s=1000.0,
                       slo_spec="interactive:hit_rate=0.95",
                       slo_fast_window_s=3600.0,
                       slo_slow_window_s=3600.0) as srv:
        _, off, _ = _call(srv.port, "/stats/history")
        assert len(off["samples"]) == 2          # baseline + this poll
        ok = [_generate(srv, [p])[0] for p in _prompts(8, seed=3)]
        slow = _slow_decode(srv, 0.01)
        late = [_generate(srv, [p], deadline_ms=1)[0]
                for p in _prompts(2, seed=4)]
        assert ok == [200] * 8 and late == [504, 504] and slow["decode"]
        code, hist, _ = _call(srv.port, "/stats/history")
        _, health, _ = _call(srv.port, "/healthz")
    assert code == 200 and hist["enabled"] is True
    res = hist["slo"]["results"]
    assert len(res) == 1 and res[0]["breach"] is True
    assert res[0]["good"] == 8 and res[0]["total"] == 10
    assert res[0]["burn_fast"] == res[0]["burn_slow"] == 4.0
    assert health["slo"]["breaching"] == ["interactive:hit_rate"]
    bundles = [f for f in os.listdir(inc) if "slo_burn" in f]
    assert len(bundles) == 1
    with open(os.path.join(inc, bundles[0])) as f:
        bundle = json.load(f)
    assert bundle["cause"] == "slo_burn"
    assert bundle["slo"][0]["breach"] and bundle["history_tail"]
    assert bundle["registry"]["serving_slo_served_interactive_total"][
        "value"] == 10


def test_history_off_and_slo_spec_without_sampler(exports):
    d, _ = exports
    with PredictServer(d, device="cpu") as srv:
        _, hist, _ = _call(srv.port, "/stats/history")
    assert hist["enabled"] is False and hist["samples"] == []
    with pytest.raises(ValueError, match="history_interval_s"):
        PredictServer(d, device="cpu", slo_spec="all:availability=0.99")
    with pytest.raises(ValueError, match="largest finite bucket"):
        PredictServer(d, device="cpu", history_interval_s=1.0,
                      slo_spec="interactive:p95_ms=90000")


# ---------------------------------------------------------------------------
# cancel and drain
# ---------------------------------------------------------------------------

def test_cancel_frees_blocks_at_once(exports):
    d, _ = exports
    with PredictServer(d, device="cpu", prefix_cache=False) as srv:
        eng = srv.engine
        free0 = eng.stats()["blocks_free"]
        # a window of ~0.3 s after the second token for the cancel's POST
        _slow_decode(srv, 0.05)
        got = {}
        th = threading.Thread(target=lambda: got.update(r=_generate(
            srv, [_prompts(1, seed=5)[0]], headers={"X-Request-Id": "rq7"})))
        th.start()
        _wait(lambda: eng.stats()["tokens_out"] >= 2, "a live request")
        assert eng.stats()["blocks_free"] < free0
        code, body, _ = _call(srv.port, "/cancel/rq7", method="POST")
        _wait(lambda: eng.stats()["blocks_free"] == free0,
              "the blocks back", timeout=5)
        th.join(WAIT_S)
        again = _call(srv.port, "/cancel/rq7", method="POST")[0]
        stats = eng.stats()
    assert code == 200 and body == {"cancelled": "rq7"}
    assert got["r"][0] == 409 and again == 404
    assert stats["cancelled"] == 1 and stats["tokens_out"] < MAX_NEW


def _reference_draining_text(jd) -> str:
    """The reference engine's answer to an admission while it drains."""
    eng = JEngine(jload_stepwise(jd))
    eng._draining = True                 # the flag drain() raises first
    try:
        eng.submit(np.asarray([1, 2, 3], np.int32))
    except Exception as e:               # noqa: BLE001
        return f"{type(e).__name__}: {e}"
    finally:
        eng.close()
    raise AssertionError("the reference engine admitted while draining")


def test_drain_drops_nothing_and_refuses_late_admission(exports):
    d, jd = exports
    srv = PredictServer(d, device="cpu", prefix_cache=False).start()
    try:
        eng = srv.engine
        _slow_decode(srv, 0.01)
        rows = _prompts(8, seed=6)
        out = [None] * 8
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, _generate(srv, [rows[i]]))) for i in range(8)]
        for t in threads:
            t.start()
        _wait(lambda: eng.health()["queue_depth"]
              + eng.health()["inflight"] + eng.stats()["requests_done"]
              == 8, "all 8 accepted")
        stopper = threading.Thread(target=srv.stop)
        stopper.start()
        _wait(lambda: eng.health()["draining"], "the drain flag")
        late = _generate(srv, [rows[0]])
        for t in threads:
            t.join(WAIT_S)
        stopper.join(WAIT_S)
    finally:
        srv.kill()
    assert [o[0] for o in out] == [200] * 8
    assert all(len(o[1]["generations"][0]) == MAX_NEW for o in out)
    code, body, hdr = late
    assert code == 503 and int(hdr["Retry-After"]) >= 0
    assert f"DrainingError: {body['error']}" == \
        _reference_draining_text(jd)
    assert eng.health()["status"] == "dead"
    assert eng.stats()["drain_ms"] > 0
    with pytest.raises(RuntimeError):
        eng.submit(np.asarray(rows[0], np.int32))


def test_stop_without_drain_fails_fast(exports):
    d, _ = exports
    srv = PredictServer(d, device="cpu", prefix_cache=False).start()
    # slower than the listener's shutdown (serve_forever polls every 0.5 s)
    _slow_decode(srv, 0.3)
    got = {}
    th = threading.Thread(target=lambda: got.update(
        r=_generate(srv, [_prompts(1, seed=7)[0]])))
    th.start()
    _wait(lambda: srv.engine.health()["inflight"] == 1, "a live request")
    srv.stop(drain=False)
    th.join(WAIT_S)
    assert got["r"][0] == 500 and "stopped" in got["r"][1]["error"]


# ---------------------------------------------------------------------------
# seams, incidents, parity, request log
# ---------------------------------------------------------------------------

def test_http_read_seam(exports):
    d, _ = exports
    with PredictServer(d, device="cpu") as srv:
        faults.install(faults.parse_spec("http.read:step=1"))
        first = _generate(srv, _prompts(1))
        second = _generate(srv, _prompts(1))
    assert first[0] == 400 and "injected fault http.read" in \
        first[1]["error"]
    assert second[0] == 200


def test_stall_writes_one_incident_bundle(exports, tmp_path):
    d, _ = exports
    inc = str(tmp_path / "inc")
    with PredictServer(d, device="cpu", incident_dir=inc) as srv:
        _generate(srv, _prompts(1))                       # warm
        srv.engine.set_stall_after(0.2)
        faults.install(faults.parse_spec(
            "engine.decode_step:step=2:stall=1.0"))
        got = {}
        th = threading.Thread(target=lambda: got.update(
            r=_generate(srv, _prompts(1, seed=8))))
        th.start()
        polls = []

        def stalled():
            code, h, _ = _call(srv.port, "/healthz")
            polls.append(code)
            return h["status"] == "stalled"

        _wait(stalled, "/healthz stalled", timeout=10)
        th.join(WAIT_S)
        faults.install(None)
        srv.engine.set_stall_after(10.0)
        assert _call(srv.port, "/healthz")[0] == 200
        _, metrics, _ = _call(srv.port, "/metrics")
    assert got["r"][0] == 200 and polls[-1] == 503
    bundles = [f for f in os.listdir(inc) if "watchdog_stall" in f]
    assert len(bundles) == 1
    with open(os.path.join(inc, bundles[0])) as f:
        bundle = json.load(f)
    assert bundle["health"]["status"] == "stalled"
    assert bundle["config"]["stall_after_s"] == 10.0
    page = prom.parse(metrics)
    assert page["serving_incidents_total"] == 1


def test_armed_and_plain_serving_are_byte_and_dispatch_identical(
        exports, tmp_path):
    d, _ = exports
    rows = _prompts(6, seed=9)
    runs = []
    for kw in ({"metrics": False, "flight_recorder": False},
               {"incident_dir": str(tmp_path / "inc"),
                "history_interval_s": 0.05,
                "request_log": str(tmp_path / "log.jsonl")}):
        with PredictServer(d, device="cpu", **kw) as srv:
            n = _slow_decode(srv, 0.0)
            code, body, _ = _generate(srv, rows)
            assert code == 200
            runs.append((json.dumps(body["generations"]), n["decode"],
                         trace.recorder().enabled))
    (plain, plain_n, plain_ring), (armed, armed_n, armed_ring) = runs
    assert plain == armed and plain_n == armed_n
    assert not plain_ring and armed_ring


def test_request_log_lines(exports, tmp_path):
    d, _ = exports
    path = str(tmp_path / "requests.jsonl")
    with PredictServer(d, device="cpu", request_log=path) as srv:
        assert _generate(srv, _prompts(2, seed=10),
                         headers={"X-Request-Id": "two"})[0] == 200
        assert _generate(srv, _prompts(1, seed=11))[0] == 200
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert [r["event"] for r in lines] == ["generate"] * 3
    assert {"two-0", "two-1"} <= {r["request_id"] for r in lines}
    for r in lines:
        assert {"queue_ms", "prefill_ms", "decode_ms", "tokens"} <= set(r)


def test_cli_takes_the_reference_flags_and_drains_on_sigterm(exports,
                                                             tmp_path):
    d, _ = exports
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m",
            "distributed_tensorflow_example_tpu_torch.serving_http",
            "--export_dir", d, "--port", "0", "--device", "cpu",
            "--scheduler", "auto", "--batch_max_size", "8",
            "--batch_max_wait_ms", "5", "--max_queue", "64",
            "--prefix_cache", "on", "--metrics", "on",
            "--trace_buffer_events", "1024", "--request_log",
            str(tmp_path / "log.jsonl"), "--thread_sanitizer",
            "--default_deadline_ms", "0", "--drain_timeout_s", "30",
            "--spec_tokens", "0", "--prefill_chunk_tokens", "0",
            "--default_priority", "interactive", "--shed_policy", "auto",
            "--stall_after_s", "10", "--flight_recorder", "on",
            "--history_interval_s", "0.5", "--history_samples", "60",
            "--slo_spec", "interactive:p95_ms=10000@0.9",
            "--incident_dir", str(tmp_path / "inc"), "--fault_spec",
            "http.read:p=0.0001", "--fault_seed", "3"]
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving 'gpt' on http://"), line
        assert line.rstrip().endswith(":generate")
        port = int(line.split("http://127.0.0.1:")[1].split("/")[0])
        path = "/v1/models/gpt:generate"
        out = {}
        th = threading.Thread(target=lambda: out.update(r=_call(
            port, path, {"inputs": {"input_ids": [[1, 2, 3]]}}, "POST")))
        th.start()
        th.join(WAIT_S)
        code, metrics, _ = _call(port, "/metrics")
        assert code == 200 and "serving_requests_done_total 1" in metrics
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
    assert out["r"][0] == 200
    assert rc == 0, proc.stderr.read()
    with open(tmp_path / "log.jsonl") as f:
        assert len(f.readlines()) == 1
