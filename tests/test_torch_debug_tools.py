"""The JAX debug tools' torch counterparts, on the CPU:

- ``--debug_checks`` (the reference's ``checkify.float_checks``): a NaN in
  the step raises ``FloatingPointError`` naming the global step and the
  first non-finite leaf; a clean run ends ``torch.equal`` to one without
  the checks.
- ``--debug_nans`` (the reference's ``jax_debug_nans``): autograd's
  anomaly mode with NaN checks raises on a NaN made in the backward, the
  flash ``autograd.Function``'s outputs included, and is off again after
  the run.
- ``--profiler_port`` (the reference's profiler server): ``POST
  /capture?steps=2`` on the loopback listener writes a trace of 2 steps;
  a busy port only warns.
- ``step_cost_analysis`` under ``--step_timing``: the FLOPs
  ``FlopCounterMode`` counts over one step equal the closed form for the
  MLP exactly, and for GPT-tiny on plain attention to 1%.
"""

import json
import logging
import math
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.config import (
    DataConfig, ObservabilityConfig, OptimizerConfig, TrainConfig)
from distributed_tensorflow_example_tpu_torch.data.mnist import \
    synthetic_mnist
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models.gpt import (GPT,
                                                                 GPTConfig)
from distributed_tensorflow_example_tpu_torch.ops.cuda.flash_attention \
    import flash_attention
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.runtime import server as rserver
from distributed_tensorflow_example_tpu_torch.train.hooks import (
    STEP_MARK, ProfilerHook)
from distributed_tensorflow_example_tpu_torch.train.optimizers import \
    make_optimizer
from distributed_tensorflow_example_tpu_torch.train.trainer import Trainer

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

WAIT_S = 60                     # every HTTP and thread wait's bound
MLP_ARGV = ["--model", "mlp", "--device", "cpu", "--batch_size", "32",
            "--learning_rate", "0.1", "--log_every_steps", "0"]


def _mlp_trainer(cfg, data):
    return Trainer(get_model("mlp", cfg), cfg,
                   {"x": data["train_x"], "y": data["train_y"]},
                   device="cpu", process_index=0, num_processes=1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _PortWarnings:
    """The port's log records at WARNING and above (its ``dtx`` logger
    does not propagate to the root logger)."""

    def __enter__(self):
        self.records = []
        self._h = logging.Handler(logging.WARNING)
        self._h.emit = self.records.append
        logging.getLogger("dtx").addHandler(self._h)
        return self.records

    def __exit__(self, *exc):
        logging.getLogger("dtx").removeHandler(self._h)


# ---------------------------------------------------------------------------
# --debug_checks
# ---------------------------------------------------------------------------

def test_debug_checks_names_the_step_and_the_leaf_of_a_step_nan():
    """``step.nan`` poisons step 3's batch: the checked step raises naming
    step 3, the loss first, then the gradient leaves."""
    with pytest.raises(FloatingPointError) as ei:
        tcli.main(MLP_ARGV + ["--train_steps", "5", "--debug_checks",
                              "--fault_spec", "step.nan:step=3"])
    msg = str(ei.value)
    assert "at step 3 in loss" in msg
    assert "grads/fc1/kernel" in msg and "4 of 4 gradients" in msg


def test_debug_checks_names_the_first_non_finite_gradient():
    """A finite loss whose gradient is NaN in one leaf only (sqrt at 0,
    times 0): the check names that leaf by its pytree path."""

    def loss_fn(params, extras, batch, gen):
        a, b = params["a"]["w"], params["b"]["w"]
        loss = (a * batch["x"]).sum() + (torch.sqrt(b) * 0.0).sum()
        return loss, ({"aux": loss.detach() * 2}, extras)

    sync = SyncReplicas(loss_fn, make_optimizer(OptimizerConfig(
        name="sgd", learning_rate=0.1)), device="cpu", debug_checks=True)
    state = sync.init(lambda g: {"a": {"w": torch.ones(3)},
                                 "b": {"w": torch.zeros(2)}})
    with pytest.raises(FloatingPointError,
                       match=r"at step 1 in grads/b/w \(1 of 4 leaves"):
        sync.step(state, {"x": np.ones(3, np.float32)})


def test_debug_checks_clean_run_equals_an_unchecked_one():
    data = synthetic_mnist(num_train=320, num_test=32, seed=0)
    finals = []
    for checks in (False, True):
        cfg = TrainConfig(model="mlp", train_steps=6,
                          data=DataConfig(batch_size=32, seed=1),
                          optimizer=OptimizerConfig(name="sgd",
                                                    learning_rate=0.1),
                          obs=ObservabilityConfig(log_every_steps=0,
                                                  debug_checks=checks))
        with _mlp_trainer(cfg, data) as t:
            assert t.sync.debug_checks is checks
            state, _ = t.train()
        finals.append(state.params)
    for k in ("fc1", "fc2"):
        for n in ("kernel", "bias"):
            assert torch.equal(finals[0][k][n], finals[1][k][n])


# ---------------------------------------------------------------------------
# --debug_nans
# ---------------------------------------------------------------------------

def test_debug_nans_raises_on_a_backward_nan_and_is_restored():
    x = torch.zeros(3, requires_grad=True)
    with tcli.debug_nans(True):
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
        # a finite forward whose backward makes a NaN (0 / 0)
        y = (torch.sqrt(x) * 0.0).sum()
        with pytest.raises(RuntimeError, match="returned nan values"):
            y.backward()
    assert not torch.is_anomaly_enabled()
    with tcli.debug_nans(False):
        assert not torch.is_anomaly_enabled()


def test_debug_nans_checks_the_flash_functions_backward():
    """A NaN cotangent into the flash attention ``autograd.Function``
    (its plain versions on the CPU): its own backward outputs are
    checked, and the error names it."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 2, 64, generator=g, requires_grad=True)
               for _ in range(3))
    out = flash_attention(q, k, v, causal=True)
    out.register_hook(lambda grad: torch.full_like(grad, math.nan))
    with tcli.debug_nans(True):
        with pytest.raises(RuntimeError,
                           match="FlashAttentionBackward.*nan values"):
            out.sum().backward()
    assert not torch.is_anomaly_enabled()


def test_cli_debug_nans_raises_on_a_step_nan_and_runs_clean():
    with pytest.raises(RuntimeError, match="returned nan values"):
        tcli.main(MLP_ARGV + ["--train_steps", "4", "--debug_nans",
                              "--fault_spec", "step.nan:step=2"])
    assert not torch.is_anomaly_enabled()
    assert tcli.main(MLP_ARGV + ["--train_steps", "3",
                                 "--debug_nans"]) == 0
    assert not torch.is_anomaly_enabled()


# ---------------------------------------------------------------------------
# --profiler_port
# ---------------------------------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=WAIT_S) as r:
        return json.loads(r.read())


def _post(port, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.loads(r.read())


def test_profiler_port_capture_traces_two_steps(tmp_path):
    port = _free_port()
    prof = str(tmp_path / "prof")
    result = {}

    def run():
        result["rc"] = tcli.main(MLP_ARGV + [
            "--train_steps", "600", "--profiler_port", str(port),
            "--profile_dir", prof])

    t = threading.Thread(target=run)
    t.start()
    try:
        deadline = time.monotonic() + WAIT_S
        while True:
            try:
                assert _get(port, "/healthz") == {"status": "live"}
                break
            except urllib.error.URLError:
                assert time.monotonic() < deadline, "listener never came up"
                time.sleep(0.005)
        got = _post(port, "/capture?steps=2&timeout_s=60")
    finally:
        t.join(WAIT_S)
    assert result["rc"] == 0
    first, last = got["steps"]
    assert last - first == 1
    assert os.path.dirname(got["path"]) == prof
    with open(got["path"]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {n for n in names if n.startswith(STEP_MARK)} \
        == {f"{STEP_MARK}{first}", f"{STEP_MARK}{last}"}
    assert any("mm" in n for n in names)
    # the listener went down with the run
    with pytest.raises(urllib.error.URLError):
        _get(port, "/healthz")


def test_profiler_port_busy_only_warns():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen()
        busy = s.getsockname()[1]
        with _PortWarnings() as records:
            assert tcli.main(MLP_ARGV + ["--train_steps", "2",
                                         "--profiler_port",
                                         str(busy)]) == 0
    assert any("profiler service failed to start" in r.getMessage()
               for r in records)


class _Requests:
    """A stand-in service: hands out the given capture requests in turn."""

    def __init__(self, *reqs):
        self.reqs = list(reqs)

    def take(self):
        return self.reqs.pop(0) if self.reqs else None


class _CpuTrainer:
    device = torch.device("cpu")


def test_profiler_hook_one_queue_reports_the_steps_traced(tmp_path):
    """The configured window and the service's requests share one queue:
    a request that arrives first is traced first, the window follows
    while it is still due, and a capture the run ends inside reports the
    steps it really holds; one still queued at the end fails."""
    first = rserver.CaptureRequest(2)
    cut = rserver.CaptureRequest(50)
    never = rserver.CaptureRequest(1)
    hook = ProfilerHook(str(tmp_path), 3, 6,
                        service=_Requests(first, cut, never))
    tr = _CpuTrainer()
    hook.begin(tr)
    for step in range(1, 9):
        hook.after_step(tr, step, None)
    hook.end(tr)
    # steps 2-3 for the request; the window (3, 6] next, from step 4;
    # then the 50-step request from step 7, cut at step 8 by the end
    assert first.result["steps"] == [2, 3]
    assert cut.result["steps"] == [7, 8]
    assert os.path.basename(cut.result["path"]) == "trace-steps-6-56.json"
    with open(os.path.join(str(tmp_path), "trace-steps-3-6.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {n for n in names if n.startswith(STEP_MARK)} \
        == {f"{STEP_MARK}{s}" for s in (4, 5, 6)}
    assert never.result is None and "ended" in never.error


def test_profiler_service_refusals():
    svc = rserver.ProfilerService(0)
    try:
        for path, code in (("/capture?steps=0", 400),
                           ("/capture?steps=x", 400), ("/nope", 404),
                           ("/capture?steps=1&timeout_s=0.05", 504)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(svc.port, path)
            assert ei.value.code == code, path
        # a request still waiting when the service closes fails (409)
        codes = []

        def waiter():
            try:
                _post(svc.port, "/capture?steps=1&timeout_s=30")
            except urllib.error.HTTPError as e:
                codes.append(e.code)

        w = threading.Thread(target=waiter)
        w.start()
        deadline = time.monotonic() + WAIT_S
        while not svc._pending and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        svc.close()
    w.join(WAIT_S)
    assert codes == [409]


# ---------------------------------------------------------------------------
# step_cost_analysis
# ---------------------------------------------------------------------------

def test_step_cost_analysis_mlp_flops_exact(tmp_path):
    """784 -> 100 -> 10 at batch 64: the forward's two GEMMs, both
    weight gradients, and the input gradient of the second layer only
    (the images need none)."""
    metrics = str(tmp_path / "m.jsonl")
    data = synthetic_mnist(num_train=640, num_test=64, seed=0)
    b = 64
    cfg = TrainConfig(model="mlp", train_steps=3,
                      data=DataConfig(batch_size=b, seed=3),
                      optimizer=OptimizerConfig(name="sgd",
                                                learning_rate=0.1),
                      obs=ObservabilityConfig(log_every_steps=0,
                                              metrics_path=metrics,
                                              step_timing=True))
    with _mlp_trainer(cfg, data) as t:
        t.train()
        flops = t.sync.last_cost_analysis["flops"]
    want = 2 * b * (2 * 784 * 100 + 2 * 100 * 10 + 100 * 10)
    assert flops == want
    recs = [json.loads(line) for line in open(metrics)]
    cost = [r["step_cost_analysis"] for r in recs
            if "step_cost_analysis" in r]
    assert cost == [{"flops": float(want)}]


def test_step_cost_analysis_gpt_tiny_plain_attention():
    """GPT-tiny, plain attention, [2, 64]: three times the forward's
    matmul FLOPs (projections, both attention products over all S²
    pairs, FFN, LM head), to 1%."""
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    model = GPT(cfg)
    sync = SyncReplicas(model.loss, make_optimizer(OptimizerConfig(
        name="adamw", learning_rate=1e-3)), device="cpu")
    state = sync.init(model.init)
    bsz, s = 2, 64
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (bsz, s))
    sync.counted_step(state, {"input_ids": ids.astype(np.int64),
                              "attention_mask": np.ones((bsz, s), np.int64)})
    h, i, v, n = cfg.hidden, cfg.intermediate, cfg.vocab_size, bsz * s
    fwd = cfg.layers * (2 * n * h * 4 * h + 2 * 2 * bsz * s * s * h
                        + 2 * 2 * n * h * i) + 2 * n * h * v
    assert sync.last_cost_analysis["flops"] == pytest.approx(3 * fwd,
                                                             rel=0.01)
