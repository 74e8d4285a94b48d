"""A tier-1 smoke of the port's serving chaos soak
(``distributed_tensorflow_example_tpu_torch/experiments/serving_chaos.py``)
on the CPU: every scenario over one shared export (and the tight-pool one),
each held to the port's own undisturbed run; the scenarios again over int8
pools; the CLI; and the ``stall=`` fault rule the wedge drills use."""

import json
import os
import subprocess
import sys

import pytest
import torch

from distributed_tensorflow_example_tpu_torch.experiments import \
    serving_chaos as sc
from distributed_tensorflow_example_tpu_torch.runtime import faults

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=[None, "int8"],
                ids=["bf16_or_f32", "int8"])
def exports(request, tmp_path_factory):
    """(kv_cache_dtype, ample export, tight-pool export, vocab), built
    once a pool dtype."""
    kv = request.param
    sc._RUN.update(device="cpu", kv_cache_dtype=kv)
    d = str(tmp_path_factory.mktemp("ample"))
    vocab = sc.build_chaos_export(d, seed=0)
    tight = str(tmp_path_factory.mktemp("tight"))
    sc.build_chaos_export(tight, seed=0, num_blocks=sc.tight_pool_blocks())
    return kv, d, tight, vocab


@pytest.mark.parametrize("name", list(sc.SCENARIOS))
def test_scenario(exports, name):
    kv, d, tight, vocab = exports
    (res,) = sc.run_scenarios([name], seed=0, export_dir=d, tight_dir=tight,
                              vocab=vocab, device="cpu", kv_cache_dtype=kv)
    assert res["ok"], res["detail"]
    assert res["scenario"] == name and isinstance(res["metrics"], dict)
    assert faults.active() is None              # no registry leaks forward


def test_cli_runs_and_reports(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m",
         "distributed_tensorflow_example_tpu_torch.experiments.serving_chaos",
         "--device", "cpu", "--smoke", "--scenario",
         "flaky_dispatch,drain_under_load"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    assert [r["scenario"] for r in lines[:-1]] == ["flaky_dispatch",
                                                   "drain_under_load"]
    assert lines[-1] == {"summary": True, "scenarios": 2, "failed": 0}
    bad = subprocess.run(
        [sys.executable, "-m",
         "distributed_tensorflow_example_tpu_torch.experiments.serving_chaos",
         "--device", "cpu", "--scenario", "nope"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode == 2 and "unknown scenario" in bad.stderr


def test_stall_rule_sleeps_and_raises_nothing():
    reg = faults.parse_spec("engine.decode_step:step=2:stall=0.05")
    assert reg.rules[0].describe() == "engine.decode_step:step=2:stall=0.05"
    assert reg.raise_if_armed("engine.decode_step") is None      # 1st
    import time
    t0 = time.perf_counter()
    assert reg.raise_if_armed("engine.decode_step") is None      # stalls
    assert time.perf_counter() - t0 >= 0.05
    assert reg.fired == ["engine.decode_step:step=2:stall=0.05@2"]
    for spec in ("engine.decode_step:step=1:stall=0",
                 "ckpt.write:step=1:corrupt=zero:stall=1"):
        with pytest.raises(faults.FaultSpecError):
            faults.parse_spec(spec)
    assert faults.parse_spec("http.read:step=1").rules[0].site == "http.read"
