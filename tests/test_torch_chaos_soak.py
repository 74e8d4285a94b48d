"""The port's training chaos soak (``experiments/chaos_soak.py``) on the
CPU: each of the reference's 7 scenarios passes its invariant (exact
resume, fallback past a corrupt or torn checkpoint, NaN skip, rollback to
the uninterrupted run's params, retried loader faults, the anomaly
budget's halt), one rank where the reference's uses a 4-device mesh;
the module runs as ``python -m`` prints one JSON line per scenario.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from distributed_tensorflow_example_tpu_torch.experiments import chaos_soak

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_scenarios_are_the_references():
    assert list(chaos_soak.SCENARIOS) == [
        "kill_resume", "corrupt_latest", "nan_skip", "nan_rollback",
        "flaky_io", "budget_halt", "torn_write"]


@pytest.mark.parametrize("name", list(chaos_soak.SCENARIOS))
def test_scenario_passes_on_the_cpu(name):
    (res,) = chaos_soak.run_scenarios([name], seed=0, steps=20,
                                      device="cpu")
    assert res["scenario"] == name
    assert res["ok"], res["detail"]


def test_module_prints_a_line_per_scenario_and_checks_its_flags():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m",
         "distributed_tensorflow_example_tpu_torch.experiments.chaos_soak",
         "--device", "cpu", "--scenario", "nan_skip,torn_write",
         "--steps", "10"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert [r["scenario"] for r in lines] == ["nan_skip", "torn_write"]
    assert all(r["ok"] for r in lines)
    for argv in (["--scenario", "nope"], ["--steps", "5"]):
        with pytest.raises(SystemExit):
            chaos_soak.main(["--device", "cpu"] + argv)
