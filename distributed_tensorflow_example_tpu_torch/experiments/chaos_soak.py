"""Training chaos soak on the port: seeded kill, corrupt, NaN and flaky-IO
scenarios with asserted recovery invariants (a port copy of
``experiments/chaos_soak.py``, driving the port's ``Trainer``).

Each scenario runs real Trainers of the MNIST MLP through a deterministic
failure and asserts the self-healing contract:

- ``kill_resume``     — a run stopped at step K, restarted to N: the final
                        params match an uninterrupted run's (exact resume
                        through the verified restore).
- ``corrupt_latest``  — the newest checkpoint file truncated on disk (and,
                        apart, zero-filled): a restart restores the
                        previous valid step.
- ``nan_skip``        — an injected NaN batch under ``on_anomaly=skip``:
                        the clean run's final step, every logged loss
                        finite, anomaly_count == 1.
- ``nan_rollback``    — an injected divergence under
                        ``on_anomaly=rollback``: the run restores the last
                        clean checkpoint, replays, and its final params
                        match the uninterrupted run's.
- ``flaky_io``        — loader faults at p=0.2 under the bounded retry and
                        backoff: the run completes with no anomaly.
- ``budget_halt``     — more injected NaN steps than ``max_anomalies``:
                        the run halts early.
- ``torn_write``      — a torn checkpoint write (``corrupt=truncate``): a
                        restart falls back past the damaged file to the
                        newest valid one.

One difference from the reference: its scenarios train one process over
a mesh of 4 data-parallel devices; the port trains one replica a rank,
so each scenario here is one rank (the same global batch of 64, on one
device). The N-rank path has its own tests.

The Trainers run on ``--device`` (the card by default; ``cpu`` runs
without a GPU).

Usage::

    python -m distributed_tensorflow_example_tpu_torch.experiments.\\
chaos_soak [--scenario all] [--seed 0] [--steps 20] [--device cpu]

Prints one JSON line per scenario, ``{"scenario", "ok", "detail"}``, and
exits nonzero if any scenario fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager
from ..config import (CheckpointConfig, DataConfig, MeshShape,
                      ObservabilityConfig, OptimizerConfig, TrainConfig)
from ..data.mnist import synthetic_mnist
from ..models import get_model
from ..train import hooks as hooks_lib
from ..train.trainer import Trainer
from ..utils.pytree import flatten_dict


def make_config(*, steps: int, seed: int, ckpt_dir: str | None = None,
                save_steps: int = 0, on_anomaly: str = "halt",
                max_anomalies: int = 10, fault_spec: str = "",
                log_every: int = 5) -> TrainConfig:
    return TrainConfig(
        model="mlp", train_steps=steps, mesh=MeshShape(data=-1),
        data=DataConfig(batch_size=64, seed=seed + 1),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.1),
        checkpoint=CheckpointConfig(directory=ckpt_dir,
                                    save_steps=save_steps),
        obs=ObservabilityConfig(log_every_steps=log_every),
        on_anomaly=on_anomaly, max_anomalies=max_anomalies,
        fault_spec=fault_spec, seed=seed)


class LossStream(hooks_lib.Hook):
    """Every step's loss on the host (forces per-step metrics: a test
    instrument, not a production pattern)."""

    every_steps = 1

    def __init__(self):
        self.losses: list[float] = []

    def after_step(self, trainer, step, metrics):
        if metrics is not None:
            self.losses.append(float(metrics["loss"]))


class Soak:
    """The scenarios' shared inputs: the data, the seed, the step count,
    the device and a scratch directory for their checkpoints."""

    def __init__(self, data: dict, seed: int, steps: int, device: str,
                 work_dir: str):
        self.data, self.seed, self.steps = data, seed, steps
        self.device, self.work_dir = device, work_dir

    def ckpt_dir(self, name: str) -> str:
        return tempfile.mkdtemp(prefix=f"chaos_{name}_", dir=self.work_dir)

    def trainer(self, cfg: TrainConfig, hooks=None) -> Trainer:
        return Trainer(get_model("mlp", cfg), cfg,
                       {"x": self.data["train_x"], "y": self.data["train_y"]},
                       device=self.device, process_index=0,
                       num_processes=1, hooks=hooks)

    def run(self, cfg: TrainConfig, hooks=None):
        with self.trainer(cfg, hooks) as trainer:
            return trainer.train()

    def restart_step(self, cfg: TrainConfig) -> int:
        """The step a restart on ``cfg``'s directory resumes from."""
        with self.trainer(cfg) as trainer:
            trainer.initialize()
            return trainer.start_step


def host_params(state) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy()
            for k, v in flatten_dict(state.params).items()}


def assert_params_equal(a, b, what: str, rtol=1e-6, atol=1e-7) -> None:
    ha, hb = host_params(a), host_params(b)
    assert sorted(ha) == sorted(hb), (sorted(ha), sorted(hb))
    for k in ha:
        np.testing.assert_allclose(ha[k], hb[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def scenario_kill_resume(s: Soak) -> str:
    steps = s.steps
    ref_state, _ = s.run(make_config(steps=steps, seed=s.seed))
    d = s.ckpt_dir("kill")
    s.run(make_config(steps=steps // 2, seed=s.seed, ckpt_dir=d,
                      save_steps=5))                   # the "killed" run
    state, summary = s.run(make_config(steps=steps, seed=s.seed,
                                       ckpt_dir=d, save_steps=5))
    assert summary["final_step"] == steps, summary["final_step"]
    assert_params_equal(state, ref_state, "kill/resume parity")
    return f"resumed at {steps // 2}, parity at {steps}"


def _damage(path: str, mode: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if mode == "truncate":
            f.truncate(max(1, size // 2))
        else:
            f.seek(size // 3)
            f.write(b"\0" * max(1, size // 3))


def scenario_corrupt_latest(s: Soak) -> str:
    details = []
    for mode in ("truncate", "zero"):
        d = s.ckpt_dir(f"corrupt_{mode}")
        cfg = make_config(steps=s.steps, seed=s.seed, ckpt_dir=d,
                          save_steps=5)
        s.run(cfg)
        mgr = CheckpointManager(d)
        latest = mgr.latest_step()
        _damage(mgr.checkpoint_path(latest), mode)
        # the restart falls back to the previous valid step
        start = s.restart_step(cfg)
        assert 0 < start < latest, (start, latest)
        details.append(f"{mode}: {latest}->{start}")
    return "; ".join(details)


def scenario_nan_skip(s: Soak) -> str:
    bad_step = s.steps // 2 + 1
    stream = LossStream()
    _, ref = s.run(make_config(steps=s.steps, seed=s.seed))
    _, summary = s.run(
        make_config(steps=s.steps, seed=s.seed, on_anomaly="skip",
                    fault_spec=f"step.nan:step={bad_step}"),
        hooks=[stream])
    assert summary["final_step"] == ref["final_step"], summary["final_step"]
    assert all(np.isfinite(v) for v in stream.losses), stream.losses
    count = int(summary["final_metrics"]["anomaly_count"])
    assert count == 1, count
    return (f"NaN at step {bad_step} skipped; {len(stream.losses)} finite "
            "losses")


def scenario_nan_rollback(s: Soak) -> str:
    bad_step = s.steps // 2 + 1
    ref_state, _ = s.run(make_config(steps=s.steps, seed=s.seed))
    d = s.ckpt_dir("rollback")
    state, summary = s.run(
        make_config(steps=s.steps, seed=s.seed, ckpt_dir=d, save_steps=5,
                    on_anomaly="rollback",
                    fault_spec=f"step.nan:step={bad_step}"))
    assert summary["final_step"] == s.steps, summary["final_step"]
    assert int(summary["final_metrics"]["anomaly_count"]) == 1
    # replaying the repaired window reaches the final params of a run
    # that never saw the fault
    assert_params_equal(state, ref_state, "rollback divergence repair")
    return f"NaN at {bad_step} rolled back + replayed to parity"


def scenario_flaky_io(s: Soak) -> str:
    _, summary = s.run(make_config(steps=s.steps, seed=s.seed,
                                   on_anomaly="skip",
                                   fault_spec="loader.next:p=0.2"))
    assert summary["final_step"] == s.steps, summary["final_step"]
    assert int(summary["final_metrics"]["anomaly_count"]) == 0
    return f"{s.steps} steps through p=0.2 loader faults (retried)"


def scenario_budget_halt(s: Soak) -> str:
    spec = ";".join(f"step.nan:step={i}" for i in range(2, s.steps, 2))
    _, summary = s.run(make_config(steps=s.steps, seed=s.seed,
                                   on_anomaly="skip", max_anomalies=2,
                                   log_every=2, fault_spec=spec))
    assert summary["final_step"] < s.steps, \
        f"budget never halted ({summary['final_step']})"
    count = int(summary["final_metrics"]["anomaly_count"])
    assert count > 2, count
    return (f"halted at step {summary['final_step']} after {count} "
            "anomalies (budget 2)")


def scenario_torn_write(s: Soak) -> str:
    d = s.ckpt_dir("torn")
    # the LAST ring write lands torn; earlier ones are whole (no extra
    # end-of-run save: the cadence already saved the final step)
    n_saves = s.steps // 5
    s.run(make_config(steps=s.steps, seed=s.seed, ckpt_dir=d, save_steps=5,
                      fault_spec=f"ckpt.write:step={n_saves}:"
                                 "corrupt=truncate"))
    start = s.restart_step(make_config(steps=s.steps, seed=s.seed,
                                       ckpt_dir=d, save_steps=5))
    assert 0 < start < s.steps, (start, s.steps)
    return f"torn final write; restart fell back to step {start}"


SCENARIOS = {
    "kill_resume": scenario_kill_resume,
    "corrupt_latest": scenario_corrupt_latest,
    "nan_skip": scenario_nan_skip,
    "nan_rollback": scenario_nan_rollback,
    "flaky_io": scenario_flaky_io,
    "budget_halt": scenario_budget_halt,
    "torn_write": scenario_torn_write,
}


def run_scenarios(names: list[str], *, seed: int = 0, steps: int = 20,
                  device: str | None = None) -> list[dict]:
    """Run ``names`` in order; one ``{"scenario", "ok", "detail"}`` each
    (a failed invariant is a result, not an exception)."""
    data = synthetic_mnist(num_train=640, num_test=64, seed=seed)
    out = []
    with tempfile.TemporaryDirectory(prefix="chaos_soak_") as work:
        soak = Soak(data, seed, steps, device or "cuda", work)
        for name in names:
            try:
                detail = SCENARIOS[name](soak)
                out.append({"scenario": name, "ok": True,
                            "detail": detail})
            except Exception as e:      # a failed invariant is the signal
                out.append({"scenario": name, "ok": False,
                            "detail": f"{type(e).__name__}: {e}"})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="all",
                    help="comma-separated scenario names, or 'all': "
                         + ", ".join(SCENARIOS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20,
                    help="training steps per scenario run (>= 10)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the Trainers (cpu runs without a GPU)")
    args = ap.parse_args(argv)
    names = (list(SCENARIOS) if args.scenario == "all"
             else [s.strip() for s in args.scenario.split(",") if s.strip()])
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        ap.error(f"unknown scenario(s) {unknown}; have {list(SCENARIOS)}")
    if args.steps < 10:
        ap.error("--steps must be >= 10 (scenarios inject mid-run)")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: CUDA is not available (pass --device cpu)")
    results = run_scenarios(names, seed=args.seed, steps=args.steps,
                            device=args.device)
    for r in results:
        print(json.dumps(r), flush=True)
    return 1 if any(not r["ok"] for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
