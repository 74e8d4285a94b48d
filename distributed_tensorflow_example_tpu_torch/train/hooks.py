"""Training hooks, the ``basic_session_run_hooks`` family (an adapted
copy of ``distributed_tensorflow_example_tpu/train/hooks.py``):
:class:`StopAtStepHook`, :class:`LoggingHook`, :class:`StepCounterHook`,
:class:`CheckpointSaverHook` (step- and time-based),
:class:`AnomalyPolicyHook` (halt and skip), :class:`NanHook` and
:class:`PreemptionHook` (SIGTERM: save, then exit).

One process, which is the chief. ``after_step`` may return True to ask
for a stop. Hooks that need metric values declare ``every_steps``; the
trainer reads the device metrics to the host only on steps where some
hook wants them, so the other steps queue without a host sync. The
summary, histogram, profiler, step-timing and global-step-waiter hooks
arrive with slice A3c.
"""

from __future__ import annotations

import signal
import time
from typing import Any

import numpy as np

from ..ckpt.checkpoint import CheckpointManager
from ..obs.trace import span
from ..utils.logging import get_logger
from ..utils.metrics import MetricsLogger, RateTracker

log = get_logger("hooks")


class Hook:
    every_steps: int = 0      # 0 => never needs materialized metrics

    def begin(self, trainer) -> None: ...
    def after_step(self, trainer, step: int,
                   metrics: dict[str, float] | None) -> bool | None: ...
    def end(self, trainer) -> None: ...

    def wants_metrics(self, step: int) -> bool:
        return self.every_steps > 0 and step % self.every_steps == 0


class LoggingHook(Hook):
    """Log the step's metrics every N steps (LoggingTensorHook parity)."""

    def __init__(self, every_steps: int = 100):
        self.every_steps = every_steps

    def after_step(self, trainer, step, metrics):
        if metrics is None or not self.wants_metrics(step):
            return
        body = " ".join(f"{k}={v:.6g}" for k, v in metrics.items())
        log.info("step %d: %s", step, body)


class StopAtStepHook(Hook):
    def __init__(self, last_step: int):
        self.last_step = last_step

    def after_step(self, trainer, step, metrics):
        return step >= self.last_step


class StepCounterHook(Hook):
    """steps/sec and examples/sec(/chip) every N steps, with the learning
    rate beside them."""

    def __init__(self, every_steps: int = 100, batch_size: int = 0,
                 metrics_logger: MetricsLogger | None = None):
        self.every_steps = every_steps
        self.tracker = RateTracker(batch_size)
        self.metrics_logger = metrics_logger
        self.last_rates: dict[str, float] = {}

    def begin(self, trainer):
        self.tracker.start(int(trainer.start_step))

    def after_step(self, trainer, step, metrics):
        if self.every_steps <= 0 or step % self.every_steps:
            return
        self.last_rates = self.tracker.rates(step)
        if not self.last_rates:
            return
        lr = getattr(trainer, "learning_rate_at", None)
        if lr is not None:
            self.last_rates["learning_rate"] = lr(step)
        log.info("step %d: %.1f steps/s, %.1f examples/s/chip", step,
                 self.last_rates["steps_per_sec"],
                 self.last_rates.get("examples_per_sec_per_chip", 0.0))
        if self.metrics_logger:
            self.metrics_logger.log({"step": step, **self.last_rates})

    def wants_metrics(self, step):
        return False          # wall-clock rates: no device sync


class CheckpointSaverHook(Hook):
    """Save every N steps and/or T seconds; always saves at the end of a
    run that advanced."""

    def __init__(self, manager: CheckpointManager, *,
                 save_steps: int = 0, save_secs: float = 0.0):
        self.manager = manager
        self.save_steps = save_steps
        self.save_secs = save_secs
        self._last_save_t = time.time()
        self._last_saved_step: int | None = None

    def _due(self, step: int) -> bool:
        if self.save_steps and step % self.save_steps == 0:
            return True
        return bool(self.save_secs
                    and time.time() - self._last_save_t >= self.save_secs)

    def _save(self, trainer, step: int) -> None:
        """One save, on the trainer's checkpoint trace lane and counted in
        its registry."""
        with span("checkpoint_save", process="training",
                  lane="checkpoint", step=step):
            self.manager.save(trainer.state, step)
        reg = getattr(trainer, "registry", None)
        if reg is not None:
            reg.counter("train_checkpoints_saved_total").inc()

    def after_step(self, trainer, step, metrics):
        if self._due(step):
            self._save(trainer, step)
            self._last_saved_step = step
            self._last_save_t = time.time()

    def end(self, trainer):
        # a run that never advanced saves nothing: a fresh-init ckpt-0
        # from a failed launch would hijack the next run's restore
        step = int(trainer.state.step)
        if step != trainer.start_step and self._last_saved_step != step:
            self._save(trainer, step)
            self._last_saved_step = step


class AnomalyPolicyHook(Hook):
    """The ``on_anomaly`` policy: ``halt`` or ``skip``.

    Detection is on the device (the sync step keeps a cumulative
    ``anomaly_count`` in the state and applies the identity update on a
    non-finite step), so this hook adds no host sync: it reads the count
    at the metrics cadence the LoggingHook already pays. ``halt`` stops
    the run on a new anomaly; ``skip`` keeps training until more than
    ``max_anomalies`` anomalous steps were seen in this run. Rollback
    arrives with slice A3c.
    """

    def __init__(self, policy: str, max_anomalies: int,
                 every_steps: int = 100):
        if policy == "rollback":
            raise NotImplementedError("anomaly policy 'rollback' arrives "
                                      "with slice A3c")
        if policy not in ("halt", "skip"):
            raise ValueError(f"unknown anomaly policy {policy!r}")
        self.policy = policy
        self.max_anomalies = max_anomalies
        self.every_steps = max(1, every_steps)
        self.observed = 0       # device-counter watermark (cumulative)
        self.baseline = 0       # counter value when this run began

    def begin(self, trainer):
        # the budget covers this run: anomalies a restored checkpoint
        # carries are history
        self.observed = self.baseline = (
            int(trainer.state.anomaly_count)
            if trainer.state is not None else 0)

    def _summary(self, step: int, total: int) -> str:
        return (f"anomaly policy {self.policy!r}: {total} anomalous "
                f"step(s) (non-finite loss or grad-norm) observed by "
                f"step {step}; every one was excluded from the training "
                "state by the on-device identity update. Rerun with "
                "--check_nans to find the exact step.")

    def after_step(self, trainer, step, metrics):
        if metrics is None or not self.wants_metrics(step):
            return
        count = int(metrics.get("anomaly_count", 0))
        reg = getattr(trainer, "registry", None)
        if reg is not None:
            reg.gauge("train_anomaly_count").set(count)
        if count <= self.observed:
            return
        self.observed = count
        total = count - self.baseline
        if self.policy == "halt":
            log.error("%s — halting (state holds the last finite "
                      "update).", self._summary(step, total))
            return True
        if total > self.max_anomalies:
            log.error("%s Budget --max_anomalies=%d EXCEEDED — halting.",
                      self._summary(step, total), self.max_anomalies)
            return True
        log.warning("%s Continuing (%d/%d of the anomaly budget spent).",
                    self._summary(step, total), total, self.max_anomalies)


class NanHook(Hook):
    """Raise on a non-finite loss, NanTensorHook parity: a host sync every
    step, for debugging (``obs.check_nans``)."""

    every_steps = 1

    def after_step(self, trainer, step, metrics):
        loss = (metrics or {}).get("loss")
        if loss is not None and not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss} at step {step}")


class PreemptionHook(Hook):
    """SIGTERM/SIGINT: finish the step in flight, stop the loop, and let
    ``CheckpointSaverHook.end()`` write the last checkpoint; a second
    signal restores the previous handler and re-raises. Inert when the
    trainer runs off the main thread (no signal handlers there)."""

    signals = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.stop_requested = False
        self._prev: dict[int, Any] = {}

    def begin(self, trainer):
        self.stop_requested = False

        def handler(signum, frame):
            if self.stop_requested:
                signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
                log.warning("second signal %d: restoring default "
                            "handling", signum)
                signal.raise_signal(signum)
                return
            log.warning("signal %d: stopping at the next step boundary "
                        "(checkpoint will be written); send again to "
                        "force", signum)
            self.stop_requested = True

        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, handler)
        except ValueError:
            self.end(trainer)       # not the main thread: stay inert

    def after_step(self, trainer, step, metrics):
        return self.stop_requested or None

    def end(self, trainer):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
