"""Training hooks, the ``basic_session_run_hooks`` family (an adapted
copy of ``distributed_tensorflow_example_tpu/train/hooks.py``):
:class:`StopAtStepHook`, :class:`LoggingHook`, :class:`StepCounterHook`,
:class:`CheckpointSaverHook` (step- and time-based),
:class:`AnomalyPolicyHook` (halt, skip and rollback), :class:`NanHook`,
:class:`SummaryHook`, :class:`ParamHistogramHook`,
:class:`StepTimingHook`, :class:`ProfilerHook` (``torch.profiler``
Chrome traces) and :class:`PreemptionHook` (SIGTERM: save, then exit).

Every rank runs the hooks; their side effects are the chief's (rank 0),
as in the reference: it alone logs the metrics and the rates, and the
checkpoint manager has it alone write. ``after_step`` may return True to
ask for a stop. Hooks that need metric values declare ``every_steps``;
the trainer reads the device metrics to the host only on steps where
some hook wants them, so the other steps queue without a host sync. The
global-step waiter (a no-op under sync training) is not ported.
"""

from __future__ import annotations

import os
import signal
import tempfile
import time
from typing import Any

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager
from ..obs.trace import span
from ..runtime import distributed
from ..runtime.server import CaptureRequest
from ..utils.logging import get_logger
from ..utils.metrics import MetricsLogger, RateTracker

log = get_logger("hooks")


def _is_chief() -> bool:
    return distributed.process_index() == 0


class Hook:
    every_steps: int = 0      # 0 => never needs materialized metrics

    def begin(self, trainer) -> None: ...
    def after_step(self, trainer, step: int,
                   metrics: dict[str, float] | None) -> bool | None: ...
    def end(self, trainer) -> None: ...

    def wants_metrics(self, step: int) -> bool:
        return self.every_steps > 0 and step % self.every_steps == 0


class LoggingHook(Hook):
    """Log the step's scalar metrics every N steps (LoggingTensorHook
    parity)."""

    def __init__(self, every_steps: int = 100):
        self.every_steps = every_steps

    def after_step(self, trainer, step, metrics):
        if metrics is None or not self.wants_metrics(step) \
                or not _is_chief():
            return
        # a vector metric (MoE-BERT's expert_load) is the JSONL's, not
        # the log line's
        body = " ".join(f"{k}={v:.6g}" for k, v in metrics.items()
                        if np.ndim(v) == 0)
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
        if not self.last_rates or not _is_chief():
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
        # every rank enters save() (its barrier), so the decision to save
        # must be the same on every rank: a wall-clock cadence is not
        if save_secs and distributed.process_count() > 1:
            raise ValueError(
                "save_secs is wall-clock-based and not deterministic across "
                "processes (a rank would wait at the save's barrier for "
                "the others); use save_steps on multi-process runs")

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
        self.manager.wait()        # async writes land before the run ends


class AnomalyPolicyHook(Hook):
    """The ``on_anomaly`` policy: ``halt``, ``skip`` or ``rollback``.

    Detection is on the device (the sync step keeps a cumulative
    ``anomaly_count`` in the state and applies the identity update on a
    non-finite step), so this hook adds no host sync: it reads the count
    at the metrics cadence the LoggingHook already pays. ``halt`` stops
    the run on a new anomaly; ``skip`` keeps training until more than
    ``max_anomalies`` anomalous steps were seen in this run; ``rollback``
    (same budget) asks the trainer to restore the last verified
    checkpoint at or before the last step known clean and replay, so the
    anomalous window is redone rather than kept with its skipped updates.
    """

    def __init__(self, policy: str, max_anomalies: int,
                 every_steps: int = 100):
        if policy not in ("halt", "skip", "rollback"):
            raise ValueError(f"unknown anomaly policy {policy!r}")
        self.policy = policy
        self.max_anomalies = max_anomalies
        self.every_steps = max(1, every_steps)
        self.observed = 0       # device-counter watermark (cumulative)
        self.baseline = 0       # counter value when this run began
        self.last_clean_step = 0

    def begin(self, trainer):
        # the budget covers this run: anomalies a restored checkpoint
        # carries are history
        self.observed = self.baseline = (
            int(trainer.state.anomaly_count)
            if trainer.state is not None else 0)
        self.last_clean_step = int(getattr(trainer, "start_step", 0) or 0)

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
            # every step up to here is finite: a rollback must not land
            # past this point
            self.last_clean_step = step
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
        if self.policy == "skip":
            log.warning("%s Continuing (%d/%d of the anomaly budget "
                        "spent).", self._summary(step, total), total,
                        self.max_anomalies)
            return
        log.warning("%s Requesting rollback to the last verified "
                    "checkpoint at or before clean step %d (%d/%d of the "
                    "anomaly budget spent).", self._summary(step, total),
                    self.last_clean_step, total, self.max_anomalies)
        trainer.request_rollback(before_step=self.last_clean_step)


class NanHook(Hook):
    """Raise on a non-finite loss, NanTensorHook parity: a host sync every
    step, for debugging (``obs.check_nans``)."""

    every_steps = 1

    def after_step(self, trainer, step, metrics):
        loss = (metrics or {}).get("loss")
        if loss is not None and not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss} at step {step}")


class SummaryHook(Hook):
    """Write the step's metrics to the metrics sinks every N steps
    (SummarySaverHook parity): the JSONL takes every metric, vectors as
    lists; TensorBoard takes the scalars. The logger belongs to its
    creator."""

    def __init__(self, metrics_logger: MetricsLogger, every_steps: int = 100):
        self.metrics_logger = metrics_logger
        self.every_steps = every_steps

    def after_step(self, trainer, step, metrics):
        if metrics is None or not self.wants_metrics(step):
            return
        self.metrics_logger.log({"step": step, **metrics})


class ParamHistogramHook(Hook):
    """Parameter histograms every N steps (``tf.summary.histogram`` on the
    trainable variables): summary stats to the JSONL, HistogramProtos to
    TensorBoard. Rank 0 logs: every rank holds the same replica."""

    def __init__(self, metrics_logger: MetricsLogger, every_steps: int):
        self.metrics_logger = metrics_logger
        self.every_steps = every_steps

    def wants_metrics(self, step: int) -> bool:
        return False          # reads trainer.state, never step metrics

    def after_step(self, trainer, step, metrics):
        if self.every_steps <= 0 or step % self.every_steps \
                or not _is_chief():
            return
        from ..utils.pytree import flatten_dict
        for key, leaf in flatten_dict(trainer.state.params).items():
            self.metrics_logger.log_histogram(
                step, "params/" + key,
                leaf.detach().float().cpu().numpy())


class StepTimingHook(Hook):
    """Per-dispatch times (the WorkerCacheLogger analogue): the Trainer
    times each dispatch (one step, or the K steps of one ``multi_step``
    call under ``steps_per_loop`` K) from its call to a
    ``torch.cuda.synchronize`` of the device (``last_dispatch_ms``), and
    every ``every_steps // K`` dispatches this hook writes their
    percentiles and ``steps_per_dispatch`` K to the metrics JSONL. The
    first dispatch (cold caches, allocator growth) is kept out of the
    stats and reported as ``first_dispatch_ms``. Syncing every step drains the
    dispatch queue: opt-in via ``--step_timing``."""

    def __init__(self, metrics_logger: MetricsLogger | None,
                 every_steps: int = 100):
        self.every_steps = every_steps
        self.metrics_logger = metrics_logger
        self._times_ms: list[float] = []
        self._first_ms: float | None = None
        self._cost_logged = False
        self.last_record: dict | None = None

    def after_step(self, trainer, step, metrics):
        dt_ms = getattr(trainer, "last_dispatch_ms", None)
        if dt_ms is None:
            return
        if self._first_ms is None:
            self._first_ms = dt_ms
            return
        self._times_ms.append(dt_ms)
        spd = _steps_per_dispatch(trainer)
        # a cadence in dispatches: with K steps a dispatch, the step
        # count only lands on multiples of K
        if len(self._times_ms) >= max(1, self.every_steps // spd):
            self._emit(trainer, step, spd)

    def _emit(self, trainer, step: int, steps_per_dispatch: int) -> None:
        if not self._times_ms:
            return
        arr = np.asarray(self._times_ms)
        rec: dict[str, Any] = {"step": step, "step_timing_ms": {
            "n": int(arr.size),
            "steps_per_dispatch": steps_per_dispatch,
            "mean": float(arr.mean()),
            "p50": float(np.percentile(arr, 50)),
            "p90": float(np.percentile(arr, 90)),
            "p99": float(np.percentile(arr, 99)),
            "max": float(arr.max()),
            "first_dispatch_ms": float(self._first_ms),
        }}
        if not self._cost_logged:
            # once: the FLOPs of the first step (SyncReplicas.counted_step)
            cost = getattr(trainer.sync, "last_cost_analysis", None)
            if cost:
                rec["step_cost_analysis"] = cost
                self._cost_logged = True
        self.last_record = rec
        self._times_ms.clear()
        if _is_chief():
            log.info("step %d: dispatch p50=%.3fms p99=%.3fms (n=%d)",
                     step, rec["step_timing_ms"]["p50"],
                     rec["step_timing_ms"]["p99"], arr.size)
            if self.metrics_logger:
                self.metrics_logger.log(rec)

    def end(self, trainer):
        # flush the residue, so a short run still yields a record
        self._emit(trainer, int(trainer.state.step),
                   _steps_per_dispatch(trainer))

    def wants_metrics(self, step):
        return False


def _steps_per_dispatch(trainer) -> int:
    """The trainer's steps a dispatch, ``steps_per_loop`` (1 unset)."""
    return max(1, getattr(trainer.config, "steps_per_loop", 1))


#: the name of the zero-length profiler annotation a trace holds for each
#: step it covers (``train_step#<global step>``)
STEP_MARK = "train_step#"


class ProfilerHook(Hook):
    """``torch.profiler`` traces of the captures it is asked for, written
    into ``profile_dir`` as Chrome trace JSON
    (``trace-steps-<start>-<stop>.json``, the profiler starting after
    step ``start`` and stopping after step ``stop``). Each traced step
    leaves a ``train_step#<step>`` annotation in the trace.

    Captures come from one queue. The configured window (start, stop]
    (``--profile_steps``) is queued on rank 0 when the run begins and is
    due from step ``start`` until step ``stop``; ``service`` (a
    :class:`~..runtime.server.ProfilerService`, the ``--profiler_port``
    listener) adds its requests, each due at once for its next N steps.
    Once no trace runs (after a trace stops, the same step), each step
    moves at most one service request into the queue and traces the first
    capture due; a trace's path and the steps
    it really holds go back to the request. Without ``profile_dir`` the
    traces go to a fresh temporary directory."""

    def __init__(self, profile_dir: str | None, start_step: int = 0,
                 stop_step: int = 0, service=None):
        self.profile_dir = profile_dir
        self.service = service
        self._configured = ((start_step, stop_step)
                            if stop_step > start_step else None)
        self._queue: list[CaptureRequest] = []
        self._req: CaptureRequest | None = None   # the capture in flight
        self._prof = None
        self._window = (0, 0)       # (start, stop] of the capture in flight
        self._traced = (0, 0)       # its first and last traced step

    def begin(self, trainer):
        if self._configured is not None and _is_chief():
            start, stop = self._configured
            self._queue.append(CaptureRequest(stop - start, start=start))

    def _due(self, step: int) -> CaptureRequest | None:
        """Take the first queued capture due after ``step``; drop a
        window the run has passed."""
        if self.service is not None:
            req = self.service.take()
            if req is not None:
                self._queue.append(req)
        for req in list(self._queue):
            if req.start is None or req.start <= step < req.start + req.steps:
                self._queue.remove(req)
                return req
            if step >= req.start + req.steps:
                self._queue.remove(req)
                req.fail("the run passed the window before it was traced")
        return None

    def _begin(self, trainer, req: CaptureRequest, step: int) -> None:
        start = step if req.start is None else req.start
        acts = [torch.profiler.ProfilerActivity.CPU]
        if trainer.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._req = req
        self._window = (start, start + req.steps)
        self._traced = (step + 1, step)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        req, self._req = self._req, None
        prof.__exit__(None, None, None)
        if self.profile_dir is None:
            self.profile_dir = tempfile.mkdtemp(prefix="profiler-")
        os.makedirs(self.profile_dir, exist_ok=True)
        start, stop = self._window
        path = os.path.join(self.profile_dir,
                            f"trace-steps-{start}-{stop}.json")
        try:
            prof.export_chrome_trace(path)
        except Exception as e:
            req.fail(f"writing the trace failed: {e}")
            raise
        log.info("profiler trace: %s", path)
        first, last = self._traced
        if last < first:
            req.fail("training ended before the capture traced a step")
        else:
            req.finish(path=path, steps=[first, last])

    def after_step(self, trainer, step, metrics):
        if self._prof is not None:
            with torch.profiler.record_function(f"{STEP_MARK}{step}"):
                pass
            self._traced = (self._traced[0], step)
            if step < self._window[1]:
                return
            if trainer.device.type == "cuda":
                torch.cuda.synchronize(trainer.device)
            self._stop()
        req = self._due(step)
        if req is not None:
            self._begin(trainer, req, step)

    def end(self, trainer):
        if self._prof is not None:
            self._stop()
        queued, self._queue = self._queue, []
        for req in queued:
            req.fail("training ended before the capture was taken")

    def wants_metrics(self, step):
        return False


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
