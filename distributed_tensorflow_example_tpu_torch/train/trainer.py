"""Trainer: the Supervisor / MonitoredTrainingSession replacement (an
adapted copy of ``distributed_tensorflow_example_tpu/train/trainer.py``,
one process on one device).

- restore-or-init          -> :func:`~..ckpt.checkpoint.restore_or_init`
- Supervisor threads       -> hooks (``train/hooks.py``)
- Coordinator should_stop  -> a hook returning True / StopAtStepHook
- per-step feed_dict       -> ShardedLoader batches, copied to the device

The loop queues steps without a host sync: device metrics are read to
the host only on steps where some hook asks (``wants_metrics``). More
than one replica, ``steps_per_loop > 1`` and rollback arrive with slice
A3c and raise; early stop, best-checkpoint tracking, warm start and the
summary, histogram, profiler, step-timing and trace sinks have no config
field in the port yet.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Iterator

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager, restore_or_init
from ..config import MeshShape, TrainConfig, anomaly_settings
from ..data.loader import make_loader
from ..obs.registry import Registry
from ..obs.trace import add_span
from ..parallel.sync_replicas import SyncReplicas
from ..runtime.device import resolve_device
from ..utils.logging import get_logger
from ..utils.metrics import MetricsLogger
from . import hooks as hooks_lib
from .optimizers import make_optimizer, make_schedule
from .state import TrainState, param_count

log = get_logger("trainer")

_A3C = "arrives with slice A3c"


def one_replica(mesh: MeshShape) -> bool:
    """True for the meshes the port trains on: every axis 1, or data=-1
    (all devices, here one)."""
    axes = mesh.as_dict()
    return axes.pop("data") in (1, -1) and all(v == 1
                                               for v in axes.values())


def refuse_later_slices(config: TrainConfig) -> None:
    """Raise NotImplementedError naming slice A3c for a set knob the
    port's Trainer does not carry yet (and the reference's ValueErrors
    on anomaly settings no path could honor)."""
    if not one_replica(config.mesh):
        raise NotImplementedError(
            f"mesh {config.mesh.as_dict()} (more than one replica or a "
            f"sharded axis) {_A3C}; the port trains on one device")
    if config.steps_per_loop > 1:
        raise NotImplementedError(f"steps_per_loop > 1 {_A3C}")
    anomaly_settings(config)          # rollback raises there


class Trainer:
    """End-to-end training loop for a registered model, one process.

    Args:
      model: a model with ``init(gen)``, ``loss`` and ``eval_metrics``.
      config: TrainConfig.
      train_arrays/eval_arrays: batch-keyed numpy arrays.
      hooks: extra hooks appended after the default set.
      device: ``cuda`` (default) or ``cpu``.
    """

    def __init__(self, model, config: TrainConfig,
                 train_arrays: dict[str, np.ndarray],
                 eval_arrays: dict[str, np.ndarray] | None = None,
                 *, hooks: list[hooks_lib.Hook] | None = None,
                 device: str | torch.device | None = None):
        refuse_later_slices(config)
        self.model = model
        self.config = config
        self.device = resolve_device(device)
        self.train_arrays = train_arrays
        self.eval_arrays = eval_arrays
        self.tx = make_optimizer(config.optimizer)
        self._schedule = make_schedule(config.optimizer)
        self.sync = SyncReplicas(model.loss, self.tx,
                                 sync=config.sync,
                                 anomaly_policy=config.on_anomaly,
                                 device=self.device)

        # the trainer's counters (hooks reach them through
        # ``trainer.registry``); registered up front so a run that never
        # checkpoints still shows the checkpoint counter at zero
        self.registry = Registry(namespace="training")
        self._c_steps = self.registry.counter(
            "train_steps_total", "optimizer steps completed")
        self._c_ckpt_saves = self.registry.counter(
            "train_checkpoints_saved_total", "checkpoint saves issued")
        self._g_anomalies = self.registry.gauge(
            "train_anomaly_count",
            "cumulative on-device anomaly count (observed at the "
            "metrics cadence)")
        self._h_data_wait = self.registry.histogram(
            "train_data_wait_seconds",
            "host time blocked on the data loader per step")
        self._h_dispatch = self.registry.histogram(
            "train_dispatch_seconds",
            "host time to enqueue one step (the device runs behind it)")

        ck = config.checkpoint
        self.ckpt_manager = (
            CheckpointManager(ck.directory, max_to_keep=ck.max_to_keep,
                              keep_every_n_hours=(
                                  ck.keep_checkpoint_every_n_hours))
            if ck.directory else None)
        self.metrics_logger = MetricsLogger(config.obs.metrics_path,
                                            registry=self.registry)
        self.state: TrainState | None = None
        self.start_step = 0
        self.hooks = self._default_hooks() + list(hooks or [])

    # ------------------------------------------------------------------
    def _default_hooks(self) -> list[hooks_lib.Hook]:
        """The hook set MonitoredTrainingSession wires for a chief."""
        cfg = self.config
        hs: list[hooks_lib.Hook] = [
            hooks_lib.StopAtStepHook(cfg.train_steps),
            hooks_lib.LoggingHook(cfg.obs.log_every_steps),
            hooks_lib.StepCounterHook(cfg.obs.log_every_steps,
                                      batch_size=cfg.data.batch_size,
                                      metrics_logger=self.metrics_logger),
        ]
        # the anomaly policy rides the log cadence (no extra host
        # syncs); with logging off, halt omits it (the on-device identity
        # update still protects the state) and skip falls back to 100
        every = cfg.obs.log_every_steps
        if not every and cfg.on_anomaly != "halt":
            every = 100
        if every:
            hs.append(hooks_lib.AnomalyPolicyHook(
                cfg.on_anomaly, cfg.max_anomalies, every_steps=every))
        if cfg.obs.check_nans:
            hs.append(hooks_lib.NanHook())
        if self.ckpt_manager and (cfg.checkpoint.save_steps
                                  or cfg.checkpoint.save_secs):
            hs.append(hooks_lib.CheckpointSaverHook(
                self.ckpt_manager, save_steps=cfg.checkpoint.save_steps,
                save_secs=cfg.checkpoint.save_secs))
            hs.append(hooks_lib.PreemptionHook())
        return hs

    def learning_rate_at(self, step: int) -> float:
        """The learning rate of the update that produced step ``step``
        (the schedule at the count before it, ``step - 1``)."""
        return float(self._schedule(max(0, step - 1)))

    # ------------------------------------------------------------------
    def initialize(self) -> TrainState:
        """Restore-or-init (SessionManager.prepare_session parity)."""
        state, restored = restore_or_init(
            self.ckpt_manager,
            lambda: self.sync.init(self.model.init, seed=self.config.seed))
        self.state = state
        self.start_step = int(state.step)
        if restored:
            log.info("restored checkpoint at step %d", self.start_step)
        else:
            log.info("initialized fresh state: %d params",
                     param_count(state.params))
        return state

    def _loader(self, start_step: int | None = None
                ) -> Iterator[dict[str, np.ndarray]]:
        """Batch iterator fast-forwarded to ``start_step`` (default: the
        run's start step), so a resumed run sees the batches an
        uninterrupted run would have."""
        if start_step is None:
            start_step = self.start_step
        d = self.config.data
        return make_loader(self.train_arrays, d.batch_size,
                           prefetch=d.prefetch, start_step=start_step,
                           shuffle=d.shuffle, seed=d.seed)

    # ------------------------------------------------------------------
    def train(self) -> tuple[TrainState, dict[str, Any]]:
        if self.state is None:
            self.initialize()
        # the resolved config opens this run's segment of the (append
        # mode) metrics stream
        self.metrics_logger.log({
            "config": dataclasses.asdict(self.config), "num_processes": 1,
            "start_step": self.start_step})
        state = self.state
        step = self.start_step
        stop = step >= self.config.train_steps
        device_metrics: dict | None = None
        t_start = time.perf_counter()
        loader = None
        try:
            # begin() inside the try: a failing begin still runs every
            # hook's end() (PreemptionHook restores signal handlers there)
            for h in self.hooks:
                h.begin(self)
            loader = self._loader()
            while not stop:
                t_d0 = time.perf_counter()
                host_batch = next(loader)
                t_d1 = time.perf_counter()
                self._h_data_wait.observe(t_d1 - t_d0)
                add_span("data_wait", t_d0, t_d1, process="training",
                         lane="data", step=step)
                t_s0 = time.perf_counter()
                state, device_metrics = self.sync.step(state, host_batch)
                t_s1 = time.perf_counter()
                step += 1
                self._h_dispatch.observe(t_s1 - t_s0)
                add_span("step_dispatch", t_s0, t_s1, process="training",
                         lane="step", step=step)
                self._c_steps.inc()
                self.state = state

                host_metrics = None
                if any(h.wants_metrics(step) for h in self.hooks):
                    host_metrics = {k: float(v)
                                    for k, v in device_metrics.items()}
                for h in self.hooks:
                    if h.after_step(self, step, host_metrics):
                        stop = True

                if (self.config.eval_every_steps
                        and step % self.config.eval_every_steps == 0
                        and self.eval_arrays is not None):
                    ev = self.evaluate(state)
                    log.info("eval @ step %d: %s", step,
                             {k: round(v, 4) for k, v in ev.items()})
                    self.metrics_logger.log({"step": step, "eval": ev})
            if self.device.type == "cuda":   # the last step has run
                torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - t_start
        finally:
            # teardown runs even when a hook raises mid-loop (NanHook's
            # FloatingPointError); a hook end() error must not mask an
            # exception already in flight
            if loader is not None and hasattr(loader, "close"):
                loader.close()
            in_flight = sys.exc_info()[0] is not None
            end_error: Exception | None = None
            for h in self.hooks:
                try:
                    h.end(self)
                except Exception as e:
                    log.exception("hook %s end() failed", type(h).__name__)
                    if end_error is None:
                        end_error = e
            if end_error is not None and not in_flight:
                raise end_error

        summary: dict[str, Any] = {
            "final_step": step,
            "wall_time_sec": wall,
            "steps_per_sec": (step - self.start_step) / wall if wall else 0.0,
        }
        if device_metrics is not None:
            summary["final_metrics"] = {k: float(v)
                                        for k, v in device_metrics.items()}
        if self.eval_arrays is not None:
            summary["eval"] = self.evaluate(state)
        return state, summary

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Release the metrics file."""
        self.metrics_logger.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def evaluate(self, state: TrainState) -> dict[str, float]:
        """Forward-only metrics over the eval set, no dropout, in batches
        of the training batch size. The tail batch is padded with copies
        of its first row and masked out by a ``__valid__`` row mask, as in
        the reference; each batch's metrics weigh by its real rows."""
        bs = self.config.data.batch_size
        n = len(next(iter(self.eval_arrays.values())))
        totals: dict[str, float] = {}
        count = 0
        for i in range(0, n, bs):
            batch = {k: v[i:i + bs] for k, v in self.eval_arrays.items()}
            m = len(next(iter(batch.values())))
            if m < bs:
                batch = {k: np.concatenate(
                    [v, np.repeat(v[:1], bs - m, axis=0)])
                    for k, v in batch.items()}
            mask = np.zeros((bs,), np.float32)
            mask[:m] = 1.0
            batch["__valid__"] = mask
            placed = {k: torch.as_tensor(v, device=self.device)
                      for k, v in batch.items()}
            out = self.model.eval_metrics(state.params, state.extras, placed)
            for k, v in out.items():
                totals[k] = totals.get(k, 0.0) + float(v) * m
            count += m
        return {k: v / count for k, v in totals.items()} if count else {}
