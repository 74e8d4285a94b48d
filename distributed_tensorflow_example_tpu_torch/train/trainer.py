"""Trainer: the Supervisor / MonitoredTrainingSession replacement (an
adapted copy of ``distributed_tensorflow_example_tpu/train/trainer.py``),
one replica per rank.

- restore-or-init          -> :func:`~..ckpt.checkpoint.restore_or_init`
- Supervisor threads       -> hooks (``train/hooks.py``)
- Coordinator should_stop  -> a hook returning True / StopAtStepHook
- per-step feed_dict       -> ShardedLoader batches, copied to the device

Under N ranks of a ``torch.distributed`` group each rank takes its slice
of every global batch (the loader's ``process_index``/``num_processes``
are the rank's coordinate and count over the batch axes, ``data`` x
``fsdp``: ``model`` ranks read the same rows) and the sync step
all-reduces the gradients. The loop queues steps
without a host sync: device metrics are read to the host only on steps
where some hook asks (``wants_metrics``).

The self-healing path is the reference's: a ``fault_spec`` arms the
injection seams (``runtime/faults.py``) for the Trainer's life, a
``step.*`` fault poisons the host batch of its global step, and
``on_anomaly="rollback"`` restores the last verified checkpoint at or
before the last clean step, keeps the anomaly count, discards the
rejected checkpoints and fast-forwards the loader to the restored step.
Dropout draws from generators seeded by the state's seed and the step,
so a replayed window draws the same masks. An eval cadence feeds the
best-checkpoint record (``keep_best_metric``) and early stop (its state
in ``early_stop.json`` beside the checkpoints, rank 0's verdict on every
rank). ``step_timing`` times each step to a device sync and counts the
first step's FLOPs (``SyncReplicas.counted_step``); ``debug_checks``
raises on a non-finite loss or gradient; a profiler service
(``--profiler_port``) arms the profiler hook for the steps a capture asks
for. ``trace_path`` dumps the data, step, checkpoint and rollback lanes as
Chrome trace JSON. A fresh run with ``checkpoint.warm_start`` takes the
params its assignment map selects from that checkpoint (resume always
wins) and re-anchors the parameter EMA's shadows there; with the EMA on,
eval runs on the shadows. Host metrics are floats, and a vector metric
(MoE-BERT's per-expert load) a list: the JSONL takes it, the scalar
hooks skip it. ``steps_per_loop`` K > 1 runs K steps a call
(``SyncReplicas.multi_step`` on K stacked host batches) while at least K
steps remain and single steps for the tail; hooks, eval, rollback and
early stop see loop boundaries only, so every set cadence must be a
multiple of K. ``max_inflight_steps`` N > 0 makes the host wait for the
card every N trained steps (:meth:`Trainer.wait_for_device`). The mesh
is one rank a card over ``data``, ``fsdp``, ``model``, ``seq``,
``expert`` and ``pipe``; the state is sharded by the
model's ``sharding_rules`` (over ``fsdp`` ZeRO-3's way, over ``model``
Megatron's: GPT, BERT, MoE-BERT and pipe_bert compute on their pieces;
over ``expert`` MoE-BERT's and pipe_moe_bert's experts; over ``pipe``
the pipe models' stages; eval, warm start and the EMA's eval see the
whole params, gathered), and ``checkpoint.sharded`` writes per-rank
shard files. Along ``seq`` the model runs replicated, as the
reference's trainer binds no ring attention.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time
from typing import Any, Iterator

import numpy as np
import torch

from ..ckpt.checkpoint import (CheckpointManager, _agreed_latest_step,
                               restore_or_init)
from ..config import MeshShape, TrainConfig, anomaly_settings
from ..data.loader import make_loader
from ..obs import trace as obs_trace
from ..obs.registry import Registry
from ..obs.trace import add_span, span
from ..parallel.mesh import AxisNames, Mesh
from ..parallel.sync_replicas import SyncReplicas, resolve_mesh
from ..runtime import distributed, faults
from ..runtime.device import resolve_device
from ..utils.logging import get_logger
from ..utils.metrics import MetricsLogger
from . import hooks as hooks_lib
from .optimizers import find_ema_params, make_optimizer, make_schedule
from .state import TrainState, param_count

log = get_logger("trainer")


def _host_metric(v):
    """A device metric as a JSON-ready host value: a scalar becomes a
    float, a vector (MoE-BERT's per-expert load) a list."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return float(v) if np.ndim(v) == 0 else np.asarray(v).tolist()


def check_config(config: TrainConfig, num_processes: int) -> None:
    """Raise NotImplementedError stating the rule of one rank a card for
    a mesh wider than the ranks, and the reference's ValueErrors on
    settings no run could honor: anomaly settings, a ``steps_per_loop``
    that a set cadence is not a multiple of (hooks only observe loop
    boundaries), a negative ``max_inflight_steps``."""
    resolve_mesh(config.mesh, num_processes)
    anomaly_settings(config)
    k = config.steps_per_loop
    if k > 1:
        for name, every in (
                ("log_every_steps", config.obs.log_every_steps),
                ("summary_every_steps", config.obs.summary_every_steps),
                ("param_histograms_every_steps",
                 config.obs.param_histograms_every_steps),
                ("save_steps", config.checkpoint.save_steps),
                ("eval_every_steps", config.eval_every_steps)):
            if every and every % k:
                raise ValueError(
                    f"{name}={every} must be a multiple of "
                    f"steps_per_loop={k} (hooks only observe loop "
                    "boundaries)")
    if config.max_inflight_steps < 0:
        raise ValueError(f"max_inflight_steps must be >= 0, got "
                         f"{config.max_inflight_steps}")


class Trainer:
    """End-to-end training loop for a registered model, one replica per
    rank.

    Args:
      model: a model with ``init(gen)``, ``loss`` and ``eval_metrics``.
      config: TrainConfig.
      train_arrays/eval_arrays: batch-keyed numpy arrays (the whole
        sets: each rank takes its slice of every global batch);
        ``train_arrays`` may instead be a source with ``make_loader``
        (``data/streaming.StreamingSource``), which the Trainer closes.
      hooks: extra hooks appended after the default set.
      device: ``cuda`` (default) or ``cpu``.
      process_index/num_processes: this rank's coordinates (default: the
        ``torch.distributed`` group's, or 0 of 1 without one).
      train_transform: the loader's per-batch ``transform(batch, epoch,
        global_indices)`` for the training set (the CIFAR augmentation).
      profiler_service: a ``runtime.server.ProfilerService`` (the
        ``--profiler_port`` listener) whose captures arm the profiler hook.
    """

    def __init__(self, model, config: TrainConfig,
                 train_arrays: dict[str, np.ndarray],
                 eval_arrays: dict[str, np.ndarray] | None = None,
                 *, hooks: list[hooks_lib.Hook] | None = None,
                 device: str | torch.device | None = None,
                 process_index: int | None = None,
                 num_processes: int | None = None,
                 train_transform=None, profiler_service=None):
        self.process_index = (distributed.process_index()
                              if process_index is None else process_index)
        self.num_processes = (distributed.process_count()
                              if num_processes is None else num_processes)
        check_config(config, self.num_processes)
        self.model = model
        self.config = config
        self.device = resolve_device(device)
        self.train_arrays = train_arrays
        self.eval_arrays = eval_arrays
        self.train_transform = train_transform
        self.profiler_service = profiler_service
        sizes = resolve_mesh(config.mesh, self.num_processes)
        mesh = MeshShape(**sizes)
        # the loader's coordinate and count: over the batch axes
        rows = Mesh(sizes, self.process_index, self.num_processes)
        self.batch_index = rows.index(AxisNames.BATCH)
        self.batch_count = rows.size(AxisNames.BATCH)
        self.tx = make_optimizer(config.optimizer)
        self._schedule = make_schedule(config.optimizer)
        self._rollback_pending = False
        self._rollback_before: int | None = None
        self._faults_installed = False
        rules = getattr(model, "sharding_rules", None)
        self.sync = SyncReplicas(model.loss, self.tx, config.mesh,
                                 sync=config.sync,
                                 rules=rules(mesh) if rules else None,
                                 anomaly_policy=config.on_anomaly,
                                 device=self.device,
                                 debug_checks=config.obs.debug_checks)
        if hasattr(model, "bind_mesh"):
            # the mesh-aware models (the pipe models' stages, the Megatron
            # pieces) check themselves against the mesh here, as the
            # reference's trainer binds them; the step binds the mesh
            # around each loss it computes on pieces, so eval and export
            # run the unbound model on whole params
            model.bind_mesh(self.sync.mesh)
            model.bind_mesh(None)

        # the trainer's counters (hooks reach them through
        # ``trainer.registry``); registered up front so a run that never
        # checkpoints still shows the checkpoint counter at zero
        self.registry = Registry(namespace="training")
        self._c_steps = self.registry.counter(
            "train_steps_total", "optimizer steps completed")
        self._c_ckpt_saves = self.registry.counter(
            "train_checkpoints_saved_total", "checkpoint saves issued")
        self._c_rollbacks = self.registry.counter(
            "train_rollbacks_total",
            "anomaly rollbacks performed (on_anomaly='rollback')")
        self._g_anomalies = self.registry.gauge(
            "train_anomaly_count",
            "cumulative on-device anomaly count (observed at the "
            "metrics cadence)")
        self._h_data_wait = self.registry.histogram(
            "train_data_wait_seconds",
            "host time blocked on the data loader per step")
        self._h_dispatch = self.registry.histogram(
            "train_dispatch_seconds",
            "host time to enqueue one step (device time only with "
            "step_timing)")

        ck = config.checkpoint
        self.ckpt_manager = (
            CheckpointManager(ck.directory, max_to_keep=ck.max_to_keep,
                              keep_every_n_hours=(
                                  ck.keep_checkpoint_every_n_hours),
                              async_save=ck.async_save,
                              sharded=ck.sharded)
            if ck.directory else None)
        self.metrics_logger = MetricsLogger(config.obs.metrics_path,
                                            tb_logdir=config.obs.tb_logdir,
                                            registry=self.registry)
        self.state: TrainState | None = None
        self.start_step = 0
        self.last_dispatch_ms: float | None = None
        self.hooks = self._default_hooks() + list(hooks or [])

        if config.early_stop_metric:
            if self.eval_arrays is None or not config.eval_every_steps:
                raise ValueError(
                    "early_stop_metric needs eval data AND "
                    "eval_every_steps > 0 (improvement is judged at the "
                    "eval cadence)")
            if config.early_stop_mode not in ("max", "min"):
                raise ValueError("early_stop_mode must be max|min, got "
                                 f"{config.early_stop_mode!r}")
            if config.early_stop_patience < 1:
                raise ValueError("early_stop_patience must be >= 1")
        self._early_best: float | None = None
        self._early_misses = 0
        self._last_eval: tuple[int, dict] | None = None
        if ck.keep_best_metric and (self.eval_arrays is None
                                    or self.ckpt_manager is None):
            raise ValueError(
                "keep_best_metric needs eval data and a checkpoint "
                "directory (missing: "
                + ("eval data" if self.eval_arrays is None
                   else "checkpoint.directory") + ")")
        # the fault spec arms the injection seams process-wide until
        # close(), once nothing above can refuse the config
        if config.fault_spec:
            faults.install(faults.parse_spec(config.fault_spec,
                                             seed=config.seed))
            self._faults_installed = True

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
        # steps, rounded up to a loop boundary
        spl = max(1, cfg.steps_per_loop)
        every = cfg.obs.log_every_steps
        if not every and cfg.on_anomaly != "halt":
            every = -(-100 // spl) * spl
        if every:
            hs.append(hooks_lib.AnomalyPolicyHook(
                cfg.on_anomaly, cfg.max_anomalies, every_steps=every))
        if cfg.obs.summary_every_steps:
            hs.append(hooks_lib.SummaryHook(self.metrics_logger,
                                            cfg.obs.summary_every_steps))
        if cfg.obs.param_histograms_every_steps:
            hs.append(hooks_lib.ParamHistogramHook(
                self.metrics_logger,
                cfg.obs.param_histograms_every_steps))
        if cfg.obs.check_nans:
            hs.append(hooks_lib.NanHook())
        if cfg.obs.step_timing:
            hs.append(hooks_lib.StepTimingHook(self.metrics_logger,
                                               cfg.obs.log_every_steps))
        if self.ckpt_manager and (cfg.checkpoint.save_steps
                                  or cfg.checkpoint.save_secs):
            hs.append(hooks_lib.CheckpointSaverHook(
                self.ckpt_manager, save_steps=cfg.checkpoint.save_steps,
                save_secs=cfg.checkpoint.save_secs))
            hs.append(hooks_lib.PreemptionHook())
        # the profiler service (--profiler_port) arms the same hook for
        # the steps a capture asks for
        service = self.profiler_service
        window = (cfg.obs.profile_steps
                  if cfg.obs.profile_steps and cfg.obs.profile_dir else None)
        if window or service is not None:
            hs.append(hooks_lib.ProfilerHook(
                cfg.obs.profile_dir, *(window or ()), service=service))
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
            if self.config.early_stop_metric:
                self._early_stop_load()   # patience survives preemption
        else:
            log.info("initialized fresh state: %d params",
                     param_count(state.params))
            if self.config.checkpoint.warm_start:
                state = self._warm_start(state)
        return state

    def _warm_start(self, state: TrainState) -> TrainState:
        """``tf.train.init_from_checkpoint`` on a fresh init: the params
        the map selects come from the warm-start checkpoint (the step and
        the optimizer state stay fresh), and any EMA shadow is re-anchored
        at them (it snapshotted the discarded init). Every rank reads the
        same file, so the ranks stay equal."""
        from ..ckpt.warm_start import parse_assignment_map, warm_start
        from .optimizers import reset_ema
        ck = self.config.checkpoint
        params, report = warm_start(self.sync.full_params(state),
                                    ck.warm_start,
                                    parse_assignment_map(ck.warm_start_map))
        if state.layout is not None:       # back to this rank's pieces
            params = state.layout.shard_params(params)
        state = state.replace(params=params,
                              opt_state=reset_ema(state.opt_state, params))
        self.state = state
        log.info("%s (from %s)", report, ck.warm_start)
        return state

    def _loader(self, start_step: int | None = None
                ) -> Iterator[dict[str, np.ndarray]]:
        """Batch iterator fast-forwarded to ``start_step`` (default: the
        run's start step), so a resumed run sees the batches an
        uninterrupted run would have."""
        if start_step is None:
            start_step = self.start_step
        d = self.config.data
        if hasattr(self.train_arrays, "make_loader"):
            # a streaming source (data/streaming.StreamingSource): batches
            # are decoded when needed instead of held in memory
            return self.train_arrays.make_loader(
                d.batch_size, start_step=start_step,
                process_index=self.batch_index,
                num_processes=self.batch_count, shuffle=d.shuffle,
                seed=d.seed, prefetch=d.prefetch,
                microbatches=self.sync.loader_microbatches)
        return make_loader(self.train_arrays, d.batch_size,
                           prefetch=d.prefetch, native=d.native,
                           start_step=start_step,
                           process_index=self.batch_index,
                           num_processes=self.batch_count,
                           shuffle=d.shuffle, seed=d.seed,
                           transform=self.train_transform,
                           microbatches=self.sync.loader_microbatches)

    # ------------------------------------------------------------------
    def train(self) -> tuple[TrainState, dict[str, Any]]:
        if self.state is None:
            self.initialize()
        # the resolved config opens this run's segment of the (append
        # mode) metrics stream
        self.metrics_logger.log({
            "config": dataclasses.asdict(self.config),
            "num_processes": self.num_processes,
            "start_step": self.start_step})
        state = self.state
        step = self.start_step
        stop = step >= self.config.train_steps
        device_metrics: dict | None = None
        t_start = time.perf_counter()
        # step_timing: each dispatch is timed from its call to a device
        # sync, which also bounds the queue; else max_inflight_steps N > 0
        # waits for the card every N trained steps
        timing = self.config.obs.step_timing
        spl = max(1, self.config.steps_per_loop)
        max_inflight = self.config.max_inflight_steps
        pending = 0
        cuda = self.device.type == "cuda"
        self.last_dispatch_ms = None
        self._rollback_pending = False
        fault_reg = faults.active()
        loader = None
        trace_path = self.config.obs.trace_path
        if trace_path:
            obs_trace.ensure_capacity(
                self.config.obs.trace_buffer_events).start()
        try:
            # begin() inside the try: a failing begin still runs every
            # hook's end() (PreemptionHook restores signal handlers there)
            for h in self.hooks:
                h.begin(self)
            loader = self._loader()
            while not stop:
                # K steps a call while K remain, single steps for the tail
                k = spl if self.config.train_steps - step >= spl else 1
                t_d0 = time.perf_counter()
                host = [next(loader) for _ in range(k)]
                t_d1 = time.perf_counter()
                self._h_data_wait.observe(t_d1 - t_d0)
                add_span("data_wait", t_d0, t_d1, process="training",
                         lane="data", step=step)
                if fault_reg is not None:
                    # step.* faults poison the host batch that produces
                    # the matching global step; the step is untouched
                    host = [fault_reg.poison_batch(b, step + i + 1)
                            for i, b in enumerate(host)]
                multi = k > 1
                batch = ({name: np.stack([b[name] for b in host])
                          for name in host[0]} if multi else host[0])
                t_s0 = time.perf_counter()
                if timing and self.sync.last_cost_analysis is None:
                    # once a run: the first dispatch's FLOPs for
                    # step_timing's record (the reference's precompile
                    # cost analysis)
                    state, device_metrics = self.sync.counted_step(
                        state, batch, multi=multi)
                elif multi:
                    state, device_metrics = self.sync.multi_step(state,
                                                                 batch)
                else:
                    state, device_metrics = self.sync.step(state, batch)
                t_s1 = time.perf_counter()
                step += k
                self._h_dispatch.observe(t_s1 - t_s0)
                add_span("step_dispatch", t_s0, t_s1, process="training",
                         lane="step", step=step)
                if timing:
                    if cuda:
                        torch.cuda.synchronize(self.device)
                    self.last_dispatch_ms = (time.perf_counter()
                                             - t_s0) * 1e3
                elif max_inflight:
                    pending += k
                    if pending >= max_inflight:
                        self.wait_for_device()
                        pending = 0
                self._c_steps.inc(k)
                self.state = state

                host_metrics = None
                if any(h.wants_metrics(step) for h in self.hooks):
                    host_metrics = {k: _host_metric(v)
                                    for k, v in device_metrics.items()}
                for h in self.hooks:
                    if h.after_step(self, step, host_metrics):
                        stop = True

                if self._rollback_pending and not stop:
                    rolled = self._perform_rollback(step, loader)
                    if rolled is None:
                        stop = True            # nothing valid to restore
                    else:
                        # this iteration's eval would measure the state
                        # just discarded
                        state, step, loader = rolled
                        continue

                if (self.config.eval_every_steps
                        and step % self.config.eval_every_steps == 0
                        and self.eval_arrays is not None):
                    ev = self.evaluate(state)
                    log.info("eval @ step %d: %s", step,
                             {k: round(v, 4) for k, v in ev.items()})
                    self.metrics_logger.log({"step": step, "eval": ev})
                    self._maybe_save_best(state, step, ev)
                    self._last_eval = (step, ev)
                    if self._early_stop_hit(step, ev):
                        stop = True
            if cuda:                         # the last step has run
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
            if trace_path:
                rec = obs_trace.recorder()
                rec.stop()
                if self.process_index == 0:
                    with open(trace_path, "w") as f:
                        json.dump(rec.to_chrome(), f)
                    log.info("training trace: %s (%d spans)", trace_path,
                             rec.spans_recorded)
            if end_error is not None and not in_flight:
                raise end_error

        summary: dict[str, Any] = {
            "final_step": step,
            "wall_time_sec": wall,
            "steps_per_sec": (step - self.start_step) / wall if wall else 0.0,
        }
        if device_metrics is not None:
            summary["final_metrics"] = {k: _host_metric(v)
                                        for k, v in device_metrics.items()}
        if self.eval_arrays is not None:
            if self._last_eval is not None and self._last_eval[0] == step:
                # the loop just evaluated this step
                summary["eval"] = self._last_eval[1]
            else:
                summary["eval"] = self.evaluate(state)
                self._maybe_save_best(state, step, summary["eval"])
        return state, summary

    def wait_for_device(self) -> None:
        """``max_inflight_steps``' wait: the host blocks until the card
        has run every step queued so far (``torch.cuda.synchronize`` of
        the Trainer's device; on the CPU the steps ran as they were
        called, and the call returns at once)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def request_rollback(self, before_step: int | None = None) -> None:
        """Restore the last verified checkpoint at the next step boundary,
        at or before ``before_step`` (the last step known clean), so the
        replay redoes the anomalous window. Every rank observes the same
        device-computed count at the same cadence, so every rank asks
        together with the same cap."""
        self._rollback_pending = True
        self._rollback_before = before_step

    def _perform_rollback(self, step: int, old_loader=None):
        """Restore the newest verified checkpoint at or before the clean
        step and fast-forward the data to it. Returns ``(state, step,
        loader)``, or None when no verified checkpoint is in range."""
        self._rollback_pending = False
        with span("rollback", process="training", lane="rollback",
                  at_step=step):
            return self._perform_rollback_inner(step, old_loader)

    def _perform_rollback_inner(self, step: int, old_loader=None):
        if old_loader is not None and hasattr(old_loader, "close"):
            old_loader.close()
        before = self._rollback_before
        mgr = self.ckpt_manager
        mgr.wait()
        # run accounting, not model state: the budget keeps charging
        # across the restore, or a divergence loop would never spend it
        pre_count = self.state.anomaly_count
        if self.num_processes > 1:
            target = _agreed_latest_step(mgr, max_step=before)
            if target is None:
                log.error("rollback requested at step %d but no verified "
                          "checkpoint at or before clean step %s exists "
                          "under %r — halting", step, before, mgr.directory)
                return None
            state = mgr.restore(self.state, step=target)
        else:
            try:
                state = mgr.restore(self.state, step=None, max_step=before)
            except FileNotFoundError as e:   # CorruptCheckpointError too
                log.error("rollback requested at step %d but no verified "
                          "checkpoint at or before clean step %s exists "
                          "under %r (%s) — halting",
                          step, before, mgr.directory, e)
                return None
            target = int(state.step)
        state = state.replace(anomaly_count=pre_count)
        self.state = state
        # checkpoints newer than the target hold the rejected trajectory:
        # a restart must not resume it
        discarded = mgr.discard_steps_above(target)
        if discarded:
            log.warning("rollback: discarded rejected-trajectory "
                        "checkpoint step(s) %s", discarded)
        loader = self._loader(start_step=target)
        self._c_rollbacks.inc()
        log.warning("rollback: restored verified checkpoint step %d "
                    "(training was at step %d); data stream "
                    "fast-forwarded to match", target, step)
        return state, target, loader

    # early-stop progress survives preemption in a file beside the
    # checkpoints (host-side floats, not state leaves)
    def _early_stop_path(self) -> str | None:
        d = self.config.checkpoint.directory
        return os.path.join(d, "early_stop.json") if d else None

    def _early_stop_save(self) -> None:
        path = self._early_stop_path()
        if path is None or self.process_index != 0:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"best": self._early_best,
                       "misses": self._early_misses}, f)
        os.replace(tmp, path)

    def _early_stop_load(self) -> None:
        path = self._early_stop_path()
        if path is None or not os.path.exists(path):
            return
        with open(path) as f:
            st = json.load(f)
        self._early_best = st.get("best")
        self._early_misses = int(st.get("misses", 0))
        log.info("early-stop state restored: best=%s misses=%d",
                 self._early_best, self._early_misses)

    def _early_stop_hit(self, step: int, ev: dict) -> bool:
        """stop_if_no_decrease_hook parity: True once the tracked eval
        metric has gone ``early_stop_patience`` evals without improving
        (a NaN eval improves on nothing). Rank 0's value decides on
        every rank."""
        metric = self.config.early_stop_metric
        if not metric:
            return False
        if metric not in ev:
            raise ValueError(
                f"early_stop_metric={metric!r} is not an eval metric "
                f"(eval produced {sorted(ev)})")
        value = distributed.broadcast_float(float(ev[metric]))
        better = (not math.isnan(value)) and (
            self._early_best is None
            or (value > self._early_best
                if self.config.early_stop_mode == "max"
                else value < self._early_best))
        if better:
            self._early_best = value
            self._early_misses = 0
            self._early_stop_save()
            return False
        self._early_misses += 1
        self._early_stop_save()
        if self._early_misses >= self.config.early_stop_patience:
            log.info("early stop at step %d: %s did not improve for %d "
                     "evals (best %s)", step, metric,
                     self._early_misses, self._early_best)
            return True
        return False

    def _maybe_save_best(self, state: TrainState, step: int,
                         ev: dict) -> None:
        """BestExporter parity: track the best eval metric and keep its
        checkpoint out of ring rotation."""
        metric = self.config.checkpoint.keep_best_metric
        if not metric or self.ckpt_manager is None:
            return
        if metric not in ev:
            raise ValueError(
                f"keep_best_metric={metric!r} is not an eval metric "
                f"(eval produced {sorted(ev)})")
        if self.ckpt_manager.save_best(
                state, step, float(ev[metric]),
                mode=self.config.checkpoint.keep_best_mode):
            log.info("new best %s=%.6f at step %d", metric,
                     float(ev[metric]), step)

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Release what the Trainer owns: the metrics sinks, an installed
        fault registry, a streaming source's decode pool and the
        checkpoint writer. A pending async-save error surfaces from the
        checkpoint manager's close, after the others are released."""
        try:
            self.metrics_logger.close()
        finally:
            try:
                if self._faults_installed:
                    faults.install(None)
                    self._faults_installed = False
                if hasattr(self.train_arrays, "close"):
                    self.train_arrays.close()
            finally:
                if self.ckpt_manager is not None:
                    self.ckpt_manager.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def evaluate(self, state: TrainState, batch_size: int | None = None,
                 use_ema: bool | None = None) -> dict[str, float]:
        """Forward-only metrics over the eval set, no dropout, in batches
        of ``batch_size`` (default: the training batch size). The tail
        batch is padded with copies of its first row and masked out by a
        ``__valid__`` row mask, as in the reference; each batch's metrics
        weigh by its real rows. With ``ema_decay`` on, eval runs on the
        EMA shadows (``use_ema=False``: the live params; ``use_ema=True``
        without an EMA raises)."""
        params = self.sync.full_params(state)
        explicit = use_ema is not None
        if use_ema is None:
            use_ema = self.config.optimizer.ema_decay > 0
        if use_ema:
            ema = find_ema_params(state.opt_state, state.params)
            if ema is not None:
                params = (ema if state.layout is None
                          else state.layout.full_params(ema))
            elif explicit:
                raise ValueError(
                    "use_ema=True but the optimizer state holds no EMA "
                    "shadow (ema_decay is 0 for this run)")
        bs = batch_size or self.config.data.batch_size
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
            out = self.model.eval_metrics(params, state.extras, placed)
            for k, v in out.items():
                totals[k] = totals.get(k, 0.0) + float(v) * m
            count += m
        return {k: v / count for k, v in totals.items()} if count else {}
