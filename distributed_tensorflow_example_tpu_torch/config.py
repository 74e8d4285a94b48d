"""Config dataclasses (port of ``distributed_tensorflow_example_tpu/
config.py``, the fields GPT, MLP, LeNet and ResNet construction,
generation, the sync training step and the ``Trainer`` read).

Field names and defaults are the reference's, so a config reads the same
in both packages. The fields of a later slice are absent (warm start,
best-checkpoint tracking, async and sharded saves, early stop, fault
injection, the summary, histogram, profiler, step-timing and trace
sinks, the streaming and ImageNet-reader, BERT and MoE knobs), or
refused by the ``Trainer`` when set: a sharded mesh axis,
``steps_per_loop > 1`` and ``on_anomaly="rollback"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .ops.losses import LM_LOSS_IMPLS


@dataclasses.dataclass
class DataConfig:
    """Input pipeline configuration: the loader's fields and the ones a
    language model reads."""

    dataset: str = "mnist"          # the CLI sets the model's name
    data_dir: str | None = None     # IDX or pre-tokenized .npy files;
                                    # None => the synthetic set
    batch_size: int = 128           # GLOBAL batch size
    shuffle: bool = True
    seed: int = 0
    synthetic: bool = False         # force synthetic data even if data_dir set
    augment: bool = False           # CIFAR pad-4 crop + flip (train split)
    prefetch: int = 2               # host-side prefetch depth
    seq_len: int = 128
    vocab_size: int = 30522


@dataclasses.dataclass
class OptimizerConfig:
    """Base-optimizer knobs (``train/optimizers.py`` reads them)."""

    name: str = "sgd"               # sgd | momentum | adam | adamw
    learning_rate: float = 0.5
    momentum: float = 0.9
    weight_decay: float = 0.0
    wd_mask: str = "exclude_1d"     # exclude_1d (no decay on leaves with
                                    # ndim <= 1: biases, LayerNorm) | all
    warmup_steps: int = 0
    decay_schedule: str = "constant"  # constant | cosine | linear |
                                      # piecewise | exponential |
                                      # polynomial | natural_exp |
                                      # inverse_time (tf.train family)
    decay_boundaries: tuple[int, ...] = ()  # piecewise: absolute steps
    decay_factor: float = 0.1       # piecewise: multiplier per boundary;
                                    # exponential: rate per decay_steps
    decay_steps: int = 0            # exponential family: steps per
                                    # decay_factor; polynomial: horizon
                                    # (total_steps when 0)
    end_learning_rate: float = 0.0  # polynomial and cosine floor
    decay_power: float = 1.0        # polynomial exponent
    total_steps: int = 0            # for schedules; 0 => constant
    grad_clip_norm: float = 0.0     # 0 disables
    grad_clip_value: float = 0.0    # elementwise |g| clip; 0 disables
    moment_dtype: str = "float32"   # bfloat16 arrives with slice A5b
    ema_decay: float = 0.0          # > 0 (shadow-param EMA): slice A5b


@dataclasses.dataclass
class SyncConfig:
    """Sync-replica semantics (``parallel/sync_replicas.py`` reads them):
    one replica per rank, ``replicas_to_aggregate`` the number of
    ranks."""

    replicas_to_aggregate: int | None = None  # None => the replica count
    total_num_replicas: int | None = None     # must equal it
    accum_steps: int = 1                      # microbatch accumulation
    mode: str = "auto"                        # auto | shard_map


@dataclasses.dataclass
class MeshShape:
    """Logical mesh axis sizes (the reference's). The port runs one
    replica per rank: ``data`` is -1 or the number of ranks, every other
    axis 1 (sharded axes arrive with slice A6)."""

    data: int = 1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1

    def total(self) -> int:
        return (self.data * self.fsdp * self.model * self.seq *
                self.expert * self.pipe)

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CheckpointConfig:
    """Saver parity: a ``max_to_keep`` ring, the ``checkpoint`` state
    file, restore-or-init (``ckpt/checkpoint.py``)."""

    directory: str | None = None
    max_to_keep: int = 5
    save_steps: int = 0             # save every N steps (0 disables)
    save_secs: float = 0.0          # save every T seconds (0 disables)
    keep_checkpoint_every_n_hours: float = 0.0


@dataclasses.dataclass
class ObservabilityConfig:
    """Logging, metrics and NaN-check knobs."""

    log_every_steps: int = 100
    metrics_path: str | None = None   # JSONL sink; None => stdout only
    check_nans: bool = False          # NanTensorHook analogue


@dataclasses.dataclass
class TrainConfig:
    """Top-level config (the fields GPT, the training step and the
    ``Trainer`` read)."""

    model: str = "mlp"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    sync: SyncConfig = dataclasses.field(default_factory=SyncConfig)
    mesh: MeshShape = dataclasses.field(default_factory=MeshShape)
    checkpoint: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    obs: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig)
    train_steps: int = 1000
    eval_every_steps: int = 0        # 0 => eval only at the end
    steps_per_loop: int = 1          # > 1: slice A3c-2b
    on_anomaly: str = "halt"         # halt | skip (rollback: A3c-4)
    max_anomalies: int = 10          # anomaly budget for skip
    lm_loss_impl: str | None = None  # full (chunked, fused: A3c-3);
                                     # None = "full", or "chunked" when
                                     # lm_loss_chunk is set
    lm_loss_chunk: int | None = None  # seq chunk of the chunked LM loss
    seed: int = 0
    label_smoothing: float = 0.0     # image classifiers' training targets
    dtype: str = "float32"           # compute dtype: float32 | bfloat16
    param_dtype: str = "float32"
    attention_impl: str = "xla"      # xla | flash (hand-written kernel)
    # flash-kernel tuning levers (attention_impl="flash" only; 0 = the
    # kernel default)
    attention_block_q: int = 0
    attention_block_k: int = 0
    attention_bwd_block: int = 0
    attention_bwd: str = "split"     # split | fused (backward variant)
    bn_stats_dtype: str = "float32"  # BN batch-statistic reduction dtype

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def flash_attention_kwargs(cfg: TrainConfig) -> dict:
    """Validated flash-kernel kwargs from the ``attention_*`` lever knobs.

    Returns {} when every lever is at its default (any ``attention_impl``
    is fine then); raises ValueError when a lever is set without
    ``attention_impl="flash"`` or carries a value the reference's kernel
    could never tile. The same validation as the reference's, so a
    config is accepted or refused identically by both packages."""
    levers = dict(block_q=cfg.attention_block_q,
                  block_k=cfg.attention_block_k,
                  bwd_block=cfg.attention_bwd_block)
    if cfg.attention_bwd not in ("split", "fused"):
        raise ValueError(f"attention_bwd must be 'split' or 'fused', "
                         f"got {cfg.attention_bwd!r}")
    set_levers = {k: v for k, v in levers.items() if v != 0}
    if cfg.attention_bwd != "split":
        set_levers["bwd_variant"] = cfg.attention_bwd
    if not set_levers:
        return {}
    if cfg.attention_impl != "flash":
        raise ValueError(
            f"attention block/bwd levers ({', '.join(set_levers)}) tune "
            f"the flash kernel and require attention_impl='flash', "
            f"got {cfg.attention_impl!r}")
    for name, mult in (("block_q", 8), ("block_k", 128),
                       ("bwd_block", 128)):
        v = levers[name]
        if v < 0 or v % mult:
            raise ValueError(
                f"attention_{name}={v} invalid: must be a positive "
                f"multiple of {mult} or 0 for the kernel default")
    return set_levers


#: --on_anomaly values anomaly_settings accepts
ANOMALY_POLICIES = ("halt", "skip", "rollback")


def anomaly_settings(cfg: TrainConfig) -> dict:
    """Validated anomaly settings, the reference's rules: ValueError on a
    policy no path could honor (an unknown policy, a negative budget,
    rollback without a checkpoint cadence, ``check_nans`` beside a
    policy other than halt). The port has halt and skip: rollback raises
    NotImplementedError after the reference's checks."""
    if cfg.on_anomaly not in ANOMALY_POLICIES:
        raise ValueError(f"on_anomaly must be one of {ANOMALY_POLICIES}, "
                         f"got {cfg.on_anomaly!r}")
    if cfg.max_anomalies < 0:
        raise ValueError(
            f"max_anomalies={cfg.max_anomalies} must be >= 0 (the budget "
            "of anomalous steps tolerated before halting)")
    if cfg.on_anomaly == "rollback":
        if not cfg.checkpoint.directory:
            raise ValueError(
                "on_anomaly='rollback' restores the last verified "
                "checkpoint and needs checkpoint.directory (--ckpt_dir)")
        if not (cfg.checkpoint.save_steps or cfg.checkpoint.save_secs):
            raise ValueError(
                "on_anomaly='rollback' needs a checkpoint cadence "
                "(--save_steps or --save_secs): with no checkpoints there "
                "is nothing to roll back to")
    if cfg.obs.check_nans and cfg.on_anomaly != "halt":
        raise ValueError(
            "check_nans (per-step NanHook) pairs with on_anomaly='halt' "
            "only: under skip/rollback an anomalous step's metrics "
            "publish the -1.0 skipped sentinel, so the hook could never "
            "fire (a silently ignored knob is worse than an error)")
    if cfg.on_anomaly == "rollback":
        raise NotImplementedError(
            "on_anomaly='rollback' arrives with slice A3c-4; the port's "
            "Trainer has halt and skip")
    return {"policy": cfg.on_anomaly, "budget": cfg.max_anomalies}


def lm_loss_settings(cfg: TrainConfig) -> tuple[str, int]:
    """Validated ``(impl, chunk)`` from ``lm_loss_impl``/``lm_loss_chunk``,
    with the reference's rules: ``None`` resolves to "full", or to
    "chunked" when a chunk is set; a chunked impl without a chunk, a chunk
    beside another impl, or a negative chunk raise."""
    impl, chunk = cfg.lm_loss_impl, cfg.lm_loss_chunk
    if impl is not None and impl not in LM_LOSS_IMPLS:
        raise ValueError(f"lm_loss_impl must be one of {LM_LOSS_IMPLS}, "
                         f"got {impl!r}")
    if chunk is not None and chunk < 0:
        raise ValueError(f"lm_loss_chunk={chunk} must be >= 0")
    if impl == "chunked" and not chunk:
        raise ValueError("lm_loss_impl='chunked' needs lm_loss_chunk > 0 "
                         "(the chunk size; it must divide seq_len)")
    if chunk and impl not in (None, "chunked"):
        raise ValueError(f"lm_loss_chunk={chunk} conflicts with "
                         f"lm_loss_impl={impl!r}: the chunk is the "
                         "'chunked' impl's lever")
    return impl or ("chunked" if chunk else "full"), chunk or 0
