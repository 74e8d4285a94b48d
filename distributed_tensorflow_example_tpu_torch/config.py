"""Config dataclasses (port of ``distributed_tensorflow_example_tpu/
config.py``, the fields GPT construction, generation and the one-card
training step read).

Field names and defaults are the reference's, so a config reads the same
in both packages; the other training, data-pipeline, mesh and
observability knobs arrive with the slices that read them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .ops.losses import LM_LOSS_IMPLS


@dataclasses.dataclass
class DataConfig:
    """The data fields a language model reads."""

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
    moment_dtype: str = "float32"   # bfloat16 arrives with slice A5
    ema_decay: float = 0.0          # > 0 (shadow-param EMA): slice A5


@dataclasses.dataclass
class SyncConfig:
    """Sync-replica semantics (``parallel/sync_replicas.py`` reads them).
    The port runs one replica; more arrive with slice A3c."""

    replicas_to_aggregate: int | None = None  # None => the replica count
    total_num_replicas: int | None = None     # must equal it
    accum_steps: int = 1                      # microbatch accumulation
    mode: str = "auto"                        # auto | shard_map


@dataclasses.dataclass
class TrainConfig:
    """Top-level config (the fields GPT and the training step read)."""

    model: str = "mlp"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    sync: SyncConfig = dataclasses.field(default_factory=SyncConfig)
    lm_loss_impl: str | None = None  # full (chunked, fused: slice A3c);
                                     # None = "full", or "chunked" when
                                     # lm_loss_chunk is set
    lm_loss_chunk: int | None = None  # seq chunk of the chunked LM loss
    seed: int = 0
    dtype: str = "float32"           # compute dtype: float32 | bfloat16
    param_dtype: str = "float32"
    attention_impl: str = "xla"      # xla | flash (hand-written kernel)
    # flash-kernel tuning levers (attention_impl="flash" only; 0 = the
    # kernel default)
    attention_block_q: int = 0
    attention_block_k: int = 0
    attention_bwd_block: int = 0
    attention_bwd: str = "split"     # split | fused (backward variant)

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
