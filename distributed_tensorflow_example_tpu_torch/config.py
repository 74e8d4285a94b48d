"""Config dataclasses (port of ``distributed_tensorflow_example_tpu/
config.py``, the fields GPT, BERT, MLP, LeNet and ResNet construction,
generation, the sync training step and the ``Trainer`` read, MoE-BERT's
routing knobs, the parameter EMA, bf16 moments and warm start included).

Field names and defaults are the reference's, so a config reads the same
in both packages.
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
    data_dir: str | None = None     # directory of real files;
                                    # None => the synthetic set
    batch_size: int = 128           # GLOBAL batch size
    shuffle: bool = True
    seed: int = 0
    synthetic: bool = False         # force synthetic data even if data_dir set
    prefetch: int = 2               # host-side prefetch depth
    native: bool = False            # C++ loader and parsers (data/native.py);
                                    # raises when the library cannot build
    max_per_class: int | None = None  # cap eager folder-tree decode (ImageNet)
    label_offset: int = 0           # TFRecord image shards: added to
                                    # every label (tf-slim ImageNet
                                    # writes 1-indexed labels: pass -1)
    streaming: bool = False         # decode-per-batch thread-pool pipeline
                                    # (data/streaming.py) instead of the
                                    # eager whole-split decode (ImageNet)
    fast_decode: bool = False       # JPEG DCT-domain downscale decode
                                    # (streaming ImageNet; the pixels
                                    # deviate slightly from the plain decode)
    augment: bool = False           # training augmentation, train split
                                    # only: ImageNet random-resized crop +
                                    # flip (streaming path), CIFAR pad-4
                                    # crop + flip (loader transform)
    seq_len: int = 128
    vocab_size: int = 30522
    mlm_mask_prob: float = 0.15     # BERT: share of positions masked


@dataclasses.dataclass
class OptimizerConfig:
    """Base-optimizer knobs (``train/optimizers.py`` reads them)."""

    name: str = "sgd"               # sgd | momentum | adam | adamw |
                                    # lars | lamb | adafactor (factored
                                    # 2nd moments; momentum=0 -> the
                                    # memory-frugal T5 setup)
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
    moment_dtype: str = "float32"   # float32 | bfloat16: the first
                                    # moment's storage dtype (Adam mu, the
                                    # momentum trace, adafactor's momentum)
    ema_decay: float = 0.0          # > 0 keeps a shadow-param EMA (f32,
                                    # the chain's last link); eval and
                                    # the export use the shadow
    ema_debias: bool = False        # the num_updates ramp:
                                    # min(decay, (1+n)/(10+n))


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
    """Logical mesh axis sizes (the reference's). The port runs one rank
    a card, so the axes multiply to the number of ranks (one ``-1``
    takes the rest). Every axis trains (``fsdp`` shards the params and
    their optimizer state ZeRO-3's way, ``model`` by the models'
    Megatron rules, the layers computing on the pieces; along ``seq`` the
    model is replicated unless ring attention is bound; ``expert`` splits
    the MoE models' experts; ``pipe`` splits the pipe models' stacked
    blocks into GPipe stages)."""

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
    warm_start: str | None = None   # checkpoint file or directory whose
                                    # params initialize a FRESH run
                                    # (a checkpoint in ``directory``,
                                    # i.e. resume, always wins)
    warm_start_map: str = ""        # 'ckpt_prefix:model_prefix' pairs,
                                    # comma-separated (assignment map)
    max_to_keep: int = 5
    keep_best_metric: str | None = None  # eval metric tracked for the
                                         # 'best' checkpoint (needs eval
                                         # data)
    keep_best_mode: str = "max"          # max (accuracy) | min (loss)
    save_steps: int = 0             # save every N steps (0 disables)
    save_secs: float = 0.0          # save every T seconds (0 disables)
    keep_checkpoint_every_n_hours: float = 0.0
    async_save: bool = False        # write on a background thread
    sharded: bool = False           # per-rank shard files under a
                                    # ckpt-N.shards.json anchor


@dataclasses.dataclass
class ObservabilityConfig:
    """Logging, metrics, summaries, profiling and tracing knobs."""

    log_every_steps: int = 100
    metrics_path: str | None = None   # JSONL sink; None => stdout only
    tb_logdir: str | None = None      # TensorBoard event-file sink
    profile_steps: tuple[int, int] | None = None  # [start, stop) steps
    profile_dir: str | None = None    # torch.profiler Chrome traces
    check_nans: bool = False          # NanTensorHook analogue
    debug_checks: bool = False        # raise on a non-finite loss, aux
                                      # metric or gradient (a host sync
                                      # every step)
    debug_nans: bool = False          # autograd anomaly mode with NaN
                                      # checks on every backward output
    summary_every_steps: int = 0      # scalar summary cadence (0 disables)
    param_histograms_every_steps: int = 0  # weight-histogram cadence
                                           # (pulls the params to the host)
    step_timing: bool = False         # per-dispatch device-time records;
                                      # a device sync every step
    trace_path: str | None = None     # dump the training-loop lanes
                                      # (data / step / checkpoint /
                                      # rollback) as Chrome trace JSON
    trace_buffer_events: int = 65536  # span ring bound for trace_path


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
    early_stop_metric: str | None = None  # stop when this eval metric
                                          # stops improving (needs
                                          # eval_every_steps)
    early_stop_patience: int = 3     # evals without improvement
    early_stop_mode: str = "max"     # max (accuracy) | min (loss)
    steps_per_loop: int = 1          # steps a dispatch (K > 1:
                                     # SyncReplicas.multi_step on K
                                     # stacked batches; hook cadences
                                     # must be multiples of K)
    max_inflight_steps: int = 0      # the host waits for the card every
                                     # N trained steps (0: never mid-loop)
    on_anomaly: str = "halt"         # halt | skip | rollback (restore the
                                     # last verified checkpoint, replay)
    max_anomalies: int = 10          # anomaly budget for skip/rollback
    fault_spec: str = ""             # fault injection (runtime/faults.py
                                     # grammar); empty = inert
    lm_loss_impl: str | None = None  # full | chunked | fused; None =
                                     # "full", or "chunked" when
                                     # lm_loss_chunk is set
    lm_loss_chunk: int | None = None  # seq chunk of the chunked LM loss
    lm_loss_vocab_block: int | None = None  # fused: vocab tile (0 = the
                                            # default, 2048)
    token_accuracy_every_n: int = 1  # gpt: the token_accuracy argmax every
                                     # n-th step (others publish -1.0)
    seed: int = 0
    label_smoothing: float = 0.0     # image classifiers' training targets
    # MoE-BERT knobs (moe_bert*): None keeps the model's default; the CLI
    # refuses them for any other model
    moe_experts: int | None = None       # experts a MoE layer
    moe_top_k: int | None = None         # routed experts a token
    moe_capacity_factor: float | None = None
    moe_every: int | None = None         # a MoE FFN every k-th layer
    moe_aux_weight: float | None = None  # load-balancing loss weight
    moe_router_z_weight: float | None = None  # router z-loss weight
    moe_jitter: float | None = None      # router noise U[1-j, 1+j], train
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
    remat: str = "none"              # none | full | dots: recompute each
                                     # transformer layer in the backward

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
    """Validated self-healing settings, the reference's rules:
    ValueError on a policy no path could honor (an unknown policy, a
    negative budget, rollback without a checkpoint cadence,
    ``check_nans`` beside a policy other than halt). The fault spec's
    grammar is ``runtime.faults.parse_spec``'s to check."""
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
    return {"policy": cfg.on_anomaly, "budget": cfg.max_anomalies,
            "fault_spec": cfg.fault_spec}


def lm_loss_settings(cfg: TrainConfig) -> dict:
    """Validated, resolved LM-head loss settings from the ``lm_loss_*`` and
    ``token_accuracy_every_n`` knobs: ``{"impl", "chunk", "vocab_block",
    "accuracy_every_n"}``, the reference's dict. ``impl=None`` resolves to
    "full", or to "chunked" when a chunk is set. Raises ValueError, with
    the reference's rules and messages, on values no path could honor or
    on a knob another knob would silently ignore."""
    impl = cfg.lm_loss_impl
    chunk = cfg.lm_loss_chunk
    block = cfg.lm_loss_vocab_block
    every = cfg.token_accuracy_every_n
    if impl is not None and impl not in LM_LOSS_IMPLS:
        raise ValueError(f"lm_loss_impl must be one of {LM_LOSS_IMPLS}, "
                         f"got {impl!r}")
    if chunk is not None and chunk < 0:
        raise ValueError(f"lm_loss_chunk={chunk} must be >= 0")
    if block is not None and block < 0:
        raise ValueError(f"lm_loss_vocab_block={block} must be >= 0")
    if every < 1:
        raise ValueError(
            f"token_accuracy_every_n={every} must be >= 1 (1 = the "
            "default per-step argmax)")
    if impl == "chunked" and not chunk:
        raise ValueError(
            "lm_loss_impl='chunked' needs lm_loss_chunk > 0 (the chunk "
            "size; it must divide seq_len)")
    if chunk and impl not in (None, "chunked"):
        raise ValueError(
            f"lm_loss_chunk={chunk} conflicts with lm_loss_impl="
            f"{impl!r}: the chunk is the 'chunked' impl's lever (fused "
            "never materializes the logits the chunk recompute bounds; "
            "full materializes them whole)")
    if block and impl != "fused":
        raise ValueError(
            f"lm_loss_vocab_block={block} tunes the fused vocab scan "
            f"and requires lm_loss_impl='fused', got {impl!r}")
    if every != 1 and impl == "fused":
        raise ValueError(
            f"token_accuracy_every_n={every} skips the full/chunked "
            "paths' per-step argmax; the fused path computes accuracy "
            "inside the same vocab scan at no extra cost — drop the "
            "knob (a silently ignored knob is worse than an error)")
    if every != 1 and cfg.sync.accum_steps > 1:
        raise ValueError(
            f"token_accuracy_every_n={every} does not compose with "
            f"accum_steps={cfg.sync.accum_steps}: the loss runs once "
            "per MICROBATCH, so the cadence counter would tick per "
            "microbatch and the microbatch-mean of metrics would "
            "average real accuracies with the -1.0 skipped sentinel "
            "into a number that is neither")
    return {
        "impl": impl or ("chunked" if chunk else "full"),
        "chunk": chunk or 0,
        "vocab_block": block or 0,
        "accuracy_every_n": every,
    }
