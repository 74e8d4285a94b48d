"""Trainer entry point (an adapted copy of
``distributed_tensorflow_example_tpu/cli/train.py``), one replica per
rank::

    python -m distributed_tensorflow_example_tpu_torch.cli.train \\
        --model mlp --batch_size 256 --learning_rate 0.5 \\
        --train_steps 1000 --ckpt_dir D --save_steps 500

    python -m distributed_tensorflow_example_tpu_torch.cli.train \\
        --model resnet50 --dtype bfloat16 --batch_size 128 \\
        --optimizer momentum --learning_rate 0.05 --warmup_steps 5 \\
        --train_steps 30

    python -m distributed_tensorflow_example_tpu_torch.cli.train \\
        --model bert --dtype bfloat16 --attention flash \\
        --optimizer lamb --learning_rate 1e-3 --batch_size 64 \\
        --seq_len 128 --train_steps 30

    python -m distributed_tensorflow_example_tpu_torch.cli.train \\
        --model gpt --attention flash --attention_bwd fused \\
        --dtype bfloat16 --seq_len 512 --batch_size 8 --optimizer adamw \\
        --learning_rate 1e-3 --train_steps 20 --ckpt_dir D --save_steps 10

Every reference flag parses, so the same argv reads the same in both
packages, and the reference's validation runs first with its messages.
Then every flag of a later slice is refused with a SystemExit naming the
slice, before any work. ``--device`` (``cuda`` by default, ``cpu`` when
asked) picks the device; without CUDA, ``cuda`` exits with an error.
``--job_name ps`` logs the no-PS notice and returns 0. With
``--worker_hosts`` naming N workers, ``--task_index i`` trains as rank i
of N (worker 0's address the rendezvous, NCCL on ``cuda``, gloo on the
CPU): each rank takes its slice of every global batch and the sync step
all-reduces the gradients (and, for the batch-norm models under
``--sync_mode auto``, the batch statistics). The port trains ``mlp`` and
``lenet`` on MNIST (IDX files under ``--data_dir``, else the synthetic
set), ``resnet20`` on CIFAR-10 (the binary batches under ``--data_dir``,
else the synthetic set; ``--augment`` for the pad-4 crop and flip),
``resnet50`` on synthetic ImageNet, ``gpt`` and ``gpt_tiny`` on the
synthetic LM corpus or pre-tokenized ``.npy`` files, and ``bert``,
``bert_large`` and ``bert_tiny`` (masked LM) on the same tokens, masked
(a raw-text corpus with a ``vocab.txt`` arrives with slice A5b);
checkpoints into
``--ckpt_dir`` (a second run on the same directory resumes; ``--async_save``
writes on a background thread, ``--keep_best_metric`` keeps the best
eval's checkpoint), evaluates at the end (or every
``--eval_every_steps``, with ``--early_stop_metric``), and hands the
trained weights to the port's ``PredictServer``: ``--export_dir`` writes
the forward's artifact (``:predict``), ``--export_generator`` the GPT
generator's (``:generate``). ``--eval_only`` evaluates a checkpoint without
training (the latest, ``--eval_step N`` or ``--eval_best``) and prints
one JSON line. ``--on_anomaly rollback`` and ``--fault_spec``, the
TensorBoard, summary and histogram sinks, ``--step_timing`` (with the
first step's FLOPs), the ``torch.profiler`` hook and ``--trace_path`` are
the reference's. The debug tools are their torch counterparts:
``--debug_checks`` raises naming the first non-finite loss or gradient,
``--debug_nans`` runs autograd's anomaly mode with NaN checks, and
``--profiler_port`` opens a loopback listener whose ``POST
/capture?steps=N`` traces the next N steps.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from ..cluster import WORKER_JOB, ClusterSpec
from ..config import (CheckpointConfig, DataConfig, MeshShape,
                      ObservabilityConfig, OptimizerConfig, SyncConfig,
                      TrainConfig, anomaly_settings, flash_attention_kwargs,
                      lm_loss_settings)
from ..utils.logging import get_logger

log = get_logger("cli")

#: the models the port trains, and the datasets it reads (the dataset
#: aliases are the reference's)
LM_MODELS = ("gpt", "gpt_tiny")
BERT_MODELS = ("bert", "bert_large", "bert_tiny")
MNIST_DATASETS = ("mlp", "mnist", "lenet")
CIFAR_DATASETS = ("resnet20", "cifar10", "cifar")
IMAGENET_DATASETS = ("resnet50", "imagenet")
MODELS = ("mlp", "lenet", "resnet20", "resnet50") + LM_MODELS + BERT_MODELS
DATASETS = (MNIST_DATASETS + CIFAR_DATASETS + IMAGENET_DATASETS + LM_MODELS
            + BERT_MODELS)


def add_legacy_flags(parser: argparse.ArgumentParser) -> None:
    """The reference's distributed flags."""
    parser.add_argument("--ps_hosts", type=str, default="",
                        help="comma-separated ps host:port list (legacy; "
                             "no PS role: accepted and mapped away)")
    parser.add_argument("--worker_hosts", type=str, default="",
                        help="comma-separated worker host:port list "
                             "(legacy)")
    parser.add_argument("--job_name", type=str, default="worker",
                        choices=["ps", "worker"],
                        help="legacy job name; 'ps' exits 0 with a notice")
    parser.add_argument("--task_index", type=int, default=0,
                        help="legacy task index (the process index)")


def parse_hosts(csv: str) -> list[str]:
    return [h.strip() for h in csv.split(",") if h.strip()]


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags (a later slice's are refused in
    :func:`main`) plus ``--device``."""
    p = argparse.ArgumentParser(
        description="sync data-parallel trainer, one replica per rank "
                    "(distributed-tensorflow-example parity CLI)")
    add_legacy_flags(p)
    a = p.add_argument
    a("--device", default="cuda", choices=["cuda", "cpu"],
      help="device to train on (cuda unless the caller asks for the CPU)")
    a("--model", default="mlp", help="mlp | lenet | resnet20 | resnet50 | "
      "gpt | gpt_tiny | bert | bert_large | bert_tiny (the MoE and "
      "pipeline models of the reference arrive with later slices)")
    a("--dataset", default=None,
      help="default: the model's canonical dataset")
    a("--data_dir", default=None,
      help="MNIST IDX files, CIFAR-10 binary batches, or pre-tokenized "
           "train.npy/test.npy or tokens.npy; omit for the synthetic set "
           "(ImageNet files, a vocab.txt text corpus: slice A5b)")
    a("--native", action="store_true", help="C++ loader (slice A5b)")
    a("--streaming", action="store_true", help="slice A5b")
    a("--fast_decode", action="store_true", help="slice A5b")
    a("--augment", action="store_true",
      help="CIFAR pad-4 crop + flip on the train split (ImageNet: slice "
           "A5b)")
    a("--label_offset", type=int, default=0, help="slice A5b")
    a("--max_per_class", type=int, default=None, help="slice A5b")
    a("--seq_len", type=int, default=128,
      help="sequence length (must be <= the model's max_len)")
    a("--batch_size", type=int, default=128, help="GLOBAL batch size")
    a("--train_steps", type=int, default=1000)
    a("--steps_per_loop", type=int, default=1,
      help="steps per dispatch (> 1: slice A3c-2b)")
    a("--max_inflight_steps", type=int, default=0, help="slice A3c-2b")
    a("--learning_rate", type=float, default=0.5)
    a("--optimizer", default="sgd", type=str.lower,
      choices=["sgd", "momentum", "adam", "adamw", "lars", "lamb",
               "adafactor"],
      help="base optimizer (lars/lamb: the large-batch layer-wise trust "
           "ratio; adafactor: factored second moments, --momentum 0 for "
           "the least memory)")
    a("--momentum", type=float, default=0.9)
    a("--weight_decay", type=float, default=0.0)
    a("--wd_mask", default="exclude_1d", choices=["exclude_1d", "all"])
    a("--warmup_steps", type=int, default=0, help="linear LR warmup steps")
    a("--decay_schedule", default="constant",
      choices=["constant", "cosine", "linear", "piecewise", "exponential",
               "polynomial", "natural_exp", "inverse_time"])
    a("--decay_steps", type=int, default=0)
    a("--end_learning_rate", type=float, default=0.0)
    a("--decay_power", type=float, default=1.0)
    a("--decay_boundaries", default="",
      help="comma-separated steps where piecewise LR drops")
    a("--decay_factor", type=float, default=0.1)
    for flag, typ in (("--moe_experts", int), ("--moe_top_k", int),
                      ("--moe_capacity_factor", float),
                      ("--moe_every", int), ("--moe_aux_weight", float),
                      ("--moe_router_z_weight", float),
                      ("--moe_jitter", float)):
        a(flag, type=typ, default=None, help="MoE models (slice A5b)")
    a("--lm_loss_impl", default=None, choices=["full", "chunked", "fused"],
      help="LM-head loss: full = the [.., V] f32 logits; chunked = "
           "sequence chunks recomputed in the backward (gpt; needs "
           "--lm_loss_chunk); fused = blockwise over the vocab, no [.., V] "
           "logits in either direction (default: full, or chunked when "
           "--lm_loss_chunk is set)")
    a("--lm_loss_vocab_block", type=int, default=None,
      help="vocab tile of --lm_loss_impl fused (0: 2048)")
    a("--token_accuracy_every_n", type=int, default=1,
      help="gpt: the token_accuracy argmax only every n-th step (the "
           "others publish -1.0); refused with --lm_loss_impl fused")
    a("--lm_loss_chunk", type=int, default=None,
      help="gpt: sequence chunk of the chunked LM loss (divides seq_len)")
    a("--mlm_mask_prob", type=float, default=0.15,
      help="bert: share of the maskable positions masked")
    a("--label_smoothing", type=float, default=0.0,
      help="training-target smoothing of the image classifiers")
    a("--grad_clip_norm", type=float, default=0.0,
      help="global-norm gradient clipping (0 disables)")
    a("--grad_clip_value", type=float, default=0.0,
      help="elementwise |g| clipping (0 disables)")
    a("--export_dir", default=None,
      help="write the trained forward's serving artifact (the port's "
           "PredictServer serves it on :predict)")
    a("--export_generator", default=None, metavar="DIR",
      help="write a generator artifact (the port's PredictServer serves "
           "it) after training; gpt/gpt_tiny")
    a("--gen_prompt_len", type=int, default=128)
    a("--gen_max_new", type=int, default=128)
    a("--gen_batch", type=int, default=1)
    a("--gen_temperature", type=float, default=0.0)
    a("--gen_top_k", type=int, default=0)
    a("--gen_top_p", type=float, default=0.0)
    a("--gen_eos_id", type=int, default=None)
    a("--gen_pad_id", type=int, default=0)
    a("--gen_ragged", action="store_true")
    a("--gen_weight_quant", default="off", choices=["off", "int8"])
    a("--warm_start", default=None, help="slice A5b")
    a("--warm_start_map", default="", help="slice A5b")
    a("--ema_decay", type=float, default=0.0, help="slice A5b")
    a("--ema_debias", action="store_true", help="slice A5b")
    a("--moment_dtype", default="float32", choices=["float32", "bfloat16"],
      help="bfloat16: slice A5b")
    a("--accum_steps", type=int, default=1)
    a("--dtype", default="float32", choices=["float32", "bfloat16"])
    a("--param_dtype", default="float32", choices=["float32", "bfloat16"])
    a("--bn_stats_dtype", default="float32",
      choices=["float32", "bfloat16"],
      help="batch-statistic reduction dtype of the ResNets")
    a("--mesh", default="",
      help="axis sizes; the port takes data=-1 or data=<ranks> (one "
           "replica per rank; sharded axes: slice A6)")
    a("--sync_mode", default="auto", choices=["auto", "shard_map"],
      help="auto: batch norm over the global batch (sync-BN); "
           "shard_map: over each rank's batch")
    a("--attention", default="xla", choices=["xla", "flash"],
      help="flash = the hand-written Hopper kernels")
    a("--attention_block_q", type=int, default=0,
      help="refused: the Hopper kernels' tiles are fixed at 64x64")
    a("--attention_block_k", type=int, default=0, help="as block_q")
    a("--attention_bwd_block", type=int, default=0, help="as block_q")
    a("--attention_bwd", default="split", choices=["split", "fused"],
      help="flash backward: split = B2a + B2b; fused = B3 (dq, dk, dv in "
           "one kernel); requires --attention flash")
    a("--prng_impl", default="threefry2x32",
      choices=["threefry2x32", "rbg", "unsafe_rbg"],
      help="a JAX key implementation: the port draws dropout from torch "
           "generators and takes only the default")
    a("--remat", default="none", choices=["none", "full", "dots"],
      help="recompute each transformer layer in the backward: full keeps "
           "the layer's input only, dots also the dense layers' outputs")
    a("--ckpt_dir", default=None)
    a("--save_steps", type=int, default=0)
    a("--save_secs", type=float, default=0.0)
    a("--max_to_keep", type=int, default=5)
    a("--keep_best_metric", default=None,
      help="eval metric whose best checkpoint is kept out of ring "
           "rotation (needs eval data and --ckpt_dir)")
    a("--keep_best_mode", default="max", choices=["max", "min"])
    a("--keep_checkpoint_every_n_hours", type=float, default=0.0)
    a("--async_save", action="store_true",
      help="write checkpoints on a background thread (the copy to the "
           "host stays on the step)")
    a("--sharded_save", action="store_true", help="slice A6")
    a("--log_every_steps", type=int, default=100)
    a("--summary_every_steps", type=int, default=0,
      help="scalar-summary cadence to the metrics sinks (0 disables)")
    a("--param_histograms_every_steps", type=int, default=0,
      help="weight-histogram cadence (HistogramProtos to --tb_logdir, "
           "summary stats to the JSONL; 0 disables)")
    a("--metrics_path", default=None)
    a("--tb_logdir", default=None,
      help="write TensorBoard event files here (no TensorFlow needed)")
    a("--eval_every_steps", type=int, default=0)
    a("--early_stop_metric", default=None,
      help="stop when this eval metric stops improving (needs "
           "--eval_every_steps)")
    a("--early_stop_patience", type=int, default=3)
    a("--early_stop_mode", default="max", choices=["max", "min"])
    a("--eval_only", action="store_true",
      help="no training: restore the latest checkpoint from --ckpt_dir "
           "(or --eval_step N, or --eval_best), evaluate, print one JSON "
           "line, exit")
    a("--eval_step", type=int, default=None,
      help="checkpoint step to evaluate (--eval_only; default: latest)")
    a("--eval_best", action="store_true",
      help="with --eval_only: evaluate (and, with --export_generator, "
           "export) the best checkpoint --keep_best_metric recorded")
    a("--seed", type=int, default=0)
    a("--on_anomaly", default="halt", choices=["halt", "skip", "rollback"],
      help="non-finite loss or grad-norm: halt | skip (identity update) "
           "| rollback (restore the last verified checkpoint, replay)")
    a("--max_anomalies", type=int, default=10)
    a("--fault_spec", default="",
      help="fault injection rules (runtime/faults.py grammar), e.g. "
           "'ckpt.write:step=2;loader.next:p=0.01'")
    a("--check_nans", action="store_true",
      help="stop on a non-finite loss (a host sync every step)")
    a("--debug_checks", action="store_true",
      help="raise FloatingPointError naming the step and the first "
           "non-finite loss, aux metric or gradient leaf (one host sync a "
           "step; debugging only)")
    a("--debug_nans", action="store_true",
      help="autograd anomaly mode with NaN checks: the first backward op "
           "that returns a NaN raises, with its forward's traceback")
    a("--profiler_port", type=int, default=0,
      help="loopback capture listener on this port + the rank: POST "
           "/capture?steps=N traces the next N steps and answers with the "
           "Chrome trace's path (into --profile_dir, else a temp dir)")
    a("--profile_dir", default=None,
      help="torch.profiler Chrome traces of --profile_steps land here")
    a("--profile_steps", default=None,
      help="start,stop step range for the profiler hook")
    a("--step_timing", action="store_true",
      help="per-step device-time percentiles to the metrics JSONL (a "
           "device sync every step)")
    a("--trace_path", default=None,
      help="dump the training loop's span lanes (data, step, checkpoint, "
           "rollback) as Chrome trace JSON here when training ends")
    a("--trace_buffer_events", type=int, default=65536,
      help="span ring bound for --trace_path (oldest drop first)")
    return p


def parse_mesh(spec: str) -> MeshShape | None:
    if not spec:
        return None
    kw = {}
    for part in spec.split(","):
        k, v = part.split("=")
        kw[k.strip()] = int(v)
    return MeshShape(**kw)


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    """The TrainConfig of the fields the port carries."""
    profile_steps = None
    if args.profile_steps:
        a, b = args.profile_steps.split(",")
        profile_steps = (int(a), int(b))
    return TrainConfig(
        model=args.model,
        train_steps=args.train_steps,
        lm_loss_impl=args.lm_loss_impl,
        lm_loss_chunk=args.lm_loss_chunk,
        lm_loss_vocab_block=args.lm_loss_vocab_block,
        token_accuracy_every_n=args.token_accuracy_every_n,
        remat=args.remat,
        eval_every_steps=args.eval_every_steps,
        early_stop_metric=args.early_stop_metric,
        early_stop_patience=args.early_stop_patience,
        early_stop_mode=args.early_stop_mode,
        steps_per_loop=args.steps_per_loop,
        on_anomaly=args.on_anomaly,
        max_anomalies=args.max_anomalies,
        fault_spec=args.fault_spec,
        seed=args.seed,
        label_smoothing=args.label_smoothing,
        bn_stats_dtype=args.bn_stats_dtype,
        dtype=args.dtype,
        param_dtype=args.param_dtype,
        attention_impl=args.attention,
        attention_block_q=args.attention_block_q,
        attention_block_k=args.attention_block_k,
        attention_bwd_block=args.attention_bwd_block,
        attention_bwd=args.attention_bwd,
        mesh=parse_mesh(args.mesh) or MeshShape(data=-1),
        data=DataConfig(dataset=args.dataset or args.model,
                        data_dir=args.data_dir,
                        batch_size=args.batch_size, seed=args.seed,
                        augment=args.augment, seq_len=args.seq_len,
                        mlm_mask_prob=args.mlm_mask_prob),
        optimizer=OptimizerConfig(
            name=args.optimizer, learning_rate=args.learning_rate,
            momentum=args.momentum, weight_decay=args.weight_decay,
            wd_mask=args.wd_mask, warmup_steps=args.warmup_steps,
            decay_schedule=args.decay_schedule,
            decay_boundaries=tuple(int(b) for b in
                                   args.decay_boundaries.split(",")
                                   if b.strip()),
            decay_factor=args.decay_factor, decay_steps=args.decay_steps,
            end_learning_rate=args.end_learning_rate,
            decay_power=args.decay_power,
            grad_clip_norm=args.grad_clip_norm,
            grad_clip_value=args.grad_clip_value,
            moment_dtype=args.moment_dtype, ema_decay=args.ema_decay,
            total_steps=args.train_steps),
        sync=SyncConfig(accum_steps=args.accum_steps, mode=args.sync_mode),
        checkpoint=CheckpointConfig(
            directory=args.ckpt_dir, max_to_keep=args.max_to_keep,
            keep_best_metric=args.keep_best_metric,
            keep_best_mode=args.keep_best_mode,
            save_steps=args.save_steps, save_secs=args.save_secs,
            keep_checkpoint_every_n_hours=(
                args.keep_checkpoint_every_n_hours),
            async_save=args.async_save),
        obs=ObservabilityConfig(
            log_every_steps=args.log_every_steps,
            metrics_path=args.metrics_path, tb_logdir=args.tb_logdir,
            profile_steps=profile_steps, profile_dir=args.profile_dir,
            check_nans=args.check_nans, debug_checks=args.debug_checks,
            debug_nans=args.debug_nans,
            summary_every_steps=args.summary_every_steps,
            param_histograms_every_steps=(
                args.param_histograms_every_steps),
            step_timing=args.step_timing, trace_path=args.trace_path,
            trace_buffer_events=args.trace_buffer_events),
    )


def _validate_like_the_reference(parser, args) -> TrainConfig:
    """The reference's checks, in its order and with its messages."""
    if args.eval_only and not args.ckpt_dir:
        raise SystemExit("--eval_only requires --ckpt_dir")
    for flag, d in (("--export_dir", args.export_dir),
                    ("--export_generator", args.export_generator)):
        if not d:
            continue
        # an unwritable export target fails now, not after the run
        try:
            os.makedirs(d, exist_ok=True)
            if not os.access(d, os.W_OK):
                raise PermissionError(d)
        except OSError as e:
            raise SystemExit(f"{flag} is not writable: {e}")
    if args.label_smoothing and args.model not in ("lenet", "resnet20",
                                                   "resnet50"):
        raise SystemExit(
            f"--label_smoothing is wired for the image classifiers "
            f"(lenet/resnet20/resnet50), not model {args.model!r}")
    if args.lm_loss_chunk is not None and not args.model.startswith("gpt"):
        raise SystemExit(
            f"--lm_loss_chunk is a causal-LM knob (gpt/gpt_tiny), not "
            f"for model {args.model!r}")
    lm_head_model = args.model.startswith(
        ("gpt", "bert", "moe_bert", "pipe_bert", "pipe_moe"))
    if ((args.lm_loss_impl is not None
         or args.lm_loss_vocab_block is not None)
            and not lm_head_model):
        raise SystemExit(
            f"--lm_loss_impl/--lm_loss_vocab_block configure the LM-head "
            f"cross-entropy (gpt/bert families), not for model "
            f"{args.model!r}")
    if args.token_accuracy_every_n != 1 and not args.model.startswith(
            "gpt"):
        raise SystemExit(
            f"--token_accuracy_every_n is a causal-LM knob (gpt/"
            f"gpt_tiny), not for model {args.model!r}")
    cfg = config_from_args(args)
    try:
        flash_attention_kwargs(cfg)
        lm_loss_settings(cfg)
        anomaly_settings(cfg)
        if cfg.fault_spec:
            from ..runtime import faults
            faults.parse_spec(cfg.fault_spec, seed=cfg.seed)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.export_generator and not args.model.startswith("gpt"):
        raise SystemExit(
            f"--export_generator is a causal-LM knob (gpt/gpt_tiny), "
            f"not for model {args.model!r} — only decoder models have "
            "a KV-cache generate path")
    gen_dests = [d for d in vars(args) if d.startswith("gen_")]
    if not args.export_generator:
        for d in gen_dests:
            if getattr(args, d) != parser.get_default(d):
                raise SystemExit(
                    f"--{d} configures the generator artifact and "
                    "does nothing without --export_generator DIR")
    else:
        if ((args.gen_top_k or args.gen_top_p)
                and args.gen_temperature <= 0.0):
            raise SystemExit(
                "--gen_top_k/--gen_top_p shape the sampling "
                "distribution; set --gen_temperature > 0")
        if not 0.0 <= args.gen_top_p <= 1.0:
            raise SystemExit(
                f"--gen_top_p must be in [0, 1], got {args.gen_top_p}")
        if args.gen_top_k < 0:
            raise SystemExit(
                f"--gen_top_k must be >= 0, got {args.gen_top_k}")
        for flag, v in (("--gen_prompt_len", args.gen_prompt_len),
                        ("--gen_max_new", args.gen_max_new),
                        ("--gen_batch", args.gen_batch)):
            if v < 1:
                raise SystemExit(f"{flag} must be >= 1, got {v}")
    for flag in ("moe_experts", "moe_top_k", "moe_capacity_factor",
                 "moe_every", "moe_aux_weight", "moe_router_z_weight",
                 "moe_jitter"):
        if getattr(args, flag) is not None and not (
                args.model.startswith("moe_")
                or args.model.startswith("pipe_moe_")):
            raise SystemExit(
                f"--{flag} is an MoE routing knob (moe_bert/moe_bert_tiny/"
                f"pipe_moe_bert/pipe_moe_bert_tiny), not for "
                f"model {args.model!r}")
    return cfg


def _num_workers(args) -> int:
    return len(parse_hosts(args.worker_hosts)) or 1


def _slice_of(name: str) -> str:
    """The slice that brings a model or dataset the port lacks."""
    return "A6" if name.startswith("pipe_") else "A5b"


def _later_slice(args) -> list[tuple[str, bool, str]]:
    """(what, set?, slice) for every knob the port does not carry yet."""
    from ..train.trainer import one_replica_per_rank
    mesh = parse_mesh(args.mesh) or MeshShape(data=-1)
    dataset = args.dataset or args.model
    imagenet = dataset in IMAGENET_DATASETS
    return [
        (f"--model {args.model}", args.model not in MODELS,
         _slice_of(args.model)),
        (f"--dataset {dataset}", dataset not in DATASETS,
         _slice_of(dataset)),
        ("--native", args.native, "A5b"),
        ("--streaming", args.streaming, "A5b"),
        ("--fast_decode", args.fast_decode, "A5b"),
        ("--augment on ImageNet", args.augment and imagenet, "A5b"),
        ("--label_offset", args.label_offset != 0, "A5b"),
        ("--max_per_class", args.max_per_class is not None, "A5b"),
        ("--data_dir for ImageNet (the folder and TFRecord readers)",
         imagenet and bool(args.data_dir), "A5b"),
        ("--steps_per_loop > 1", args.steps_per_loop > 1, "A3c-2b"),
        ("--max_inflight_steps", args.max_inflight_steps != 0, "A3c-2b"),
        ("--moment_dtype bfloat16", args.moment_dtype != "float32", "A5b"),
        ("--ema_decay", args.ema_decay != 0.0, "A5b"),
        ("--ema_debias", args.ema_debias, "A5b"),
        ("--warm_start", args.warm_start is not None, "A5b"),
        ("--warm_start_map", bool(args.warm_start_map), "A5b"),
        (f"--mesh {args.mesh} (a sharded axis, or more replicas than the "
         f"{_num_workers(args)} rank(s))",
         not one_replica_per_rank(mesh, _num_workers(args)), "A6"),
        ("--sharded_save (per-rank shard files of a sharded state)",
         args.sharded_save, "A6"),
    ]


def refuse_later_slices(args) -> None:
    """SystemExit for the first set knob of a later slice, and for the
    knobs the port refuses by design."""
    for what, on, slice_ in _later_slice(args):
        if on:
            raise SystemExit(f"{what} arrives with slice {slice_} of the "
                             "port; the port trains " + ", ".join(MODELS)
                             + ", one replica per rank")
    for flag in ("attention_block_q", "attention_block_k",
                 "attention_bwd_block"):
        if getattr(args, flag):
            raise SystemExit(
                f"--{flag}: the Hopper flash-attention kernels have fixed "
                "64x64 tiles by design and take no tile lever")
    if args.prng_impl != "threefry2x32":
        raise SystemExit(
            f"--prng_impl {args.prng_impl} is a JAX key implementation: "
            "the port draws dropout from torch generators seeded by "
            "--seed and the step")


def load_dataset(cfg: TrainConfig, model=None):
    """(train_arrays, eval_arrays): MNIST for the MLP and LeNet (``x`` flat
    784, ``y`` int32), CIFAR-10 for ResNet-20 and synthetic ImageNet for
    ResNet-50 (``x`` NHWC f32 in [0, 1]), the LM corpus for the causal-LM
    models, and the same tokens masked for BERT (the vocab and
    ``max_predictions`` from the model, so data and logits agree)."""
    name = cfg.data.dataset
    if cfg.data.augment and name not in (CIFAR_DATASETS
                                         + IMAGENET_DATASETS):
        raise SystemExit(
            f"--augment is an image-training recipe; dataset {name!r} "
            "has no augmentation pipeline")
    if name in MNIST_DATASETS + CIFAR_DATASETS + IMAGENET_DATASETS:
        if name in MNIST_DATASETS:
            from ..data.mnist import get_mnist
            d = get_mnist(cfg.data.data_dir, cfg.data.synthetic)
        elif name in CIFAR_DATASETS:
            from ..data.cifar import get_cifar10
            d = get_cifar10(cfg.data.data_dir, cfg.data.synthetic)
        else:
            from ..data.imagenet import get_imagenet
            d = get_imagenet(cfg.data.data_dir, cfg.data.synthetic)
        return ({"x": d["train_x"], "y": d["train_y"]},
                {"x": d["test_x"], "y": d["test_y"]})
    if name not in LM_MODELS + BERT_MODELS:
        raise SystemExit(f"dataset {name!r} arrives with a later slice of "
                         "the port")
    from ..data.bert_data import get_bert_data, get_lm_data
    mcfg = getattr(model, "cfg", None)
    vocab = mcfg.vocab_size if mcfg else cfg.data.vocab_size
    if mcfg and cfg.data.seq_len > mcfg.max_len:
        raise SystemExit(
            f"--seq_len {cfg.data.seq_len} exceeds the model's "
            f"max_len {mcfg.max_len}")
    if name in LM_MODELS:
        return get_lm_data(cfg.data.data_dir, vocab_size=vocab,
                           seq_len=cfg.data.seq_len,
                           synthetic=cfg.data.synthetic)
    d = cfg.data.data_dir
    has_npy = d and any(os.path.exists(os.path.join(d, f))
                        for f in ("train.npy", "tokens.npy"))
    if (d and os.path.exists(os.path.join(d, "vocab.txt")) and not has_npy
            and not cfg.data.synthetic):
        raise SystemExit(
            f"{d!r} is a raw-text corpus with a vocab.txt: tokenizing it "
            "(data/bert_text.py) arrives with slice A5b of the port; pass "
            "pre-tokenized train.npy/test.npy or tokens.npy")
    tr, te = get_bert_data(
        d, vocab_size=vocab, seq_len=cfg.data.seq_len,
        max_predictions=mcfg.max_predictions if mcfg else 20,
        mask_prob=cfg.data.mlm_mask_prob, synthetic=cfg.data.synthetic)
    if mcfg and tr["input_ids"].shape[1] > mcfg.max_len:
        raise SystemExit(
            f"dataset sequence length {tr['input_ids'].shape[1]} "
            f"exceeds the model's max_len {mcfg.max_len}")
    return tr, te


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = _validate_like_the_reference(parser, args)

    cluster = None
    if args.ps_hosts or args.worker_hosts:
        cluster = ClusterSpec({
            "ps": parse_hosts(args.ps_hosts),
            WORKER_JOB: parse_hosts(args.worker_hosts) or ["localhost:0"],
        })
    from ..runtime.server import Server
    if args.job_name == "ps":              # notice + exit 0, as the
        Server(cluster, args.job_name, args.task_index).join()
        return 0                           # reference's ps branch
    refuse_later_slices(args)

    from ..runtime import distributed
    from ..runtime.device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    try:
        server = Server(cluster, args.job_name, args.task_index,
                        profiler_port=args.profiler_port or None,
                        device=device)
    except NotImplementedError as e:
        raise SystemExit(str(e))
    ctx = server.context
    try:
        with debug_nans(cfg.obs.debug_nans):
            return _train(args, cfg, device, ctx, server.profiler)
    finally:
        server.close()
        if ctx.is_distributed:
            distributed.shutdown()


@contextlib.contextmanager
def debug_nans(on: bool):
    """``--debug_nans``, the counterpart of the reference's
    ``jax_debug_nans``: autograd's anomaly mode with NaN checks for the
    run (every backward node's outputs, a custom ``autograd.Function``'s
    such as the flash kernels' included, are checked, and the first NaN
    raises with the forward's traceback), restored afterwards."""
    if not on:
        yield
        return
    import torch
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*prev)


def _train(args, cfg: TrainConfig, device, ctx, profiler=None) -> int:
    """Model, data, the Trainer's run and the export, as this rank
    (``profiler``: the ``--profiler_port`` service, or None)."""
    from ..models import get_model
    from ..train.trainer import Trainer

    model = get_model(cfg.model, cfg)
    if args.export_generator:
        # the prechecks that need the model fail before training
        ml = model.cfg.max_len
        if args.gen_prompt_len + args.gen_max_new > ml:
            raise SystemExit(
                f"--gen_prompt_len {args.gen_prompt_len} + "
                f"--gen_max_new {args.gen_max_new} exceeds the model's "
                f"max_len {ml}")
        if args.gen_top_k > model.cfg.vocab_size:
            raise SystemExit(
                f"--gen_top_k {args.gen_top_k} exceeds the model's "
                f"vocab_size {model.cfg.vocab_size}")
    train_arrays, eval_arrays = load_dataset(cfg, model)
    train_transform = None
    if cfg.data.augment and cfg.data.dataset in CIFAR_DATASETS:
        from ..data.cifar import make_augment_transform
        train_transform = make_augment_transform(cfg.data.seed)
    trainer = Trainer(model, cfg, train_arrays, eval_arrays, device=device,
                      process_index=ctx.process_index,
                      num_processes=ctx.num_processes,
                      train_transform=train_transform,
                      profiler_service=profiler)
    if args.eval_only:
        return _eval_only(args, cfg, model, trainer, ctx)
    with trainer:
        state, summary = trainer.train()

    if "eval" in summary:
        log.info("final eval: %s",
                 {k: round(v, 4) for k, v in summary["eval"].items()})
    log.info("done: step=%d wall=%.1fs steps/sec=%.2f",
             summary["final_step"], summary["wall_time_sec"],
             summary["steps_per_sec"])
    _maybe_export(args, cfg, model, state, ctx)
    return 0


def _eval_only(args, cfg, model, trainer, ctx) -> int:
    """``--eval_only``: restore the step every rank agrees on (rank 0's
    latest that verifies, ``--eval_step``, or with ``--eval_best`` the
    best record), evaluate it, print one JSON line ``{"step": ...,
    <metric>: ...}`` and export from it with ``--export_generator``."""
    import json

    from ..ckpt.checkpoint import _agreed_best_step, _agreed_latest_step
    if trainer.eval_arrays is None:
        raise SystemExit("--eval_only: no eval split for this dataset")
    with trainer:
        if args.eval_best:
            if args.eval_step is not None:
                raise SystemExit(
                    "--eval_best and --eval_step are exclusive")
            step = _agreed_best_step(trainer.ckpt_manager)
            if step is None:
                raise SystemExit(
                    "--eval_best: no best checkpoint recorded under "
                    f"{args.ckpt_dir!r} (train with --keep_best_metric "
                    "first)")
        else:
            step = (args.eval_step if args.eval_step is not None
                    else _agreed_latest_step(trainer.ckpt_manager))
        if step is None:
            raise SystemExit(
                f"--eval_only: no checkpoint under {args.ckpt_dir!r}")
        template = trainer.sync.init(model.init, seed=cfg.seed)
        try:
            state = trainer.ckpt_manager.restore(template, step=step)
        except FileNotFoundError as e:
            raise SystemExit(f"--eval_only: {e}")
        metrics = trainer.evaluate(state)
    print(json.dumps({"step": int(state.step),
                      **{k: round(float(v), 6)
                         for k, v in metrics.items()}}), flush=True)
    _maybe_export(args, cfg, model, state, ctx)
    return 0


def _maybe_export(args, cfg, model, state, ctx) -> None:
    """The trained weights as the artifacts the port's ``PredictServer``
    serves, written by rank 0 (every rank holds the same weights):
    ``--export_dir`` the forward (``:predict``), ``--export_generator``
    the causal LM's generator (``:generate``)."""
    if ctx.process_index != 0:
        return
    if args.export_dir:
        from ..serving import export_model
        artifact = export_model(model, state.params, state.extras,
                                args.export_dir,
                                batch_size=min(8, cfg.data.batch_size))
        log.info("exported servable: %s", artifact)
    if not args.export_generator:
        return
    from ..serving import export_generator
    artifact = export_generator(
        model, state.params, args.export_generator,
        prompt_len=args.gen_prompt_len, max_new_tokens=args.gen_max_new,
        batch_size=args.gen_batch, temperature=args.gen_temperature,
        top_k=args.gen_top_k, top_p=args.gen_top_p, eos_id=args.gen_eos_id,
        pad_id=args.gen_pad_id, ragged=args.gen_ragged,
        weight_quant=args.gen_weight_quant)
    log.info("exported generator: %s", artifact)


if __name__ == "__main__":
    sys.exit(main())
