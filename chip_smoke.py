"""On-card check of the PyTorch/CUDA port: builds the hand-written Hopper
kernels, holds each against its plain PyTorch version at the shapes its
path gives it, trains GPT-small for a few steps through the port's sync
step and then through its training CLI (``cli/train.py`` -> ``Trainer``
-> checkpoint ring, the fused flash backward), then serves GPT-small
generation over HTTP through the port's entry points, without and with
the continuous-batching engine, and checks the kernels carried each
path; then it trains the source's MNIST MLP through the port's copy of
the reference example and through the CLI, its convolutional models
(LeNet, ResNet-20, ResNet-50) through the CLI, BERT's masked LM
(BERT-base, bert_large, bert_tiny) on the flash kernels' non-causal
path, the rest of GPT-small's training (adafactor, sync and async
saves, rollback, the best checkpoint, the observability sinks), and
GPT-small's speculative decoding, chunked prefill and SLO knobs over
HTTP, training's debug tools, and last a single server's HTTP and
operator surface (``:predict``, ``/metrics``, ``/trace/*``,
``/stats/history``, cancel, drain, the flight recorder) and the serving
chaos soak.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``). Prints, in order:
the card's name and power limit, the kernel build (seconds and the
``-Xptxas -v`` register / shared-memory lines), one kernel phase per
kernel (error against the plain version; kernel, plain and library time
on the device through ``torch.profiler`` and per call on CUDA events;
the roofline bound; the flash forward, timed at B=1 S=4096 too; the flash
backward's dq and dk/dv kernels, bitwise from launch to launch and timed
at B=1 S=4096 too, and its fused kernel, bitwise against them; all four
flash kernels at B*H = 65,536; the split-K slab decode kernel at
both head dims, over empty and mid-tile windows and over 16,384-slot
rows; the split-K paged kernel over bf16 and over int8 pools and over
16,384-slot rows; each split-K kernel bitwise from launch to launch), the
training phase (one step's grads through the flash
kernels against the plain attention's, then 20 AdamW steps of
full-width GPT-small through ``SyncReplicas`` with launch counts, the
loss curve, ms per step, tokens/s, peak memory and the device idle share
of one step; then GPT-small's LM head under ``--lm_loss_impl`` full,
chunked and fused: step-1 losses, ms per step, peak memory, the head's
device time against a traced step's), the CLI phase (20 steps of the
training CLI with the fused
backward and a checkpoint ring, a resume to 30 with a generator export
served once, a 5-step split-backward run against it; launch counts, the
loss curve, ms per step, save and restore times, peak memory and the
idle share of one Trainer step), the slice phase (three ``:generate`` requests on full-width GPT-small with
launch counts, token agreement with the plain versions, tokens/s,
latency, peak memory, then one request of an int8-weight export and the
decode step with int8 weights beside the float one), the engine phase
(the continuous-batching engine over HTTP on a paged, a slab, an int8-KV
paged and an int8-KV int8-weight paged export: concurrent requests,
prefix reuse, launch counts, agreement between them, tokens/s, latency,
peak memory, the device idle share of one request), the MNIST phase
(the source's own workload, no hand-written kernel on its path: the
port's copy of ``examples/mnist_distributed.py`` as one worker at the
reference's defaults, 1000 steps with a checkpoint and a resume, then
``cli.train --model mlp`` with a ring of checkpoints and a resume; the
loss curve, the final test accuracy against the reference's 0.95, the
resume lines, 20 card steps against 20 CPU steps, examples/s and ms per
step over steps 101-1000, peak memory and the device idle share of one
step, each beside the card's name and power limit), the conv phase (the
source's convolutional configs through ``cli/train.py``, no hand-written
kernel on their path: full-width ResNet-50 in bf16 at batch 128 with a
ring, a resume and a top-5 eval, its examples/s, ms per step, peak
memory, idle share and share of the bf16 peak; ResNet-20 with
``--augment`` to an eval bar and 20 f32 card steps against 20 CPU steps;
LeNet to 0.95), the BERT phase (B1, B2a/B2b and B3 non-causal with
trailing pads against their plain versions at BERT-base's shape;
BERT-base, config 5 at its preset, in bf16 with LAMB through the CLI:
30 steps with a ring, a resume to 40, the eval, exact launch counts;
sequences/s, tokens/s, ms per step, peak memory, idle share and share
of the bf16 peak of a Trainer run; a padded fixture's step under flash
and plain attention against an f32 oracle, then 10 CLI steps; the fused
backward, ``--remat full|dots``, the fused head, lars and seq 512, a
few steps each; bert_large's step time; bert_tiny card against CPU), the
train-rest phase (GPT-small through ``cli/train.py`` and its
``Trainer``: adafactor against AdamW, state bytes, peak memory and step
time; 40 steps with no, sync and async saves, each save step's host
time and the steps inside the writes' window; rollback after a NaN step
against an uninterrupted run, bitwise; ``--eval_only --eval_best``
against the logged eval; the TensorBoard, summary, histogram,
step-timing, profiler and trace sinks; launch counts each), the spec
and chunk phase (GPT-small exported with ``spec_tokens=4`` and
``prefill_chunk=128``: the verify step alone, B5 and B6 on 8 x 4 query
rows against their plain versions, exact launches; 8 concurrent greedy
requests over HTTP spec on against off: agreement, accept rate, tokens/s
and ms per shared dispatch each way; a 512-token prompt admitted while 7
slots decode, chunked against monolithic: the largest decode stall each
way; spec on int8 pools; an infeasible ``deadline_ms`` answered 429),
the debug-tools phase (GPT-small through ``cli/train.py``:
``--debug_checks`` under a ``step.nan`` fault, its cost a step, the
step's counted FLOPs beside the closed form, ``--debug_nans``, one
``--profiler_port`` capture), the HTTP-ops phase (the MLP trained and
exported with ``--export_dir``, 16 concurrent ``:predict`` clients
through the MicroBatcher: answers bitwise a replay of their batch, the
batcher's counters exact, latency and rows/s; BERT-base ``:predict`` at
64 x 128: 12 flash launches a batch, logits against the plain
attention's, rows/s; GPT-small paged ``:generate`` on a ``--metrics off
--flight_recorder off`` server and an armed one: equal bytes and launch
counts, tokens/s each, ``/metrics`` against ``/stats``, the trace routes,
``/stats/history`` with SLO results, a cancel mid-decode, a fault-spec
wedge's ``/healthz`` flip and incident bundle, a drain of 16 requests;
``trace_summary`` of one profiled request; the ``serving_chaos``
scenarios over bf16 and int8 pools), a
``{"kernels":
[...]}`` JSON line, the card line again, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line; without CUDA (or outside the repository) it exits
non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Tolerances, kernel vs plain version on the same bf16 inputs. An output
# row (one query of one head, D values) is held to its relative error
# max|o - o_ref| / max|o_ref|: the size of |o| runs from ~|v| (rows with
# one live key) down to ~|v| / sqrt(n) (n live keys), so one absolute
# tolerance is either loose on the long rows or tight on the short ones.
# Both versions round the probabilities to bf16 before the PV product
# (the kernel the unnormalised exp, the plain version the normalised
# softmax) and round the output to bf16, so an output element may differ
# by an ulp or two, and one ulp of an element just above a power of two
# is 2^-7 = 7.8e-3 of it. Measured worst rows (H100, 700 W): flash 8.0e-3,
# decode 1.7e-3. Each limit is a few times that and a fiftieth to a
# hundredth of the row's own size, so a wrong PV product or a wrong
# rescale of the running sum fails it; the decode limit stays above the
# one-ulp 7.8e-3.
FLASH_ROW_REL_TOL = 2e-2
DECODE_ROW_REL_TOL = 1e-2
FLASH_LSE_TOL = 1e-3      # f32 logsumexp, differing only in sum order
# first-step logits of GPT-small, kernel path vs plain path: the two
# prefills differ by bf16 rounding inside attention, which the 12 layers
# carry into the logits. Measured 0.023 (H100, 700 W) against a logit std
# of 0.556: the limit is ~4x the measured error and under a fifth of the
# std
LOGIT_TOL = 0.1
# greedy tokens, kernel path vs plain path: a bf16 near-tie flips one
# token and the rows diverge from there, so the floor is on the share of
# equal positions, with the first-step logits above as the strict check
AGREEMENT_FLOOR = 0.5

# paged decode attention, split-K: the Pallas float kernel's arithmetic,
# each split rounding its unnormalised probabilities exp(s - running max)
# to bf16 before the PV product and the f32 sum dividing at the end, where
# the plain version rounds the normalised softmax to bf16; the two differ
# by bf16 rounding. Measured worst rows (H100, 700 W): 7.0e-3 at D=64,
# 7.1e-3 at D=128, 7.8e-3 over 16,384-slot rows (about one bf16 ulp of an
# element); the limit is under 3x the worst, two to three ulps
PAGED_ROW_REL_TOL = 2e-2
# the int8 paged kernel follows the Pallas kernel's algebra (scales folded
# into the f32 scores and probabilities), its plain version the reference's
# XLA path (rows dequantized to bf16, probabilities rounded to bf16): the
# two differ by bf16 rounding as the bf16 kernel and its plain version do,
# and are held to the same limit
PAGED_INT8_ROW_REL_TOL = 2e-2
# int8 KV (and int8 weights) against the float engine, greedy: the
# reference's drift gate (experiments/serving_load.py INT8_MIN_AGREEMENT)
INT8_MIN_AGREEMENT = 0.75

# the flash backward kernels (B2a dq, B2b dk/dv) against their plain
# versions: the kernels round p and ds to bf16 before their products where
# the plain versions keep f32, and round their outputs to bf16, as the
# forward does; each gradient row (one query's dq, one key's dk or dv, of
# one head) is held to the forward's limit (see grad_row_rel_err)
FLASH_BWD_ROW_REL_TOL = 2e-2
# the fused flash backward (B3) runs B2a's and B2b's products in their
# order, so its dq, dk and dv are theirs bit for bit where the card forms
# the transposed scores S^T = K Q^T (B2b's form) with the bits of B2a's
# S = Q K^T. dk and dv are held to that bitwise; dq too, or, should the
# card's S^T and S differ in their bits, to 1e-6 of B2a's dq relative to
# each row (set before any run: ~100x f32 rounding, far below one bf16 ulp)
FUSED_DQ_ROW_REL_TOL = 1e-6
# the CLI phase's 5-step run with the split backward against the fused
# run, same seed, batches and dropout masks: B3 is B2a and B2b bit for
# bit, but the embedding's backward on the card (index_add with atomics)
# is not deterministic, so the runs part by f32 rounding from step 3 on
# (steps 1 and 2 run on equal params: lr(0) = 0 in the warmup)
CLI_SPLIT_LOSS_REL_TOL = 1e-3
# the serving phases run no backward kernel
NO_BACKWARD = {"flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
               "flash_attention_bwd_fused": 0}
# training phase: GPT-small, B=8, S=512, 20 AdamW steps on one fixed batch
# (two rows end in 64 padding tokens), dropout 0.1
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_PAD = 8, 512, 20, 64
# the loss after the last step must lie this share below the first's
TRAIN_MIN_LOSS_DROP = 0.10
# one step's grads with dropout off, attention_impl="flash" (B1, B2a,
# B2b) against "xla" (the plain einsum path), both bf16 on the card: each
# leaf's ||g_flash - g_xla|| / ||g_xla|| and the loss's difference. The
# attention's key biases have a zero gradient by the softmax's shift
# invariance (any rounding is all they get), so they are held instead to
# ||g|| <= 1e-3 of the global grad norm in both paths
TRAIN_GRAD_REL_TOL = 5e-2
TRAIN_LOSS_TOL = 1e-2
TRAIN_ZERO_GRAD_SHARE = 1e-3

FLASH_SHAPE = dict(b=8, s=512, h=12, d=64)
# the engine's decode step at GPT-small: 8 slots, 12 heads, 16-slot blocks,
# 40 blocks per row (prompt 512 + 128 new = 640 slots)
PAGED_SHAPE = dict(b=8, h=12, bs=16, nb=40)
# the paged phases' long rows: 1024 blocks of 16 = 16,384 slots a row
PAGED_LONG_NB = 1024
FLASH_ODD_S = 500
# the flash kernels' long causal case: B=1, 64 tiles of 64 a row
FLASH_LONG_S = 4096
# B*H = 65,536: one past what a grid with B*H on its y axis takes; S=80
# gives each row a ragged second tile
FLASH_WIDE = dict(b=4096, s=80, h=16)
DECODE_SHAPE = dict(b=8, t=640, h=12, d=64)
PROMPT_LEN, MAX_NEW, BATCH = 512, 128, 8
ENGINE_SLOTS = 8
# paged vs slab engine on the same weights and prompts: the two differ in
# layout (left-aligned blocks vs right-packed slab rows) and kernel (B5 vs
# B4), which moves bf16 rounding; a near-tie flip diverges a row from there
# on, so the floor is on the share of equal greedy tokens, and the
# first-step logits are the strict check. Measured (H100, 700 W): token
# agreement 0.9453, first-step logits 2.09e-2 (logit std ~0.56). Limits:
# ~3.6x the measured disagreement (0.055) and ~4x the logit error.
ENGINE_AGREEMENT_FLOOR = 0.8
ENGINE_LOGIT_TOL = 0.08
# an exact prefix-cache hit runs its last prompt token through the decode
# step (B5) where its cold request ran it in the prefill (B1): measured
# agreement 0.8203 (one early near-tie flip in 128 tokens); the floor is
# ~2.8x that disagreement
PREFIX_HIT_AGREEMENT_FLOOR = 0.5


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cold_sets(tensors: tuple, total_bytes: float = 100e6) -> list[tuple]:
    """``tensors`` plus equal copies, enough that together they exceed
    the 50 MB L2 cache twice over."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, int(-(-total_bytes // size)))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def cuda_ms(fn, sets: list[tuple], iters: int = 48,
            warmup: int = 4) -> float:
    """Mean device time of ``fn(*args)`` in ms over ``iters`` launches,
    timed with CUDA events after ``warmup`` launches. The launches cycle
    through ``sets`` of equal inputs (:func:`cold_sets`), so each launch
    finds its inputs in device memory and not in L2, as on the serving
    path, where 12 layers' activations and caches cycle through L2."""
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, sets: list[tuple], iters: int = 48, warmup: int = 4,
              by_kernel: dict | None = None) -> float:
    """Device time of one ``fn(*args)`` call in ms: the durations of every
    kernel and copy it ran on the card, as ``torch.profiler`` records them,
    summed over ``iters`` calls that cycle through ``sets`` (as
    :func:`cuda_ms`) and divided by ``iters``. The host's time between
    launches is left out, so a call whose host work outlasts its kernels
    (a wrapper's checks and allocations, a library's dispatch) reads what
    the card spent on it; a call of two kernels counts both, and
    ``by_kernel``, where given, gets each kernel's ms per call by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    # a profiler window now and then records no device activity at all
    # (seen on one card: the whole window empty, not a short count); the
    # window is profiled again, up to three times, before giving up
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*sets[i % len(sets)])
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        total = sum(_device_us(e) for e in events)
        if total > 0:
            break
        log(f"[profiler] window {attempt} of 3 recorded no device time")
    else:
        raise SystemExit("torch.profiler saw no device time: the kernels' "
                         "device times cannot be measured")
    if by_kernel is not None:
        by_kernel.update({e.key: _device_us(e) / iters / 1e3
                          for e in events})
    return total / iters / 1e3


def kernel_times(kernel, sets: list[tuple], library, lib_sets: list[tuple],
                 iters: int = 48, by_kernel: dict | None = None) -> dict:
    """A kernel's time and that of its one-call library yardstick, each on
    the device (:func:`device_ms`, every kernel of a call summed: ``ms``,
    ``library_ms``) and per call on CUDA events (:func:`cuda_ms`, which
    also pays the call's host work: ``call_ms``, ``library_call_ms``).
    ``by_kernel`` gets the kernel's parts by name."""
    return {"ms": device_ms(kernel, sets, iters=iters, by_kernel=by_kernel),
            "call_ms": cuda_ms(kernel, sets, iters=iters),
            "library_ms": device_ms(library, lib_sets, iters=iters),
            "library_call_ms": cuda_ms(library, lib_sets, iters=iters)}


def short_names(parts: dict) -> dict:
    """Kernel names as ``torch.profiler`` reports them, cut to the
    function's name (``void paged::split_kernel<64, false>(...)`` ->
    ``split_kernel``)."""
    return {re.sub(r"^void (?:\(anonymous namespace\)|paged)::(\w+)<.*",
                   r"\1", k): v for k, v in parts.items()}


def row_rel_err(o: torch.Tensor, o_ref: torch.Tensor) -> float:
    """Worst row of ``max|o - o_ref| / max|o_ref|`` over the last axis. A
    row whose reference is all zero counts 0 only where ``o`` is zero too."""
    diff = (o.float() - o_ref.float()).abs().amax(dim=-1)
    size = o_ref.float().abs().amax(dim=-1)
    return (diff / size.clamp_min(torch.finfo(torch.float32).tiny)
            ).max().item()


def grad_row_rel_err(g: torch.Tensor, g_ref: torch.Tensor) -> float:
    """:func:`row_rel_err` for a gradient, with each row's size floored at
    a hundredth of the mean row size: a row whose gradient cancels to zero
    (the first query of a causal row has one live key, where ds = p (dp -
    D) is zero but for rounding) is held to that absolute error instead."""
    diff = (g.float() - g_ref.float()).abs().amax(dim=-1)
    size = g_ref.float().abs().amax(dim=-1)
    return (diff / torch.maximum(size, 1e-2 * size.mean())).max().item()


def live_slots(bt: torch.Tensor, pos: torch.Tensor, pad: torch.Tensor,
               bs: int) -> tuple[int, int]:
    """(live (row, slot) pairs, distinct physical slots they read): rows
    that share prefix blocks read the same slots, which the bound counts
    once."""
    slots = torch.arange(bt.shape[1] * bs, device=bt.device)
    live = (slots[None, :] <= pos[:, None]) & (slots[None, :] >= pad[:, None])
    phys = bt.long()[:, slots // bs] * bs + slots % bs
    return int(live.sum()), int(torch.unique(phys[live]).numel())


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from distributed_tensorflow_example_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(_build.sources())} kernel sources in "
        f"{time.perf_counter() - t0:.2f} s (parallel nvcc, sm_90a)")
    for stem, rec in sorted(logs.items()):
        log(f"[build] {stem}: {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log(f"[build]   {line.strip()}")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def _ragged_key_mask(gen, b: int, s: int, dev) -> torch.Tensor:
    """[B, S] int32 key mask with per-row left pads (the ragged-prefill
    layout): row 0 unpadded, the others up to a quarter padded."""
    pads = torch.randint(0, s // 4, (b,), generator=gen)
    pads[0] = 0
    mask = (torch.arange(s)[None, :] >= pads[:, None]).to(torch.int32)
    return mask.to(dev)


def flash_case(s: int, gen, timed: bool, b: int = FLASH_SHAPE["b"],
               h: int = FLASH_SHAPE["h"]) -> dict:
    """B1 at [B, S, H, 64] (causal, left pads, row 0 unpadded) against its
    plain version; with ``timed``, its kernel, plain and SDPA times and its
    bound."""
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        flash_attention as fa
    dev = torch.device("cuda")
    d = FLASH_SHAPE["d"]
    q, k, v = (torch.randn((b, s, h, d), generator=gen).to(
        dev, torch.bfloat16) for _ in range(3))
    mask = _ragged_key_mask(gen, b, s, dev)
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, mask,
                                                  causal=True)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    rel = row_rel_err(o, o_ref)
    # rows with a live key: the logsumexp agrees; fully masked rows (the
    # left pads under causal masking) give exactly zero output
    kpos = torch.arange(s, device=dev)
    first_live = (mask == 0).sum(dim=1)                       # [B]
    live_row = kpos[None, :] >= first_live[:, None]           # [B, S]
    lse_err = ((lse - lse_ref).abs() * live_row[:, None, :]).max().item()
    dead_max = (o.float().abs() * (~live_row)[:, :, None, None]).max().item()
    ok = (rel <= FLASH_ROW_REL_TOL and lse_err <= FLASH_LSE_TOL
          and dead_max == 0)
    label = f"[flash B={b} S={s} H={h}]"
    log(f"{label} worst row max|o - plain| / max|plain| {rel:.3e} "
        f"(tol {FLASH_ROW_REL_TOL}; max abs err {err:.3e}), "
        f"max|lse - plain| {lse_err:.3e} (tol {FLASH_LSE_TOL}), "
        f"fully-masked rows max|o| {dead_max} (must be 0): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"flash_attention_fwd disagrees with its plain "
                         f"version at B={b} S={s} H={h}")
    rec = {"max_abs_err": err, "max_row_rel_err": rel}
    if not timed:
        return rec
    # the work this run's data needs: causal pairs with a live key
    live_pairs = 0
    for row in range(b):
        p = int(first_live[row])
        n = s - p                     # live keys p..s-1 for rows i >= p
        live_pairs += n * (n + 1) // 2
    flops = 4.0 * d * h * live_pairs                  # QK^T + PV
    nbytes = (4 * b * s * h * d * 2                  # q, k, v in; o out
              + b * s * 4 + b * h * s * 4)           # mask in; lse out
    bms, by = bound(flops, nbytes)
    sets = cold_sets((q, k, v, mask))
    how = sdpa_mask_args(mask, causal=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = kernel_times(
        lambda *a: fa.flash_attention_fwd(*a, causal=True), sets,
        lambda q_, k_, v_, _: sdpa(                     # [B,H,S,D] views
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            **how), sets)
    pms = device_ms(lambda *a: fa.flash_attention_fwd_plain(
        *a, causal=True), sets, iters=8)
    log(f"{label} device ms: kernel {t['ms']:.4f} ({t['ms'] / bms:.2f}x "
        f"bound), plain {pms:.4f}, sdpa {t['library_ms']:.4f} "
        f"({t['ms'] / t['library_ms']:.2f}x); per call on CUDA events: kernel "
        f"{t['call_ms']:.4f}, sdpa {t['library_call_ms']:.4f}; bound_ms "
        f"{bms:.4f} ({by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB); "
        f"sdpa with {', '.join(how)}")
    rec.update(**t, plain_ms=pms, bound_ms=bms, bound_by=by)
    return rec


def phase_flash(gen) -> dict:
    """B1 at the training shape (timed), at a ragged S=500, and at B=1
    S=4096 (timed: the longest causal walks, 64 tiles), whose times the
    row carries as ``long_row``."""
    rec = flash_case(FLASH_SHAPE["s"], gen, timed=True)
    odd = flash_case(FLASH_ODD_S, gen, timed=False)
    # its own generator: the later phases draw what they drew before
    long = flash_case(FLASH_LONG_S, torch.Generator().manual_seed(
        FLASH_LONG_S + 1), timed=True, b=1)
    for key in ("max_abs_err", "max_row_rel_err"):
        rec[key] = max(rec[key], odd[key], long[key])
    rec["long_row"] = {"b": 1, "s": FLASH_LONG_S, **{
        key: long[key] for key in ("ms", "call_ms", "plain_ms", "library_ms",
                                   "library_call_ms", "bound_ms",
                                   "bound_by")}}
    return rec


def phase_flash_wide() -> None:
    """All four flash kernels at B*H = 65,536 (B=4096, H=16, S=80: a
    ragged second tile; causal, left pads), past the 65,535 that a 2-D
    grid with B*H on y would take: B1, B2a and B2b and B3 against their
    plain versions, B3 bitwise B2a's and B2b's. Untimed; its own
    generator."""
    b, s, h = FLASH_WIDE["b"], FLASH_WIDE["s"], FLASH_WIDE["h"]
    gen = torch.Generator().manual_seed(b * h)
    flash_case(s, gen, timed=False, b=b, h=h)
    flash_bwd_case(b, s, gen, timed=False, h=h)
    flash_bwd_fused_case(b, s, True, gen, timed=False, h=h)
    gc.collect()
    torch.cuda.empty_cache()


def flash_bwd_case(b: int, s: int, gen, timed: bool,
                   h: int = FLASH_SHAPE["h"]) -> tuple[dict, dict]:
    """B2a and B2b at [B, S, H, 64] (causal, left pads, row 0 unpadded)
    against their plain versions, on one forward's lse and Dsum; two
    launches of each bitwise equal; with ``timed``, their kernel, plain and
    library times and bounds."""
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        flash_attention as fa
    dev = torch.device("cuda")
    d = FLASH_SHAPE["d"]
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen).to(
        dev, torch.bfloat16) for _ in range(4))
    mask = _ragged_key_mask(gen, b, s, dev)
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=True)
    args = (q, k, v, do, lse, fa.flash_attention_dsum(do, o), mask)
    dq = fa.flash_attention_bwd_dq(*args, causal=True)
    dk, dv = fa.flash_attention_bwd_dkv(*args, causal=True)
    again = (fa.flash_attention_bwd_dq(*args, causal=True),
             *fa.flash_attention_bwd_dkv(*args, causal=True))
    dq_ref = fa.flash_attention_bwd_dq_plain(*args, causal=True)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(*args, causal=True)
    torch.cuda.synchronize()
    # left pads: key j is masked, and (causal) query j sees no key, for
    # j below the row's first live position
    first_live = (mask == 0).sum(dim=1)
    dead = (torch.arange(s, device=dev)[None, :]
            < first_live[:, None])[:, :, None, None]            # [B,S,1,1]
    label = f"[flash bwd B={b} S={s} H={h}]"
    recs = []
    for name, pairs, twice in (("dq", ((dq, dq_ref),), again[:1]),
                               ("dk, dv", ((dk, dk_ref), (dv, dv_ref)),
                                again[1:])):
        rel = max(grad_row_rel_err(g, r) for g, r in pairs)
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in pairs)
        dead_max = max((g.float().abs() * dead).max().item()
                       for g, _ in pairs)
        determ = all(torch.equal(g, a) for (g, _), a in zip(pairs, twice))
        ok = rel <= FLASH_BWD_ROW_REL_TOL and dead_max == 0 and determ
        what = ("queries that see no key" if name == "dq"
                else "masked keys")
        log(f"{label} {name}: worst row max|g - plain| / max|plain| "
            f"{rel:.3e} (tol {FLASH_BWD_ROW_REL_TOL}; max abs err "
            f"{err:.3e}), {what} max|g| {dead_max} (must be 0), two "
            f"launches bitwise equal {determ}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"flash backward {name} fails its checks at "
                             f"B={b} S={s}")
        recs.append({"max_abs_err": err, "max_row_rel_err": rel})
    if not timed:
        return recs[0], recs[1]
    live_pairs = sum((s - int(p)) * (s - int(p) + 1) // 2 for p in first_live)
    act = b * s * h * d * 2                       # one bf16 [B,S,H,D]
    rows = 2 * b * h * s * 4 + b * s * 4          # lse, Dsum, mask
    sets = cold_sets(args)
    library, lib_sets = sdpa_bwd(sets, mask, causal=True)
    for rec, stem, matmuls, outs in ((recs[0], "dq", 3, 1),
                                     (recs[1], "dkv", 4, 2)):
        fn = getattr(fa, f"flash_attention_bwd_{stem}")
        plain = getattr(fa, f"flash_attention_bwd_{stem}_plain")
        flops = 2.0 * matmuls * d * h * live_pairs
        nbytes = (4 + outs) * act + rows     # q, k, v, dO in; grads out
        bms, by = bound(flops, nbytes)
        t = kernel_times(lambda *a: fn(*a, causal=True), sets, library,
                         lib_sets)
        pms = device_ms(lambda *a: plain(*a, causal=True), sets, iters=8)
        log(f"{label} {stem}: device ms: kernel {t['ms']:.4f} "
            f"({t['ms'] / bms:.2f}x bound), plain {pms:.4f}, sdpa backward "
            f"(dq, dk, dv) {t['library_ms']:.4f}; per call on CUDA events: "
            f"kernel {t['call_ms']:.4f}, sdpa backward "
            f"{t['library_call_ms']:.4f}; bound_ms {bms:.4f} ({by}: "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
        rec.update(**t, plain_ms=pms, bound_ms=bms, bound_by=by)
    pair = recs[0]["ms"] + recs[1]["ms"]
    log(f"{label} B2a + B2b {pair:.4f} device ms against sdpa backward "
        f"{recs[0]['library_ms']:.4f} ({pair / recs[0]['library_ms']:.2f}x; "
        f"sdpa with {', '.join(sdpa_mask_args(mask, causal=True))})")
    return recs[0], recs[1]


def sdpa_mask_args(mask: torch.Tensor, causal: bool) -> dict:
    """SDPA's keyword arguments for the function a flash kernel computes
    under the [B, S] key ``mask``: with no key masked (B=1 here, whose one
    row is unpadded), the causal flag alone, which lets SDPA take its flash
    path; else an explicit boolean mask, [B,1,S,S] causal or [B,1,1,S]."""
    if bool((mask != 0).all()):
        return {"is_causal": causal}
    s = mask.shape[1]
    amask = (mask[:, None, :] != 0)[:, None]                 # [B,1,1,S]
    if causal:
        tri = torch.ones((s, s), dtype=torch.bool, device=mask.device).tril()
        amask = amask & tri[None, None]                      # [B,1,S,S]
    return {"attn_mask": amask}


def sdpa_bwd(sets: list[tuple], mask: torch.Tensor,
             causal: bool) -> tuple:
    """(fn, sets) that time SDPA's backward (one call computing dq, dk and
    dv) through autograd on a retained graph, so that only the backward
    runs, over the (q, k, v, dO, ...) ``sets`` with the [B, S] key
    ``mask``."""
    how = sdpa_mask_args(mask, causal)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    graphs = []
    for q_, k_, v_, do_, *_ in sets:
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q_, k_, v_)]
        graphs.append((sdpa(*leaves, **how), leaves,
                       do_.transpose(1, 2)))
    return (lambda o_, leaves, do_: torch.autograd.grad(
        o_, leaves, do_, retain_graph=True)), graphs


def flash_bwd_fused_case(b: int, s: int, causal: bool, gen, timed: bool,
                         h: int = FLASH_SHAPE["h"]) -> dict:
    """B3 at [B, S, H, 64] with left pads (row 0 unpadded) against its
    plain version; two launches bitwise equal (dq is accumulated in a
    fixed order, not by atomics); dk and dv bitwise B2b's; dq bitwise
    B2a's, or, if the card forms S^T (B2b's and B3's form) with other bits
    than B2a's S, within FUSED_DQ_ROW_REL_TOL of B2a per row, with both
    max-abs differences printed; dead query rows and masked keys exactly
    0. With ``timed``: kernel, plain, split-pair and SDPA-backward times
    and the bound."""
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        flash_attention as fa
    dev = torch.device("cuda")
    d = FLASH_SHAPE["d"]
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen).to(
        dev, torch.bfloat16) for _ in range(4))
    mask = _ragged_key_mask(gen, b, s, dev)
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=causal)
    args = (q, k, v, do, lse, fa.flash_attention_dsum(do, o), mask)
    got = fa.flash_attention_bwd_fused(*args, causal=causal)
    again = fa.flash_attention_bwd_fused(*args, causal=causal)
    want = fa.flash_attention_bwd_fused_plain(*args, causal=causal)
    dq_split = fa.flash_attention_bwd_dq(*args, causal=causal)
    dk_split, dv_split = fa.flash_attention_bwd_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    first_live = (mask == 0).sum(dim=1)
    dead = (torch.arange(s, device=dev)[None, :]
            < first_live[:, None])[:, :, None, None]            # [B,S,1,1]
    rel = max(grad_row_rel_err(g, w) for g, w in zip(got, want))
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    determ = all(torch.equal(g, a) for g, a in zip(got, again))
    dkv_bitwise = torch.equal(got[1], dk_split) and torch.equal(got[2],
                                                                dv_split)
    dq_bitwise = torch.equal(got[0], dq_split)
    dq_rel = 0.0 if dq_bitwise else row_rel_err(got[0], dq_split)
    dead_max = max((got[1].float().abs() * dead).max().item(),
                   (got[2].float().abs() * dead).max().item(),
                   (got[0].float().abs() * dead).max().item()
                   if causal else 0.0)
    label = (f"[flash bwd fused B={b} S={s} H={h}"
             f"{'' if causal else ' non-causal'}]")
    if not dq_bitwise:
        log(f"{label} dq differs from B2a's bits: max|dq - B2a dq| "
            f"{(got[0].float() - dq_split.float()).abs().max().item():.3e}, "
            f"max|dk - B2b dk| "
            f"{(got[1].float() - dk_split.float()).abs().max().item():.3e}"
            f"; dq held to {FUSED_DQ_ROW_REL_TOL} of B2a per row: "
            f"{dq_rel:.3e}")
    ok = (rel <= FLASH_BWD_ROW_REL_TOL and determ and dkv_bitwise
          and dq_rel <= FUSED_DQ_ROW_REL_TOL and dead_max == 0)
    log(f"{label} worst row max|g - plain| / max|plain| {rel:.3e} (tol "
        f"{FLASH_BWD_ROW_REL_TOL}; max abs err {err:.3e}); two launches "
        f"bitwise equal {determ}; dk, dv bitwise B2b's {dkv_bitwise}; dq "
        f"bitwise B2a's {dq_bitwise}; dead rows and masked keys max|g| "
        f"{dead_max} (must be 0): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the fused flash backward fails its checks at "
                         f"B={b} S={s} causal={causal}")
    rec = {"max_abs_err": err, "max_row_rel_err": rel}
    if not timed:
        return rec
    if causal:
        live_pairs = sum((s - int(p)) * (s - int(p) + 1) // 2
                         for p in first_live)
    else:
        live_pairs = sum(s * (s - int(p)) for p in first_live)
    act = b * s * h * d * 2
    flops = 2.0 * 5 * d * h * live_pairs          # five products a pair
    nbytes = 7 * act + 2 * b * h * s * 4 + b * s * 4  # q,k,v,dO; dq,dk,dv
    bms, by = bound(flops, nbytes)
    sets = cold_sets(args)

    def fused(*a):
        return fa.flash_attention_bwd_fused(*a, causal=causal)

    def split(*a):
        return (fa.flash_attention_bwd_dq(*a, causal=causal),
                fa.flash_attention_bwd_dkv(*a, causal=causal))

    library, lib_sets = sdpa_bwd(sets, mask, causal)
    parts = {}
    t = kernel_times(fused, sets, library, lib_sets, by_kernel=parts)
    split_ms = device_ms(split, sets)
    split_call_ms = cuda_ms(split, sets)
    again = device_ms(fused, sets)
    pms = device_ms(lambda *a: fa.flash_attention_bwd_fused_plain(
        *a, causal=causal), sets, iters=8)
    log(f"{label} device ms: kernel {t['ms']:.4f} (again {again:.4f}; "
        f"{fmt_ms(short_names(parts))}), B2a + B2b {split_ms:.4f}, plain "
        f"{pms:.4f}, sdpa backward (dq, dk, dv) {t['library_ms']:.4f}; per "
        f"call on CUDA events: kernel {t['call_ms']:.4f}, B2a + B2b "
        f"{split_call_ms:.4f}, sdpa backward {t['library_call_ms']:.4f}; "
        f"bound_ms {bms:.4f} ({by}: {flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB)")
    rec.update(**t, plain_ms=pms, split_ms=split_ms,
               split_call_ms=split_call_ms, bound_ms=bms, bound_by=by)
    return rec


def phase_flash_bwd_fused(gen) -> dict:
    """B3 at the training shape (timed), at S=4096 B=1, at a ragged
    S=200, and non-causal."""
    b, s = FLASH_SHAPE["b"], FLASH_SHAPE["s"]
    rec = flash_bwd_fused_case(b, s, True, gen, timed=True)
    for case in ((1, 4096, True), (b, 200, True), (b, s, False)):
        odd = flash_bwd_fused_case(*case, gen, timed=False)
        for key in ("max_abs_err", "max_row_rel_err"):
            rec[key] = max(rec[key], odd[key])
    return rec


def phase_flash_bwd(gen) -> tuple[dict, dict]:
    """B2a and B2b at the training shape (timed), at a ragged S=500, and at
    B=1 S=4096 (timed: the longest causal walks, 64 tiles). Each row
    carries the S=4096 times as ``long_row``."""
    b = FLASH_SHAPE["b"]
    dq, dkv = flash_bwd_case(b, FLASH_SHAPE["s"], gen, timed=True)
    odd = flash_bwd_case(b, FLASH_ODD_S, gen, timed=False)
    # its own generator: the later phases draw what they drew before
    long = flash_bwd_case(1, FLASH_LONG_S,
                          torch.Generator().manual_seed(FLASH_LONG_S),
                          timed=True)
    for rec, lg, od in zip((dq, dkv), long, odd):
        for key in ("max_abs_err", "max_row_rel_err"):
            rec[key] = max(rec[key], lg[key], od[key])
        rec["long_row"] = {"b": 1, "s": FLASH_LONG_S, **{
            key: lg[key] for key in ("ms", "call_ms", "plain_ms",
                                     "library_ms", "library_call_ms",
                                     "bound_ms", "bound_by")}}
    return dq, dkv


def decode_inputs(gen, d: int = DECODE_SHAPE["d"],
                  t: int = DECODE_SHAPE["t"]) -> tuple:
    """B4's inputs at the decode step's shape (B=8, H=12): random slabs,
    per-row pads up to 127 and pos in the last 128 slots, row 0's window
    the whole row."""
    dev = torch.device("cuda")
    b, h = DECODE_SHAPE["b"], DECODE_SHAPE["h"]
    q = torch.randn((b, h, d), generator=gen).to(dev, torch.bfloat16)
    k, v = (torch.randn((b, t, h, d), generator=gen).to(
        dev, torch.bfloat16) for _ in range(2))
    pad = torch.randint(0, 128, (b,), generator=gen, dtype=torch.int32)
    pos = torch.randint(t - 128, t, (b,), generator=gen, dtype=torch.int32)
    pad[0], pos[0] = 0, t - 1                  # one full-window row
    return q, k, v, pos.to(dev), pad.to(dev)


def decode_check(name: str, q, k, v, pos, pad, empty=()) -> tuple:
    """B4 against its plain version (rows outside ``empty``: worst row
    within DECODE_ROW_REL_TOL), against itself (two launches bitwise
    equal), and the rows in ``empty`` (pad > pos) exactly zero. Returns
    (max abs err, worst row)."""
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        decode_attention as da
    o = da.decode_attention(q, k, v, pos=pos, pad=pad)
    again = da.decode_attention(q, k, v, pos=pos, pad=pad)
    o_ref = da.xla_decode_attention(q, k, v, pos=pos, pad=pad)
    torch.cuda.synchronize()
    live = torch.ones(q.shape[0], dtype=torch.bool)
    live[list(empty)] = False
    e = (o[live].float() - o_ref[live].float()).abs().max().item()
    r = row_rel_err(o[live], o_ref[live])
    det = torch.equal(o, again)
    zero = o[~live].float().abs().max().item() if empty else 0.0
    ok = r <= DECODE_ROW_REL_TOL and det and zero == 0
    log(f"[decode {name}] worst row max|o - plain| / max|plain| {r:.3e} "
        f"(tol {DECODE_ROW_REL_TOL}; max abs err {e:.3e}); two launches "
        f"bitwise equal {det}"
        + (f"; empty windows max|o| {zero} (must be 0)" if empty else "")
        + f": {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"decode_attention disagrees with its plain "
                         f"version or itself: {name}")
    return e, r


def decode_times(q, k, v, pos, pad, sets: list[tuple],
                 plain: bool) -> dict:
    """B4 and SDPA (over the slabs' [B, H, T, D] views, the live window as
    its mask) on the device and per call (:func:`kernel_times`), the plain
    version on the device, the split plan and the bound: the live K and V
    rows read once, q read and o written once, pos and pad."""
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        decode_attention as da
    b, t, h, d = k.shape
    slots = torch.arange(t, device=k.device)
    amask = ((slots[None, :] <= pos[:, None])
             & (slots[None, :] >= pad[:, None]))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel(q_, k_, v_):
        return da.decode_attention(q_, k_, v_, pos=pos, pad=pad)

    def library(q_, k_, v_):
        return sdpa(q_[:, :, None], k_.transpose(1, 2), v_.transpose(1, 2),
                    attn_mask=amask)

    parts = {}
    out = kernel_times(kernel, sets, library, sets, iters=192,
                       by_kernel=parts)
    out["kernels_ms"] = short_names(parts)  # scores, PV, combine
    if plain:
        out["plain_ms"] = device_ms(lambda *a: da.xla_decode_attention(
            *a, pos=pos, pad=pad), sets, iters=8)
    live = int((pos - pad + 1).sum())
    out["bound_ms"], out["bound_by"] = bound(
        4.0 * h * d * live, 2 * live * h * d * 2 + 2 * b * h * d * 2 + 8 * b)
    per, splits = da.split_plan(
        b, h, t, torch.cuda.get_device_properties(0).multi_processor_count)
    out.update(splits=splits, tiles_per_split=per)
    log(f"[decode T={t}] device ms: kernel {out['ms']:.4f} "
        f"({fmt_ms(out['kernels_ms'])})"
        + (f", plain {out['plain_ms']:.4f}" if plain else "")
        + f", sdpa {out['library_ms']:.4f}; per call on CUDA events: kernel "
        f"{out['call_ms']:.4f}, sdpa {out['library_call_ms']:.4f}; bound_ms "
        f"{out['bound_ms']:.4f} ({out['bound_by']}: {live} live slots of "
        f"{b * t}); {splits} splits of {per} tiles")
    return out


# (pad, pos) per row of the windows case: empty (pad > pos) on rows 1 and
# 7, edges inside 64-slot tiles and across them, one live slot at a tile's
# last slot and at the next tile's first
DECODE_WINDOWS = [(0, 639), (300, 299), (5, 70), (63, 63), (64, 64),
                  (17, 639), (100, 130), (640, 639)]


def phase_decode(gen) -> dict:
    """B4 (split-K) against its plain version and itself at the decode
    step's shape: [B] pos, scalar pos, odd T, D=128, windows that are
    empty or cut mid-tile, and 8 rows of 16,384 slots; timed at the decode
    step's shape and over the long rows."""
    b, t = DECODE_SHAPE["b"], DECODE_SHAPE["t"]
    q, k, v, pos, pad = decode_inputs(gen)
    t_odd = t - 27               # odd cache length: no T % 128 gate here
    k_odd, v_odd = k[:, :t_odd].contiguous(), v[:, :t_odd].contiguous()
    win_pad, win_pos = (torch.tensor(w, dtype=torch.int32, device=q.device)
                        for w in zip(*DECODE_WINDOWS))
    results = [decode_check("[B] pos", q, k, v, pos, pad),
               decode_check("scalar pos", q, k, v, t - 1, pad),
               decode_check(f"T={t_odd}", q, k_odd, v_odd, t_odd - 1, pad),
               decode_check("windows", q, k, v, win_pos, win_pad,
                            empty=(1, 7))]
    del k_odd, v_odd
    results.append(decode_check("D=128", *decode_inputs(gen, d=128)))
    rec = decode_times(q, k, v, pos, pad, cold_sets((q, k, v)), plain=True)
    del q, k, v
    long_in = decode_inputs(gen, t=PAGED_LONG_NB * PAGED_SHAPE["bs"])
    e, r = decode_check(f"{b} rows of {long_in[1].shape[1]} slots",
                        *long_in)
    results.append((e, r))
    long_row = decode_times(*long_in, [long_in[:3]], plain=False)
    long_row.update(slots=long_in[1].shape[1], max_row_rel_err=r)
    return {"max_abs_err": max(e for e, _ in results),
            "max_row_rel_err": max(r for _, r in results), **rec,
            "long_row": long_row}


def paged_inputs(gen, d: int, nb: int = PAGED_SHAPE["nb"]) -> dict:
    """B5's inputs at the engine's shapes: B rows of ~640 logical slots in
    16-slot blocks (``nb`` blocks a row; :data:`PAGED_LONG_NB` for the long
    rows), physical blocks shuffled over the pool, rows 0-3 sharing their
    first 8 blocks (a 128-token prefix), per-row pos and pad, and table
    entries outside each row's live window pointing at the null block 0
    (random bytes here; :func:`phase_paged` also runs it NaN-filled)."""
    dev = torch.device("cuda")
    b, h, bs = (PAGED_SHAPE[x] for x in ("b", "h", "bs"))
    shared = 8
    n = 1 + b * nb                                    # null block + rows
    perm = torch.randperm(n - 1, generator=gen) + 1
    bt = perm[:b * nb].reshape(b, nb).to(torch.int32)
    bt[1:4, :shared] = bt[0, :shared]                 # shared prefix blocks
    pos = torch.randint(nb * bs - 40, nb * bs, (b,), generator=gen,
                        dtype=torch.int32)
    pad = torch.zeros(b, dtype=torch.int32)
    pad[4:] = torch.randint(1, 3 * bs, (b - 4,), generator=gen,
                            dtype=torch.int32)
    for row in range(b):          # blocks wholly outside the window -> 0
        blk = torch.arange(nb)
        outside = (blk > pos[row] // bs) | (blk < pad[row] // bs)
        bt[row, outside] = 0
    q = torch.randn((b, h, d), generator=gen).to(dev, torch.bfloat16)
    k_pool, v_pool = (torch.randn((n, bs, h, d), generator=gen).to(
        dev, torch.bfloat16) for _ in range(2))
    return {"q": q, "k_pool": k_pool, "v_pool": v_pool,
            "bt": bt.to(dev), "pos": pos.to(dev), "pad": pad.to(dev)}


def paged_bound(x: dict, quant: bool) -> tuple[float, str, int, int, float]:
    """(bound ms, bound by, live slots, distinct physical slots, MB) of one
    paged call at D=64 on ``x``: the live K and V rows read once (a shared
    physical slot once; int8 rows with their two f32 scales), q read and o
    written once, the table, pos and pad; 4 FLOP per live (slot, head,
    dim)."""
    b, h, bs = (PAGED_SHAPE[k] for k in ("b", "h", "bs"))
    d, nb = 64, x["bt"].shape[1]
    live, distinct = live_slots(x["bt"], x["pos"], x["pad"], bs)
    row = h * d + 4 if quant else h * d * 2           # bytes a K or V slot
    nbytes = (2 * distinct * row + 2 * b * h * d * 2
              + b * nb * 4 + 2 * b * 4)
    bms, by = bound(4.0 * h * d * live, nbytes)
    return bms, by, live, distinct, nbytes / 1e6


def paged_times(kernel, plain, slab, sets: list[tuple], amask) -> dict:
    """The paged kernel against its plain version and SDPA, each on the
    device (:func:`device_ms`, the split and combine kernels summed), and
    the kernel's and SDPA's per-call times on CUDA events (:func:`cuda_ms`,
    which also pay each call's host work). ``slab(*args)`` gathers one
    set's rows into the [B, H, T, D] slabs SDPA takes (dequantized, for
    int8): ``library_ms`` times SDPA over slabs gathered beforehand,
    ``library_gather_ms`` with the gather. ``plain`` None leaves the plain
    version out."""
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(q_, k_, v_):
        return sdpa(q_[:, :, None], k_, v_, attn_mask=amask)

    slab_sets = [slab(*a) for a in sets]
    parts = {}
    out = kernel_times(kernel, sets, library, slab_sets, iters=192,
                       by_kernel=parts)
    out["library_gather_ms"] = device_ms(lambda *a: library(*slab(*a)),
                                         sets, iters=192)
    if plain is not None:
        out["plain_ms"] = device_ms(plain, sets)
    out["kernels_ms"] = short_names(parts)  # the split and combine kernels
    return out


def fmt_ms(named: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in named.items())


def paged_window_mask(x: dict) -> torch.Tensor:
    """SDPA's [B, 1, 1, T] mask of each row's live window."""
    nb, bs = x["bt"].shape[1], PAGED_SHAPE["bs"]
    slots = torch.arange(nb * bs, device=x["pos"].device)
    return ((slots[None, :] <= x["pos"][:, None])
            & (slots[None, :] >= x["pad"][:, None]))[:, None, None, :]


def paged_plan(x: dict) -> dict:
    """The wrapper's split plan for ``x`` on this card."""
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        paged_decode_attention as pa
    b, nb = x["bt"].shape
    per, splits = pa.split_plan(
        b, PAGED_SHAPE["h"], nb * PAGED_SHAPE["bs"],
        torch.cuda.get_device_properties(0).multi_processor_count)
    return {"splits": splits, "tiles_per_split": per}


def phase_paged(gen) -> dict:
    """B5 against its plain version at D=64 and D=128 (shuffled and shared
    blocks), against itself (two launches bitwise equal) and with the null
    block 0 NaN-filled: the output must not change by a bit, since the
    kernel never reads a masked slot. (The plain version, like the
    reference's gather path, multiplies masked V rows by zero
    probabilities, so it cannot take a NaN null block.) Then timed at D=64
    (:func:`paged_times`), and once more over 16,384-slot rows, held to
    the plain version there too."""
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        paged_decode_attention as pa
    err = rel = 0.0
    b, h, bs = (PAGED_SHAPE[k] for k in ("b", "h", "bs"))
    for d in (128, 64):                 # the timed D=64 inputs stay below
        x = paged_inputs(gen, d)
        kw = dict(block_tables=x["bt"], pos=x["pos"], pad=x["pad"])
        o = pa.paged_decode_attention(x["q"], x["k_pool"], x["v_pool"], **kw)
        o_again = pa.paged_decode_attention(x["q"], x["k_pool"],
                                            x["v_pool"], **kw)
        o_ref = pa.xla_paged_decode_attention(x["q"], x["k_pool"],
                                              x["v_pool"], **kw)
        k_nan, v_nan = x["k_pool"].clone(), x["v_pool"].clone()
        k_nan[0] = v_nan[0] = float("nan")
        o_nan = pa.paged_decode_attention(x["q"], k_nan, v_nan, **kw)
        torch.cuda.synchronize()
        e = (o.float() - o_ref.float()).abs().max().item()
        r = row_rel_err(o, o_ref)
        same, det = bool(torch.equal(o, o_nan)), bool(torch.equal(o, o_again))
        log(f"[paged D={d}] worst row max|o - plain| / max|plain| {r:.3e} "
            f"(tol {PAGED_ROW_REL_TOL}; max abs err {e:.3e}); two launches "
            f"bitwise equal: {det}; NaN null block leaves the output "
            f"bitwise unchanged: {same}")
        if not same or not det or r > PAGED_ROW_REL_TOL:
            raise SystemExit(f"paged_decode_attention disagrees with its "
                             f"plain version or itself at D={d}")
        err, rel = max(err, e), max(rel, r)
    del k_nan, v_nan
    nb = x["bt"].shape[1]
    bt_l = x["bt"].long()
    kw = dict(block_tables=x["bt"], pos=x["pos"], pad=x["pad"])

    def slab(q_, kp, vp):               # [B, H, T, D] views for SDPA
        return (q_, kp[bt_l].reshape(b, nb * bs, h, 64).transpose(1, 2),
                vp[bt_l].reshape(b, nb * bs, h, 64).transpose(1, 2))

    times = paged_times(
        lambda *a: pa.paged_decode_attention(*a, **kw),
        lambda *a: pa.xla_paged_decode_attention(*a, **kw), slab,
        cold_sets((x["q"], x["k_pool"], x["v_pool"])), paged_window_mask(x))
    bms, by, live, distinct, mb = paged_bound(x, quant=False)
    plan = paged_plan(x)
    log(f"[paged] device ms: kernel {times['ms']:.4f} "
        f"({fmt_ms(times['kernels_ms'])}), "
        f"plain {times['plain_ms']:.4f}, sdpa over the gathered slab "
        f"{times['library_ms']:.4f}, with the gather "
        f"{times['library_gather_ms']:.4f}; per call on CUDA events: kernel "
        f"{times['call_ms']:.4f}, sdpa {times['library_call_ms']:.4f}; "
        f"bound_ms {bms:.4f} ({by}: {live} live slots of {b * nb * bs} over "
        f"{distinct} distinct physical slots, {mb:.2f} MB); {plan}")
    long_row = paged_long_row(gen, quant=False)
    return {"max_abs_err": err, "max_row_rel_err": rel, **times,
            "bound_ms": bms, "bound_by": by, **plan, "long_row": long_row}


def paged_long_row(gen, quant: bool) -> dict:
    """B5 (or, ``quant``, B6) over 8 rows of :data:`PAGED_LONG_NB` blocks
    (16,384 slots) at D=64: held to the
    plain version, then the kernel and SDPA over the gathered slab timed
    on the device beside the bound."""
    from distributed_tensorflow_example_tpu_torch.models.gpt import \
        quantize_kv_rows
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        paged_decode_attention as pa
    b, h, bs = (PAGED_SHAPE[k] for k in ("b", "h", "bs"))
    x = paged_inputs(gen, 64, nb=PAGED_LONG_NB)
    nb, bt_l = PAGED_LONG_NB, x["bt"].long()
    kw = dict(block_tables=x["bt"], pos=x["pos"], pad=x["pad"])
    args = (x["q"], x["k_pool"], x["v_pool"])
    if quant:
        (kq, ks), (vq, vs) = (quantize_kv_rows(x[k])
                              for k in ("k_pool", "v_pool"))
        args = (x["q"], kq, vq, ks, vs)
        del x["k_pool"], x["v_pool"]

    def kernel(q_, k_, v_, ks_=None, vs_=None):
        return pa.paged_decode_attention(q_, k_, v_, k_scale=ks_,
                                         v_scale=vs_, **kw)

    def slab(q_, k_, v_, ks_=None, vs_=None):
        def one(pool, scale):
            g = pool[bt_l]
            if scale is not None:
                g = (g.float() * scale[bt_l][..., None, None]).to(
                    torch.bfloat16)
            return g.reshape(b, nb * bs, h, 64).transpose(1, 2)
        return q_, one(k_, ks_), one(v_, vs_)

    o = kernel(*args)
    o_ref = pa.xla_paged_decode_attention(
        *args[:3], k_scale=ks if quant else None,
        v_scale=vs if quant else None, **kw)
    torch.cuda.synchronize()
    r = row_rel_err(o, o_ref)
    del o_ref
    times = paged_times(kernel, None, slab, [args], paged_window_mask(x))
    bms, by, live, distinct, mb = paged_bound(x, quant)
    plan = paged_plan(x)
    label = "paged int8" if quant else "paged"
    log(f"[{label} long rows] {b} rows of {nb * bs} slots: worst row "
        f"max|o - plain| / max|plain| {r:.3e} (tol {PAGED_ROW_REL_TOL}); "
        f"device ms: kernel {times['ms']:.4f} "
        f"({fmt_ms(times['kernels_ms'])}), sdpa over the gathered slab "
        f"{times['library_ms']:.4f}, with the gather "
        f"{times['library_gather_ms']:.4f}; per call on CUDA events: kernel "
        f"{times['call_ms']:.4f}; bound_ms {bms:.4f} ({by}: {live} live "
        f"slots over {distinct} distinct, {mb:.2f} MB); {plan}")
    if r > PAGED_ROW_REL_TOL:
        raise SystemExit(f"{label} disagrees with its plain version over "
                         f"{nb * bs}-slot rows")
    return {"slots": nb * bs, "max_row_rel_err": r, **times,
            "bound_ms": bms, "bound_by": by, **plan}


def phase_paged_int8(gen) -> dict:
    """B6 (int8 pools, one f32 scale per slot) at B5's shapes, its pools
    quantized on the card from random bf16 ones: against its plain version
    at D=128 and D=64, against itself (two launches bitwise equal) and with
    garbage bytes and NaN scales in the null block 0 (never read, so no bit
    may change). Then timed at D=64 (:func:`paged_times`; SDPA over the
    slab gathered and dequantized beforehand, and with the gather and
    dequant), and over 16,384-slot rows."""
    from distributed_tensorflow_example_tpu_torch.models.gpt import \
        quantize_kv_rows
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        paged_decode_attention as pa
    err = rel = 0.0
    b, h, bs = (PAGED_SHAPE[k] for k in ("b", "h", "bs"))
    for d in (128, 64):                 # the timed D=64 inputs stay below
        x = paged_inputs(gen, d)
        kq, ks = quantize_kv_rows(x["k_pool"])
        vq, vs = quantize_kv_rows(x["v_pool"])
        kw = dict(block_tables=x["bt"], pos=x["pos"], pad=x["pad"])
        o = pa.paged_decode_attention(x["q"], kq, vq, k_scale=ks,
                                      v_scale=vs, **kw)
        o_again = pa.paged_decode_attention(x["q"], kq, vq, k_scale=ks,
                                            v_scale=vs, **kw)
        o_ref = pa.xla_paged_decode_attention(x["q"], kq, vq, k_scale=ks,
                                              v_scale=vs, **kw)
        k_bad, v_bad, ks_nan, vs_nan = (t.clone() for t in (kq, vq, ks, vs))
        k_bad[0], v_bad[0] = 127, -128
        ks_nan[0] = vs_nan[0] = float("nan")
        o_nan = pa.paged_decode_attention(x["q"], k_bad, v_bad,
                                          k_scale=ks_nan, v_scale=vs_nan,
                                          **kw)
        torch.cuda.synchronize()
        e = (o.float() - o_ref.float()).abs().max().item()
        r = row_rel_err(o, o_ref)
        same, det = bool(torch.equal(o, o_nan)), bool(torch.equal(o, o_again))
        log(f"[paged int8 D={d}] worst row max|o - plain| / max|plain| "
            f"{r:.3e} (tol {PAGED_INT8_ROW_REL_TOL}; max abs err {e:.3e}); "
            f"two launches bitwise equal: {det}; garbage bytes and NaN "
            f"scales in the null block leave the output bitwise unchanged: "
            f"{same}; output dtype {o.dtype}")
        if (not same or not det or r > PAGED_INT8_ROW_REL_TOL
                or o.dtype != x["q"].dtype):
            raise SystemExit(f"paged_decode_attention int8 disagrees with "
                             f"its plain version or itself at D={d}")
        err, rel = max(err, e), max(rel, r)
    del k_bad, v_bad, ks_nan, vs_nan
    nb = x["bt"].shape[1]
    bt_l = x["bt"].long()
    kw = dict(block_tables=x["bt"], pos=x["pos"], pad=x["pad"])

    def kernel(q_, kq_, vq_, ks_, vs_):
        return pa.paged_decode_attention(q_, kq_, vq_, k_scale=ks_,
                                         v_scale=vs_, **kw)

    def plain(q_, kq_, vq_, ks_, vs_):
        return pa.xla_paged_decode_attention(q_, kq_, vq_, k_scale=ks_,
                                             v_scale=vs_, **kw)

    def slab(q_, kq_, vq_, ks_, vs_):   # dequantized [B, H, T, D] for SDPA
        def one(pool, scale):
            return (pool[bt_l].float() * scale[bt_l][..., None, None]).to(
                torch.bfloat16).reshape(b, nb * bs, h, 64).transpose(1, 2)
        return q_, one(kq_, ks_), one(vq_, vs_)

    times = paged_times(kernel, plain, slab,
                        cold_sets((x["q"], kq, vq, ks, vs)),
                        paged_window_mask(x))
    bms, by, live, distinct, mb = paged_bound(x, quant=True)
    plan = paged_plan(x)
    log(f"[paged int8] device ms: kernel {times['ms']:.4f} "
        f"({fmt_ms(times['kernels_ms'])}), plain {times['plain_ms']:.4f}, "
        f"sdpa over the slab "
        f"gathered and dequantized beforehand {times['library_ms']:.4f}, "
        f"with the gather and dequant {times['library_gather_ms']:.4f}; per "
        f"call on CUDA events: kernel {times['call_ms']:.4f}, sdpa "
        f"{times['library_call_ms']:.4f}; bound_ms {bms:.4f} ({by}: {live} "
        f"live slots of {b * nb * bs} over {distinct} distinct physical "
        f"slots, {mb:.2f} MB); {plan}")
    long_row = paged_long_row(gen, quant=True)
    return {"max_abs_err": err, "max_row_rel_err": rel, **times,
            "bound_ms": bms, "bound_by": by, **plan, "long_row": long_row}


# ---------------------------------------------------------------------------
# training phase: GPT-small training steps through SyncReplicas
# ---------------------------------------------------------------------------

def _loss_and_grads(model, params, batch) -> tuple[float, dict]:
    """One forward and backward of ``model.loss`` with no generator
    (dropout off): (loss, {flat key: grad})."""
    from distributed_tensorflow_example_tpu_torch.utils.pytree import (
        flatten_dict, unflatten_dict)
    flat = {k: v.detach().requires_grad_() for k, v in
            flatten_dict(params).items()}
    loss, _ = model.loss(unflatten_dict(flat), {}, batch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.item(), dict(zip(flat, grads))


def phase_train(card: str) -> dict:
    """Full-width GPT-small (bf16 compute, f32 params, flash attention,
    dropout 0.1) trained by ``SyncReplicas`` with AdamW (lr 1e-3, 5
    warmup steps, cosine decay, clip 1.0, weight decay 0.01 off the 1-d
    leaves) for 20 steps on one fixed batch of 8 x 512 tokens, two rows
    ending in 64 padding tokens. First one step's grads with dropout off,
    flash against the plain einsum attention; then the 20 steps with
    every kernel's launch count set to 0 just before and read just
    after: B1, B2a and B2b must each launch 12 times a step, the serving
    kernels not at all; every metric finite, no anomaly, the loss down by
    at least 10%. Returns the launch counts."""
    from distributed_tensorflow_example_tpu_torch.config import (
        OptimizerConfig, TrainConfig)
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas \
        import SyncReplicas
    from distributed_tensorflow_example_tpu_torch.train.optimizers import \
        make_optimizer
    from distributed_tensorflow_example_tpu_torch.train.state import \
        param_count

    cfg = TrainConfig(model="gpt", dtype="bfloat16", attention_impl="flash",
                      seed=0, optimizer=OptimizerConfig(
                          name="adamw", learning_rate=1e-3, warmup_steps=5,
                          decay_schedule="cosine", total_steps=TRAIN_STEPS,
                          grad_clip_norm=1.0, weight_decay=0.01))
    cfg.data.seq_len = TRAIN_S
    model = get_model("gpt", cfg)
    c = model.cfg
    sync = SyncReplicas(model.loss, make_optimizer(cfg.optimizer),
                        sync=cfg.sync)
    state = sync.init(model.init, seed=cfg.seed)
    log(f"[train] GPT-small: {param_count(state.params)} params (f32), "
        f"vocab {c.vocab_size}, {c.layers} layers, bf16 compute, flash "
        f"attention, dropout {c.dropout}; AdamW lr "
        f"{cfg.optimizer.learning_rate}, warmup {cfg.optimizer.warmup_steps}"
        f", cosine over {TRAIN_STEPS} steps, clip "
        f"{cfg.optimizer.grad_clip_norm}; batch {TRAIN_B} x {TRAIN_S}")
    rs = np.random.RandomState(2)
    ids = rs.randint(0, c.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, -TRAIN_PAD:] = mask[5, -TRAIN_PAD:] = 0
    batch = {k: torch.as_tensor(x, device="cuda")
             for k, x in (("input_ids", ids), ("attention_mask", mask))}

    # flash (B1, B2a, B2b) against the plain einsum attention, dropout off
    plain = get_model("gpt", cfg.replace(attention_impl="xla"))
    lf, gf = _loss_and_grads(model, state.params, batch)
    lx, gx = _loss_and_grads(plain, state.params, batch)
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in gx.values()))
    worst, worst_key, zero = 0.0, "", 0.0
    for key in gx:
        a, b = gf[key].float(), gx[key].float()
        if key.endswith("attn/k/bias"):
            zero = max(zero, (a.norm() / total).item(),
                       (b.norm() / total).item())
            continue
        rel = ((a - b).norm() / b.norm()).item()
        if rel > worst:
            worst, worst_key = rel, key
    del gf, gx, plain
    log(f"[train] one step's grads, flash vs xla attention (dropout off): "
        f"worst leaf {worst_key} ||g_flash - g_xla|| / ||g_xla|| "
        f"{worst:.3e} (tol {TRAIN_GRAD_REL_TOL}); key biases ||g|| / global "
        f"norm {zero:.3e} (tol {TRAIN_ZERO_GRAD_SHARE}); loss {lf:.5f} vs "
        f"{lx:.5f} (tol {TRAIN_LOSS_TOL})")
    if worst > TRAIN_GRAD_REL_TOL or zero > TRAIN_ZERO_GRAD_SHARE \
            or abs(lf - lx) > TRAIN_LOSS_TOL:
        raise SystemExit("flash attention's grads disagree with the plain "
                         "attention's")

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_launches = _reset_launches()
    metrics = []
    t0 = t1 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        if i == 1:                         # the first step is not timed
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        state, met = sync.step(state, batch)
        metrics.append(met)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    vals = [{k: float(v) for k, v in m.items()} for m in metrics]
    ms = (t2 - t1) / (TRAIN_STEPS - 1) * 1e3
    log(f"[train] {TRAIN_STEPS} steps: loss " + " ".join(
        f"{v['loss']:.3f}" for v in vals))
    log(f"[train] grad_norm first {vals[0]['grad_norm']:.3f} last "
        f"{vals[-1]['grad_norm']:.3f}, token_accuracy last "
        f"{vals[-1]['token_accuracy']:.4f}, anomaly_count "
        f"{int(vals[-1]['anomaly_count'])}; launches {launches}")
    log(f"[train] first step {(t1 - t0) * 1e3:.1f} ms, then {ms:.2f} ms per "
        f"step, {TRAIN_B * TRAIN_S / ms * 1e3:.1f} tokens/s (all {TRAIN_B} "
        f"x {TRAIN_S} input tokens), peak device memory "
        f"{peak / 2**20:.1f} MiB ({card})")
    want = {"flash_attention_fwd": c.layers * TRAIN_STEPS,
            "flash_attention_bwd_dq": c.layers * TRAIN_STEPS,
            "flash_attention_bwd_dkv": c.layers * TRAIN_STEPS,
            "flash_attention_bwd_fused": 0,
            "decode_attention": 0, "paged_decode_attention": 0,
            "paged_decode_attention_int8": 0}
    failed = []
    if launches != want:
        failed.append(f"launches {launches}, want {want}")
    if not all(np.isfinite(x) for v in vals for x in v.values()):
        failed.append("a metric is not finite")
    if int(vals[-1]["anomaly_count"]) != 0 or state.step != TRAIN_STEPS:
        failed.append(f"anomaly_count {vals[-1]['anomaly_count']}, step "
                      f"{state.step}")
    if vals[-1]["loss"] > (1 - TRAIN_MIN_LOSS_DROP) * vals[0]["loss"]:
        failed.append(f"the loss fell from {vals[0]['loss']:.4f} to "
                      f"{vals[-1]['loss']:.4f}, less than "
                      f"{TRAIN_MIN_LOSS_DROP:.0%}")
    if failed:
        raise SystemExit("the training phase failed: " + "; ".join(failed))
    phase_train_profile(sync, state, batch, card)
    del sync, state, batch
    phase_train_lm_head(card)
    return launches


def phase_train_profile(sync, state, batch, card: str) -> None:
    """One step on the host clock, then the device's busy time and idle
    share under ``torch.profiler`` over a second step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = sync.step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sync.step(state, batch)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    if not kernels:
        log("[train profile] the profiler saw no device time: idle share "
            "not measured")
        return
    busy = sum(_device_us(e) for e in kernels) / 1e3
    log(f"[train profile] one step {wall * 1e3:.1f} ms; traced step "
        f"{traced * 1e3:.1f} ms, device busy {busy:.1f} ms in "
        f"{sum(e.count for e in kernels)} kernel launches: idle share "
        f"{1 - busy / (traced * 1e3):.3f} of the traced step, "
        f"{1 - busy / (wall * 1e3):.3f} of the untraced one ({card})")
    ours = [e for e in kernels if "flash_" in e.key]
    for e in sorted(kernels, key=_device_us, reverse=True)[:8] + ours:
        log(f"[train profile]   {_device_us(e) / 1e3:8.2f} ms  "
            f"{e.count:6d}x  {e.key[:90]}")


# ---------------------------------------------------------------------------
# CLI phase: GPT-small training through cli/train.py -> Trainer -> ring
# ---------------------------------------------------------------------------

class _LogTap(logging.Handler):
    """Keeps the messages of the port's loggers (the LoggingHook's per-step
    metrics, the trainer's restore line)."""

    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _step_metrics(lines: list[str]) -> dict[int, dict]:
    """{step: {metric: value}} from the LoggingHook's lines."""
    out = {}
    for line in lines:
        m = re.match(r"step (\d+): (\w+=.*)$", line)
        if m and "loss=" in m.group(2):
            out[int(m.group(1))] = {
                k: float(v) for k, v in
                (kv.split("=") for kv in m.group(2).split())}
    return out


def _ring(ckpt_dir: str) -> list[int]:
    """The ring's steps, each verified against its CRC record."""
    from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import \
        CheckpointManager
    mgr = CheckpointManager(ckpt_dir)
    steps = mgr.all_steps()
    for step in steps:
        mgr.verify_step(step)
    return steps


def phase_cli(card: str) -> dict:
    """The tentpole command: ``cli/train.main`` trains full-width GPT-small
    (bf16 compute, f32 params, flash attention with the fused backward B3,
    dropout 0.1) on the synthetic LM corpus, 8 x 512 tokens a step, AdamW,
    for 20 steps with a checkpoint every 10 in a ring of 2; a second call
    on the same directory resumes at 20 and trains to 30, then exports the
    generator, which ``PredictServer`` serves for one ``:generate``; a
    5-step run with the split backward from the same seed gives the fused
    run's losses. Launch counts are set to 0 before each call and read
    after it: B3 12 a step, B2a and B2b none, B1 12 a step and 12 an eval
    batch. Returns the B3 launches of the first call."""
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    from distributed_tensorflow_example_tpu_torch.obs import trace
    from distributed_tensorflow_example_tpu_torch.serving_http import \
        PredictServer

    tap = _LogTap()
    for name in ("dtx.hooks", "dtx.trainer"):
        logging.getLogger(name).addHandler(tap)
    rec = trace.recorder()
    failed = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    ck, gen_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "gen")
    base = ["--model", "gpt", "--device", "cuda", "--attention", "flash",
            "--attention_bwd", "fused", "--dtype", "bfloat16",
            "--seq_len", str(TRAIN_S), "--batch_size", str(TRAIN_B),
            "--optimizer", "adamw", "--learning_rate", "1e-3",
            "--warmup_steps", "5", "--decay_schedule", "cosine",
            "--grad_clip_norm", "1.0", "--weight_decay", "0.01",
            "--seed", "0"]
    layers = 12
    eval_batches = -(-256 // TRAIN_B)     # get_lm_data's 256 eval rows

    def run(argv, steps, label):
        tap.lines.clear()
        rec.start()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        read = _reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(base + argv)
        wall = time.perf_counter() - t0
        launches = read()
        spans = rec.drain("training")
        rec.stop()
        peak = torch.cuda.max_memory_allocated()
        want = {"flash_attention_fwd": layers * (steps + eval_batches),
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "flash_attention_bwd_fused": layers * steps,
                "decode_attention": 0, "paged_decode_attention": 0,
                "paged_decode_attention_int8": 0}
        if "split" in argv:
            want.update(flash_attention_bwd_fused=0,
                        flash_attention_bwd_dq=layers * steps,
                        flash_attention_bwd_dkv=layers * steps)
        if rc != 0:
            failed.append(f"{label}: main returned {rc}")
        if launches != want:
            failed.append(f"{label}: launches {launches}, want {want}")
        saves = [t1 - t0_ for _, lane, name, t0_, t1, _ in spans
                 if name == "checkpoint_save"]
        log(f"[cli {label}] rc {rc} in {wall:.1f} s, launches {launches}, "
            f"peak device memory {peak / 2**20:.1f} MiB, checkpoint saves "
            + (", ".join(f"{x:.2f} s" for x in saves) or "none")
            + f" ({card})")
        return _step_metrics(tap.lines), list(tap.lines), saves, launches

    metrics = os.path.join(tmp, "metrics.jsonl")
    first, _, saves1, launches1 = run(
        ["--train_steps", "20", "--ckpt_dir", ck, "--save_steps", "10",
         "--max_to_keep", "2", "--log_every_steps", "1",
         "--metrics_path", metrics], 20, "steps 1-20")
    ring1 = _ring(ck)
    second, lines2, saves2, _ = run(
        ["--train_steps", "30", "--ckpt_dir", ck, "--save_steps", "10",
         "--max_to_keep", "2", "--log_every_steps", "10",
         "--metrics_path", metrics, "--export_generator", gen_dir,
         "--gen_prompt_len", "64", "--gen_max_new", "16",
         "--gen_batch", "2"], 10, "resume to 30 + export")
    ring2 = _ring(ck)
    split, _, _, _ = run(["--train_steps", "5", "--attention_bwd", "split",
                       "--log_every_steps", "1"], 5, "split, 5 steps")
    losses = [first[i]["loss"] for i in sorted(first)]
    log(f"[cli] fused run losses (steps 1-20): "
        + " ".join(f"{x:.4f}" for x in losses))
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    rates = {r["step"]: r["sec_per_step"] for r in recs
             if "sec_per_step" in r}
    # steps 2-20 of the first call (a host sync each step: log every
    # step), leaving out step 11, whose window holds step 10's save
    every = [rates[i] for i in range(2, 21) if i != 11 and i in rates]
    ms1 = 1e3 * sum(every) / max(1, len(every))
    ms2 = 1e3 * rates.get(30, float("nan"))     # steps 21-30, one window
    log(f"[cli] ms per step: {ms1:.2f} over steps 2-20 but 11 (metrics "
        f"read each step), {ms2:.2f} over steps 21-30 (read at 30 only); "
        f"tokens/s {TRAIN_B * TRAIN_S / ms2 * 1e3:.1f} ({card})")
    log(f"[cli] ring after 20: {ring1} (verified), after 30: {ring2} "
        f"(verified); saves {[round(x, 3) for x in saves1 + saves2]} s")

    # restore time of the newest checkpoint, outside the Trainer
    from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import \
        CheckpointManager
    from distributed_tensorflow_example_tpu_torch.config import \
        OptimizerConfig, TrainConfig
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas \
        import SyncReplicas
    from distributed_tensorflow_example_tpu_torch.train.optimizers import \
        make_optimizer
    cfg = TrainConfig(model="gpt", dtype="bfloat16",
                      optimizer=OptimizerConfig(name="adamw",
                                                grad_clip_norm=1.0,
                                                weight_decay=0.01))
    model = get_model("gpt", cfg)
    sync = SyncReplicas(model.loss, make_optimizer(cfg.optimizer))
    template = sync.init(model.init, seed=1)
    mgr = CheckpointManager(ck)
    t0 = time.perf_counter()
    restored = mgr.restore(template)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.verify_step(30)
    t_verify = time.perf_counter() - t0
    size = os.path.getsize(mgr.checkpoint_path(30))
    log(f"[cli] checkpoint ckpt-30.npz {size / 2**20:.1f} MiB: restore "
        f"(read, CRC, to the card) {t_restore:.2f} s, verify alone "
        f"{t_verify:.2f} s; restored step {restored.step}")
    del template, restored, sync, model

    # the exported generator, served
    with PredictServer(gen_dir) as srv:
        ids = np.random.RandomState(3).randint(0, 30522, (2, 64)).tolist()
        out, secs = post(srv.port, srv.name, {"inputs": {"input_ids": ids}})
    toks = np.asarray(out["generations"])
    log(f"[cli] exported generator served: :generate of 2 x 64 tokens "
        f"-> {toks.shape} in {secs * 1e3:.1f} ms")
    # the server's flight recorder armed the span ring; its stop() must
    # disarm it, or every later phase records spans
    if trace.recorder().enabled:
        failed.append("the stopped server left the span ring armed")

    if sorted(first) != list(range(1, 21)):
        failed.append(f"logged steps {sorted(first)}")
    elif losses[-1] > (1 - TRAIN_MIN_LOSS_DROP) * losses[0]:
        failed.append(f"the loss fell from {losses[0]:.4f} to "
                      f"{losses[-1]:.4f}, less than "
                      f"{TRAIN_MIN_LOSS_DROP:.0%}")
    counts = [m["anomaly_count"] for m in first.values()] + [
        m["anomaly_count"] for m in second.values()]
    if any(c != 0 for c in counts) or not all(
            np.isfinite(x) for m in first.values() for x in m.values()):
        failed.append(f"anomaly counts {counts} or a metric not finite")
    if ring1 != [10, 20] or ring2 != [20, 30]:
        failed.append(f"ring {ring1} then {ring2}, want [10, 20] then "
                      "[20, 30]")
    if not any("restored checkpoint at step 20" in x for x in lines2) \
            or 30 not in second:
        failed.append("the second call did not resume at step 20")
    split_losses = [split[i]["loss"] for i in sorted(split)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(split_losses, losses))
    log(f"[cli] split backward, 5 steps: losses "
        + " ".join(f"{x:.4f}" for x in split_losses)
        + f"; worst relative difference from the fused run {rel:.3e} "
        f"(tol {CLI_SPLIT_LOSS_REL_TOL})")
    if len(split_losses) != 5 or rel > CLI_SPLIT_LOSS_REL_TOL:
        failed.append(f"split vs fused losses differ by {rel:.3e}")
    if toks.shape != (2, 16) or toks.dtype.kind != "i":
        failed.append(f"generations of shape {toks.shape}")
    for name in ("dtx.hooks", "dtx.trainer"):
        logging.getLogger(name).removeHandler(tap)
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise SystemExit("the CLI phase failed: " + "; ".join(failed))
    phase_cli_profile(base, card)
    return {"launches": launches1["flash_attention_bwd_fused"]}


class _ProfileStep:
    """A Trainer hook that traces one step with ``torch.profiler``: it
    starts after step ``at`` and stops after step ``at + 1``."""

    every_steps = 0

    def __init__(self, at: int):
        self.at = at
        self.prof = None
        self.t0 = self.wall = 0.0

    def begin(self, trainer):
        pass

    def wants_metrics(self, step):
        return False

    def after_step(self, trainer, step, metrics):
        from torch.profiler import ProfilerActivity, profile
        if step == self.at:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif step == self.at + 1 and self.prof is not None:
            torch.cuda.synchronize()
            self.wall = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)

    def end(self, trainer):
        pass


def phase_cli_profile(base: list, card: str) -> None:
    """The device's busy time and idle share of one Trainer step of the
    CLI's configuration (step 4 of a 5-step run, metrics read every 10
    steps), under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.train.trainer import \
        Trainer
    args = cli.build_parser().parse_args(
        base + ["--train_steps", "5", "--log_every_steps", "10"])
    cfg = cli.config_from_args(args)
    model = get_model(cfg.model, cfg)
    train, _ = cli.load_dataset(cfg, model)
    hook = _ProfileStep(3)
    with Trainer(model, cfg, train, None, hooks=[hook]) as tr:
        tr.train()
    kernels = [e for e in hook.prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    if not kernels:
        log("[cli profile] the profiler saw no device time: idle share not "
            "measured")
        return
    busy = sum(_device_us(e) for e in kernels) / 1e3
    log(f"[cli profile] one Trainer step (step 4) traced: "
        f"{hook.wall * 1e3:.1f} ms, device busy {busy:.1f} ms in "
        f"{sum(e.count for e in kernels)} kernel launches: idle share "
        f"{1 - busy / (hook.wall * 1e3):.3f} ({card})")
    ours = [e for e in kernels if "flash_" in e.key]
    for e in ours:
        log(f"[cli profile]   {_device_us(e) / 1e3:8.2f} ms  {e.count:6d}x"
            f"  {e.key[:90]}")


# ---------------------------------------------------------------------------
# slice phase: GPT-small generation served over HTTP
# ---------------------------------------------------------------------------

def post(port: int, name: str, payload: dict) -> tuple[dict, float]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
    return body, time.perf_counter() - t0


def phase_slice(card: str) -> dict:
    from distributed_tensorflow_example_tpu_torch.config import TrainConfig
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.serving import \
        export_generator
    from distributed_tensorflow_example_tpu_torch.serving_http import \
        PredictServer

    cfg = TrainConfig(model="gpt", dtype="bfloat16", attention_impl="flash")
    model = get_model("gpt", cfg)
    c = model.cfg
    log(f"[slice] GPT-small: vocab {c.vocab_size}, hidden {c.hidden}, "
        f"layers {c.layers}, heads {c.heads}, intermediate "
        f"{c.intermediate}, max_len {c.max_len}, bf16 compute, f32 params")
    params = model.init(0)                     # seeded, on cuda
    rs = np.random.RandomState(0)
    ids = rs.randint(0, c.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)
    ragged = np.ones((BATCH, PROMPT_LEN), np.int32)
    for row in range(1, BATCH):                # left pads of 0..~P/2
        ragged[row, :rs.randint(0, PROMPT_LEN // 2)] = 0

    with tempfile.TemporaryDirectory() as tmp:
        greedy_dir = os.path.join(tmp, "greedy")
        sampled_dir = os.path.join(tmp, "sampled")
        t0 = time.perf_counter()
        export_generator(model, params, greedy_dir, prompt_len=PROMPT_LEN,
                         max_new_tokens=MAX_NEW, batch_size=BATCH,
                         ragged=True)
        export_generator(model, params, sampled_dir, prompt_len=PROMPT_LEN,
                         max_new_tokens=MAX_NEW, batch_size=BATCH,
                         temperature=0.8, top_k=50, top_p=0.95)
        log(f"[slice] two exports in {time.perf_counter() - t0:.2f} s")
        with PredictServer(greedy_dir, port=0) as g_srv, \
                PredictServer(sampled_dir, port=0) as s_srv:
            requests = [
                (g_srv, "greedy", {"inputs": {
                    "input_ids": ids.tolist(),
                    "prompt_mask": np.ones_like(ragged).tolist()}}),
                (g_srv, "greedy ragged", {"inputs": {
                    "input_ids": ids.tolist(),
                    "prompt_mask": ragged.tolist()}}),
                (s_srv, "sampled seed 7", {"inputs": {
                    "input_ids": ids.tolist()}, "seed": 7}),
            ]
            post(g_srv.port, g_srv.name, requests[0][2])    # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            read_launches = _reset_launches()
            outs, lat = [], []
            for srv, label, payload in requests:
                body, sec = post(srv.port, srv.name, payload)
                outs.append(np.asarray(body["generations"]))
                lat.append(sec)
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated()
            again, _ = post(s_srv.port, s_srv.name, requests[2][2])
    n_req = len(requests)
    want = {"flash_attention_fwd": c.layers * n_req,
            "decode_attention": c.layers * (MAX_NEW - 1) * n_req,
            "paged_decode_attention": 0, "paged_decode_attention_int8": 0,
            **NO_BACKWARD}
    log(f"[slice] launches over {n_req} requests: {launches} "
        f"(want {want})")
    if launches != want:
        raise SystemExit("the served path did not run the kernels the "
                         "expected number of times")
    for (_, label, _), out, sec in zip(requests, outs, lat):
        if out.shape != (BATCH, MAX_NEW) or out.min() < 0 \
                or out.max() >= c.vocab_size:
            raise SystemExit(f"{label}: bad generations {out.shape} "
                             f"[{out.min()}, {out.max()}]")
        log(f"[slice] {label}: {sec * 1e3:.1f} ms, "
            f"{BATCH * MAX_NEW / sec:.1f} tokens/s ({card})")
    if not np.array_equal(np.asarray(again["generations"]), outs[2]):
        raise SystemExit("sampled generation is not deterministic per seed")
    log(f"[slice] peak device memory {peak / 2**20:.1f} MiB ({card})")

    # the server's greedy answers equal a direct generate on the card
    ids_t = torch.as_tensor(ids, device="cuda")
    direct = model.generate(params, ids_t, MAX_NEW).cpu().numpy()
    direct_r = model.generate(params, ids_t, MAX_NEW,
                              prompt_mask=torch.as_tensor(
                                  ragged, device="cuda")).cpu().numpy()
    if not (np.array_equal(direct, outs[0])
            and np.array_equal(direct_r, outs[1])):
        raise SystemExit("served greedy tokens differ from a direct "
                         "model.generate on the card")
    log("[slice] served greedy == direct model.generate (plain and ragged)")

    # the same generation through the plain versions on the card
    plain = get_model("gpt", cfg.replace(attention_impl="xla"))
    agree = []
    for label, mask, got in (("greedy", None, outs[0]),
                             ("greedy ragged", ragged, outs[1])):
        m_t = None if mask is None else torch.as_tensor(mask, device="cuda")
        ref = plain.generate(params, ids_t, MAX_NEW, prompt_mask=m_t,
                             decode_attention="xla").cpu().numpy()
        a = float((ref == got).mean())
        agree.append(a)
        log(f"[slice] {label}: token agreement with the plain versions "
            f"{a:.4f} (floor {AGREEMENT_FLOOR})")
    with torch.no_grad():
        m_t = torch.as_tensor(ragged, device="cuda")
        h_k = model.ragged_prefill(params, ids_t, m_t, PROMPT_LEN + 1)[0]
        h_p = plain.ragged_prefill(params, ids_t, m_t, PROMPT_LEN + 1)[0]
        lg_k = model.lm_logits(params, h_k[:, None])[:, 0]
        lg_p = plain.lm_logits(params, h_p[:, None])[:, 0]
        lerr = (lg_k - lg_p).abs().max().item()
    log(f"[slice] first-step logits, kernel vs plain: max abs err "
        f"{lerr:.3e} (tol {LOGIT_TOL}; logit std {lg_p.std().item():.3f})")
    if min(agree) < AGREEMENT_FLOOR or lerr > LOGIT_TOL:
        raise SystemExit("the kernel path disagrees with the plain path")
    phase_profile(model, params, ids_t, card)
    phase_weight_int8(model, params, ids, outs[0], card)
    return launches


def phase_weight_int8(model, params, ids: np.ndarray, float_out: np.ndarray,
                      card: str) -> None:
    """The monolithic path with int8 decode weights: an export with
    ``weight_quant="int8"`` served over HTTP (batch 8, prompt 512, 128 new
    tokens) with its launch counts, its first tokens against the float
    export's (the prefill runs on the float weights, so they are equal)
    and its token agreement with them; then the decode step with int8
    weights beside the float step on the host clock, in turns (float,
    int8, int8, float)."""
    from distributed_tensorflow_example_tpu_torch.serving import \
        export_generator
    from distributed_tensorflow_example_tpu_torch.serving_http import \
        PredictServer
    c = model.cfg
    payload = {"inputs": {"input_ids": ids.tolist(),
                          "prompt_mask": np.ones_like(ids).tolist()}}
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "w8")
        export_generator(model, params, d, prompt_len=PROMPT_LEN,
                         max_new_tokens=MAX_NEW, batch_size=BATCH,
                         ragged=True, weight_quant="int8")
        with PredictServer(d, port=0) as srv:
            post(srv.port, srv.name, payload)                   # warm-up
            read_launches = _reset_launches()
            body, sec = post(srv.port, srv.name, payload)
            launches = read_launches()
    out = np.asarray(body["generations"])
    want = {"flash_attention_fwd": c.layers,
            "decode_attention": c.layers * (MAX_NEW - 1),
            "paged_decode_attention": 0, "paged_decode_attention_int8": 0,
            **NO_BACKWARD}
    agree = float((out == float_out).mean())
    log(f"[weight int8] greedy request: {sec * 1e3:.1f} ms, "
        f"{BATCH * MAX_NEW / sec:.1f} tokens/s, launches {launches} (want "
        f"{want}); token agreement with the float export {agree:.4f}; "
        f"first tokens equal: {bool((out[:, 0] == float_out[:, 0]).all())} "
        f"({card})")
    if launches != want or out.shape != (BATCH, MAX_NEW) \
            or not (out[:, 0] == float_out[:, 0]).all():
        raise SystemExit("the int8-weight export did not serve through the "
                         "kernels, or its first tokens differ from the "
                         "float export's")
    ids_t = torch.as_tensor(ids, device="cuda")

    def wall(n_new: int, wq) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(params, ids_t, n_new, weight_quant=wq)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    steps = {None: [], "int8": []}
    for wq in (None, "int8", "int8", None):
        one = min(wall(1, wq) for _ in range(2))
        steps[wq].append((wall(MAX_NEW, wq) - one) / (MAX_NEW - 1) * 1e3)
    log(f"[weight int8] decode ms/step, float {steps[None]} and int8 "
        f"weights {steps['int8']} (host clock, in turns; {card})")


# ---------------------------------------------------------------------------
# engine phase: the continuous-batching engine over HTTP, paged and slab
# ---------------------------------------------------------------------------

def _post_rows(srv, prompts: list, results: list, lat: list) -> float:
    """POST each prompt as its own concurrent ``:generate`` request;
    returns the wall time of the whole wave."""
    import threading

    errors = []

    def worker(i):
        try:
            body, sec = post(srv.port, srv.name, {"inputs": {
                "input_ids": [prompts[i].tolist()]}})
            results[i], lat[i] = body["generations"][0], sec
        except Exception as e:
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(r is None for r in results):
        raise SystemExit(f"engine requests failed: {errors}")
    return wall


def _reset_launches():
    """Set every kernel's launch count to 0; returns a function that reads
    them all ({kernel name: launches})."""
    from distributed_tensorflow_example_tpu_torch.ops.cuda import (
        decode_attention as da, flash_attention as fa,
        paged_decode_attention as pa)
    counters = (("flash_attention_fwd", fa.flash_attention_fwd, "launches"),
                ("flash_attention_bwd_dq", fa.flash_attention_bwd_dq,
                 "launches"),
                ("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv,
                 "launches"),
                ("flash_attention_bwd_fused", fa.flash_attention_bwd_fused,
                 "launches"),
                ("decode_attention", da.decode_attention, "launches"),
                ("paged_decode_attention", pa.paged_decode_attention,
                 "launches"),
                ("paged_decode_attention_int8", pa.paged_decode_attention,
                 "launches_int8"))
    for _, fn, attr in counters:
        setattr(fn, attr, 0)
    return lambda: {name: getattr(fn, attr) for name, fn, attr in counters}


def _engine_wave(srv, label: str, prompts: list, card: str) -> dict:
    """One wave of concurrent requests through ``srv``'s engine, with
    every kernel's launch count set to 0 just before it and read just
    after, and the engine's dispatch counters over the same window."""
    eng = srv.engine
    n = len(prompts)
    results, lat = [None] * n, [0.0] * n
    d0, p0 = eng.decode_steps, eng.prefills
    gc.collect()          # servers closed earlier free their tensors first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_launches = _reset_launches()
    wall = _post_rows(srv, prompts, results, lat)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps, prefills = eng.decode_steps - d0, eng.prefills - p0
    toks = sum(len(r) for r in results)
    log(f"[engine {label}] {n} concurrent requests: {prefills} prefills, "
        f"{steps} shared decode steps, launches {launches}; wave "
        f"{wall * 1e3:.1f} ms, {toks / wall:.1f} tokens/s, request latency "
        f"p50 {sorted(lat)[n // 2] * 1e3:.1f} ms max {max(lat) * 1e3:.1f} "
        f"ms, {wall / max(steps, 1) * 1e3:.2f} ms per shared step, peak "
        f"device memory {peak / 2**20:.1f} MiB ({card})")
    return {"results": results, "launches": launches, "steps": steps,
            "prefills": prefills, "wall": wall, "lat": lat, "peak": peak}


def phase_engine(card: str) -> dict:
    """GPT-small (bf16, flash prefill) exported stepwise twice, paged
    (16-slot blocks, B5) and slab (B4), and served by the
    continuous-batching engine over HTTP: 8 concurrent ragged greedy
    requests, then 2 shared-prefix requests on the paged server, then the
    same 8 on the slab server."""
    from distributed_tensorflow_example_tpu_torch.config import TrainConfig
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.serving import (
        export_generator, load_stepwise)
    from distributed_tensorflow_example_tpu_torch.serving_http import \
        PredictServer

    cfg = TrainConfig(model="gpt", dtype="bfloat16", attention_impl="flash")
    model = get_model("gpt", cfg)
    c = model.cfg
    params = model.init(0)
    bs, slots = PAGED_SHAPE["bs"], ENGINE_SLOTS
    per_row = -(-(PROMPT_LEN + MAX_NEW) // bs)
    num_blocks = 1 + 2 * slots * per_row     # 8 full rows + prefix room
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, c.vocab_size, (int(n),)).astype(np.int32)
               for n in rs.randint(PROMPT_LEN // 4, PROMPT_LEN + 1, slots)]
    prompts[0] = rs.randint(0, c.vocab_size, (PROMPT_LEN,)).astype(np.int32)
    prompts[1] = prompts[1][:PROMPT_LEN - 5]       # ends inside a block
    # shared prefix: prompt 0's first half (whole blocks) + a new suffix
    # (a partial hit), and an exact repeat of prompt 1 (an exact hit whose
    # first write copies its shared tail block)
    half = PROMPT_LEN // 2 // bs * bs
    prefix_reqs = [np.concatenate([prompts[0][:half], rs.randint(
        0, c.vocab_size, (PROMPT_LEN // 8,)).astype(np.int32)]), prompts[1]]
    warm = [rs.randint(0, c.vocab_size, (PROMPT_LEN,)).astype(np.int32)]
    with tempfile.TemporaryDirectory() as tmp:
        paged_dir = os.path.join(tmp, "paged")
        slab_dir = os.path.join(tmp, "slab")
        t0 = time.perf_counter()
        export_generator(model, params, paged_dir, prompt_len=PROMPT_LEN,
                         max_new_tokens=MAX_NEW, ragged=True, stepwise=True,
                         slots=slots, paged=True, block_size=bs,
                         num_blocks=num_blocks)
        export_generator(model, params, slab_dir, prompt_len=PROMPT_LEN,
                         max_new_tokens=MAX_NEW, ragged=True, stepwise=True,
                         slots=slots)
        log(f"[engine] two stepwise exports in "
            f"{time.perf_counter() - t0:.2f} s; paged pool {num_blocks} "
            f"blocks of {bs} slots "
            f"({2 * c.layers * num_blocks * bs * c.hidden * 2 / 1e9:.3f} GB"
            f" bf16), slab pool {slots} x {PROMPT_LEN + MAX_NEW} slots")
        with PredictServer(paged_dir, scheduler="on", port=0) as srv:
            _post_rows(srv, warm, [None], [0.0])                # warm-up
            paged = _engine_wave(srv, "paged", prompts, card)
            saved0, cow0 = srv.engine.prefill_tokens_saved, \
                srv.engine.cow_copies
            shared = _engine_wave(srv, "paged shared-prefix", prefix_reqs,
                                  card)
            stats = srv.engine.stats()
            saved = srv.engine.prefill_tokens_saved - saved0
            cows = srv.engine.cow_copies - cow0
            idle = phase_engine_profile(srv.engine, prompts[0], card)
        with PredictServer(slab_dir, scheduler="on", port=0) as srv:
            _post_rows(srv, warm, [None], [0.0])                # warm-up
            slab = _engine_wave(srv, "slab", prompts, card)
        del srv                       # the int8 waves' peak excludes it
        quant = phase_engine_int8(model, params, tmp, paged_dir, paged,
                                  prompts, prefix_reqs, warm, card)
        paged_sw = load_stepwise(paged_dir)
        slab_sw = load_stepwise(slab_dir)
        lerr = first_logits_err(paged_sw, slab_sw, prompts)
        del paged_sw, slab_sw
    log(f"[engine] /stats after the paged waves: prefills "
        f"{stats['prefills']}, decode_steps {stats['decode_steps']}, "
        f"steps_shared {stats['steps_shared']}, prefix_cache_hits "
        f"{stats['prefix_cache_hits']}, cow_copies {stats['cow_copies']}, "
        f"bytes_resident_peak {stats['bytes_resident_peak']}")
    want = {"paged": {"flash_attention_fwd": c.layers * paged["prefills"],
                      "decode_attention": 0,
                      "paged_decode_attention": c.layers * paged["steps"],
                      "paged_decode_attention_int8": 0, **NO_BACKWARD},
            "slab": {"flash_attention_fwd": c.layers * slab["prefills"],
                     "decode_attention": c.layers * slab["steps"],
                     "paged_decode_attention": 0,
                     "paged_decode_attention_int8": 0, **NO_BACKWARD}}
    for label, run in (("paged", paged), ("slab", slab)):
        if run["launches"] != want[label] or run["steps"] < MAX_NEW - 1:
            raise SystemExit(f"engine {label}: launches {run['launches']} "
                             f"over {run['steps']} shared steps, want "
                             f"{want[label]}")
    if shared["launches"]["paged_decode_attention"] \
            != c.layers * shared["steps"] or shared["prefills"] \
            or shared["launches"]["paged_decode_attention_int8"]:
        raise SystemExit(f"shared-prefix requests: {shared}")
    log(f"[engine] shared-prefix requests: 0 prefills, {saved} prefill "
        f"tokens saved, {cows} copy-on-write block copies")
    if saved <= 0 or cows < 1:
        raise SystemExit("the shared-prefix requests did not reuse cached "
                         "blocks with a copy-on-write")
    for out in paged["results"] + slab["results"] + shared["results"]:
        if len(out) != MAX_NEW or min(out) < 0 or max(out) >= c.vocab_size:
            raise SystemExit(f"bad engine generation {out[:8]}...")
    agree = _agreement(paged["results"], slab["results"])
    # the exact hit feeds its last prompt token through the decode step
    # (B5) where the cold request ran it in the prefill (B1): the same
    # bytes in the cache, other bf16 rounding for that one token
    hit = _agreement(shared["results"][1:], paged["results"][1:2])
    log(f"[engine] paged vs slab greedy token agreement {agree:.4f} (floor "
        f"{ENGINE_AGREEMENT_FLOOR}), exact prefix hit vs its cold request "
        f"{hit:.4f} (floor {PREFIX_HIT_AGREEMENT_FLOOR}); first-step logits "
        f"max abs err {lerr:.3e} (tol {ENGINE_LOGIT_TOL})")
    if agree < ENGINE_AGREEMENT_FLOOR or hit < PREFIX_HIT_AGREEMENT_FLOOR \
            or lerr > ENGINE_LOGIT_TOL:
        raise SystemExit("the paged engine disagrees with the slab engine")
    return {"launches": paged["launches"]["paged_decode_attention"],
            "launches_int8": quant, "idle": idle}


def phase_engine_int8(model, params, tmp: str, float_dir: str,
                      float_wave: dict, prompts: list, prefix_reqs: list,
                      warm: list, card: str) -> int:
    """The quantized engine: GPT-small exported stepwise and paged with an
    int8 KV pool at the float paged pool's byte budget (``pool_bytes``),
    then with int8 weights as well, each served by the engine over HTTP:
    the 8 concurrent requests of the float wave, then (int8 KV) the 2
    shared-prefix requests and a profile of one request. Every shared
    decode step must attend through B6 (12 launches a step, B5 none); the
    first tokens equal the float wave's (the prefill attends in float
    before the int8 write); greedy agreement with the float wave holds
    the reference's drift gate. Last, the float wave again, so that the
    per-step times come in turns (float, int8, int8 + weights, float).
    Returns B6's launches in the int8 wave."""
    from distributed_tensorflow_example_tpu_torch.serving import (
        export_generator, load_stepwise)
    from distributed_tensorflow_example_tpu_torch.serving_http import \
        PredictServer
    c = model.cfg
    with open(os.path.join(float_dir, "export.json")) as f:
        fm = json.load(f)["stepwise"]
    budget = fm["num_blocks"] * fm["block_bytes"]     # the float K/V bytes
    dirs = {}
    for name, kw in (("int8", {}), ("int8_w8", dict(weight_quant="int8"))):
        dirs[name] = os.path.join(tmp, name)
        export_generator(model, params, dirs[name], prompt_len=PROMPT_LEN,
                         max_new_tokens=MAX_NEW, ragged=True, stepwise=True,
                         slots=ENGINE_SLOTS, paged=True,
                         block_size=fm["block_size"], pool_bytes=budget,
                         kv_cache_dtype="int8", **kw)
    with open(os.path.join(dirs["int8"], "export.json")) as f:
        qm = json.load(f)["stepwise"]
    usable = (fm["num_blocks"] - 1, qm["num_blocks"] - 1)
    log(f"[engine int8] pool_bytes {budget} (the float paged pool's K/V "
        f"bytes): usable blocks bf16 {usable[0]}, int8 {usable[1]} (at "
        f"least {2 * usable[0] - 1} wanted); block_bytes bf16 "
        f"{fm['block_bytes']}, int8 {qm['block_bytes']} with its scale rows")
    if usable[1] < 2 * usable[0] - 1:
        raise SystemExit("the int8 export does not hold twice the blocks")
    with PredictServer(dirs["int8"], scheduler="on", port=0) as srv:
        _post_rows(srv, warm, [None], [0.0])                    # warm-up
        wave = _engine_wave(srv, "paged int8", prompts, card)
        saved0, cow0 = srv.engine.prefill_tokens_saved, srv.engine.cow_copies
        shared = _engine_wave(srv, "paged int8 shared-prefix", prefix_reqs,
                              card)
        stats = srv.engine.stats()
        saved = srv.engine.prefill_tokens_saved - saved0
        cows = srv.engine.cow_copies - cow0
        phase_engine_profile(srv.engine, prompts[0], card,
                             label="engine int8 profile")
    with PredictServer(dirs["int8_w8"], scheduler="on", port=0) as srv:
        _post_rows(srv, warm, [None], [0.0])                    # warm-up
        w8 = _engine_wave(srv, "paged int8 + int8 weights", prompts, card)
    with PredictServer(float_dir, scheduler="on", port=0) as srv:
        _post_rows(srv, warm, [None], [0.0])                    # warm-up
        again = _engine_wave(srv, "paged again", prompts, card)
    # after the waves, so that their peak memory holds no other model
    float_sw = load_stepwise(float_dir)
    lerr_q, std = step_logits_err(float_sw, load_stepwise(dirs["int8"]),
                                  prompts)
    lerr_w, _ = step_logits_err(float_sw, load_stepwise(dirs["int8_w8"]),
                                prompts)
    del float_sw
    log(f"[engine int8] first decode step's logits against the float "
        f"engine's, max abs err: int8 KV {lerr_q:.3e}, int8 KV + int8 "
        f"weights {lerr_w:.3e} (logit std {std:.3f})")
    log(f"[engine int8] /stats: kv_cache_dtype {stats['kv_cache_dtype']}, "
        f"prefills {stats['prefills']}, decode_steps "
        f"{stats['decode_steps']}, prefix_cache_hits "
        f"{stats['prefix_cache_hits']}, cow_copies {stats['cow_copies']}, "
        f"bytes_resident_peak {stats['bytes_resident_peak']}; shared-prefix "
        f"requests: {saved} prefill tokens saved, {cows} copy-on-write "
        f"block copies")
    ms = {label: run["wall"] / max(run["steps"], 1) * 1e3
          for label, run in (("float", float_wave), ("int8 KV", wave),
                             ("int8 KV + weights", w8),
                             ("float again", again))}
    log(f"[engine int8] ms per shared step, same call, in this order: "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
        + f"; the float wave's tokens again: "
        f"{again['results'] == float_wave['results']} ({card})")
    agree = {label: _agreement(run["results"], float_wave["results"])
             for label, run in (("int8 KV", wave), ("int8 KV + weights", w8))}
    first = {label: [r[0] for r in run["results"]]
             == [r[0] for r in float_wave["results"]]
             for label, run in (("int8 KV", wave), ("int8 KV + weights", w8))}
    hit = _agreement(shared["results"][1:], wave["results"][1:2])
    log(f"[engine int8] greedy token agreement with the float engine: "
        + ", ".join(f"{k} {v:.4f}" for k, v in agree.items())
        + f" (floor {INT8_MIN_AGREEMENT} on int8 KV); first tokens equal: "
        f"{first}; exact prefix hit vs its cold int8 request {hit:.4f}")
    failed = []
    for label, run in (("int8", wave), ("int8 + weights", w8),
                       ("float again", again)):
        b5, b6 = (0, run["steps"]) if run is not again else (run["steps"], 0)
        want = {"flash_attention_fwd": c.layers * run["prefills"],
                "decode_attention": 0,
                "paged_decode_attention": c.layers * b5,
                "paged_decode_attention_int8": c.layers * b6,
                **NO_BACKWARD}
        if run["launches"] != want or run["steps"] < MAX_NEW - 1:
            failed.append(f"{label}: launches {run['launches']}, want {want}")
    if shared["prefills"] or shared["launches"][
            "paged_decode_attention_int8"] != c.layers * shared["steps"] \
            or shared["launches"]["paged_decode_attention"]:
        failed.append(f"shared-prefix: {shared['prefills']} prefills, "
                      f"launches {shared['launches']}")
    if saved <= 0 or cows < 1:
        failed.append("no prefix reuse with a copy-on-write")
    if stats["kv_cache_dtype"] != "int8":
        failed.append(f"/stats kv_cache_dtype {stats['kv_cache_dtype']}")
    for run in (wave, shared, w8):
        for out in run["results"]:
            if len(out) != MAX_NEW or min(out) < 0 \
                    or max(out) >= c.vocab_size:
                failed.append(f"bad generation {out[:8]}...")
    if not all(first.values()):
        failed.append(f"first tokens differ from the float engine: {first}")
    if agree["int8 KV"] < INT8_MIN_AGREEMENT:
        failed.append(f"int8 KV agreement {agree['int8 KV']:.4f}")
    if failed:
        raise SystemExit("the int8 engine failed: " + "; ".join(failed))
    return wave["launches"]["paged_decode_attention_int8"]


def step_logits_err(float_sw, quant_sw, prompts: list) -> tuple[float, float]:
    """Max abs difference of the first decode step's logits (the step after
    the prefill, which reads the cache), float paged program vs a quantized
    one, over ``prompts``; and the float logits' std."""
    worst, std = 0.0, 0.0
    pools = (float_sw.make_pool(), quant_sw.make_pool())
    m = float_sw.step_meta
    nb, slots = m["blocks_per_slot"], m["slots"]
    tables = np.zeros((slots, nb), np.int32)
    tables[0] = np.arange(1, nb + 1)
    alive = np.zeros(slots, np.int32)
    alive[0] = 1
    for p in prompts:
        ids = np.zeros((1, PROMPT_LEN), np.int32)
        mask = np.zeros((1, PROMPT_LEN), np.int32)
        ids[0, :p.size], mask[0, :p.size] = p, 1
        logits = []
        for sw, pool in zip((float_sw, quant_sw), pools):
            first = sw.prefill({"input_ids": ids, "prompt_mask": mask,
                                "table_row": tables[0, :m["prompt_blocks"]],
                                **pool})["logits"]
            tok = np.zeros(slots, np.int32)
            tok[0] = int(np.argmax(first[0]))
            pos = np.zeros(slots, np.int32)
            pos[0] = p.size
            logits.append(sw.decode({
                "tok": tok, "pos": pos, "pad": np.zeros(slots, np.int32),
                "alive": alive, "block_tables": tables, **pool})["logits"][0])
        worst = max(worst, float(np.abs(logits[0] - logits[1]).max()))
        std = max(std, float(logits[0].std()))
    return worst, std


def _agreement(a: list, b: list) -> float:
    return float(np.mean([x == y for ra, rb in zip(a, b)
                          for x, y in zip(ra, rb)]))


def first_logits_err(paged_sw, slab_sw, prompts: list) -> float:
    """Max abs difference of the first-step logits of each prompt, paged
    prefill (left-aligned, whole blocks) vs slab prefill (right-packed)."""
    worst = 0.0
    paged_pool, slab_pool = paged_sw.make_pool(), slab_sw.make_pool()
    nb = paged_sw.step_meta["prompt_blocks"]
    for i, p in enumerate(prompts):
        ids = np.zeros((1, PROMPT_LEN), np.int32)
        mask = np.zeros((1, PROMPT_LEN), np.int32)
        ids[0, :p.size], mask[0, :p.size] = p, 1
        a = paged_sw.prefill({"input_ids": ids, "prompt_mask": mask,
                              "table_row": np.arange(1, nb + 1,
                                                     dtype=np.int32),
                              **paged_pool})["logits"]
        b = slab_sw.prefill({"input_ids": ids, "prompt_mask": mask,
                             "slot": np.int32(i), **slab_pool})["logits"]
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def phase_engine_profile(eng, prompt, card: str,
                         label: str = "engine profile") -> float:
    """One engine request alone (prompt, 128 new tokens): host-clock
    latency, then the device's busy time and idle share under
    ``torch.profiler`` over a second identical request."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fresh = prompt.copy()
    fresh[0] = (fresh[0] + 1) % 1000          # a cold prompt, no cache hit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(fresh, timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fresh[0] = (fresh[0] + 1) % 1000
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(fresh, timeout=600)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    log(f"[{label}] one request ({prompt.size} prompt tokens, "
        f"{MAX_NEW} new): {wall * 1e3:.1f} ms, {MAX_NEW / wall:.1f} "
        f"tokens/s ({card})")
    if not kernels:
        log(f"[{label}] the profiler saw no device time: idle share "
            "not measured")
        return float("nan")
    idle = 1 - busy / (wall * 1e3)
    log(f"[{label}] traced request {traced * 1e3:.1f} ms, device "
        f"busy {busy:.1f} ms: idle share {1 - busy / (traced * 1e3):.3f} "
        f"of the traced request, {idle:.3f} of the untraced one")
    for e in sorted(kernels, key=_device_us, reverse=True)[:6]:
        log(f"[{label}]   {_device_us(e) / 1e3:8.2f} ms  "
            f"{e.count:6d}x  {e.key[:90]}")
    return idle


# ---------------------------------------------------------------------------
# MNIST phase: the reference's own example, one worker on the card
# ---------------------------------------------------------------------------

# the reference example's defaults: hidden 100, global batch 256, lr 0.5
MNIST_STEPS, MNIST_BATCH = 1000, 256
# the reference's own bar (tests/test_example_script.py)
MNIST_MIN_ACCURACY = 0.95
# 20 SGD steps at lr 0.5 on the card against the same steps on the CPU,
# same init and batches: f32 on both (no TF32), so the two differ in
# summation order only, which SGD carries from step to step. The CPU
# port holds the reference to 1.5e-6 over 20 such steps; the limit is
# ~60x that
MNIST_CARD_CPU_LOSS_RTOL = 1e-4


def _mnist_parts(device: str):
    """The example's pieces: the MLP, SGD at lr 0.5 under the sync step,
    the seed-0 state, and its loader over synthetic MNIST."""
    from distributed_tensorflow_example_tpu_torch.config import \
        OptimizerConfig
    from distributed_tensorflow_example_tpu_torch.data.loader import \
        make_loader
    from distributed_tensorflow_example_tpu_torch.data.mnist import \
        get_mnist
    from distributed_tensorflow_example_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas \
        import SyncReplicas
    from distributed_tensorflow_example_tpu_torch.train.optimizers import \
        make_optimizer
    model = MLP(hidden=100)
    sync = SyncReplicas(model.loss, make_optimizer(OptimizerConfig(
        name="sgd", learning_rate=0.5)), device=device)
    data = get_mnist(None, synthetic=True)
    batches = make_loader({"x": data["train_x"], "y": data["train_y"]},
                          MNIST_BATCH, shuffle=True, seed=0)
    return model, sync, sync.init(model.init, seed=0), batches


def _run_example(argv: list[str]) -> tuple[int, str]:
    """The port's example in this process, its stdout kept and echoed."""
    import contextlib
    import io
    from distributed_tensorflow_example_tpu_torch.examples import \
        mnist_distributed
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mnist_distributed.main(argv)
    for line in buf.getvalue().splitlines():
        log(f"[mnist example]   {line}")
    return rc, buf.getvalue()


def phase_mnist(card: str) -> dict:
    """The source's own workload: the port's copy of
    ``examples/mnist_distributed.py`` as one worker on the card at the
    reference's defaults (hidden 100, global batch 256, lr 0.5, 1000
    steps, synthetic MNIST) with a checkpoint, then a resume to 1100;
    ``cli.train --model mlp`` for 600 steps with a ring of 2 checkpoints
    every 200 and a resume to 1000. No hand-written kernel runs on this
    path (two ``torch.matmul`` layers, as the reference's two
    ``nn.dense``): every launch count must stay 0. Checks the loss
    curve, the final test accuracy (>= 0.95, the reference's bar), the
    resume lines and the ring; holds 20 card steps to 20 CPU steps; and
    measures examples/s and ms per step (host clock over steps 101-1000,
    one sync at each end), peak device memory and the device idle share
    of one step."""
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    failed = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mnist_")
    ck = os.path.join(tmp, "example")
    read = _reset_launches()

    # the example, at its defaults, then a resume
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc, out = _run_example(["--device", "cuda", "--ckpt_dir", ck])
    wall = time.perf_counter() - t0
    peak_example = torch.cuda.max_memory_allocated()
    curve = [(int(a), float(b)) for a, b in
             re.findall(r"^step (\d+): loss=([\d.]+) ", out, re.M)]
    acc = re.search(r"final test accuracy: ([\d.]+)", out)
    acc = float(acc.group(1)) if acc else float("nan")
    log(f"[mnist example] rc {rc}, 1000 steps in {wall:.1f} s (process "
        f"start to final eval), loss curve "
        + " ".join(f"{s}:{x:.4f}" for s, x in curve)
        + f", final test accuracy {acc:.4f}, peak device memory "
        f"{peak_example / 2**20:.1f} MiB ({card})")
    if rc != 0 or [s for s, _ in curve] != list(range(100, 1001, 100)):
        failed.append(f"example rc {rc}, logged steps {curve}")
    elif not all(np.isfinite(x) for _, x in curve) \
            or curve[-1][1] >= curve[0][1]:
        failed.append(f"example loss curve {curve}")
    if not acc >= MNIST_MIN_ACCURACY:
        failed.append(f"example accuracy {acc}")
    rc2, out2 = _run_example(["--device", "cuda", "--ckpt_dir", ck,
                              "--train_steps", "1100"])
    acc2 = re.search(r"final test accuracy: ([\d.]+)", out2)
    if rc2 != 0 or "restored checkpoint at step 1000" not in out2 \
            or "step 1100: loss=" not in out2 or not acc2 \
            or float(acc2.group(1)) < MNIST_MIN_ACCURACY:
        failed.append("the example did not resume at step 1000 to 1100")

    # the CLI with a ring, then a resume
    tap = _LogTap()
    logging.getLogger("dtx.trainer").addHandler(tap)
    ring_dir = os.path.join(tmp, "cli")
    metrics = os.path.join(tmp, "metrics.jsonl")
    base = ["--model", "mlp", "--device", "cuda", "--batch_size",
            str(MNIST_BATCH), "--learning_rate", "0.5", "--ckpt_dir",
            ring_dir, "--save_steps", "200", "--max_to_keep", "2",
            "--log_every_steps", "100", "--metrics_path", metrics]
    rc3 = cli.main(base + ["--train_steps", "600", "--eval_every_steps",
                           "600"])
    ring1 = _ring(ring_dir)
    rc4 = cli.main(base + ["--train_steps", "1000", "--eval_every_steps",
                           "1000"])
    ring2 = _ring(ring_dir)
    logging.getLogger("dtx.trainer").removeHandler(tap)
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    evals = {r["step"]: r["eval"] for r in recs if "eval" in r}
    rates = [r["examples_per_sec"] for r in recs if "examples_per_sec" in r]
    log(f"[mnist cli] rc {rc3}, {rc4}; ring after 600 {ring1}, after 1000 "
        f"{ring2} (verified); eval {evals}; examples/s at the log cadence "
        + ", ".join(f"{x:.0f}" for x in rates) + f" ({card})")
    if (rc3, rc4) != (0, 0) or ring1 != [400, 600] or ring2 != [800, 1000]:
        failed.append(f"CLI rc {rc3}, {rc4}, rings {ring1}, {ring2}")
    if not any("restored checkpoint at step 600" in x for x in tap.lines):
        failed.append("the CLI did not resume at step 600")
    if evals.get(1000, {}).get("accuracy", 0.0) < MNIST_MIN_ACCURACY:
        failed.append(f"CLI eval {evals}")
    launches = read()
    if any(launches.values()):
        failed.append(f"a kernel launched on the MNIST path: {launches}")

    # 20 steps on the card against the same 20 on the CPU
    model, sync, state, batches = _mnist_parts("cuda")
    _, csync, cstate, _ = _mnist_parts("cpu")
    cstate = cstate.replace(params={k: {n: t.cpu() for n, t in v.items()}
                                    for k, v in state.params.items()})
    rel = 0.0
    for _ in range(20):
        b = next(batches)
        state, m = sync.step(state, b)
        cstate, cm = csync.step(cstate, b)
        rel = max(rel, abs(float(m["loss"]) - float(cm["loss"]))
                  / float(cm["loss"]))
    log(f"[mnist] 20 SGD steps, card against CPU: worst loss relative "
        f"difference {rel:.3e} (tol {MNIST_CARD_CPU_LOSS_RTOL})")
    if not rel <= MNIST_CARD_CPU_LOSS_RTOL:
        failed.append(f"card vs CPU loss differs by {rel:.3e}")

    # examples/s and ms per step: the example's loop, steps 101-1000
    model, sync, state, batches = _mnist_parts("cuda")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(100):
        state, m = sync.step(state, next(batches))
    torch.cuda.synchronize()
    t_data = 0.0
    t0 = time.perf_counter()
    for _ in range(MNIST_STEPS - 100):
        t_d = time.perf_counter()
        b = next(batches)
        t_data += time.perf_counter() - t_d
        state, m = sync.step(state, b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = MNIST_STEPS - 100
    ms = secs / n * 1e3
    eps = MNIST_BATCH * n / secs
    log(f"[mnist] example loop, steps 101-1000: {ms:.4f} ms per step "
        f"({t_data / n * 1e3:.4f} of it in the loader's next(), the rest "
        f"in SyncReplicas.step), {eps:.1f} examples/s, peak device memory "
        f"{peak / 2**20:.1f} MiB, final loss {float(m['loss']):.5f} "
        f"({card})")

    # the device idle share of one step
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    b = next(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = sync.step(state, b)
    torch.cuda.synchronize()
    step_wall = time.perf_counter() - t0
    b = next(batches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = sync.step(state, b)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    idle = float("nan")
    if kernels:
        busy = sum(_device_us(e) for e in kernels) / 1e3
        idle = 1 - busy / (traced * 1e3)
        log(f"[mnist profile] one step {step_wall * 1e3:.3f} ms; traced "
            f"step {traced * 1e3:.3f} ms, device busy {busy:.4f} ms in "
            f"{sum(e.count for e in kernels)} kernel launches: idle share "
            f"{idle:.3f} of the traced step, "
            f"{1 - busy / (step_wall * 1e3):.3f} of the untraced one "
            f"({card})")
        for e in sorted(kernels, key=_device_us, reverse=True)[:6]:
            log(f"[mnist profile]   {_device_us(e) / 1e3:8.4f} ms  "
                f"{e.count:4d}x  {e.key[:90]}")
        host = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CPU]
        for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:8]:
            log(f"[mnist profile]   host {e.self_cpu_time_total / 1e3:8.4f}"
                f" ms self  {e.count:4d}x  {e.key[:70]}")
    else:
        log("[mnist profile] the profiler saw no device time: idle share "
            "not measured")
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise SystemExit("the MNIST phase failed: " + "; ".join(failed))
    return {"ms_per_step": ms, "examples_per_sec": eps, "idle": idle,
            "accuracy": acc, "peak_mib": peak / 2**20}


# ---------------------------------------------------------------------------
# conv phase: LeNet, ResNet-20 and ResNet-50 through the port's CLI
# ---------------------------------------------------------------------------

# BASELINE.json config 4 at the registered preset: [3, 4, 6, 3]
# bottlenecks, 224x224x3, 1000 classes, bf16 compute, f32 statistics
R50_ARGV = ["--model", "resnet50", "--device", "cuda", "--dtype",
            "bfloat16", "--batch_size", "128", "--optimizer", "momentum",
            "--learning_rate", "0.05", "--warmup_steps", "5",
            "--label_smoothing", "0.1", "--seed", "0"]
R50_BATCH = 128
# config 3: f32 on the card (TF32 off), the CIFAR augmentation on
# the CIFAR recipe's piecewise drop (lr x 0.1 after step 300), because
# the eval at a constant lr is noise: at 0.05 the same argv read 0.957
# after 300 steps in one card run and 0.6641 in the next
R20_ARGV = ["--model", "resnet20", "--device", "cuda", "--augment",
            "--batch_size", "128", "--optimizer", "momentum",
            "--learning_rate", "0.05", "--decay_schedule", "piecewise",
            "--decay_boundaries", "300", "--decay_factor", "0.1",
            "--seed", "0"]
R20_STEPS, R20_MIN_ACCURACY = 400, 0.9
# 20 f32 momentum steps (lr 0.01, batch 32) of ResNet-20 on the card
# against the same steps on the CPU from one checkpoint. Step 1 starts
# from the same weights: only the summation order differs (cuDNN against
# the CPU's), ~1e-7 of the loss, where TF32 would put ~1e-3 into every
# conv. From there batch norm and momentum amplify the rounding: on the
# CPU alone the f32 run of these 20 steps drifts from the f64 one by up
# to 2.3e-3 of the loss (steps 19-20), so the later steps are held to
# 1e-2
R20_CARD_CPU_STEP1_RTOL = 1e-5
R20_CARD_CPU_LOSS_RTOL = 1e-2
LENET_ARGV = ["--model", "lenet", "--device", "cuda", "--batch_size",
              "128", "--optimizer", "momentum", "--learning_rate", "0.05",
              "--seed", "0"]
LENET_STEPS = 200


class _Window:
    """A Trainer hook that times steps ``a + 1 .. b`` on the host clock,
    with a device sync after step ``a`` and after step ``b``."""

    every_steps = 0

    def __init__(self, a: int, b: int):
        self.a, self.b = a, b
        self.t0 = self.wall = 0.0

    def begin(self, trainer):
        pass

    def wants_metrics(self, step):
        return False

    def after_step(self, trainer, step, metrics):
        if step in (self.a, self.b):
            torch.cuda.synchronize()
            if step == self.a:
                self.t0 = time.perf_counter()
            else:
                self.wall = time.perf_counter() - self.t0

    def end(self, trainer):
        pass


def _train_flops(model, hw: int) -> float:
    """Training FLOPs an image: 3 x the forward's multiply-adds x 2 of
    every conv and dense call of one forward, from the shapes the code
    gives them (the stem's input gradient included)."""
    from distributed_tensorflow_example_tpu_torch.ops import nn
    total = [0.0]
    conv, dense = nn.conv2d, nn.dense

    def conv_rec(params, x, **kw):
        y = conv(params, x, **kw)
        kh, kw_, cin, cout = params["kernel"].shape
        total[0] += 2.0 * y.shape[1] * y.shape[2] * kh * kw_ * cin * cout
        return y

    def dense_rec(params, x, **kw):
        total[0] += 2.0 * params["kernel"].numel() * (x.numel()
                                                      // x.shape[-1])
        return dense(params, x, **kw)

    params, extras = model.init(0)
    nn.conv2d, nn.dense = conv_rec, dense_rec
    try:
        with torch.no_grad():
            model.apply(params, extras, {"x": torch.zeros(
                1, hw, hw, 3, device="cuda")})
    finally:
        nn.conv2d, nn.dense = conv, dense
    return 3 * total[0]


def _cli_run(argv: list[str], label: str, failed: list, card: str, *,
             tag: str = "conv", want: dict | None = None):
    """``cli.main(argv)`` with every kernel's count set to 0 before and
    read after: each must equal ``want``, or with no ``want`` none may
    launch (no hand-written kernel is on the conv path); returns (rc,
    the trainer's and hooks' log lines, the metrics records, peak device
    memory in MiB)."""
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    tap = _LogTap()
    for name in ("dtx.hooks", "dtx.trainer", "dtx.cli"):
        logging.getLogger(name).addHandler(tap)
    metrics = argv[argv.index("--metrics_path") + 1]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    read = _reset_launches()
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:
        for name in ("dtx.hooks", "dtx.trainer", "dtx.cli"):
            logging.getLogger(name).removeHandler(tap)
    wall = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated() / 2**20
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    log(f"[{tag} {label}] rc {rc} in {wall:.1f} s, peak device memory "
        f"{peak:.1f} MiB" + (f", launches {launches}" if want else "")
        + f" ({card})")
    if rc != 0:
        failed.append(f"{label}: main returned {rc}")
    if want is None and any(launches.values()):
        failed.append(f"{label}: a kernel launched: {launches}")
    if want is not None and launches != want:
        failed.append(f"{label}: launches {launches}, want {want}")
    return rc, list(tap.lines), recs, peak


def _final_eval(lines: list[str]) -> dict:
    """The CLI's ``final eval: {...}`` line as a dict."""
    import ast
    for line in lines:
        if line.startswith("final eval: "):
            return ast.literal_eval(line[len("final eval: "):])
    return {}


def _rates(recs: list[dict]) -> list[float]:
    return [r["examples_per_sec"] for r in recs if "examples_per_sec" in r]


def phase_conv(card: str) -> dict:
    """The convolutional configs of ``BASELINE.json`` through the port's
    CLI on the card, no hand-written kernel on their path (every launch
    count must stay 0): ResNet-50 (config 4, full width: bf16 compute,
    f32 batch statistics, batch 128 of synthetic ImageNet, momentum) for
    30 steps with a ring of 2 checkpoints and a resume to 40, the final
    eval with top-5; its examples/s and ms per step over steps 11-30 of
    a ``Trainer`` run (host clock, one sync at each end), peak device
    memory, the device idle share and launches of one traced step and
    the step's share of the bf16 peak from the FLOPs of its conv and
    dense shapes. ResNet-20 (config 3, f32 with TF32 off, ``--augment``)
    with a ring and a resume to an eval accuracy of 0.9, and 20 f32
    steps on the card against 20 on the CPU from one checkpoint. LeNet
    (config 2) on synthetic MNIST to the reference's 0.95."""
    from torch.autograd import DeviceType
    from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import (
        CheckpointManager)
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    from distributed_tensorflow_example_tpu_torch.config import (
        OptimizerConfig)
    from distributed_tensorflow_example_tpu_torch.data.cifar import \
        synthetic_cifar10
    from distributed_tensorflow_example_tpu_torch.data.loader import \
        make_loader
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas \
        import SyncReplicas
    from distributed_tensorflow_example_tpu_torch.train.optimizers import \
        make_optimizer
    from distributed_tensorflow_example_tpu_torch.train.trainer import \
        Trainer
    failed: list[str] = []
    out: dict = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_conv_")

    # ResNet-50 through the CLI: 30 steps, a ring of 2, a resume to 40
    ck, m = os.path.join(tmp, "r50"), os.path.join(tmp, "r50.jsonl")
    base = R50_ARGV + ["--ckpt_dir", ck, "--save_steps", "10",
                       "--max_to_keep", "2", "--metrics_path", m]
    _, lines, _, peak1 = _cli_run(base + ["--train_steps", "30",
                                          "--log_every_steps", "5"],
                                  "resnet50 steps 1-30", failed, card)
    curve = _step_metrics(lines)
    ring1 = _ring(ck)
    _, lines2, _, _ = _cli_run(base + ["--train_steps", "40",
                                       "--log_every_steps", "10"],
                               "resnet50 resume to 40", failed, card)
    ring2 = _ring(ck)
    ev = _final_eval(lines2)
    losses = [curve[s]["loss"] for s in sorted(curve)]
    log("[conv resnet50] loss at steps " + " ".join(
        f"{s}:{curve[s]['loss']:.4f}" for s in sorted(curve))
        + f"; ring after 30 {ring1}, after 40 {ring2} (verified); final "
        f"eval {ev} ({card})")
    if sorted(curve) != list(range(5, 31, 5)) \
            or not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        failed.append(f"resnet50 loss curve {curve}")
    if ring1 != [20, 30] or ring2 != [30, 40] or not any(
            "restored checkpoint at step 30" in x for x in lines2):
        failed.append(f"resnet50 ring {ring1} then {ring2}, or no resume")
    if "top5_accuracy" not in ev or not np.isfinite(ev["loss"]):
        failed.append(f"resnet50 final eval {ev}")

    # ResNet-50 speed: a Trainer of the same argv, steps 11-30 timed, step
    # 32 traced
    args = cli.build_parser().parse_args(
        R50_ARGV + ["--train_steps", "32", "--log_every_steps", "100"])
    cfg = cli.config_from_args(args)
    model = get_model(cfg.model, cfg)
    train, _ = cli.load_dataset(cfg, model)
    flops = _train_flops(model, 224)
    window, prof = _Window(10, 30), _ProfileStep(31)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with Trainer(model, cfg, train, None, hooks=[window, prof]) as tr:
        tr.train()
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = window.wall / 20 * 1e3
    eps = R50_BATCH * 20 / window.wall
    bound_ms = flops * R50_BATCH / PEAK_BF16_FLOPS * 1e3
    kernels = [e for e in prof.prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    idle = 1 - busy / (prof.wall * 1e3) if kernels else float("nan")
    log(f"[conv resnet50] steps 11-30: {ms:.2f} ms per step, {eps:.1f} "
        f"examples/s; peak device memory {peak:.1f} MiB (CLI run "
        f"{peak1:.1f}); training FLOPs {flops / 1e9:.3f} GFLOP an image, "
        f"{flops * R50_BATCH / 1e12:.3f} TFLOP a step, {bound_ms:.3f} ms "
        f"at the bf16 peak: {bound_ms / ms:.4f} of it ({card})")
    if kernels:
        log(f"[conv resnet50 profile] one Trainer step (32) traced: "
            f"{prof.wall * 1e3:.1f} ms, device busy {busy:.2f} ms in "
            f"{n_launch} kernel launches: idle share {idle:.3f} ({card})")
        for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
            log(f"[conv resnet50 profile]   {_device_us(e) / 1e3:8.3f} ms "
                f" {e.count:5d}x  {e.key[:90]}")
        host = [e for e in prof.prof.key_averages()
                if e.device_type == DeviceType.CPU]
        for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:8]:
            log(f"[conv resnet50 profile]   host "
                f"{e.self_cpu_time_total / 1e3:8.3f} ms self  "
                f"{e.count:5d}x  {e.key[:70]}")
    else:
        log("[conv resnet50 profile] the profiler saw no device time: "
            "idle share not measured")
    out.update(r50_ms=ms, r50_eps=eps, r50_peak_mib=peak, r50_idle=idle,
               r50_peak_share=bound_ms / ms, r50_launches=n_launch)
    del model, train, tr
    gc.collect()

    # ResNet-20 through the CLI: a ring, a resume to the eval bar
    ck, m = os.path.join(tmp, "r20"), os.path.join(tmp, "r20.jsonl")
    base = R20_ARGV + ["--ckpt_dir", ck, "--save_steps", "150",
                       "--max_to_keep", "2", "--log_every_steps", "50",
                       "--metrics_path", m]
    _cli_run(base + ["--train_steps", "300"], "resnet20 steps 1-300",
             failed, card)
    ring1 = _ring(ck)
    _, lines, recs, _ = _cli_run(base + ["--train_steps", str(R20_STEPS)],
                                 f"resnet20 resume to {R20_STEPS}", failed,
                                 card)
    ev = _final_eval(lines)
    rates = _rates(recs)
    log(f"[conv resnet20] f32 (the port's f32 convs run without TF32); "
        f"ring after 300 {ring1}, after {R20_STEPS} {_ring(ck)}; "
        "examples/s at the log cadence " + ", ".join(f"{x:.0f}" for x in rates)
        + f"; final eval {ev} ({card})")
    if ring1 != [150, 300] or not any(
            "restored checkpoint at step 300" in x for x in lines):
        failed.append(f"resnet20 ring {ring1} or no resume")
    if not ev.get("accuracy", 0.0) >= R20_MIN_ACCURACY:
        failed.append(f"resnet20 eval {ev}")
    out.update(r20_eps=float(np.median(rates)) if rates else float("nan"),
               r20_accuracy=ev.get("accuracy", float("nan")))

    # 20 f32 steps on the card against 20 on the CPU, one checkpoint,
    # with cuDNN's TF32 flag left at its default (True): the port's f32
    # conv turns it off around itself
    if not torch.backends.cudnn.allow_tf32:
        failed.append("cuDNN's TF32 flag was changed before the card vs "
                      "CPU check")
    model = get_model("resnet20")
    d = synthetic_cifar10(640, 8)
    syncs = {dev: SyncReplicas(model.loss, make_optimizer(OptimizerConfig(
        name="momentum", learning_rate=0.01)), device=dev)
        for dev in ("cuda", "cpu")}
    state = syncs["cuda"].init(model.init, seed=0)
    bridge = CheckpointManager(os.path.join(tmp, "bridge"))
    bridge.save(state)
    cstate = bridge.restore(syncs["cpu"].init(model.init, seed=1))
    batches = make_loader({"x": d["train_x"], "y": d["train_y"]}, 32,
                          seed=0)
    rels = []
    for _ in range(20):
        b = next(batches)
        state, mt = syncs["cuda"].step(state, b)
        cstate, cm = syncs["cpu"].step(cstate, b)
        rels.append(abs(float(mt["loss"]) - float(cm["loss"]))
                    / float(cm["loss"]))
    rel = max(rels)
    log(f"[conv resnet20] 20 f32 momentum steps (batch 32), card (cuDNN, "
        f"f32 convs without TF32) against CPU from one checkpoint: loss "
        f"relative difference a step " + " ".join(f"{r:.1e}" for r in rels)
        + f" (tol {R20_CARD_CPU_STEP1_RTOL} at step 1, "
        f"{R20_CARD_CPU_LOSS_RTOL} after)")
    if not (rels[0] <= R20_CARD_CPU_STEP1_RTOL
            and rel <= R20_CARD_CPU_LOSS_RTOL):
        failed.append(f"resnet20 card vs CPU losses differ by {rels}")
    out.update(r20_card_cpu=rel)

    # LeNet on synthetic MNIST to the reference's bar
    m = os.path.join(tmp, "lenet.jsonl")
    _, lines, recs, _ = _cli_run(
        LENET_ARGV + ["--train_steps", str(LENET_STEPS), "--log_every_steps",
                      "50", "--metrics_path", m], "lenet", failed, card)
    ev = _final_eval(lines)
    rates = _rates(recs)
    log(f"[conv lenet] examples/s at the log cadence "
        + ", ".join(f"{x:.0f}" for x in rates) + f"; final eval {ev} "
        f"({card})")
    if not ev.get("accuracy", 0.0) >= MNIST_MIN_ACCURACY:
        failed.append(f"lenet eval {ev}")
    out.update(lenet_eps=float(np.median(rates)) if rates else float("nan"),
               lenet_accuracy=ev.get("accuracy", float("nan")))
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise SystemExit("the conv phase failed: " + "; ".join(failed))
    return out


# ---------------------------------------------------------------------------
# BERT phase: BASELINE.json config 5 through cli/train.py, non-causal flash
# ---------------------------------------------------------------------------

# config 5 at the registered preset (12 layers, hidden 768, 12 heads, FFN
# 3072, vocab 30522, 20 predictions a sequence), bf16 compute, the flash
# kernels non-causal under the key-pad mask, LAMB
BERT_ARGV = ["--model", "bert", "--device", "cuda", "--dtype",
             "bfloat16", "--attention", "flash", "--optimizer",
             "lamb", "--learning_rate", "2e-3", "--warmup_steps", "5",
             "--weight_decay", "0.01", "--batch_size", "64", "--seq_len",
             "128", "--seed", "0"]
BERT_B, BERT_S, BERT_EVAL, BERT_LAYERS = 64, 128, 256, 12
BERT_VOCAB = 30522
BERT_LONG_B, BERT_LONG_S = 16, 512
BERT_LEVER_STEPS = 6
BERT_LARGE_B, BERT_LARGE_STEPS = 32, 5
# 20 f32 LAMB steps (lr 1e-3, batch 32, no dropout) of BERT-tiny on the
# card against the CPU from one checkpoint: the runs differ only in
# summation order (TF32 is off for f32 matmuls); four runs on the H100
# read at most 1.4e-7 of the loss over the 20 steps
TINY_CARD_CPU_LOSS_RTOL = 1e-5
# the padded BERT-base step (bf16) against the same model in f32: each
# leaf within TRAIN_GRAD_REL_TOL of its f32 gradient, save the
# attention's q and k leaves whose f32 gradient is under BERT_QK_SHARE of
# the global norm, which are held to BERT_QK_FLOOR of the global norm: at
# random init the deepest layers' post-LN token states nearly coincide,
# dp - D cancels in ds = p (dp - D), and a bf16 flash backward (D =
# rowsum(dO * O) from the bf16 O) keeps little of those leaves' gradient,
# as the reference's Pallas kernels do (probes/flash_bwd_precision.py).
# On the H100 (the same bits in every run) flash is off by 2e-5 to 5.2e-5
# of the global norm on every layer's q and k kernels, past 5e-2 of the
# leaf from layer 6 (7.1e-2, share 4.9e-4) to layer 11 (2.7x, share
# 1.9e-5); layer 5 (share 1.0e-3) reads 2.4e-2. The floor is twice the
# worst reading
BERT_QK_SHARE = 1e-3
BERT_QK_FLOOR = 1e-4
# GPT-small's LM head (8 x 512, bf16 operands, f32 logits): full,
# chunked and fused compute one function, their step-1 losses part only
# by the f32 summation order of the logits' GEMMs (cuBLAS splits a
# 30522-wide product otherwise than 2048-wide blocks), ~1e-6
GPT_HEAD_LOSS_RTOL = 1e-4


def bert_flash_case(gen) -> None:
    """B1, B2a and B2b at BERT-base's shape (B=64, S=128, H=12, D=64),
    NON-causal, key masks with TRAILING pads (BERT's layout) and one row
    all PAD, against their plain versions; B3 bitwise equal to B2a and
    B2b on the same inputs. A row with every key masked gives zero
    output and zero dq; a masked key gets zero dk and dv; a padded query
    still attends to its row's valid keys."""
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        flash_attention as fa
    dev = torch.device("cuda")
    b, s, h, d = BERT_B, BERT_S, 12, 64
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen).to(
        dev, torch.bfloat16) for _ in range(4))
    lens = torch.randint(s // 4, s + 1, (b,), generator=gen)
    lens[0], lens[-1] = s, 0
    mask = (torch.arange(s)[None, :] < lens[:, None]).to(torch.int32).to(dev)
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=False)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, mask)
    args = (q, k, v, do, lse, fa.flash_attention_dsum(do, o), mask)
    dq = fa.flash_attention_bwd_dq(*args, causal=False)
    dk, dv = fa.flash_attention_bwd_dkv(*args, causal=False)
    fq, fk, fv = fa.flash_attention_bwd_fused(*args, causal=False)
    dq_ref = fa.flash_attention_bwd_dq_plain(*args)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    live = lens > 0
    rel = row_rel_err(o[live], o_ref[live])
    lse_err = (lse[live] - lse_ref[live]).abs().max().item()
    dead_o = o[~live].float().abs().max().item()
    dead_dq = dq[~live].float().abs().max().item()
    masked = (mask == 0)[:, :, None, None]
    dead_kv = max((g.float().abs() * masked).max().item() for g in (dk, dv))
    g_rel = max(grad_row_rel_err(g[live], r[live]) for g, r in
                ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)))
    bits = all(torch.equal(a, c) for a, c in ((fq, dq), (fk, dk), (fv, dv)))
    finite = all(torch.isfinite(x).all().item() for x in (o, dq, dk, dv))
    ok = (rel <= FLASH_ROW_REL_TOL and lse_err <= FLASH_LSE_TOL
          and g_rel <= FLASH_BWD_ROW_REL_TOL and dead_o == 0
          and dead_dq == 0 and dead_kv == 0 and bits and finite)
    log(f"[bert flash B={b} S={s} H={h}, non-causal, trailing pads, row "
        f"{b - 1} all PAD] B1 worst row rel err {rel:.3e} (tol "
        f"{FLASH_ROW_REL_TOL}), lse {lse_err:.3e} (tol {FLASH_LSE_TOL}); "
        f"B2a/B2b worst grad row rel err {g_rel:.3e} (tol "
        f"{FLASH_BWD_ROW_REL_TOL}); all-PAD row max|o| {dead_o}, max|dq| "
        f"{dead_dq}, masked keys max|dk|,|dv| {dead_kv} (must be 0); B3 "
        f"bitwise B2a/B2b {bits}; finite {finite}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the flash kernels fail BERT's non-causal, "
                         "trailing-pad case")


def _bert_train_flops(model) -> float:
    """Training FLOPs of one sequence of BERT at BERT_S: 3 x the forward's
    multiply-adds x 2 of every dense layer (from the shapes the code
    gives them, one forward traced) and of the tied MLM decoder over
    max_predictions positions, plus the flash kernels' matmuls over the
    whole [S, S] (non-causal) as the reference's
    ``attention_train_flops`` counts them: 2 forward and 7 split-backward
    [S, D] x [D, S] products."""
    from distributed_tensorflow_example_tpu_torch.ops import nn
    c = model.cfg
    total = [0.0]
    dense = nn.dense

    def dense_rec(params, x, **kw):
        total[0] += 2.0 * params["kernel"].numel() * (x.numel()
                                                      // x.shape[-1])
        return dense(params, x, **kw)

    params = model.init(0)
    batch = {k: torch.as_tensor(v[:1, :BERT_S], device="cuda")
             for k, v in model.dummy_batch(1).items()}
    nn.dense = dense_rec
    try:
        with torch.no_grad():
            model.apply(params, {}, batch)
    finally:
        nn.dense = dense
    decoder = 2.0 * c.max_predictions * c.hidden * c.vocab_size
    attention = (2 + 7) * 2.0 * BERT_S ** 2 * c.hidden * c.layers
    return 3 * (total[0] + decoder) + attention


class _CountStep:
    """A Trainer hook that reads the kernels' launch counts over one step:
    set to 0 after step ``at``, read after step ``at + 1``."""

    every_steps = 0

    def __init__(self, at: int):
        self.at, self.read, self.counts = at, None, {}

    def begin(self, trainer):
        pass

    def wants_metrics(self, step):
        return False

    def after_step(self, trainer, step, metrics):
        if step == self.at:
            self.read = _reset_launches()
        elif step == self.at + 1 and self.read is not None:
            self.counts = self.read()

    def end(self, trainer):
        pass


def _launches_want(layers: int, steps: int, eval_batches: int, *,
                   bwd: str = "split", fwd_per_step: int = 1) -> dict:
    """The exact launch counts of a BERT CLI run: per step B1 once a
    layer (twice under remat) and the split (B2a, B2b) or fused (B3)
    backward once a layer; B1 once a layer for each eval batch."""
    split = bwd == "split"
    return {"flash_attention_fwd": layers * (steps * fwd_per_step
                                             + eval_batches),
            "flash_attention_bwd_dq": layers * steps * split,
            "flash_attention_bwd_dkv": layers * steps * split,
            "flash_attention_bwd_fused": layers * steps * (not split),
            "decode_attention": 0, "paged_decode_attention": 0,
            "paged_decode_attention_int8": 0}


def _padded_fixture(path: str, n_train: int, n_test: int,
                    vocab: int) -> None:
    """``train.npy``/``test.npy`` of synthetic-corpus rows (S=128) cut to
    random lengths with trailing PAD, the first train row all PAD."""
    from distributed_tensorflow_example_tpu_torch.data.bert_data import (
        PAD, synthetic_corpus)
    os.makedirs(path, exist_ok=True)
    for name, n, seed in (("train", n_train, 11), ("test", n_test, 12)):
        seqs = synthetic_corpus(n, BERT_S, vocab, seed)
        lens = np.random.RandomState(seed).randint(BERT_S // 4, BERT_S + 1,
                                                   n)
        if name == "train":
            lens[0] = 0
        for i, n_tok in enumerate(lens):
            seqs[i, n_tok:] = PAD
        np.save(os.path.join(path, f"{name}.npy"), seqs)


def _bert_grad_gate(grads: dict, g32: dict, total) -> tuple[list, list]:
    """(leaves over the gate, leaves held to the floor) of one path's
    gradients against the f32 oracle ``g32`` (global norm ``total``): each
    leaf within TRAIN_GRAD_REL_TOL of its f32 gradient, the attention's q
    and k leaves under BERT_QK_SHARE of the global norm within
    BERT_QK_FLOOR of the global norm; the key biases (a zero gradient)
    are held apart."""
    bad, floored = [], []
    for key, ref in g32.items():
        if key.endswith("attn/k/bias"):
            continue
        ref = ref.float()
        n = ref.norm()
        err = (grads[key].float() - ref).norm()
        share = (n / total).item()
        qk = "/attn/q/" in key or "/attn/k/" in key
        if qk and share < BERT_QK_SHARE:
            floored.append(key)
            ok = err <= max(TRAIN_GRAD_REL_TOL * n, BERT_QK_FLOOR * total)
        else:
            ok = err <= TRAIN_GRAD_REL_TOL * n
        if not ok:
            bad.append(key)
    return bad, floored


def _bert_flash_vs_xla(argv: list[str], data_dir: str, failed: list) -> None:
    """One step's loss and gradients of BERT-base (bf16, dropout off) on
    the first BERT_B rows of the padded fixture (an all-PAD row among
    them) under the flash kernels and under the plain einsum attention,
    from one state, each held to the same model in f32 (plain attention,
    f32 matmuls) as the oracle by :func:`_bert_grad_gate`; the
    attention's key biases, whose gradient is 0, within
    TRAIN_ZERO_GRAD_SHARE of the global norm. A control must fail the
    gate: the flash gradients with every layer's attention q leaves
    zeroed (a lost dq). Every output and gradient finite."""
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    from distributed_tensorflow_example_tpu_torch.data.bert_data import \
        get_bert_data
    from distributed_tensorflow_example_tpu_torch.models import get_model
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    model = get_model("bert", cfg)
    plain = get_model("bert", cfg.replace(attention_impl="xla"))
    oracle = get_model("bert", cfg.replace(attention_impl="xla",
                                           dtype="float32"))
    params = model.init(0)
    tr, _ = get_bert_data(data_dir, vocab_size=model.cfg.vocab_size,
                          seq_len=BERT_S,
                          max_predictions=model.cfg.max_predictions)
    batch = {k: torch.as_tensor(v[:BERT_B], device="cuda")
             for k, v in tr.items()}
    with torch.no_grad():
        outs = [m.encode(params, batch) for m in (model, plain)]
    finite = all(torch.isfinite(o).all().item() for o in outs)
    out_rel = ((outs[0].float() - outs[1].float()).norm()
               / outs[1].float().norm()).item()
    lf, gf = _loss_and_grads(model, params, batch)
    lx, gx = _loss_and_grads(plain, params, batch)
    l32, g32 = _loss_and_grads(oracle, params, batch)
    finite = finite and np.isfinite(lf) and all(
        torch.isfinite(g).all().item() for g in (*gf.values(),
                                                 *gx.values()))
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in g32.values()))
    zero = max((g[k].float().norm() / total).item() for g in (gf, gx)
               for k in g32 if k.endswith("attn/k/bias"))
    bad_f, floored = _bert_grad_gate(gf, g32, total)
    bad_x, _ = _bert_grad_gate(gx, g32, total)
    control = {k: torch.zeros_like(g) if "/attn/q/" in k else g
               for k, g in gf.items()}
    bad_c, _ = _bert_grad_gate(control, g32, total)
    floor_share = torch.sqrt(sum((g32[k].float() ** 2).sum()
                                 for k in floored)) / total
    log(f"[bert padded] one step from one state (bf16, dropout off, "
        f"{int((batch['attention_mask'] == 0).sum())} padded tokens, row 0 "
        f"all PAD), each path against the f32 einsum attention: loss flash "
        f"{lf:.5f}, xla {lx:.5f}, f32 {l32:.5f} (tol {TRAIN_LOSS_TOL}); "
        f"sequence output flash vs xla ||d|| / ||xla|| {out_rel:.3e}; key "
        f"biases ||g|| / global norm {zero:.3e} (tol "
        f"{TRAIN_ZERO_GRAD_SHARE}); every output and gradient finite "
        f"{finite}; leaves over the gate: flash {bad_f}, xla {bad_x}; "
        f"{len(floored)} of {len(g32)} leaves (q and k under "
        f"{BERT_QK_SHARE} of the global norm, together "
        f"{floor_share.item():.2e} of it) held to {BERT_QK_FLOOR} of the "
        f"global norm, the rest to {TRAIN_GRAD_REL_TOL} of the leaf; "
        f"control (flash with every attn/q leaf zeroed): {len(bad_c)} "
        f"leaves over the gate (must be > 0)")
    t = total.item()
    for i in range(model.cfg.layers):
        parts = []
        for w in ("q", "k"):
            key = f"layer_{i}/attn/{w}/kernel"
            ref = g32[key].float()
            n = ref.norm().item()
            ef = (gf[key].float() - ref).norm().item()
            ex = (gx[key].float() - ref).norm().item()
            parts.append(f"{w} share {n / t:.2e}, flash off by {ef / t:.2e} "
                         f"({ef / n:.2e} of the leaf), xla {ex / t:.2e} "
                         f"({ex / n:.2e})")
        log(f"[bert padded]   layer_{i}/attn kernels, of the global norm: "
            + "; ".join(parts))
    if (bad_f or bad_x or not bad_c or zero > TRAIN_ZERO_GRAD_SHARE
            or not finite or abs(lf - l32) > TRAIN_LOSS_TOL
            or out_rel > TRAIN_GRAD_REL_TOL):
        failed.append("padded BERT: flash or xla off the f32 oracle, the "
                      "control passed, or a value is not finite")


def phase_bert(card: str) -> dict:
    """BASELINE.json config 5, BERT-base MLM, at its registered preset
    (nothing cut: 12 layers, hidden 768, vocab 30522, 20 predictions),
    bf16 compute, through the port's CLI on the flash kernels'
    non-causal path, LAMB: 30 steps of 64 x 128 synthetic tokens with a
    ring of 2, a resume to 40 and the final eval; a Trainer of the same
    argv timed over steps 11-30 (sequences/s, tokens/s), step 32 traced
    (idle share, launches, B1/B2a/B2b 12 each), its share of the bf16
    peak. Then the padded non-causal path (a fixture with trailing PAD
    and an all-PAD row: flash against xla, 10 CLI steps), the levers
    (``--attention_bwd fused``, ``--remat full|dots``, ``--lm_loss_impl
    fused``, ``--optimizer lars``: each a few steps, the loss falling,
    the launch counts exact), one seq-512 run, bert_large's step time,
    and bert_tiny on the card against the CPU."""
    from torch.autograd import DeviceType
    from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import (
        CheckpointManager)
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    from distributed_tensorflow_example_tpu_torch.config import (
        OptimizerConfig, TrainConfig)
    from distributed_tensorflow_example_tpu_torch.data.bert_data import \
        get_bert_data
    from distributed_tensorflow_example_tpu_torch.data.loader import \
        make_loader
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.models.bert import (
        Bert, BertConfig)
    from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas \
        import SyncReplicas
    from distributed_tensorflow_example_tpu_torch.train.optimizers import \
        make_optimizer
    from distributed_tensorflow_example_tpu_torch.train.state import \
        param_count
    from distributed_tensorflow_example_tpu_torch.train.trainer import \
        Trainer
    failed: list[str] = []
    out: dict = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bert_")
    bert_flash_case(torch.Generator().manual_seed(128))
    eval_batches = -(-BERT_EVAL // BERT_B)

    # BERT-base through the CLI: 30 steps, a ring of 2, a resume to 40
    ck, m = os.path.join(tmp, "bert"), os.path.join(tmp, "bert.jsonl")
    base = BERT_ARGV + ["--ckpt_dir", ck, "--save_steps", "10",
                        "--max_to_keep", "2", "--metrics_path", m]
    _, lines, _, peak1 = _cli_run(
        base + ["--train_steps", "30", "--log_every_steps", "5"],
        "steps 1-30", failed, card, tag="bert",
        want=_launches_want(BERT_LAYERS, 30, eval_batches))
    curve = _step_metrics(lines)
    ring1 = _ring(ck)
    _, lines2, _, _ = _cli_run(
        base + ["--train_steps", "40", "--log_every_steps", "10"],
        "resume to 40", failed, card, tag="bert",
        want=_launches_want(BERT_LAYERS, 10, eval_batches))
    ring2 = _ring(ck)
    ev = _final_eval(lines2)
    losses = [curve[s]["loss"] for s in sorted(curve)]
    log("[bert] loss at steps " + " ".join(
        f"{s}:{curve[s]['loss']:.4f}" for s in sorted(curve))
        + ", mlm_accuracy at steps " + " ".join(
            f"{s}:{curve[s]['mlm_accuracy']:.4f}" for s in sorted(curve))
        + f"; ring after 30 {ring1}, after 40 {ring2} (verified); final "
        f"eval {ev} ({card})")
    if sorted(curve) != list(range(5, 31, 5)) \
            or not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        failed.append(f"bert loss curve {curve}")
    if ring1 != [20, 30] or ring2 != [30, 40] or not any(
            "restored checkpoint at step 30" in x for x in lines2):
        failed.append(f"bert ring {ring1} then {ring2}, or no resume")
    if "mlm_accuracy" not in ev or not np.isfinite(ev.get("loss", np.nan)):
        failed.append(f"bert final eval {ev}")

    # speed: a Trainer of the same argv, steps 11-30 timed, step 32 traced
    # and its launches counted
    args = cli.build_parser().parse_args(
        BERT_ARGV + ["--train_steps", "32", "--log_every_steps", "100"])
    cfg = cli.config_from_args(args)
    model = get_model(cfg.model, cfg)
    train, _ = cli.load_dataset(cfg, model)
    flops = _bert_train_flops(model) * BERT_B
    window, prof, count = _Window(10, 30), _ProfileStep(31), _CountStep(31)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with Trainer(model, cfg, train, None, hooks=[window, prof, count]) as tr:
        state, _ = tr.train()
    n_params = param_count(state.params)
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = window.wall / 20 * 1e3
    seqs = BERT_B * 20 / window.wall
    bound_ms = flops / PEAK_BF16_FLOPS * 1e3
    kernels = [e for e in prof.prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    idle = 1 - busy / (prof.wall * 1e3) if kernels else float("nan")
    log(f"[bert] BERT-base {n_params} params (f32), bf16 compute: steps "
        f"11-30 of a Trainer run: {ms:.2f} ms per step, {seqs:.1f} "
        f"sequences/s, {seqs * BERT_S:.0f} tokens/s ({BERT_B} x {BERT_S}); "
        f"peak device memory {peak:.1f} MiB (CLI run {peak1:.1f}); "
        f"training FLOPs {flops / 1e12:.3f} TFLOP a step, {bound_ms:.3f} ms "
        f"at the bf16 peak: {bound_ms / ms:.4f} of it ({card})")
    want_step = {k: v for k, v in _launches_want(BERT_LAYERS, 1, 0).items()}
    if count.counts != want_step:
        failed.append(f"bert traced step launches {count.counts}, want "
                      f"{want_step}")
    if kernels:
        log(f"[bert profile] one Trainer step (32) traced: "
            f"{prof.wall * 1e3:.1f} ms, device busy {busy:.2f} ms in "
            f"{n_launch} kernel launches: idle share {idle:.3f}; the "
            f"port's kernels in it: {count.counts} ({card})")
        ours = [e for e in kernels if "flash_" in e.key]
        for e in sorted(kernels, key=_device_us, reverse=True)[:10] + ours:
            log(f"[bert profile]   {_device_us(e) / 1e3:8.3f} ms "
                f" {e.count:5d}x  {e.key[:90]}")
        host = [e for e in prof.prof.key_averages()
                if e.device_type == DeviceType.CPU]
        for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:6]:
            log(f"[bert profile]   host {e.self_cpu_time_total / 1e3:8.3f} "
                f"ms self  {e.count:5d}x  {e.key[:70]}")
    else:
        log("[bert profile] the profiler saw no device time: idle share "
            "not measured")
    out.update(ms=ms, seqs=seqs, tokens=seqs * BERT_S, peak_mib=peak,
               idle=idle, peak_share=bound_ms / ms, launches=n_launch)
    del model, train, tr, state
    gc.collect()

    # the padded, non-causal path: flash against xla, then 10 CLI steps
    fixture = os.path.join(tmp, "padded")
    _padded_fixture(fixture, n_train=640, n_test=BERT_B, vocab=BERT_VOCAB)
    _bert_flash_vs_xla(BERT_ARGV, fixture, failed)
    gc.collect()
    torch.cuda.empty_cache()
    _, lines, _, _ = _cli_run(
        BERT_ARGV + ["--data_dir", fixture, "--train_steps", "10",
                  "--log_every_steps", "5", "--metrics_path",
                  os.path.join(tmp, "padded.jsonl")],
        "padded data, 10 steps", failed, card, tag="bert",
        want=_launches_want(BERT_LAYERS, 10, 1))
    curve = _step_metrics(lines)
    log(f"[bert padded] loss at steps " + " ".join(
        f"{s}:{curve[s]['loss']:.4f}" for s in sorted(curve))
        + f"; final eval {_final_eval(lines)}")
    if sorted(curve) != [5, 10] or curve[10]["loss"] >= curve[5]["loss"] \
            or not all(np.isfinite(list(curve[s].values())).all()
                       for s in curve):
        failed.append(f"bert padded loss curve {curve}")

    # the levers: a few steps each, the loss falling, launches exact
    n = BERT_LEVER_STEPS
    for label, extra, want in (
            ("--attention_bwd fused", ["--attention_bwd", "fused"],
             _launches_want(BERT_LAYERS, n, eval_batches, bwd="fused")),
            ("--remat full", ["--remat", "full"],
             _launches_want(BERT_LAYERS, n, eval_batches, fwd_per_step=2)),
            ("--remat dots", ["--remat", "dots"],
             _launches_want(BERT_LAYERS, n, eval_batches, fwd_per_step=2)),
            ("--lm_loss_impl fused", ["--lm_loss_impl", "fused"],
             _launches_want(BERT_LAYERS, n, eval_batches)),
            ("--optimizer lars", ["--optimizer", "lars", "--learning_rate",
                                  "5.0", "--momentum", "0.9"],
             _launches_want(BERT_LAYERS, n, eval_batches)),
            (f"seq {BERT_LONG_S}, batch {BERT_LONG_B}",
             ["--seq_len", str(BERT_LONG_S), "--batch_size",
              str(BERT_LONG_B)],
             _launches_want(BERT_LAYERS, n, -(-BERT_EVAL // BERT_LONG_B)))):
        mpath = os.path.join(tmp, "lever.jsonl")
        if os.path.exists(mpath):
            os.unlink(mpath)
        _, lines, recs, peak = _cli_run(
            BERT_ARGV + extra + ["--train_steps", str(n),
                                 "--log_every_steps", "3",
                                 "--metrics_path", mpath],
            label, failed, card, tag="bert", want=want)
        curve = _step_metrics(lines)
        rates = [r for r in recs if "sec_per_step" in r]
        step_ms = rates[-1]["sec_per_step"] * 1e3 if rates else float("nan")
        log(f"[bert {label}] loss at steps " + " ".join(
            f"{s}:{curve[s]['loss']:.4f}" for s in sorted(curve))
            + f"; {step_ms:.2f} ms per step over steps 4-{n} (host clock at "
            f"the log cadence); peak {peak:.1f} MiB ({card})")
        if sorted(curve) != [3, 6] or not curve[6]["loss"] < curve[3]["loss"]:
            failed.append(f"bert {label}: loss curve {curve}")
        if label.startswith("seq"):
            out.update(long_ms=step_ms)

    # bert_large: 5 timed SyncReplicas steps
    lcfg = TrainConfig(model="bert_large", dtype="bfloat16",
                       attention_impl="flash", seed=0,
                       optimizer=OptimizerConfig(name="lamb",
                                                 learning_rate=1e-3))
    lcfg.data.seq_len = BERT_S
    large = get_model("bert_large", lcfg)
    lsync = SyncReplicas(large.loss, make_optimizer(lcfg.optimizer))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lstate = lsync.init(large.init, seed=0)
    ltr, _ = get_bert_data(None, vocab_size=large.cfg.vocab_size,
                           seq_len=BERT_S,
                           max_predictions=large.cfg.max_predictions,
                           synthetic=True, num_train=BERT_LARGE_B,
                           num_test=1)
    lbatch = {k: torch.as_tensor(v, device="cuda") for k, v in ltr.items()}
    lstate, lm = lsync.step(lstate, lbatch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lvals = []
    for _ in range(BERT_LARGE_STEPS):
        lstate, lm = lsync.step(lstate, lbatch)
        lvals.append(lm["loss"])
    torch.cuda.synchronize()
    lms = (time.perf_counter() - t0) / BERT_LARGE_STEPS * 1e3
    lpeak = torch.cuda.max_memory_allocated() / 2**20
    lvals = [float(x) for x in lvals]
    log(f"[bert_large] {param_count(lstate.params)} params, 24 layers, "
        f"hidden 1024, bf16, LAMB, batch {BERT_LARGE_B} x {BERT_S}: "
        f"{lms:.2f} ms per step over {BERT_LARGE_STEPS} steps (host clock, "
        f"one sync at each end), {BERT_LARGE_B * BERT_S / lms * 1e3:.0f} "
        f"tokens/s; loss {' '.join(f'{x:.4f}' for x in lvals)}; peak "
        f"{lpeak:.1f} MiB ({card})")
    if not all(np.isfinite(lvals)):
        failed.append(f"bert_large losses {lvals}")
    out.update(large_ms=lms, large_peak_mib=lpeak)
    del large, lsync, lstate, lbatch
    gc.collect()
    torch.cuda.empty_cache()

    # bert_tiny: 20 f32 steps on the card against 20 on the CPU
    tiny = Bert(BertConfig(**{**BertConfig.tiny().__dict__, "dropout": 0.0}))
    syncs = {dev: SyncReplicas(tiny.loss, make_optimizer(OptimizerConfig(
        name="lamb", learning_rate=1e-3, weight_decay=0.01)), device=dev)
        for dev in ("cuda", "cpu")}
    tstate = syncs["cuda"].init(tiny.init, seed=0)
    bridge = CheckpointManager(os.path.join(tmp, "tiny_bridge"))
    bridge.save(tstate)
    cstate = bridge.restore(syncs["cpu"].init(tiny.init, seed=1))
    tarr, _ = get_bert_data(None, vocab_size=1000, seq_len=64,
                            max_predictions=8, synthetic=True,
                            num_train=640, num_test=1)
    batches = make_loader(tarr, 32, seed=0)
    rels = []
    for _ in range(20):
        b = next(batches)
        tstate, mt = syncs["cuda"].step(tstate, b)
        cstate, mc = syncs["cpu"].step(cstate, b)
        rels.append(abs(float(mt["loss"]) - float(mc["loss"]))
                    / float(mc["loss"]))
    log(f"[bert_tiny] 20 f32 LAMB steps (batch 32, no dropout), card "
        f"against CPU from one checkpoint: loss relative difference a step "
        + " ".join(f"{r:.1e}" for r in rels)
        + f" (tol {TINY_CARD_CPU_LOSS_RTOL})")
    if not max(rels) <= TINY_CARD_CPU_LOSS_RTOL:
        failed.append(f"bert_tiny card vs CPU losses differ by {rels}")
    out.update(tiny_card_cpu=max(rels))
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise SystemExit("the BERT phase failed: " + "; ".join(failed))
    return out


def phase_train_lm_head(card: str) -> None:
    """GPT-small's LM head at the training shape (8 x 512, bf16 compute,
    flash attention, AdamW) under ``--lm_loss_impl`` full, chunked (128)
    and fused: for each, the step-1 loss (the three within
    GPT_HEAD_LOSS_RTOL), ms per step over 3 steps (host clock), peak
    device memory, the device-busy time of one traced step, and the
    head's own device time (its forward and backward alone on the same
    shapes, traced) as a share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from distributed_tensorflow_example_tpu_torch.config import (
        OptimizerConfig, TrainConfig)
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.ops import losses
    from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas \
        import SyncReplicas
    from distributed_tensorflow_example_tpu_torch.train.optimizers import \
        make_optimizer

    def busy_ms(fn) -> float:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(_device_us(e) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3

    rs = np.random.RandomState(2)
    first = {}
    for impl, chunk in (("full", None), ("chunked", 128), ("fused", None)):
        cfg = TrainConfig(model="gpt", dtype="bfloat16",
                          attention_impl="flash", seed=0, lm_loss_impl=impl,
                          lm_loss_chunk=chunk, optimizer=OptimizerConfig(
                              name="adamw", learning_rate=1e-3))
        cfg.data.seq_len = TRAIN_S
        model = get_model("gpt", cfg)
        c = model.cfg
        ids = np.random.RandomState(2).randint(
            0, c.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int32)
        batch = {"input_ids": torch.as_tensor(ids, device="cuda"),
                 "attention_mask": torch.ones((TRAIN_B, TRAIN_S),
                                              dtype=torch.int32,
                                              device="cuda")}
        sync = SyncReplicas(model.loss, make_optimizer(cfg.optimizer))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = sync.init(model.init, seed=0)
        state, met = sync.step(state, batch)
        first[impl] = float(met["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            state, met = sync.step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**20
        step_busy = busy_ms(lambda: sync.step(state, batch))
        table = state.params["wte"]["table"].detach().requires_grad_()
        h = torch.randn((TRAIN_B, TRAIN_S, c.hidden), device="cuda",
                        dtype=torch.bfloat16, requires_grad=True)
        tgt = torch.as_tensor(rs.randint(0, c.vocab_size,
                                         (TRAIN_B, TRAIN_S)), device="cuda")
        w = torch.ones((TRAIN_B, TRAIN_S), device="cuda")

        def head():
            loss, _ = losses.lm_head_xent(
                h, table, tgt, w, impl=impl, seq_chunk=chunk or 0,
                dtype=torch.bfloat16)
            loss.backward()
        head()
        head_busy = busy_ms(head)
        busy = (f"one traced step device busy {step_busy:.2f} ms, the head's "
                f"forward and backward alone {head_busy:.2f} ms: "
                f"{head_busy / step_busy:.3f} of it" if step_busy else
                "the profiler saw no device time: busy not measured")
        log(f"[train lm head {impl}{f' {chunk}' if chunk else ''}] GPT-small "
            f"{TRAIN_B} x {TRAIN_S}, vocab {c.vocab_size}: step-1 loss "
            f"{first[impl]:.6f}; {ms:.2f} ms per step (3 steps, host "
            f"clock); {busy}; peak device memory {peak:.1f} MiB ({card})")
        del model, sync, state, table, h
    ref = first["full"]
    worst = max(abs(v - ref) / ref for v in first.values())
    log(f"[train lm head] step-1 losses {first}: worst relative difference "
        f"from full {worst:.2e} (tol {GPT_HEAD_LOSS_RTOL})")
    if worst > GPT_HEAD_LOSS_RTOL:
        raise SystemExit("the LM-head impls disagree at step 1")
    gc.collect()
    torch.cuda.empty_cache()


REST_ARGV = ["--model", "gpt", "--device", "cuda", "--attention", "flash",
             "--dtype", "bfloat16", "--seq_len", str(TRAIN_S),
             "--batch_size", str(TRAIN_B), "--learning_rate", "1e-3",
             "--warmup_steps", "5", "--grad_clip_norm", "1.0", "--seed", "0"]
REST_LAYERS = 12
REST_EVAL_BATCHES = -(-256 // TRAIN_B)     # get_lm_data's 256 eval rows
#: the adafactor run's loss must fall by this share from step 10 to 30
#: (an H100 run fell 25%, 6.99 to 5.27)
REST_MIN_LOSS_DROP = 0.10
#: adafactor's chain on GPT-small's parameters, on the card against the
#: CPU from the same parameters and gradients: steps, and each leaf's
#: largest update difference over its largest update (f32 means over up
#: to 23.4M elements, the token embedding's, summed in another order on
#: each device)
REST_ADAFACTOR_STEPS, REST_ADAFACTOR_RTOL = 3, 1e-5
#: --eval_only's printed metrics against the eval the training run logged
#: at the best step: the same forward on the same restored bits; the print
#: rounds to 6 decimals (half a unit: 5e-7), and 1e-6 of the value more
#: is allowed for a library kernel that picks another summation order
REST_EVAL_ROUND, REST_EVAL_REL_TOL = 5e-7, 1e-6


def _rest_want(steps: int, evals: int = 1) -> dict:
    """The launches of ``steps`` GPT-small steps (split backward) and
    ``evals`` full evals: B1 12 a step and 12 an eval batch, B2a and B2b
    12 a step, nothing else."""
    return {"flash_attention_fwd": REST_LAYERS * (
                steps + evals * REST_EVAL_BATCHES),
            "flash_attention_bwd_dq": REST_LAYERS * steps,
            "flash_attention_bwd_dkv": REST_LAYERS * steps,
            "flash_attention_bwd_fused": 0, "decode_attention": 0,
            "paged_decode_attention": 0, "paged_decode_attention_int8": 0}


def _opt_state_bytes(path: str) -> int:
    """Bytes of a checkpoint's optimizer-state leaves (what the run held
    on the card, f32 and int32)."""
    from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import \
        load_npz
    return sum(v.nbytes for k, v in load_npz(path).items()
               if k.startswith(("opt_state/", "__bf16__/opt_state/")))


class _StepClock:
    """A Trainer hook that syncs the card after every step and stamps the
    host clock: ``times[n]`` ends step n (its hooks, a save included)."""

    every_steps = 0

    def __init__(self):
        self.times: dict[int, float] = {}

    def begin(self, trainer):
        torch.cuda.synchronize()
        self.times[trainer.start_step] = time.perf_counter()

    def wants_metrics(self, step):
        return False

    def after_step(self, trainer, step, metrics):
        torch.cuda.synchronize()
        self.times[step] = time.perf_counter()

    def end(self, trainer):
        pass

    def step_ms(self, step: int) -> float:
        return (self.times[step] - self.times[step - 1]) * 1e3


def _rest_trainer(argv: list[str], arrays_fn=None, hooks=()):
    """The CLI's Trainer for ``REST_ARGV + argv`` (its config, model and
    data, through ``cli/train.py``'s own functions), with extra hooks."""
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.train.trainer import \
        Trainer
    args = cli.build_parser().parse_args(REST_ARGV + argv)
    cfg = cli.config_from_args(args)
    model = get_model(cfg.model, cfg)
    train, evals = cli.load_dataset(cfg, model)
    if arrays_fn is not None:
        train = arrays_fn(train)
    return Trainer(model, cfg, train, evals, device=args.device,
                   hooks=list(hooks))


def _float_mask(arrays: dict) -> dict:
    """The LM corpus with its attention mask as f32, the one float leaf
    GPT takes: a ``step.nan`` fault poisons it (an integer-only batch is
    refused, as in the reference)."""
    return dict(arrays, attention_mask=arrays["attention_mask"].astype(
        np.float32))


def _adafactor_card_vs_cpu(argv: list[str]) -> float:
    """The worst leaf's relative update difference of ``argv``'s optimizer
    (the CLI's chain: the global-norm clip, the warmup schedule, adafactor)
    over :data:`REST_ADAFACTOR_STEPS` steps on GPT-small's seeded
    parameters, on the card against the CPU, the gradients drawn from a
    numpy seed: the factored leaves (the embeddings and the 768-wide
    matrices) and the unfactored ones (biases, norm scales)."""
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.train.optimizers import (
        apply_updates, make_optimizer)
    from distributed_tensorflow_example_tpu_torch.utils.pytree import \
        tree_leaves
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    cpu = tree_leaves(get_model(cfg.model, cfg).init(0, device="cpu"))
    params = {"cpu": cpu, "cuda": [p.to("cuda") for p in cpu]}
    opt = make_optimizer(cfg.optimizer)
    state = {d: opt.init(ps) for d, ps in params.items()}
    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(REST_ADAFACTOR_STEPS):
        grads = [torch.from_numpy(rng.standard_normal(
            p.shape, dtype=np.float32) * 1e-2) for p in cpu]
        ups = {}
        for d in params:
            g = [x.to(d) for x in grads]
            ups[d], state[d] = opt.update(g, state[d], params[d])
            params[d] = apply_updates(params[d], ups[d])
        for uc, ug in zip(ups["cpu"], ups["cuda"]):
            # a zero update (the warmup's first step) must stay zero
            diff, scale = (float((ug.cpu() - uc).abs().max()),
                           float(uc.abs().max()))
            worst = max(worst, diff / scale if scale else
                        (0.0 if diff == 0 else float("inf")))
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def phase_train_rest(card: str) -> None:
    """The rest of training on full-width GPT-small (bf16 compute, f32
    params, flash attention with the split backward, dropout 0.1, the
    synthetic LM corpus, 8 x 512 tokens a step; only the step count cut),
    through ``cli/train.py`` and its ``Trainer``:

    (a) 30 steps of ``--optimizer adafactor --momentum 0`` against 30 of
        AdamW, each with ``--eval_every_steps 10``, ``--keep_best_metric
        loss --keep_best_mode min`` and ``--step_timing``: the loss falls,
        the optimizer state's bytes (from the run's checkpoint) and peak
        memory of each, the step's p50 over steps 12-30 (each step to its
        device sync, saves and evals outside); and adafactor's chain on
        GPT-small's parameters, card against CPU over 3 steps;
    (b) 40 steps with ``--save_steps 10``: no save, sync, ``--async_save``,
        each step synced and stamped: the host ms of each save step, and
        the median ms of the steps inside the async writes' window against
        the same steps of the run without saves; both rings equal;
    (c) ``--fault_spec step.nan:step=15 --on_anomaly rollback --save_steps
        10`` over 30 steps (the mask as f32, see :func:`_float_mask`):
        restored step 10, anomaly_count 1, final params ``torch.equal`` to
        an uninterrupted run's;
    (d) ``--eval_only --eval_best`` on (a)'s adafactor directory: the
        printed metrics equal the eval the run logged at the best step;
    (e) one 20-step run with ``--tb_logdir``, ``--summary_every_steps``,
        ``--param_histograms_every_steps``, ``--step_timing``,
        ``--profile_dir``/``--profile_steps`` and ``--trace_path``: each
        file parses, every event record's masked CRC32C checks (the port's
        reader), the step-timing records counted.

    Every run's kernel launches are set to 0 before it and read after:
    B1, B2a and B2b exactly as :func:`_rest_want` counts."""
    import contextlib
    import io

    from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import (
        CheckpointManager, load_npz)
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    from distributed_tensorflow_example_tpu_torch.obs import trace
    from distributed_tensorflow_example_tpu_torch.utils import tb_events

    failed: list[str] = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rest_")
    tag = "train rest"

    # (a) adafactor against AdamW, and (d) --eval_best
    res = {}
    # adafactor's steps are relative to each parameter's RMS: its usual
    # learning rate is ten times AdamW's
    for opt, extra in (("adafactor", ["--momentum", "0",
                                      "--learning_rate", "1e-2"]),
                       ("adamw", [])):
        ck = os.path.join(tmp, opt)
        metrics = os.path.join(tmp, f"{opt}.jsonl")
        _, _, recs, peak = _cli_run(
            REST_ARGV + ["--optimizer", opt, "--train_steps", "30",
                         "--ckpt_dir", ck, "--eval_every_steps", "10",
                         "--keep_best_metric", "loss", "--keep_best_mode",
                         "min", "--log_every_steps", "10",
                         "--summary_every_steps", "10", "--step_timing",
                         "--metrics_path", metrics] + extra,
            f"(a) {opt}", failed, card, tag=tag, want=_rest_want(30, 3))
        losses = {r["step"]: r["loss"] for r in recs if "loss" in r}
        evals = {r["step"]: r["eval"] for r in recs if "eval" in r}
        # the steps alone, each to its device sync: the window's saves
        # and evals stay out (StepTimingHook, records at 11, 21, 30)
        p50s = [r["step_timing_ms"]["p50"] for r in recs
                if "step_timing_ms" in r]
        ms = float(np.mean(p50s[1:])) if len(p50s) > 1 else float("nan")
        res[opt] = dict(peak=peak, ms=ms, losses=losses, evals=evals,
                        state=_opt_state_bytes(
                            CheckpointManager(ck).checkpoint_path(30)),
                        ck=ck, extra=extra)
        log(f"[{tag} (a)] {opt}: loss {losses.get(10, float('nan')):.4f} "
            f"(10) {losses.get(20, float('nan')):.4f} (20) "
            f"{losses.get(30, float('nan')):.4f} (30); optimizer state "
            f"{res[opt]['state'] / 2**20:.2f} MiB; peak device memory "
            f"{peak:.1f} MiB; step p50 {ms:.2f} ms over steps 12-30 "
            f"(each synced; {[round(x, 2) for x in p50s]} a record) "
            f"({card})")
    a, w = res["adafactor"], res["adamw"]
    log(f"[{tag} (a)] adafactor against AdamW: optimizer state "
        f"{a['state'] / 2**20:.2f} vs {w['state'] / 2**20:.2f} MiB "
        f"({(w['state'] - a['state']) / 2**30:.3f} GiB less), peak "
        f"{a['peak']:.1f} vs {w['peak']:.1f} MiB "
        f"({(w['peak'] - a['peak']) / 1024:.3f} GiB less), "
        f"{a['ms']:.2f} vs {w['ms']:.2f} ms per step ({card})")
    la = a["losses"]
    if not (10 in la and 30 in la
            and la[30] < (1 - REST_MIN_LOSS_DROP) * la[10]):
        failed.append(f"(a) adafactor's loss did not fall by "
                      f"{REST_MIN_LOSS_DROP:.0%}: {la}")
    rel = _adafactor_card_vs_cpu(REST_ARGV + ["--optimizer", "adafactor"]
                                 + a["extra"])
    log(f"[{tag} (a)] adafactor's chain on GPT-small's parameters, "
        f"{REST_ADAFACTOR_STEPS} steps on the card against the CPU: worst "
        f"leaf's update difference over its largest update {rel:.2e} "
        f"(tol {REST_ADAFACTOR_RTOL})")
    if not rel <= REST_ADAFACTOR_RTOL:
        failed.append(f"(a) adafactor on the card against the CPU: {rel}")
    best = CheckpointManager(a["ck"]).best_step()
    buf = io.StringIO()
    read = _reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(REST_ARGV + ["--optimizer", "adafactor", "--ckpt_dir",
                                   a["ck"], "--eval_only", "--eval_best"]
                      + a["extra"])
    launches = read()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    logged = a["evals"].get(best, {})
    excess = max((abs(out[k] - v) - REST_EVAL_ROUND - REST_EVAL_REL_TOL
                  * abs(v) for k, v in logged.items() if k in out),
                 default=float("inf"))
    log(f"[{tag} (d)] --eval_only --eval_best: rc {rc}, best step {best}, "
        f"printed {out}, logged {logged}: worst excess over "
        f"{REST_EVAL_ROUND} + {REST_EVAL_REL_TOL} x |value| {excess:.2e}; "
        f"launches {launches}")
    if rc != 0 or out.get("step") != best or excess > 0 \
            or set(out) - {"step"} != set(logged):
        failed.append(f"(d) --eval_best printed {out}, the run logged "
                      f"{logged} at best step {best}")
    if launches != dict(_rest_want(0), flash_attention_fwd=REST_LAYERS
                        * REST_EVAL_BATCHES):
        failed.append(f"(d) launches {launches}")
    for opt in res:
        shutil.rmtree(res[opt]["ck"], ignore_errors=True)

    # (b) sync and async saves against no save
    rec = trace.recorder()
    clocks, windows, rings = {}, {}, {}
    for label, extra in (("none", []),
                         ("sync", ["--save_steps", "10"]),
                         ("async", ["--save_steps", "10", "--async_save"])):
        ck = os.path.join(tmp, f"saves_{label}")
        clock = _StepClock()
        tr = _rest_trainer(["--optimizer", "adamw", "--train_steps", "40",
                            "--log_every_steps", "40"]
                           + (["--ckpt_dir", ck] + extra if extra else []),
                           hooks=[clock])
        gc.collect()
        torch.cuda.empty_cache()
        read = _reset_launches()
        rec.start()
        with tr:
            tr.train()
        spans = rec.drain("training")
        rec.stop()
        launches = read()
        if launches != _rest_want(40):
            failed.append(f"(b) {label}: launches {launches}")
        clocks[label] = clock
        windows[label] = [(t0, t1) for _, lane, name, t0, t1, _ in spans
                          if name == "checkpoint_write"]
        if extra:
            rings[label] = ck
    saves = (10, 20, 30, 40)
    for label in ("sync", "async"):
        c = clocks[label]
        inside = [n for n in range(2, 41) if n not in saves and any(
            c.times[n - 1] < t1 and c.times[n] > t0
            for t0, t1 in windows[label])]
        med = float(np.median([c.step_ms(n) for n in inside])) \
            if inside else float("nan")
        base = float(np.median([clocks["none"].step_ms(n)
                                for n in inside])) if inside else \
            float("nan")
        writes = [round((t1 - t0) * 1e3, 1) for t0, t1 in windows[label]]
        log(f"[{tag} (b)] {label} saves: host ms of save steps "
            + ", ".join(f"{n}: {c.step_ms(n):.1f}" for n in saves)
            + f" (no-save run: "
            + ", ".join(f"{clocks['none'].step_ms(n):.1f}" for n in saves)
            + f"); writes {writes} ms; {len(inside)} steps inside the "
            f"write windows {inside}: median {med:.2f} ms against "
            f"{base:.2f} ms for the same steps without saves ({card})")
    ms_none = float(np.median([clocks["none"].step_ms(n)
                               for n in range(2, 41)]))
    log(f"[{tag} (b)] the no-save run: median {ms_none:.2f} ms per step "
        f"(synced every step) ({card})")
    steps_sync, steps_async = (CheckpointManager(rings[k]).all_steps()
                               for k in ("sync", "async"))
    if steps_sync != steps_async or not steps_sync:
        failed.append(f"(b) rings {steps_sync} vs {steps_async}")
    for step in steps_sync:
        x = load_npz(CheckpointManager(rings["sync"]).checkpoint_path(step))
        y = load_npz(CheckpointManager(rings["async"]).checkpoint_path(step))
        bad = [k for k in x if not np.array_equal(x[k], y[k])]
        if sorted(x) != sorted(y) or bad:
            failed.append(f"(b) step {step}: sync and async rings differ "
                          f"at {bad[:3]}")
    log(f"[{tag} (b)] rings {steps_sync}: sync and async checkpoints "
        "restore to equal arrays" if not any(f.startswith("(b) step")
                                             for f in failed) else
        f"[{tag} (b)] rings differ")
    for ck in rings.values():
        shutil.rmtree(ck, ignore_errors=True)

    # (c) rollback against an uninterrupted run
    finals = {}
    for label, extra in (("uninterrupted", []),
                         ("rollback", ["--fault_spec", "step.nan:step=15",
                                       "--on_anomaly", "rollback"])):
        ck = os.path.join(tmp, f"rb_{label}")
        tap = _LogTap()
        logging.getLogger("dtx.trainer").addHandler(tap)
        tr = _rest_trainer(["--optimizer", "adamw", "--train_steps", "30",
                            "--log_every_steps", "5"]
                           + (["--ckpt_dir", ck, "--save_steps", "10"]
                              + extra if extra else []),
                           arrays_fn=_float_mask)
        read = _reset_launches()
        try:
            with tr:
                state, summary = tr.train()
        finally:
            logging.getLogger("dtx.trainer").removeHandler(tap)
        launches = read()
        replayed = 5 if extra else 0       # steps 11-15 again
        if launches != _rest_want(30 + replayed):
            failed.append(f"(c) {label}: launches {launches}")
        finals[label] = (state, summary, [x for x in tap.lines
                                          if "rollback" in x])
        shutil.rmtree(ck, ignore_errors=True)
    s_ref, _, _ = finals["uninterrupted"]
    s_rb, sum_rb, lines = finals["rollback"]
    from distributed_tensorflow_example_tpu_torch.utils.pytree import \
        flatten_dict
    ref_p, rb_p = flatten_dict(s_ref.params), flatten_dict(s_rb.params)
    unequal = [k for k in ref_p if not torch.equal(ref_p[k], rb_p[k])]
    count = int(sum_rb["final_metrics"]["anomaly_count"])
    log(f"[{tag} (c)] rollback: {lines}; final step {s_rb.step}, "
        f"anomaly_count {count}; params torch.equal to the uninterrupted "
        f"run's: {not unequal} ({len(unequal)} leaves differ)")
    if count != 1 or s_rb.step != 30 or not any(
            "restored verified checkpoint step 10" in x for x in lines):
        failed.append(f"(c) rollback: {lines}, anomaly_count {count}")
    if unequal:
        worst = max(float((ref_p[k] - rb_p[k]).abs().max())
                    for k in unequal)
        failed.append(f"(c) {len(unequal)} leaves differ from the "
                      f"uninterrupted run's (worst {worst:.3e}): "
                      f"{unequal[:3]}")

    # (e) the observability sinks
    obs = os.path.join(tmp, "obs")
    tb, prof = os.path.join(obs, "tb"), os.path.join(obs, "prof")
    trace_path = os.path.join(obs, "trace.json")
    metrics = os.path.join(obs, "m.jsonl")
    t0 = time.perf_counter()
    _, _, recs, _ = _cli_run(
        REST_ARGV + ["--optimizer", "adamw", "--train_steps", "20",
                     "--log_every_steps", "5", "--metrics_path", metrics,
                     "--tb_logdir", tb, "--summary_every_steps", "5",
                     "--param_histograms_every_steps", "20",
                     "--step_timing", "--profile_dir", prof,
                     "--profile_steps", "5,6", "--trace_path", trace_path],
        "(e) sinks", failed, card, tag=tag, want=_rest_want(20))
    wall = time.perf_counter() - t0
    timing = [r for r in recs if "step_timing_ms" in r]
    events, = [os.path.join(tb, f) for f in os.listdir(tb)]
    n_records = sum(1 for _ in tb_events.read_records(events))
    scalars = tb_events.read_scalars(events)
    with open(os.path.join(prof, "trace-steps-5-6.json")) as f:
        prof_events = json.load(f)["traceEvents"]
    with open(trace_path) as f:
        lanes = {e["args"]["name"] for e in json.load(f)["traceEvents"]
                 if e["name"] == "thread_name"}
    log(f"[{tag} (e)] {wall:.1f} s; event file {n_records} records, every "
        f"CRC checked, {len(scalars)} scalars; step-timing records "
        f"{len(timing)} ("
        + ", ".join(f"step {r['step']}: n {r['step_timing_ms']['n']}, p50 "
                    f"{r['step_timing_ms']['p50']:.2f} ms"
                    for r in timing)
        + f"); profiler trace {len(prof_events)} events; trace lanes "
        f"{sorted(lanes)} ({card})")
    if len(timing) != 4 or sum(r["step_timing_ms"]["n"]
                               for r in timing) != 19:
        failed.append(f"(e) step-timing records {timing}")
    if not any(t == "loss" for _, t, _, _ in scalars) or not prof_events \
            or lanes != {"data", "step"}:
        failed.append(f"(e) sinks: {len(scalars)} scalars, "
                      f"{len(prof_events)} profiler events, lanes {lanes}")
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise SystemExit("the train-rest phase failed: " + "; ".join(failed))


# ---------------------------------------------------------------------------
# speculative verify, chunked prefill and the SLO knobs (slice A2c)
# ---------------------------------------------------------------------------

SPEC_K = 4
CHUNK_TOKENS = 128
#: the verify step's written K/V, kernel path against plain path, per
#: (slot, layer) row of H*D values: layer 0's rows are bitwise equal (the
#: same inputs); a deeper layer's come from hidden states that already
#: went through the attention of the layers below it, where the kernel
#: and the plain version round the bf16 probabilities differently (a
#: couple of bf16 ulps of an output, DECODE_ROW_REL_TOL's reasoning), so
#: the limit is a few ulps of the row's largest value
VERIFY_KV_ROW_REL_TOL = 5e-2


class _StallRecorder:
    """Stands in for an engine's ``serving_decode_stall_seconds``
    histogram: keeps every observed gap (the registry keeps only bucket
    counts) and passes it on."""

    def __init__(self, hist):
        self.hist = hist
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(v)
        self.hist.observe(v)


def _repeating_prompts(rs, vocab: int) -> list:
    """8 ragged prompts built of a short random pattern repeated, so that
    prompt lookup finds n-grams to draft from."""
    out = []
    for _ in range(ENGINE_SLOTS):
        pattern = rs.randint(0, vocab, (int(rs.randint(4, 33)),))
        n = int(rs.randint(PROMPT_LEN // 4, PROMPT_LEN + 1))
        out.append(np.resize(pattern, n).astype(np.int32))
    return out


def _verify_program(model, params, gen, card: str) -> None:
    """(a) The verify step alone on 8 rows x 4 lanes (one row at width 2,
    one at width 1) over pools of the engine's geometry: B5 (or B6 over
    int8 pools) at the expanded shape, 32 query rows sharing 8 tables,
    against its plain version; then the whole step through the kernels
    against the plain attention: exact launches (12 a dispatch), live
    lanes' logits, every slot no live lane writes bitwise unchanged,
    layer 0's written rows bitwise equal, deeper layers' to
    VERIFY_KV_ROW_REL_TOL."""
    from distributed_tensorflow_example_tpu_torch.models.gpt import \
        quantize_kv_rows
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        paged_decode_attention as pa
    c, dev = model.cfg, torch.device("cuda")
    hd = c.hidden // c.heads
    b, bs = ENGINE_SLOTS, PAGED_SHAPE["bs"]
    nb = -(-(PROMPT_LEN + MAX_NEW) // bs)
    n = 1 + b * nb
    bt = ((torch.randperm(n - 1, generator=gen) + 1)[:b * nb]
          .reshape(b, nb).to(torch.int32))
    pos = torch.randint(PROMPT_LEN // 4, PROMPT_LEN + MAX_NEW - SPEC_K,
                        (b,), generator=gen, dtype=torch.int32)
    n_tok = torch.tensor([4, 4, 4, 2, 1, 4, 4, 4], dtype=torch.int32)
    tok = torch.randint(0, c.vocab_size, (b, SPEC_K), generator=gen,
                        dtype=torch.int32)
    pad = torch.zeros(b, dtype=torch.int32)
    alive = torch.ones(b, dtype=torch.int32)
    written = torch.zeros((n, bs), dtype=torch.bool)
    for r in range(b):
        for j in range(int(n_tok[r])):
            p = int(pos[r]) + j
            written[int(bt[r, p // bs]), p % bs] = True
    written = written.to(dev)
    stacked = model.stack_decode_params(params)
    shape = (c.layers, n, bs, c.heads, hd)
    kf, vf = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
              for _ in range(2))
    rows = (bt.repeat_interleave(SPEC_K, 0).contiguous().to(dev),
            (pos[:, None] + torch.arange(SPEC_K)).reshape(-1).to(dev),
            torch.zeros(b * SPEC_K, dtype=torch.int32, device=dev))
    args = [t.to(dev) for t in (bt, tok, pos, pad, alive, n_tok)]
    for quant in (False, True):
        name = "paged_decode_attention" + ("_int8" if quant else "")
        if quant:
            (kq, ks), (vq, vs) = quantize_kv_rows(kf), quantize_kv_rows(vf)
            pools = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            pools = {"k": kf, "v": vf}
        sc = ({"k_scale": pools["k_scale"][0], "v_scale": pools["v_scale"][0]}
              if quant else {})
        q = torch.randn((b * SPEC_K, c.heads, hd), generator=gen).to(
            dev, torch.bfloat16)
        kw = dict(block_tables=rows[0], pos=rows[1], pad=rows[2], **sc)
        o = pa.paged_decode_attention(q, pools["k"][0], pools["v"][0], **kw)
        o_ref = pa.xla_paged_decode_attention(q, pools["k"][0],
                                              pools["v"][0], **kw)
        r_attn = row_rel_err(o, o_ref)
        tol = PAGED_INT8_ROW_REL_TOL if quant else PAGED_ROW_REL_TOL
        pk = {k: v.clone() for k, v in pools.items()}
        pp = {k: v.clone() for k, v in pools.items()}
        torch.cuda.synchronize()
        read = _reset_launches()
        lg_k, _ = model.decode_verify_batched_paged(params, stacked, pk,
                                                    *args)
        torch.cuda.synchronize()
        launches = read()
        lg_p, _ = model.decode_verify_batched_paged(
            params, stacked, pp, *args, decode_attention="xla")
        torch.cuda.synchronize()
        want = {k: 0 for k in launches}
        want[name] = c.layers
        lane = torch.arange(SPEC_K)[None, :] < n_tok[:, None]
        lerr = (lg_k - lg_p).abs()[lane.to(dev)].max().item()
        same_rest = all(
            torch.equal(x[:, ~written], pools[k][:, ~written])
            for d in (pk, pp) for k, x in d.items())
        same_l0 = all(torch.equal(pk[k][0][written], pp[k][0][written])
                      for k in pk)

        def rows_of(d, k):
            x = d[k][1:][:, written]                 # [L-1, W, H, D]
            if quant:
                s = d[k + "_scale"][1:][:, written]
                x = x.float() * s[..., None, None]
            return x.float().reshape(-1, c.heads * hd)

        kv_rel = max(row_rel_err(rows_of(pk, k), rows_of(pp, k))
                     for k in ("k", "v"))
        log(f"[spec verify {'int8' if quant else 'bf16'}] {name} at the "
            f"verify shape ({b} x {SPEC_K} = {b * SPEC_K} query rows over "
            f"{b} tables): worst row {r_attn:.3e} (tol {tol}); the verify "
            f"step through the kernels vs the plain attention: launches "
            f"{launches} (want {c.layers} of {name}), live lanes' logits "
            f"max abs err {lerr:.3e} (tol {ENGINE_LOGIT_TOL}), unwritten "
            f"slots bitwise unchanged {same_rest}, layer-0 written rows "
            f"bitwise equal {same_l0}, deeper layers' written rows worst "
            f"{kv_rel:.3e} (tol {VERIFY_KV_ROW_REL_TOL}) ({card})")
        if (r_attn > tol or launches != want or lerr > ENGINE_LOGIT_TOL
                or not same_rest or not same_l0
                or kv_rel > VERIFY_KV_ROW_REL_TOL):
            raise SystemExit(f"the verify step disagrees on {name}")
        del pk, pp, pools
    del kf, vf


def _dispatch_costs(model, params, gen, card: str) -> dict:
    """What one engine dispatch costs on its own, outside a wave: an
    8-row decode step, an 8 x 4 verify step, the last 128-token chunk of
    a 512-token prompt (its window the prompt's 32 blocks) and the whole
    512-token paged prefill, on bf16 pools of the engine's geometry. For
    each, the wall time of one call and its sync (median of 20: the stall
    a live decoder sees), the device time of one call (:func:`device_ms`)
    and the three kernels that take most of it."""
    c, dev = model.cfg, torch.device("cuda")
    hd = c.hidden // c.heads
    b, bs = ENGINE_SLOTS, PAGED_SHAPE["bs"]
    nb = -(-(PROMPT_LEN + MAX_NEW) // bs)
    n = 1 + b * nb
    bt = ((torch.randperm(n - 1, generator=gen) + 1).reshape(b, nb)
          .to(dev, torch.int32))
    pos = torch.randint(PROMPT_LEN // 4, PROMPT_LEN + MAX_NEW - SPEC_K,
                        (b,), generator=gen, dtype=torch.int32).to(dev)
    tok = torch.randint(0, c.vocab_size, (b, SPEC_K), generator=gen,
                        dtype=torch.int32).to(dev)
    pad = torch.zeros(b, dtype=torch.int32, device=dev)
    alive = torch.ones(b, dtype=torch.int32, device=dev)
    n_tok = torch.full((b,), SPEC_K, dtype=torch.int32, device=dev)
    shape = (c.layers, n, bs, c.heads, hd)
    pools = {k: torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
             for k in ("k", "v")}
    stacked = model.stack_decode_params(params)
    ids = torch.randint(0, c.vocab_size, (1, PROMPT_LEN),
                        generator=gen).to(dev)
    mask = torch.ones_like(ids)
    row = bt[0, :PROMPT_LEN // bs]
    start = PROMPT_LEN - CHUNK_TOKENS
    calls = {
        "decode": lambda: model.decode_step_batched_paged(
            params, stacked, pools, bt, tok[:, 0], pos, pad, alive),
        "verify": lambda: model.decode_verify_batched_paged(
            params, stacked, pools, bt, tok, pos, pad, alive, n_tok),
        "chunk": lambda: model.paged_prefill_chunk(
            params, ids[:, start:], mask[:, start:], start, pools["k"],
            pools["v"], row, row[start // bs:]),
        "prefill": lambda: model.paged_prefill(
            params, ids, mask, pools["k"], pools["v"], row),
    }
    what = {"decode": f"decode step ({b} rows)",
            "verify": f"verify step ({b} x {SPEC_K} rows)",
            "chunk": f"{CHUNK_TOKENS}-token chunk at slot {start}",
            "prefill": f"{PROMPT_LEN}-token paged prefill"}
    out = {}
    with torch.no_grad():
        for key, fn in calls.items():
            walls = []
            for i in range(24):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i >= 4:
                    walls.append(time.perf_counter() - t0)
            parts: dict = {}
            dev_ms = device_ms(fn, [()], iters=8, warmup=1, by_kernel=parts)
            wall = float(np.median(walls)) * 1e3
            top = ", ".join(f"{k[:48]} {v:.3f}" for k, v in sorted(
                parts.items(), key=lambda kv: -kv[1])[:3])
            log(f"[spec dispatch] {what[key]}: wall {wall:.3f} ms a call "
                f"(median of {len(walls)}), device {dev_ms:.3f} ms, device "
                f"idle share {1 - dev_ms / wall:.3f}; largest kernels (ms): "
                f"{top} ({card})")
            out[key] = {"wall": wall, "device": dev_ms}
    log(f"[spec dispatch] verify over decode: wall "
        f"{out['verify']['wall'] / out['decode']['wall']:.3f}x, device "
        f"{out['verify']['device'] / out['decode']['device']:.3f}x; one "
        f"chunk over the whole prefill: wall "
        f"{out['chunk']['wall'] / out['prefill']['wall']:.3f}x, device "
        f"{out['chunk']['device'] / out['prefill']['device']:.3f}x ({card})")
    del pools
    return out


def _spec_wave(srv, label: str, prompts: list, card: str,
               layers: int) -> dict:
    """One wave of concurrent greedy requests through ``srv``, with every
    kernel's launch count set to 0 just before it and read just after,
    and the engine's counters over the same window; the paged kernel must
    have run 12 launches a shared dispatch (B5, or B6 on an int8 pool),
    and the flash forward 12 a monolithic prefill."""
    eng = srv.engine
    keys = ("decode_steps", "verify_steps", "spec_proposed", "spec_accepted",
            "prefills", "prefill_chunks", "tokens_out")
    s0 = eng.stats()
    n = len(prompts)
    results, lat = [None] * n, [0.0] * n
    torch.cuda.synchronize()
    read = _reset_launches()
    wall = _post_rows(srv, prompts, results, lat)
    launches = read()
    s1 = eng.stats()
    d = {k: s1[k] - s0[k] for k in keys}
    steps = d["decode_steps"] + d["verify_steps"]
    kernel = ("paged_decode_attention_int8"
              if eng.sw.kv_cache_dtype == "int8"
              else "paged_decode_attention")
    want = {k: 0 for k in launches}
    want[kernel] = layers * steps
    want["flash_attention_fwd"] = layers * d["prefills"]
    toks = sum(len(r) for r in results)
    rate = d["spec_accepted"] / max(d["spec_proposed"], 1)
    log(f"[spec {label}] {n} concurrent requests: {d['prefills']} "
        f"prefills, {d['prefill_chunks']} prefill chunks, "
        f"{d['decode_steps']} decode + {d['verify_steps']} verify "
        f"dispatches, drafts proposed {d['spec_proposed']} accepted "
        f"{d['spec_accepted']} (accept rate {rate:.4f}); launches "
        f"{launches}; wave {wall * 1e3:.1f} ms, {toks / wall:.1f} tokens/s, "
        f"wave average {wall / max(steps, 1) * 1e3:.2f} ms per shared "
        f"dispatch (prefills and HTTP included), latency "
        f"p50 {sorted(lat)[n // 2] * 1e3:.1f} ms ({card})")
    if launches != want:
        raise SystemExit(f"spec {label}: launches {launches}, want {want}")
    for out in results:
        if len(out) != MAX_NEW:
            raise SystemExit(f"spec {label}: bad generation {out[:8]}...")
    return {"results": results, "launches": launches, "steps": steps,
            "wall": wall, "toks": toks, "accept_rate": rate, **d}


def _stall_run(srv, shorts: list, long_prompt, card: str,
               label: str) -> dict:
    """(c) 7 short requests decode; once all 7 are live, the 512-token
    prompt arrives. Returns the largest decode stall any live slot saw
    from its arrival on (the gaps between shared dispatches), the prefill
    chunks its admission took, and every request's tokens."""
    import threading
    eng = srv.engine
    rec = _StallRecorder(eng._h_decode_stall)
    eng._h_decode_stall = rec
    results, lat = [None] * len(shorts), [0.0] * len(shorts)
    toks0 = eng.stats()["tokens_out"]
    t = threading.Thread(target=_post_rows,
                         args=(srv, shorts, results, lat))
    t.start()
    t0 = time.monotonic()
    while eng.stats()["live_slots"] < len(shorts) \
            or eng.stats()["tokens_out"] - toks0 < 4 * len(shorts):
        if time.monotonic() - t0 > 120:
            raise SystemExit(f"stall {label}: the short requests never "
                             "all went live")
        time.sleep(0.002)
    s0 = eng.stats()
    rec.samples.clear()
    body, sec = post(srv.port, srv.name,
                     {"inputs": {"input_ids": [long_prompt.tolist()]}})
    t.join(600)
    s1 = eng.stats()
    chunks = s1["prefill_chunks"] - s0["prefill_chunks"]
    prefills = s1["prefills"] - s0["prefills"]
    worst = max(rec.samples)
    log(f"[spec stall {label}] a {long_prompt.size}-token prompt admitted "
        f"while {len(shorts)} slots decode: {prefills} prefills, {chunks} "
        f"prefill chunks; serving_decode_stall_seconds max "
        f"{worst * 1e3:.2f} ms, p50 {np.median(rec.samples) * 1e3:.2f} ms "
        f"over {len(rec.samples)} gaps; its latency {sec * 1e3:.1f} ms "
        f"({card})")
    return {"results": results + [body["generations"][0]], "max": worst,
            "chunks": chunks, "prefills": prefills}


def phase_spec_chunk(card: str) -> dict:
    """Speculative verify and chunked prefill on GPT-small at full width
    (bf16, flash prefill, 16-slot paged blocks, prompts up to 512, 128 new
    tokens, 8 slots), exported with ``spec_tokens=4`` and
    ``prefill_chunk=128``: (a) the verify step alone, kernel against
    plain, float and int8 pools, and each kind of dispatch's own wall and
    device time (:func:`_dispatch_costs`); (b) 8 concurrent greedy requests over
    HTTP, spec on against off; (c) a 512-token prompt admitted while 7
    slots decode, chunked against monolithic; (d) spec on int8 pools;
    (e) an infeasible ``deadline_ms`` answered 429. Returns the B5 and B6
    launches of the spec-on waves."""
    import urllib.error
    from distributed_tensorflow_example_tpu_torch.config import TrainConfig
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.serving import \
        export_generator
    from distributed_tensorflow_example_tpu_torch.serving_http import \
        PredictServer

    t_phase = time.perf_counter()
    cfg = TrainConfig(model="gpt", dtype="bfloat16", attention_impl="flash")
    model = get_model("gpt", cfg)
    c = model.cfg
    params = model.init(0)
    gen = torch.Generator().manual_seed(7)
    _verify_program(model, params, gen, card)
    costs = _dispatch_costs(model, params, gen, card)
    bs = PAGED_SHAPE["bs"]
    per_row = -(-(PROMPT_LEN + MAX_NEW) // bs)
    num_blocks = 1 + 2 * ENGINE_SLOTS * per_row
    rs = np.random.RandomState(5)
    prompts = _repeating_prompts(rs, c.vocab_size)
    shorts = [rs.randint(0, c.vocab_size, (int(rs.randint(32, 97)),))
              .astype(np.int32) for _ in range(ENGINE_SLOTS - 1)]
    long_prompt = rs.randint(0, c.vocab_size, (PROMPT_LEN,)).astype(np.int32)
    warm = [rs.randint(0, c.vocab_size, (PROMPT_LEN,)).astype(np.int32)]
    kw = dict(prompt_len=PROMPT_LEN, max_new_tokens=MAX_NEW, ragged=True,
              stepwise=True, slots=ENGINE_SLOTS, paged=True, block_size=bs,
              num_blocks=num_blocks, spec_tokens=SPEC_K,
              prefill_chunk=CHUNK_TOKENS)
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        d, d8 = os.path.join(tmp, "spec"), os.path.join(tmp, "spec_int8")
        export_generator(model, params, d, **kw)
        export_generator(model, params, d8, kv_cache_dtype="int8", **kw)
        waves = {}
        for label, spec in (("off", 0), ("on", SPEC_K)):
            with PredictServer(d, scheduler="on", port=0, prefix_cache=False,
                               spec_tokens=spec) as srv:
                _post_rows(srv, warm, [None], [0.0])            # warm-up
                waves[label] = _spec_wave(srv, f"bf16 spec {label}", prompts,
                                          card, c.layers)
                if spec:
                    # (e) the decode EMA is seeded: a deadline the measured
                    # rate cannot meet is shed now, 429 + Retry-After
                    try:
                        post(srv.port, srv.name, {"inputs": {
                            "input_ids": [prompts[0].tolist()]},
                            "deadline_ms": 50})
                        raise SystemExit("an infeasible deadline_ms was "
                                         "served")
                    except urllib.error.HTTPError as e:
                        err = json.loads(e.read()).get("error", "")
                        ra = e.headers.get("Retry-After")
                        log(f"[spec deadline] deadline_ms 50 for {MAX_NEW} "
                            f"tokens: HTTP {e.code}, Retry-After {ra} s: "
                            f"{err[:90]} ({card})")
                        if e.code != 429 or ra is None or "shed" not in err:
                            raise SystemExit("an infeasible deadline was "
                                             "not shed with 429")
                    shed = srv.engine.stats()["shed_infeasible"]
                    if shed != 1:
                        raise SystemExit(f"shed_infeasible {shed}, want 1")
        on, off = waves["on"], waves["off"]
        agree = _agreement(on["results"], off["results"])
        log(f"[spec] bf16 spec on vs off: greedy token agreement "
            f"{agree:.4f} (floor {ENGINE_AGREEMENT_FLOOR}), accept rate "
            f"{on['accept_rate']:.4f}, shared dispatches {on['steps']} vs "
            f"{off['steps']}, tokens/s {on['toks'] / on['wall']:.1f} vs "
            f"{off['toks'] / off['wall']:.1f}, wave average ms per shared "
            f"dispatch "
            f"{on['wall'] / on['steps'] * 1e3:.2f} vs "
            f"{off['wall'] / off['steps'] * 1e3:.2f} ({card})")
        if agree < ENGINE_AGREEMENT_FLOOR or on["verify_steps"] < 1 \
                or on["spec_accepted"] < 1:
            raise SystemExit("speculative decoding did not verify drafts "
                             "or disagrees with spec off")
        stalls = {}
        for label, chunk in (("monolithic", 0), ("chunked", CHUNK_TOKENS)):
            with PredictServer(d, scheduler="on", port=0, prefix_cache=False,
                               prefill_chunk_tokens=chunk) as srv:
                _post_rows(srv, warm, [None], [0.0])            # warm-up
                stalls[label] = _stall_run(srv, shorts, long_prompt, card,
                                           label)
        mono, chunked = stalls["monolithic"], stalls["chunked"]
        cagree = _agreement(chunked["results"], mono["results"])
        want_chunks = -(-PROMPT_LEN // CHUNK_TOKENS)
        log(f"[spec stall] max decode stall chunked {chunked['max'] * 1e3:.2f}"
            f" ms vs monolithic {mono['max'] * 1e3:.2f} ms; chunks for the "
            f"long prompt {chunked['chunks']} (want {want_chunks}); greedy "
            f"token agreement chunked vs monolithic {cagree:.4f} (floor "
            f"{ENGINE_AGREEMENT_FLOOR}) ({card})")
        if (chunked["chunks"] != want_chunks or chunked["prefills"]
                or mono["chunks"] or mono["prefills"] != 1
                or cagree < ENGINE_AGREEMENT_FLOOR):
            raise SystemExit("chunked prefill did not run as asked, or "
                             "disagrees with the monolithic prefill")
        with PredictServer(d8, scheduler="on", port=0, prefix_cache=False,
                           spec_tokens=SPEC_K) as srv:
            _post_rows(srv, warm, [None], [0.0])                # warm-up
            q8 = _spec_wave(srv, "int8 KV spec on", prompts, card, c.layers)
        qagree = _agreement(q8["results"], off["results"])
        log(f"[spec int8] int8 KV spec on vs bf16 spec off: greedy token "
            f"agreement {qagree:.4f} (floor {INT8_MIN_AGREEMENT}, the int8 "
            f"drift gate) ({card})")
        if qagree < INT8_MIN_AGREEMENT or q8["verify_steps"] < 1:
            raise SystemExit("int8 speculation failed its drift gate")
    out.update(b5=on["launches"]["paged_decode_attention"],
               b6=q8["launches"]["paged_decode_attention_int8"],
               accept_rate=on["accept_rate"], stall_mono=mono["max"],
               stall_chunked=chunked["max"], dispatch=costs)
    log(f"[spec] phase done in {time.perf_counter() - t_phase:.1f} s "
        f"({card})")
    return out


# ---------------------------------------------------------------------------
# training's debug tools (slice A3c-4b)
# ---------------------------------------------------------------------------

def _gpt_train_flops(c, b: int, s: int) -> tuple[float, float]:
    """(all matmul FLOPs of one training step, the attention products'
    share of them) of GPT on [b, s]: three times the forward's (the
    backward takes two products a product), the attention over all s²
    pairs as the plain path computes it."""
    n = b * s
    attn = c.layers * 2 * 2 * b * s * s * c.hidden
    fwd = (c.layers * (2 * n * c.hidden * 4 * c.hidden
                       + 2 * 2 * n * c.hidden * c.intermediate)
           + 2 * n * c.hidden * c.vocab_size + attn)
    return 3.0 * fwd, 3.0 * attn


def phase_debug_tools(card: str) -> None:
    """GPT-small through ``cli/train.py`` with the debug tools:
    ``--debug_checks`` under a ``step.nan`` fault raises naming the step
    and the leaf; ``--step_timing`` runs with and without
    ``--debug_checks`` (the checks' cost a step; the step's counted FLOPs
    beside the closed form, whose gap is the flash kernels' products,
    which ``FlopCounterMode`` cannot see through ``ctypes``); a few steps
    under ``--debug_nans``; one capture through ``--profiler_port``."""
    import socket
    import threading
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    from distributed_tensorflow_example_tpu_torch.models import get_model
    t_phase = time.perf_counter()
    # ``step.nan`` poisons the one float leaf, the mask (as in
    # phase_train_rest's rollback)
    t = _rest_trainer(["--train_steps", "4", "--debug_checks",
                       "--log_every_steps", "0", "--fault_spec",
                       "step.nan:step=3"], arrays_fn=_float_mask)
    try:
        with t:
            t.train()
        raise SystemExit("--debug_checks let a NaN step through")
    except FloatingPointError as e:
        msg = str(e)
    log(f"[debug checks] step.nan at step 3: FloatingPointError: "
        f"{msg[:200]} ({card})")
    if "at step 3 in " not in msg or "grads/" not in msg:
        raise SystemExit("--debug_checks did not name the step and leaf")
    steps, every = 12, 11
    timing = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra in (("plain", []), ("debug_checks",
                                             ["--debug_checks"])):
            path = os.path.join(tmp, f"{label}.jsonl")
            read = _reset_launches()
            rc = cli.main(REST_ARGV + [
                "--train_steps", str(steps), "--step_timing",
                "--log_every_steps", str(every), "--metrics_path", path]
                + extra)
            launches = read()
            recs = [json.loads(line) for line in open(path)]
            rec = [r for r in recs if "step_timing_ms" in r][0]
            timing[label] = rec
            want = _rest_want(steps)
            log(f"[debug timing {label}] step p50 "
                f"{rec['step_timing_ms']['p50']:.2f} ms (n "
                f"{rec['step_timing_ms']['n']}); launches {launches} "
                f"({card})")
            if rc != 0 or launches != want:
                raise SystemExit(f"{label} run: rc {rc}, launches "
                                 f"{launches}, want {want}")
    flops = timing["plain"]["step_cost_analysis"]["flops"]
    model = get_model("gpt", cli.config_from_args(
        cli.build_parser().parse_args(REST_ARGV)))
    total, attn = _gpt_train_flops(model.cfg, TRAIN_B, TRAIN_S)
    gap = abs(flops - (total - attn)) / (total - attn)
    p_plain = timing["plain"]["step_timing_ms"]["p50"]
    p_chk = timing["debug_checks"]["step_timing_ms"]["p50"]
    log(f"[debug cost] step_cost_analysis flops {flops:.6e} beside the "
        f"closed form {total:.6e}, of which the attention products "
        f"{attn:.6e} (run by the flash kernels, which the counter cannot "
        f"see through ctypes): counted vs closed form less attention "
        f"{gap:.2e} (tol 1e-2); --debug_checks costs "
        f"{p_chk - p_plain:.2f} ms a step ({p_chk:.2f} vs {p_plain:.2f} "
        f"ms p50) ({card})")
    if gap > 1e-2:
        raise SystemExit("step_cost_analysis does not match the closed "
                         "form less the attention products")
    t0 = time.perf_counter()
    rc = cli.main(REST_ARGV + ["--train_steps", "3", "--debug_nans",
                               "--log_every_steps", "0"])
    nan_s = time.perf_counter() - t0
    log(f"[debug nans] 3 GPT-small steps and the eval under --debug_nans: "
        f"rc {rc}, {nan_s:.1f} s; anomaly mode after the run "
        f"{torch.is_anomaly_enabled()} ({card})")
    if rc != 0 or torch.is_anomaly_enabled():
        raise SystemExit("--debug_nans run failed or left anomaly mode on")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as prof:
        done = {}
        th = threading.Thread(target=lambda: done.update(rc=cli.main(
            REST_ARGV + ["--train_steps", "10", "--log_every_steps", "0",
                         "--profiler_port", str(port), "--profile_dir",
                         prof])))
        th.start()
        t0 = time.monotonic()
        while True:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                       timeout=5).read()
                break
            except OSError:
                if time.monotonic() - t0 > 120:
                    raise SystemExit("the profiler listener never came up")
                time.sleep(0.01)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/capture?steps=2&timeout_s=300",
            data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            got = json.loads(r.read())
        th.join(600)
        with open(got["path"]) as f:
            events = json.load(f)["traceEvents"]
        marks = sorted({e["name"] for e in events
                        if e.get("name", "").startswith("train_step#")})
        kernels = [e for e in events if e.get("cat") == "kernel"]
        log(f"[debug profiler] POST /capture?steps=2 on port {port}: steps "
            f"{got['steps']}, marks {marks}, {len(events)} events, "
            f"{len(kernels)} device kernels; run rc {done.get('rc')} "
            f"({card})")
        if done.get("rc") != 0 or len(marks) != 2:
            raise SystemExit("the profiler capture did not trace 2 steps")
    log(f"[debug] phase done in {time.perf_counter() - t_phase:.1f} s "
        f"({card})")


# ---------------------------------------------------------------------------
# a single server's HTTP and operator surface (slice A4a)
# ---------------------------------------------------------------------------

# BERT-base :predict, flash (B1 non-causal) against the plain attention on
# the same export and rows, bf16: the largest |logit difference| over the
# batch, against the logits' spread (set before the first run at GPT-small's
# LOGIT_TOL: both carry bf16 attention rounding through 12 layers)
PREDICT_BERT_LOGIT_TOL = 0.1
# the :predict shapes: BERT-base 64 rows x 128 tokens a wave, eight clients
# of eight rows, one masked position a row (the [rows, 1, 30522] f32 logits
# are what the JSON answer carries)
PREDICT_BERT_B, PREDICT_BERT_S, PREDICT_BERT_M = 64, 128, 1
PREDICT_BERT_WAVES = 2
# the ops phase's GPT-small engine: prompts up to 128, 64 new tokens, 8 slots
OPS_PROMPT, OPS_NEW, OPS_SLOTS = 128, 64, 8


def http_json(port: int, path: str, payload=None, method: str = "GET",
              headers: dict | None = None, timeout: float = 600
              ) -> tuple[int, object, dict]:
    """(status, parsed body, headers) of one request to the local server;
    HTTP errors are answers too."""
    import urllib.error
    data = None if payload is None else json.dumps(payload).encode()
    if method == "POST" and data is None:
        data = b""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, code, hdr = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, code, hdr = e.read(), e.code, dict(e.headers)
    text = raw.decode()
    try:
        return code, json.loads(text), hdr
    except ValueError:
        return code, text, hdr


def _concurrent(n: int, fn) -> tuple[list, list, float]:
    """Run ``fn(i)`` for i < n on n threads at once: (results, seconds
    each, wall seconds). Raises on any failure."""
    import threading
    out, sec, errors = [None] * n, [0.0] * n, []

    def worker(i):
        t0 = time.perf_counter()
        try:
            out[i] = fn(i)
        except Exception as e:
            errors.append(f"{i}: {type(e).__name__}: {e}")
        sec[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"concurrent requests failed: {errors[:4]}")
    return out, sec, wall


class _RecordingServable:
    """Wraps the batcher's servable: every batch it runs (the padded
    feature columns and the logits) is kept, so each answer can be held
    bitwise to a replay of its own batch."""

    def __init__(self, servable):
        self.inner, self.batches = servable, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, cols):
        preds = self.inner(cols)
        self.batches.append(({k: np.array(v) for k, v in cols.items()},
                             np.array(preds)))
        return preds


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _predict_mlp(tmp: str, card: str) -> dict:
    """(a) The source's workload trained, exported and served: MLP through
    ``cli/train.py --export_dir``, 16 concurrent ``:predict`` clients of
    1-8 rows through the MicroBatcher."""
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    from distributed_tensorflow_example_tpu_torch.serving import \
        load_servable
    from distributed_tensorflow_example_tpu_torch.serving_http import \
        PredictServer
    d = os.path.join(tmp, "mlp_export")
    t0 = time.perf_counter()
    rc = cli.main(["--model", "mlp", "--device", "cuda", "--batch_size",
                   "256", "--learning_rate", "0.5", "--train_steps", "200",
                   "--log_every_steps", "100", "--export_dir", d])
    log(f"[http mlp] cli.train --model mlp 200 steps + --export_dir: rc "
        f"{rc} in {time.perf_counter() - t0:.1f} s; artifact "
        f"{sorted(os.listdir(d))}")
    if rc != 0 or not os.path.exists(os.path.join(d, "export.json")):
        raise SystemExit("the MLP run did not export its forward")
    rs = np.random.RandomState(11)
    rows = [rs.rand(int(rs.randint(1, 9)), 784).astype(np.float32)
            for _ in range(16)]
    offline = load_servable(d)
    with PredictServer(d, scheduler="on", port=0) as srv:
        rec = _RecordingServable(srv.batcher.servable)
        srv.batcher.servable = rec
        path = f"/v1/models/{srv.name}:predict"
        http_json(srv.port, path, {"instances": rows[0].tolist()},
                  "POST")                                       # warm-up
        rec.batches.clear()
        b0 = srv.batcher.stats()
        read = _reset_launches()

        def client(i):
            code, body, _ = http_json(srv.port, path,
                                      {"inputs": {"x": rows[i].tolist()}},
                                      "POST")
            if code != 200:
                raise RuntimeError(f"HTTP {code}: {body}")
            return np.asarray(body["predictions"], np.float32)

        answers, sec, wall = _concurrent(len(rows), client)
        launches = read()
        st = srv.batcher.stats()
    n_rows = sum(len(r) for r in rows)
    batches = st["batches"] - b0["batches"]
    padded = st["padded_rows"] - b0["padded_rows"]
    # place each request in the batch that ran it: its rows at some offset
    # of the batch's columns, its answer bitwise those rows of the logits
    real = [0] * len(rec.batches)
    placed = 0
    for x, ans in zip(rows, answers):
        for j, (cols, preds) in enumerate(rec.batches):
            xs = cols["x"]
            off = next((o for o in range(len(xs) - len(x) + 1)
                        if np.array_equal(xs[o:o + len(x)], x)), None)
            if off is not None:
                real[j] += len(x)
                placed += np.array_equal(preds[off:off + len(x)], ans)
                break
    buckets_ok = all(len(cols["x"]) == _bucket(k)
                     for k, (cols, _) in zip(real, rec.batches))
    replay = all(np.array_equal(offline(cols), preds)
                 for cols, preds in rec.batches)
    solo = max(float(np.abs(offline({"x": x}) - ans).max())
               for x, ans in zip(rows, answers))
    bitwise = placed == len(rows) and replay and buckets_ok
    pad_want = sum(_bucket(k) - k for k in real)
    lat = sorted(sec)
    log(f"[http mlp] 16 concurrent :predict clients, {n_rows} rows: "
        f"{batches} micro-batches (recorded {len(rec.batches)}, real rows "
        f"{real}), rows {st['rows'] - b0['rows']}, padded rows {padded} "
        f"(want {pad_want}); answers bitwise the offline servable's on "
        f"their own batch: {placed}/{len(rows)}, replays bitwise: "
        f"{replay}; against one-request offline calls max abs err "
        f"{solo:.3e}; request latency p50 {lat[len(lat) // 2] * 1e3:.2f} "
        f"ms max {lat[-1] * 1e3:.2f} ms, {n_rows / wall:.1f} rows/s; "
        f"batcher p50 {st['latency_p50_ms']} ms; launches {launches} "
        f"({card})")
    if (not bitwise or batches != len(rec.batches)
            or st["rows"] - b0["rows"] != n_rows or sum(real) != n_rows
            or padded != pad_want or any(launches.values()) or solo > 1e-4):
        raise SystemExit("MicroBatcher :predict of the MLP export failed "
                         "its checks")
    return {"p50_ms": lat[len(lat) // 2] * 1e3, "max_ms": lat[-1] * 1e3,
            "rows_per_s": n_rows / wall}


def _predict_bert(tmp: str, card: str) -> dict:
    """(b) BERT-base ``:predict`` at 64 x 128 (bf16, flash) from
    ``export_model`` on its init params: B1 12 times a batch, logits
    against the plain attention's on the same export, rows/s."""
    from distributed_tensorflow_example_tpu_torch.config import (
        DataConfig, TrainConfig)
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.serving import (
        export_model, load_servable)
    from distributed_tensorflow_example_tpu_torch.serving_http import \
        PredictServer
    cfg = TrainConfig(model="bert", dtype="bfloat16", attention_impl="flash",
                      data=DataConfig(seq_len=PREDICT_BERT_S))
    model = get_model("bert", cfg)
    params = model.init(0)
    B, S, M = PREDICT_BERT_B, PREDICT_BERT_S, PREDICT_BERT_M
    rs = np.random.RandomState(12)

    def batch(n):
        lens = rs.randint(S // 2, S + 1, n)
        lens[0] = S
        mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
        return {"input_ids": (rs.randint(1, model.cfg.vocab_size, (n, S))
                              * mask).astype(np.int32),
                "token_type_ids": np.zeros((n, S), np.int32),
                "attention_mask": mask,
                "masked_positions": (rs.randint(0, S // 2, (n, M))
                                     ).astype(np.int32)}

    d = os.path.join(tmp, "bert_export")
    t0 = time.perf_counter()
    export_model(model, params, {}, d, sample_batch=batch(8))
    del params
    log(f"[http bert] export_model of BERT-base in "
        f"{time.perf_counter() - t0:.2f} s")
    waves = [batch(B) for _ in range(PREDICT_BERT_WAVES + 1)]
    per = B // 8
    with PredictServer(d, scheduler="on", port=0, batch_max_size=B,
                       batch_max_wait_ms=50.0) as srv:
        path = f"/v1/models/{srv.name}:predict"

        def run_wave(w):
            def client(i):
                rows = {k: v[i * per:(i + 1) * per].tolist()
                        for k, v in waves[w].items()}
                code, body, _ = http_json(srv.port, path, {"inputs": rows},
                                          "POST")
                if code != 200:
                    raise RuntimeError(f"HTTP {code}: {str(body)[:200]}")
                return np.asarray(body["predictions"], np.float32)
            return _concurrent(8, client)

        run_wave(0)                                             # warm-up
        b0 = srv.batcher.stats()["batches"]
        read = _reset_launches()
        walls, lats, answers = [], [], []
        for w in range(1, PREDICT_BERT_WAVES + 1):
            out, sec, wall = run_wave(w)
            walls.append(wall)
            lats += sec
            answers.append(np.concatenate(out))
        launches = read()
        st = srv.batcher.stats()
        batches = st["batches"] - b0
    plain = load_servable(d)
    plain.model.attention_impl = "xla"
    err, spread = 0.0, 0.0
    for w, got in enumerate(answers, start=1):
        ref = plain(waves[w])
        err = max(err, float(np.abs(got - ref).max()))
        spread = max(spread, float(ref.std()))
    del plain
    lat = sorted(lats)
    rows = B * PREDICT_BERT_WAVES
    log(f"[http bert] BERT-base :predict, {PREDICT_BERT_WAVES} waves of 8 "
        f"concurrent clients x {per} rows ({B} x {S}, {M} masked position a "
        f"row): {batches} batches, B1 launches "
        f"{launches['flash_attention_fwd']} (want 12 a batch: "
        f"{12 * batches}), other kernels "
        f"{ {k: v for k, v in launches.items() if k != 'flash_attention_fwd'} };"
        f" logits vs plain attention max abs err {err:.3e} (tol "
        f"{PREDICT_BERT_LOGIT_TOL}, logit std {spread:.3f}); "
        f"{rows / sum(walls):.1f} rows/s, request latency p50 "
        f"{lat[len(lat) // 2] * 1e3:.1f} ms max {lat[-1] * 1e3:.1f} ms; "
        f"batcher p50 {st['latency_p50_ms']} ms ({card})")
    others = {k: v for k, v in launches.items() if k != "flash_attention_fwd"}
    if launches["flash_attention_fwd"] != 12 * batches or any(
            others.values()) or err > PREDICT_BERT_LOGIT_TOL:
        raise SystemExit("BERT :predict failed its checks")
    return {"b1": launches["flash_attention_fwd"], "batches": batches,
            "rows_per_s": rows / sum(walls),
            "p50_ms": lat[len(lat) // 2] * 1e3, "max_ms": lat[-1] * 1e3,
            "err": err}


#: /stats field -> the registry metric it views (the counters and gauges
#: /metrics must carry with the same value)
STATS_METRICS = (
    ("prefills", "serving_prefills_total"),
    ("decode_steps", "serving_decode_steps_total"),
    ("decode_slot_steps", "serving_decode_slot_steps_total"),
    ("admissions", "serving_admissions_total"),
    ("requests_done", "serving_requests_done_total"),
    ("requests_failed", "serving_requests_failed_total"),
    ("cancelled", "serving_cancelled_total"),
    ("deadline_expired", "serving_deadline_expired_total"),
    ("redispatches", "serving_redispatches_total"),
    ("tokens_out", "serving_tokens_out_total"),
    ("verify_steps", "serving_verify_steps_total"),
    ("shed", "serving_shed_total"),
    ("prefill_chunks", "serving_prefill_chunks_total"),
    ("slo_served", "serving_slo_served_total"),
    ("slo_good", "serving_slo_good_total"),
    ("goodput_tokens", "serving_goodput_tokens_total"),
    ("blocks_free", "serving_blocks_free"),
    ("bytes_resident_peak", "serving_bytes_resident_peak"),
    ("live_slots", "serving_live_slots"),
    ("queue_depth", "serving_queue_depth"))


def _gen_wave(srv, prompts: list, label: str, card: str) -> dict:
    """One ``:generate`` of all ``prompts`` as the rows of one request
    (one atomic admission wave), every launch count set to 0 just before
    and read just after."""
    eng = srv.engine
    d0 = eng.decode_steps
    read = _reset_launches()
    t0 = time.perf_counter()
    code, body, _ = http_json(
        srv.port, f"/v1/models/{srv.name}:generate",
        {"inputs": {"input_ids": [p.tolist() for p in prompts]}}, "POST")
    wall = time.perf_counter() - t0
    launches = read()
    if code != 200:
        raise SystemExit(f"{label} wave: HTTP {code}: {str(body)[:300]}")
    gens = body["generations"]
    toks = sum(len(g) for g in gens)
    # a --metrics off server counts nothing: its steps are B5's launches
    steps = (eng.decode_steps - d0 if srv.registry.enabled else
             launches["paged_decode_attention"] // eng.sw.model.cfg.layers)
    log(f"[http ops {label}] {len(prompts)} rows in one :generate: "
        f"{steps} shared decode steps, {toks} tokens in {wall * 1e3:.1f} ms, "
        f"{toks / wall:.1f} tokens/s, launches {launches} ({card})")
    return {"gens": gens, "launches": launches, "wall": wall, "toks": toks,
            "steps": steps}


def _wait_for(pred, what: str, timeout: float = 60.0) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise SystemExit(f"timed out waiting for {what}")
        time.sleep(0.002)
    return time.perf_counter() - t0


def _span_cost_us(n: int = 20000) -> dict:
    """Host microseconds of one engine-style span (name, lane and a
    request id), with the ring off and with it armed, over ``n`` spans
    into a ring of its own; the process ring is restored after."""
    from distributed_tensorflow_example_tpu_torch.obs import trace as obs_trace
    old = obs_trace.recorder()
    rec = obs_trace.set_recorder(obs_trace.TraceRecorder(n))
    out = {}
    try:
        for label in ("off", "armed"):
            if label == "armed":
                rec.start()
            t0 = time.perf_counter()
            for _ in range(n):
                with obs_trace.span("decode_step", lane="scheduler",
                                    request_id="r"):
                    pass
            out[label] = (time.perf_counter() - t0) / n * 1e6
    finally:
        rec.stop()
        obs_trace.set_recorder(old)
    return out


def _ops_checks(srv, tmp: str, prompts: list, inc: str, card: str) -> dict:
    """On the armed server: /metrics against /stats, /stats/history, a
    cancel mid-decode, a fault-spec wedge, then a drain under a full
    queue."""
    import threading
    from distributed_tensorflow_example_tpu_torch.obs import prom
    from distributed_tensorflow_example_tpu_torch.runtime import faults
    eng = srv.engine
    # /metrics parsed against /stats, quiesced
    _, stats, _ = http_json(srv.port, "/stats")
    _, text, _ = http_json(srv.port, "/metrics")
    page = prom.parse_snapshot(text)
    gen = stats["generate"]
    diff = {k: (gen[k], page[m]["value"]) for k, m in STATS_METRICS
            if gen[k] != page[m]["value"]}
    hist_lat = page["serving_request_latency_seconds"]["count"]
    log(f"[http ops metrics] /metrics: {len(page)} metrics; {len(STATS_METRICS)}"
        f" /stats fields against their metrics, mismatches {diff}; latency "
        f"histogram count {hist_lat} vs requests_done "
        f"{gen['requests_done']}")
    if diff or hist_lat != gen["requests_done"]:
        raise SystemExit("/metrics and /stats disagree")
    _, hist, _ = http_json(srv.port, "/stats/history")
    res = (hist.get("slo") or {}).get("results") or []
    log(f"[http ops history] /stats/history: {len(hist['samples'])} samples, "
        f"interval {hist['interval_s']} s; SLO results "
        f"{[(r['class'], r['kind'], r['attainment'], r['burn_fast'], r['breach']) for r in res]}")
    if len(hist["samples"]) < 2 or not res:
        raise SystemExit("/stats/history holds no samples or SLO results")
    # cancel mid-decode: the blocks come back at the next step boundary
    free0 = eng.stats()["blocks_free"]
    t_out = eng.stats()["tokens_out"]
    holder = {}
    th = threading.Thread(target=lambda: holder.update(r=http_json(
        srv.port, f"/v1/models/{srv.name}:generate",
        {"inputs": {"input_ids": [prompts[0].tolist()]}}, "POST",
        headers={"X-Request-Id": "ops-cancel"})))
    th.start()
    _wait_for(lambda: eng.stats()["tokens_out"] >= t_out + 8,
              "the cancel target decoding")
    during = eng.stats()["blocks_free"]
    t0 = time.perf_counter()
    code, body, _ = http_json(srv.port, "/cancel/ops-cancel", method="POST")
    back = _wait_for(lambda: eng.stats()["blocks_free"] == free0,
                     "the cancelled request's blocks")
    th.join(60)
    waiter = holder["r"][0]
    code2, _, _ = http_json(srv.port, "/cancel/ops-cancel", method="POST")
    log(f"[http ops cancel] POST /cancel mid-decode: HTTP {code}; "
        f"blocks_free {during} -> {free0} (before the request) in "
        f"{back * 1e3:.2f} ms; the request's own waiter HTTP {waiter}; a "
        f"second cancel HTTP {code2} ({card})")
    if code != 200 or waiter != 409 or code2 != 404 \
            or eng.stats()["blocks_free"] != free0:
        raise SystemExit("cancel did not return the blocks exactly")
    # a fault-spec wedge of the decode step: /healthz flips to stalled and
    # the flight recorder writes one watchdog_stall bundle
    eng.set_stall_after(0.5)
    faults.install(faults.parse_spec("engine.decode_step:step=3:stall=2.5"))
    try:
        th = threading.Thread(target=lambda: holder.update(w=http_json(
            srv.port, f"/v1/models/{srv.name}:generate",
            {"inputs": {"input_ids": [prompts[1].tolist()]},
             "max_new": 8}, "POST")))
        th.start()
        seen = []

        def stalled():
            code, h, _ = http_json(srv.port, "/healthz")
            seen.append((code, h["status"]))
            return h["status"] == "stalled"

        flip = _wait_for(stalled, "/healthz to report stalled", 20.0)
        th.join(60)
    finally:
        faults.install(None)
    eng.set_stall_after(10.0)
    code_h, h, _ = http_json(srv.port, "/healthz")
    bundles = sorted(f for f in os.listdir(inc) if "watchdog_stall" in f)
    with open(os.path.join(inc, bundles[0])) as f:
        bundle = json.load(f)
    log(f"[http ops wedge] engine.decode_step:step=3:stall=2.5: /healthz "
        f"stalled after {flip * 1e3:.0f} ms ({len(seen)} polls, last "
        f"{seen[-1]}), back to HTTP {code_h} {h['status']}; the request HTTP"
        f" {holder['w'][0]}; watchdog_stall bundles {len(bundles)} (keys "
        f"{sorted(bundle)[:12]}...) ({card})")
    if len(bundles) != 1 or holder["w"][0] != 200 or code_h != 200 \
            or "registry" not in bundle:
        raise SystemExit("the wedge did not flip /healthz or write one "
                         "incident bundle")
    # drain under a full queue: 16 single-row requests on 8 slots, then
    # stop(drain=True); a late admission answers 503
    results = [None] * 16

    def client(i):
        results[i] = http_json(
            srv.port, f"/v1/models/{srv.name}:generate",
            {"inputs": {"input_ids": [prompts[i % len(prompts)].tolist()]}},
            "POST")

    done0 = eng.stats()["requests_done"]

    def accepted() -> int:
        h = eng.health()
        return (h["queue_depth"] + h["inflight"]
                + eng.stats()["requests_done"] - done0)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    # every request is queued or live before the drain: a request that
    # reaches the engine after it is a new admission, answered 503
    _wait_for(lambda: accepted() == 16, "all 16 requests accepted")
    queued = eng.health()["queue_depth"]
    stopper = threading.Thread(target=srv.stop)
    stopper.start()
    _wait_for(lambda: eng.health()["draining"], "the drain flag")
    late = http_json(srv.port, f"/v1/models/{srv.name}:generate",
                     {"inputs": {"input_ids": [prompts[0].tolist()]}},
                     "POST")
    for t in threads:
        t.join(120)
    stopper.join(120)
    ok = sum(1 for r in results
             if r and r[0] == 200 and len(r[1]["generations"][0]) == OPS_NEW)
    log(f"[http ops drain] stop(drain=True) with {queued} of 16 queued "
        f"behind {OPS_SLOTS} slots: {ok}/16 answered 200 with all "
        f"{OPS_NEW} tokens; late admission HTTP {late[0]} Retry-After "
        f"{late[2].get('Retry-After')}; drain_ms "
        f"{eng.stats()['drain_ms']}; engine {eng.health()['status']} "
        f"({card})")
    if ok != 16 or late[0] != 503 or eng.health()["status"] != "dead":
        raise SystemExit("the drain dropped a request or admitted a late one")
    return {"cancel_ms": back * 1e3, "stall_ms": flip * 1e3}


def _ops_profile(srv, prompt, c, card: str) -> dict:
    """(d) ``utils/trace_summary.py`` over a ``torch.profiler`` capture of
    one engine request."""
    from torch.profiler import ProfilerActivity, profile
    from distributed_tensorflow_example_tpu_torch.utils import \
        trace_summary
    read = _reset_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        code, body, _ = http_json(
            srv.port, f"/v1/models/{srv.name}:generate",
            {"inputs": {"input_ids": [prompt.tolist()]}}, "POST")
        torch.cuda.synchronize()
    launches = read()
    steps = launches["paged_decode_attention"] // c.layers
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_trace_"),
                        "engine_request.json")
    prof.export_chrome_trace(path)
    s = trace_summary.summarize(path, top=5)["engine_request.json"]
    dev = s.get("device") or {}
    share = dev.get("families_share", {})
    log(f"[http ops trace_summary] one engine request ({steps} decode "
        f"steps): {s['events']} events; device busy {dev.get('busy_ms')} ms,"
        f" families {dev.get('families_ms')}, kernels a family "
        f"{dev.get('families_count')} (the wrappers counted B1 "
        f"{launches['flash_attention_fwd']}, B5 "
        f"{launches['paged_decode_attention']} launches of a split and a "
        f"combine kernel each; the profiler may miss the first kernels of "
        f"its window); B5 share of device time "
        f"{share.get('B5', 0.0):.4f}; B1 share {share.get('B1', 0.0):.4f} "
        f"({card})")
    for ln in s["lanes"][:6]:
        log(f"[http ops trace_summary]   lane {ln['lane'][:60]!r}: busy "
            f"{ln['busy_ms']:.3f} ms (naive sum {ln['naive_ms']:.3f} ms), "
            f"{ln['events']} events")
    for o in s["top_ops"]:
        log(f"[http ops trace_summary]   top op {o['ms']:9.3f} ms "
            f"x{o['count']:<5d} [{o['family']}] {o['op'][:90]}")
    if code != 200 or not dev or share.get("B5", 0.0) <= 0 \
            or not dev["families_count"].get("B1"):
        raise SystemExit("trace_summary saw no B5 decode or no B1 prefill")
    return {"b5_share": share.get("B5", 0.0)}


def _ops_chaos(card: str) -> dict:
    """(e) The port's ``serving_chaos`` on the card: every scenario over
    bf16 pools, then over int8 pools (B6)."""
    from distributed_tensorflow_example_tpu_torch.experiments import \
        serving_chaos
    out = {}
    for label, kv in (("bf16", None), ("int8", "int8")):
        read = _reset_launches()
        t0 = time.perf_counter()
        res = serving_chaos.run_scenarios(list(serving_chaos.SCENARIOS),
                                          seed=0, device="cuda",
                                          kv_cache_dtype=kv)
        launches = read()
        failed = [r for r in res if not r["ok"]]
        for r in res:
            log(f"[http ops chaos {label}] {r['scenario']}: "
                f"{'ok' if r['ok'] else 'FAILED'} — {r['detail'][:240]}")
        log(f"[http ops chaos {label}] {len(res)} scenarios in "
            f"{time.perf_counter() - t0:.1f} s, failed {len(failed)}; "
            f"launches {launches} ({card})")
        kernel = ("paged_decode_attention_int8" if kv
                  else "paged_decode_attention")
        if failed or not launches[kernel] \
                or not launches["flash_attention_fwd"]:
            raise SystemExit(f"serving_chaos {label} failed: "
                             f"{[r['scenario'] for r in failed]}")
        out[label] = launches
    return out


def phase_http_ops(card: str) -> dict:
    """A single server's HTTP and operator surface: (a) the MLP trained,
    exported with ``--export_dir`` and served through the MicroBatcher;
    (b) BERT-base ``:predict`` on the flash forward; (c) GPT-small paged
    ``:generate`` with the operator surface armed, against a
    ``--metrics off --flight_recorder off`` server on the same wave, then
    /metrics, /trace, /stats/history, cancel, a wedge and a drain; (d)
    ``trace_summary`` over one profiled request; (e) ``serving_chaos``.
    Returns the B1, B5 and B6 launches of its measured runs."""
    from distributed_tensorflow_example_tpu_torch.config import TrainConfig
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.obs import trace as obs_trace
    from distributed_tensorflow_example_tpu_torch.serving import \
        export_generator
    from distributed_tensorflow_example_tpu_torch.serving_http import \
        PredictServer
    t_phase = time.perf_counter()
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        mlp = _predict_mlp(tmp, card)
        bert = _predict_bert(tmp, card)
        gc.collect()
        torch.cuda.empty_cache()
        model = get_model("gpt", TrainConfig(model="gpt", dtype="bfloat16",
                                             attention_impl="flash"))
        c = model.cfg
        params = model.init(0)
        bs = PAGED_SHAPE["bs"]
        per_row = -(-(OPS_PROMPT + OPS_NEW) // bs)
        d = os.path.join(tmp, "ops_paged")
        export_generator(model, params, d, prompt_len=OPS_PROMPT,
                         max_new_tokens=OPS_NEW, ragged=True, stepwise=True,
                         slots=OPS_SLOTS, paged=True, block_size=bs,
                         num_blocks=1 + 2 * OPS_SLOTS * per_row)
        del params
        rs = np.random.RandomState(13)
        prompts = [rs.randint(0, c.vocab_size, (int(n),)).astype(np.int32)
                   for n in rs.randint(OPS_PROMPT // 4, OPS_PROMPT + 1,
                                       OPS_SLOTS)]
        warm = [rs.randint(0, c.vocab_size, (OPS_PROMPT,)).astype(np.int32)]
        def plain_server():
            # --metrics off --flight_recorder off, with the span ring off
            obs_trace.recorder().stop()
            return PredictServer(d, scheduler="on", port=0,
                                 prefix_cache=False, metrics=False,
                                 flight_recorder=False)

        # plain, armed, armed under /trace/start, plain again: each
        # server in turn (the span ring is one a process)
        waves = {}
        with plain_server() as srv:
            _gen_wave(srv, warm, "plain warm-up", card)
            waves["plain A"] = _gen_wave(srv, prompts, "plain A", card)
        inc = os.path.join(tmp, "incidents")
        srv = PredictServer(
            d, scheduler="on", port=0, prefix_cache=False,
            incident_dir=inc, history_interval_s=0.25,
            slo_spec="interactive:p95_ms=30000@0.9;all:availability=0.99",
            request_log=os.path.join(tmp, "requests.jsonl")).start()
        try:
            _gen_wave(srv, warm, "armed warm-up", card)
            waves["armed"] = _gen_wave(srv, prompts, "armed", card)
            code, _, _ = http_json(srv.port, "/trace/start", method="POST")
            waves["armed traced"] = _gen_wave(srv, prompts, "armed traced",
                                              card)
            _, chrome, _ = http_json(srv.port, "/trace/stop", method="POST")
            _, exp1, _ = http_json(srv.port, "/trace/export")
            _, exp2, _ = http_json(srv.port, "/trace/export")
            names = sorted({s[2] for s in exp1["spans"]})
            lanes = sorted({s[1] for s in exp1["spans"]})
            log(f"[http ops trace] /trace/start HTTP {code}; /trace/stop "
                f"{len(chrome['traceEvents'])} events; /trace/export "
                f"{len(exp1['spans'])} spans, names {names}, {len(lanes)} "
                f"lanes; a second export {len(exp2['spans'])} spans")
            if code != 200 or not {"prefill", "decode_step"} <= set(names) \
                    or exp2["spans"]:
                raise SystemExit("the trace routes did not hold the "
                                 "engine's spans, or export did not drain")
            # the always-on ring's cost as a count: the spans a shared
            # step records, times one span's host cost
            tw = waves["armed traced"]
            per_step = len(exp1["spans"]) / max(tw["steps"], 1)
            cost = _span_cost_us()
            step_us = tw["wall"] / max(tw["steps"], 1) * 1e6
            extra = per_step * (cost["armed"] - cost["off"])
            log(f"[http ops span cost] {len(exp1['spans'])} spans over "
                f"{tw['steps']} shared steps = {per_step:.2f} a step; a "
                f"span {cost['armed']:.3f} us armed, {cost['off']:.3f} us "
                f"off; {extra:.1f} us a step of {step_us:.1f} us "
                f"({extra / step_us:.5f} of a step's wall) ({card})")
            ops = _ops_checks(srv, tmp, prompts, inc, card)
            log_lines = sum(1 for _ in open(os.path.join(tmp,
                                                         "requests.jsonl")))
            log(f"[http ops request_log] {log_lines} JSONL events")
        finally:
            srv.kill()
        del srv
        gc.collect()
        with plain_server() as srv:
            _gen_wave(srv, warm, "plain warm-up", card)
            waves["plain B"] = _gen_wave(srv, prompts, "plain B", card)
            prof = _ops_profile(srv, prompts[0], c, card)
        armed, plain = waves["armed"], waves["plain A"]
        same = all(w["gens"] == plain["gens"] for w in waves.values())
        eq_launch = all(w["launches"] == plain["launches"]
                        for w in waves.values())
        rate = {k: w["toks"] / w["wall"] for k, w in waves.items()}
        log(f"[http ops armed vs plain] generations equal over the four "
            f"waves: {same}; launches equal: {eq_launch} (B5 "
            f"{[w['launches']['paged_decode_attention'] for w in waves.values()]}"
            f"); tokens/s "
            f"{ {k: round(v, 1) for k, v in rate.items()} } ({card})")
        if not same or not eq_launch or armed["launches"][
                "paged_decode_attention"] != c.layers * armed["steps"]:
            raise SystemExit("the armed server is not byte- and "
                             "dispatch-identical to the plain one")
        obs_trace.recorder().stop()
        gc.collect()
        torch.cuda.empty_cache()
    chaos = _ops_chaos(card)
    out.update(
        b1=bert["b1"] + sum(w["launches"]["flash_attention_fwd"]
                            for w in waves.values())
        + chaos["bf16"]["flash_attention_fwd"]
        + chaos["int8"]["flash_attention_fwd"],
        b5=sum(w["launches"]["paged_decode_attention"]
               for w in waves.values())
        + chaos["bf16"]["paged_decode_attention"],
        b6=chaos["int8"]["paged_decode_attention_int8"])
    log(f"[http ops] :predict mlp p50 {mlp['p50_ms']:.2f} ms max "
        f"{mlp['max_ms']:.2f} ms {mlp['rows_per_s']:.1f} rows/s; bert "
        f"{bert['rows_per_s']:.1f} rows/s p50 {bert['p50_ms']:.1f} ms; "
        f":generate tokens/s armed {rate['armed']:.1f} vs plain "
        f"{rate['plain A']:.1f} / {rate['plain B']:.1f}; cancel returned blocks "
        f"in {ops['cancel_ms']:.2f} ms; B5 share of a request's device time "
        f"{prof['b5_share']:.4f}; phase done in "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# the serving fleet: serving_router over in-process replicas on one card
# ---------------------------------------------------------------------------

#: the bench row's serving shape (``bench.py``'s ``gpt`` serving row, its
#: ``run_router_mode`` leg included): GPT-small, 8 closed-loop clients x 4
#: requests, prompts up to 128 tokens and up to 64 new, 8 slots, 16-slot
#: blocks; the fleet leg 2 replicas hedging after 200 ms
FLEET_CLIENTS, FLEET_REQUESTS = 8, 4
FLEET_PROMPT, FLEET_NEW, FLEET_SLOTS = 128, 64, 8
FLEET_REPLICAS, FLEET_HEDGE_MS = 2, 200
#: device memory after a replica's crash, its restart and the fleet's
#: close may stand at most this far above where it stood before the fleet
#: started (cuBLAS workspaces cleared on both sides). One GPT-small
#: replica holds ~0.8 GB (f32 weights, their bf16 decode copies, the
#: pool), so a leaked replica, or a killed engine's pool, shows 10x over
#: it; what may remain is allocator rounding and a handle's small state
FLEET_MEM_BOUND_MIB = 64
#: how long after the fleet's close the memory may take to come back
FLEET_MEM_SETTLE_S = 15.0


def _clear_workspaces() -> None:
    """Drop the cuBLAS workspaces each thread's handle keeps (they count
    in ``memory_allocated`` and outlive the thread)."""
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.synchronize()


def _wave_rows(matrix: list) -> list:
    """Each client's first request: one wave of concurrent requests."""
    return [rows[0] for rows in matrix]


def _profiled_wave(port: int, name: str, wave: list, label: str,
                   card: str) -> dict:
    """One wave of concurrent ``:generate`` requests (each its own client)
    under ``torch.profiler``: wall, device busy (the kernels' device time;
    every replica dispatches on the card's one default stream), idle
    share, and the generations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def one(i):
        prompt, m = wave[i]
        code, body, _ = http_json(port, f"/v1/models/{name}:generate", {
            "inputs": {"input_ids": [prompt.tolist()]}, "max_new": m},
            "POST")
        if code != 200:
            raise RuntimeError(f"HTTP {code}: {body}")
        return body

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, sec, wall = _concurrent(len(wave), one)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    idle = 1 - busy / (wall * 1e3) if kernels else float("nan")
    toks = sum(len(b["generations"][0]) for b in out)
    log(f"[fleet wave {label}] {len(wave)} concurrent requests traced: "
        f"wall {wall * 1e3:.1f} ms, {toks / wall:.1f} tokens/s, device busy "
        f"{busy:.1f} ms, idle share "
        f"{idle:.3f}{'' if kernels else ' (not measured: no device time)'}; "
        f"served_by {sorted(b.get('served_by', '-') for b in out)} ({card})")
    return {"wall": wall, "busy": busy, "idle": idle,
            "gens": [b["generations"][0] for b in out],
            "trace_ids": [b.get("trace_id") for b in out]}


def _fleet_leg(d: str, matrix: list, vocab: int, card: str) -> dict:
    """(a) One traced wave through one replica for the device's idle share
    (its server's first request also warms the process), then the bench
    row's serving leg and its fleet leg over the same matrix:
    ``serving_load.run_mode`` (one replica, scheduler on),
    ``run_router_mode(replicas=2, hedge_after_ms=200)`` and the same
    router without hedging, each with the kernels' counts set to 0 just
    before it and read just after."""
    from distributed_tensorflow_example_tpu_torch.experiments import \
        serving_load as sl
    from distributed_tensorflow_example_tpu_torch.serving_http import \
        PredictServer
    layers = 12
    wave = _wave_rows(matrix)
    with PredictServer(d, scheduler="on", port=0) as srv:
        # a warm-up prompt of its own (a prompt of the wave would be a
        # cache hit)
        http_json(srv.port, f"/v1/models/{srv.name}:generate", {
            "inputs": {"input_ids": [_warm_prompt(vocab)]}, "max_new": 2},
            "POST")
        read = _reset_launches()
        w_one = _profiled_wave(srv.port, srv.name, wave, "one replica",
                               card)
        l_w1 = read()
    gc.collect()
    read = _reset_launches()
    one = sl.run_mode(d, matrix, scheduler="on", prompt_len=FLEET_PROMPT)
    l_one = read()
    gc.collect()
    read = _reset_launches()
    fleet = sl.run_router_mode(d, matrix, replicas=FLEET_REPLICAS,
                               hedge_after_ms=FLEET_HEDGE_MS)
    l_fleet = read()
    gc.collect()
    # the same fleet without hedging: what sharing the card costs apart
    # from the hedges' duplicated work
    read = _reset_launches()
    plain = sl.run_router_mode(d, matrix, replicas=FLEET_REPLICAS,
                               mode_name="router_no_hedge")
    l_plain = read()
    gc.collect()
    n = FLEET_CLIENTS * FLEET_REQUESTS
    for label, row, ln in (("one replica", one, l_one),
                           (f"{FLEET_REPLICAS}-replica router", fleet,
                            l_fleet),
                           (f"{FLEET_REPLICAS}-replica router, no hedging",
                            plain, l_plain)):
        p95 = row.get("registry_p95_ms", row.get("fleet_registry_p95_ms"))
        log(f"[fleet leg {label}] {row['requests']} requests, "
            f"{row['tokens_per_s']:.2f} tokens/s, client p50 "
            f"{row['latency_p50_ms']:.2f} ms p95 {row['latency_p95_ms']:.2f}"
            f" ms, registry p95 {p95:.2f} ms; {row['prefills']} prefills, "
            f"{row['decode_steps']} decode steps; launches {ln}; errors "
            f"{len(row['errors'])} ({card})")
    for row in (fleet, plain):
        log(f"[fleet leg {row['mode']}] hedges {row['router_hedges']}, "
            f"hedge wins {row['router_hedge_wins']}, retries "
            f"{row['router_retries']}, failovers {row['router_failovers']},"
            f" router requests {row['router_requests']}, served_by "
            f"{row['served_by']}")
    # B5: one launch a layer a shared decode step (every slot in one
    # launch). B1: one launch a layer a prefill dispatch — the engine's
    # admission runs the paged prefill (the flash forward) once a cold
    # request and counts it in serving_prefills_total; a prefix-cache hit
    # runs no prefill (its known tokens go through the decode step), and
    # these legs chunk nothing
    bad = []
    for label, row, ln in (("one", one, l_one), ("fleet", fleet, l_fleet),
                           ("fleet, no hedging", plain, l_plain)):
        want = {"flash_attention_fwd": layers * row["prefills"],
                "paged_decode_attention": layers * row["decode_steps"],
                "paged_decode_attention_int8": 0, "decode_attention": 0,
                **NO_BACKWARD}
        if ln != want or row["errors"] or row["requests"] != n:
            bad.append(f"{label}: launches {ln} want {want}, "
                       f"{row['requests']} requests, errors "
                       f"{row['errors'][:2]}")
    for row in (fleet, plain):
        if row["_gens"] != one["_gens"]:
            bad.append(f"{row['mode']}: the router's generations differ "
                       "from one replica's")
        if row["router_requests"] != n:
            bad.append(f"{row['mode']}: router_requests_total "
                       f"{row['router_requests']} != {n}")
    if bad:
        raise SystemExit(f"fleet leg: {bad}")
    for row in (one, fleet, plain):
        for gens in row["_gens"]:
            for g in gens:
                if min(g, default=0) < 0 or max(g, default=0) >= vocab:
                    raise SystemExit(f"bad fleet generation {g[:8]}")
    log(f"[fleet leg] the router's {n} generations are byte-identical to "
        f"one replica's; B5 = {layers} x merged decode steps and B1 = "
        f"{layers} x merged prefills on every leg")
    log(f"[fleet] one replica vs {FLEET_REPLICAS}-replica router: tokens/s "
        f"{one['tokens_per_s']:.2f} vs {fleet['tokens_per_s']:.2f}, client "
        f"p50 {one['latency_p50_ms']:.2f} vs {fleet['latency_p50_ms']:.2f} "
        f"ms, p95 {one['latency_p95_ms']:.2f} vs "
        f"{fleet['latency_p95_ms']:.2f} ms, registry p95 "
        f"{one['registry_p95_ms']:.2f} vs "
        f"{fleet['fleet_registry_p95_ms']:.2f} ms; hedges "
        f"{fleet['router_hedges']} won {fleet['router_hedge_wins']}; "
        f"without hedging {plain['tokens_per_s']:.2f} tokens/s, p50 "
        f"{plain['latency_p50_ms']:.2f} ms, p95 "
        f"{plain['latency_p95_ms']:.2f} ms ({card})")
    total = {k: l_w1[k] + l_one[k] + l_fleet[k] + l_plain[k] for k in l_one}
    return {"launches": total, "one": one, "fleet": fleet, "wave": w_one}


def _warm_prompt(vocab: int) -> list:
    return np.random.RandomState(7).randint(
        0, vocab, (FLEET_PROMPT,)).astype(np.int32).tolist()


def _fleet_chaos(card: str) -> dict:
    """(b) The port's ``fleet_chaos`` on the card: the five scenarios over
    bf16 pools, then over int8 pools (B6)."""
    from distributed_tensorflow_example_tpu_torch.experiments import \
        fleet_chaos
    out = {}
    for label, kv in (("bf16", None), ("int8", "int8")):
        read = _reset_launches()
        t0 = time.perf_counter()
        res = fleet_chaos.run_scenarios(list(fleet_chaos.SCENARIOS),
                                        seed=0, device="cuda",
                                        kv_cache_dtype=kv)
        launches = read()
        failed = [r for r in res if not r["ok"]]
        for r in res:
            log(f"[fleet chaos {label}] {r['scenario']}: "
                f"{'ok' if r['ok'] else 'FAILED'} — {r['detail'][:400]}")
        log(f"[fleet chaos {label}] {len(res)} scenarios in "
            f"{time.perf_counter() - t0:.1f} s, failed {len(failed)}; "
            f"launches {launches} ({card})")
        kernel = ("paged_decode_attention_int8" if kv
                  else "paged_decode_attention")
        if failed or not launches[kernel] \
                or not launches["flash_attention_fwd"]:
            raise SystemExit(f"fleet_chaos {label} failed: "
                             f"{[r['scenario'] for r in failed]}")
        out[label] = launches
        gc.collect()
    return out


def _fleet_kill_and_trace(d: str, matrix: list, leg: dict, vocab: int,
                          card: str) -> dict:
    """A 2-replica fleet hedging after 200 ms: (a) one traced wave through
    the router for the device's idle share, beside one replica's; (d) the
    stitched ``GET /trace/fleet`` of that wave through ``trace_summary
    --fleet``, one of its hedged requests (the loser cancelled) checked,
    and one ``servetop --frames 1`` frame off the router's
    ``/stats/history``; (c) replica0 killed mid-wave,
    restarted, the fleet closed: device memory back within
    :data:`FLEET_MEM_BOUND_MIB` of where it stood before the fleet
    started, and the survivors' and the restarted replica's answers
    clean."""
    import contextlib
    import io
    import threading

    from distributed_tensorflow_example_tpu_torch.obs import stitch
    from distributed_tensorflow_example_tpu_torch.obs import trace as obs_trace
    from distributed_tensorflow_example_tpu_torch.serving_router import \
        InProcessFleet
    from distributed_tensorflow_example_tpu_torch.tools import servetop
    from distributed_tensorflow_example_tpu_torch.utils import \
        trace_summary
    _clear_workspaces()
    before = torch.cuda.memory_allocated()
    wave = _wave_rows(matrix)
    ref = [gens[0] for gens in leg["one"]["_gens"]]
    read = _reset_launches()
    # prefix cache off: the kill wave repeats the traced wave's prompts,
    # and an exact cache hit runs its last prompt token through the
    # decode step (other bf16 rounding than the prefill's)
    f = InProcessFleet(d, FLEET_REPLICAS, hedge_after_ms=FLEET_HEDGE_MS,
                       server_kw={"history_interval_s": 0.5,
                                  "prefix_cache": False})
    try:
        torch.cuda.synchronize()
        footprint = torch.cuda.memory_allocated() - before
        # each replica warmed directly (a comprehension: no local of the
        # function may keep a server, and its device memory, alive)
        [http_json(x.port, f"/v1/models/{x.name}:generate", {
            "inputs": {"input_ids": [_warm_prompt(vocab)]}, "max_new": 2},
            "POST") for x in f.servers]
        w_one = leg["wave"]
        w_fleet = _profiled_wave(f.port, f.name, wave, "router", card)
        if w_fleet["gens"] != w_one["gens"]:
            raise SystemExit("the traced router wave differs from one "
                             "replica's")
        log(f"[fleet wave] idle share one replica {w_one['idle']:.3f} vs "
            f"the {FLEET_REPLICAS}-replica router {w_fleet['idle']:.3f}; "
            f"device busy {w_one['busy']:.1f} vs {w_fleet['busy']:.1f} ms "
            f"over a wave of {w_one['wall'] * 1e3:.1f} vs "
            f"{w_fleet['wall'] * 1e3:.1f} ms ({card})")
        # (d) the wave's long requests outlast 200 ms: each is hedged and
        # its loser cancelled. The router records a cancel span once the
        # loser's POST resolves, and /trace/fleet drains, so wait in the
        # ring for one of the wave's traces to hold its cancel first
        hedges = f.router.registry.snapshot()[
            "router_hedges_total"]["value"]
        tids = set(w_fleet["trace_ids"])
        found: list = []

        def cancelled() -> bool:
            found[:] = [(s[5] or {}).get("trace_id") for s in
                        obs_trace.recorder().tail(2048, process="router")
                        if s[2] == "cancel"
                        and (s[5] or {}).get("trace_id") in tids]
            return bool(found)

        _wait_for(cancelled, "a hedge loser's cancel span")
        tid = found[0]
        _, stitched, _ = http_json(f.port, "/trace/fleet")
        mine = stitch.spans_for_trace(stitched, tid)
        path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_fleet_"),
                            "fleet_trace.json")
        with open(path, "w") as fh:
            json.dump(stitched, fh)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            trace_summary.main(["--fleet", path])
        for ln in buf.getvalue().splitlines():
            log(f"[fleet trace_summary --fleet] {ln[:200]}")
        procs = {e["pid"] for e in mine}
        names = {e["name"] for e in mine}
        log(f"[fleet trace] the wave's {hedges} hedges; trace {tid}: "
            f"{len(mine)} spans in {len(procs)} process groups, "
            f"{sorted(names)}")
        if len(procs) < 3 or not {"request", "hedge", "forward_launch",
                                  "cancel"} <= names:
            raise SystemExit(f"the stitched hedged trace lacks a process "
                             f"group or a span: {sorted(names)}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            servetop.main(["--url", f"http://127.0.0.1:{f.port}",
                           "--frames", "1"])
        for ln in buf.getvalue().splitlines():
            log(f"[fleet servetop] {ln}")
        if "replica0" not in buf.getvalue():
            raise SystemExit("servetop's frame shows no replica")
        # (c) a wave in flight, replica0 killed under it
        outs, errors = [None] * len(wave), []

        def client(k):
            try:
                c, b, _ = http_json(f.port,
                                    f"/v1/models/{f.name}:generate", {
                                        "inputs": {"input_ids": [
                                            wave[k][0].tolist()]},
                                        "max_new": wave[k][1]}, "POST")
                if c != 200:
                    raise RuntimeError(f"HTTP {c}: {b}")
                outs[k] = b
            except Exception as e:
                errors.append(f"{k}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(len(wave))]
        for t in threads:
            t.start()
        eng0 = f.servers[0].engine
        _wait_for(lambda: eng0.stats()["live_slots"] > 0,
                  "replica0 decoding")
        f.crash(0)
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        if errors or [o["generations"][0] for o in outs] != ref:
            raise SystemExit(f"the wave across a kill: errors {errors[:3]},"
                             " or bytes differ")
        served = sorted(o["served_by"] for o in outs)
        f.restart(0)
        rep0 = f.router.replicas[0]
        # the crash opened replica0's breaker: routing prefers closed
        # breakers until the prober's half-open probe closes it
        _wait_for(lambda: f.router.replica_states()["replica0"]
                  == "healthy" and rep0.breaker.state == "closed",
                  "the restarted replica healthy, its breaker closed")
        # sequential requests: the idle tie-break sends each to replica0
        after_restart = [http_json(f.port, f"/v1/models/{f.name}:generate",
                                   {"inputs": {"input_ids": [
                                       p.tolist()]}, "max_new": m},
                                   "POST")[1] for p, m in wave[:2]]
        if [o["generations"][0] for o in after_restart] != ref[:2] \
                or "replica0" not in {o["served_by"] for o in after_restart}:
            raise SystemExit("the restarted replica did not serve clean")
        retries = f.router.registry.snapshot()[
            "router_retries_total"]["value"]
    finally:
        f.close()
    launches = read()
    del f, eng0, rep0
    # a closed engine's scheduler thread may still be ending its last
    # dispatch: poll (bounded) for the memory to come back
    t_close = time.perf_counter()
    while True:
        _clear_workspaces()
        after = torch.cuda.memory_allocated()
        if (after - before) / 2**20 <= FLEET_MEM_BOUND_MIB \
                or time.perf_counter() - t_close > FLEET_MEM_SETTLE_S:
            break
        time.sleep(0.25)
    settle = time.perf_counter() - t_close
    delta = (after - before) / 2**20
    log(f"[fleet kill] replica0 killed under a wave of {len(wave)}: 0 client"
        f" errors, {retries} router retries, served_by {served}; restarted "
        f"replica0 served {[o['served_by'] for o in after_restart]}; device "
        f"memory before the fleet {before / 2**20:.1f} MiB, the running "
        f"fleet {footprint / 2**20:.1f} MiB over it, after crash + restart +"
        f" close {after / 2**20:.1f} MiB: {delta:+.1f} MiB (bound "
        f"{FLEET_MEM_BOUND_MIB} MiB) {settle:.2f} s after the close "
        f"({card})")
    if delta > FLEET_MEM_BOUND_MIB:
        raise SystemExit("device memory did not come back after the "
                         "fleet's crash, restart and close")
    return {"launches": launches, "delta_mib": delta}


def phase_fleet(card: str) -> dict:
    """The serving fleet on one card: (a) the bench row's serving leg and
    its 2-replica router leg (GPT-small bf16, paged), byte parity and
    exact launch counts, then a traced wave each; (b) the five fleet
    chaos scenarios over bf16 and int8 pools; (c) memory after a kill,
    a restart and the fleet's close; (d) a hedged request's stitched
    trace through ``trace_summary --fleet`` and a ``servetop`` frame.
    Returns the B1, B5 and B6 launches of its runs."""
    from distributed_tensorflow_example_tpu_torch.experiments import \
        serving_load as sl
    t_phase = time.perf_counter()
    sl._RUN.update(device="cuda", lockstep=False)
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "fleet_paged")
        t0 = time.perf_counter()
        vocab = sl.build_export(d, prompt_len=FLEET_PROMPT,
                                max_new=FLEET_NEW, slots=FLEET_SLOTS,
                                model_name="gpt", paged=True,
                                block_size=PAGED_SHAPE["bs"])
        matrix = sl.make_requests(FLEET_CLIENTS, FLEET_REQUESTS,
                                  prompt_len=FLEET_PROMPT,
                                  max_new=FLEET_NEW, vocab=vocab, seed=0)
        log(f"[fleet] GPT-small paged export in "
            f"{time.perf_counter() - t0:.2f} s; matrix {FLEET_CLIENTS} "
            f"clients x {FLEET_REQUESTS} requests, prompts "
            f"{min(p.size for r in matrix for p, _ in r)}-"
            f"{max(p.size for r in matrix for p, _ in r)} tokens, max_new "
            f"{min(m for r in matrix for _, m in r)}-"
            f"{max(m for r in matrix for _, m in r)}")
        leg = _fleet_leg(d, matrix, vocab, card)
        t_a = time.perf_counter()
        kill = _fleet_kill_and_trace(d, matrix, leg, vocab, card)
        t_cd = time.perf_counter()
    chaos = _fleet_chaos(card)
    parts = (leg["launches"], kill["launches"], chaos["bf16"],
             chaos["int8"])
    out = {"b1": sum(p["flash_attention_fwd"] for p in parts),
           "b5": sum(p["paged_decode_attention"] for p in parts),
           "b6": sum(p["paged_decode_attention_int8"] for p in parts)}
    log(f"[fleet] phase done in {time.perf_counter() - t_phase:.1f} s "
        f"((a) {t_a - t_phase:.1f} s, (c)+(d) {t_cd - t_a:.1f} s, (b) "
        f"{time.perf_counter() - t_cd:.1f} s); launches B1 {out['b1']}, "
        f"B5 {out['b5']}, B6 {out['b6']} ({card})")
    return out


def _device_us(evt) -> float:
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0))


def phase_profile(model, params, ids_t, card: str) -> None:
    """Where one greedy request's time goes: prefill vs decode steps on
    the host clock, then the device's busy time, idle share and largest
    kernels under ``torch.profiler`` over one whole generation."""
    def wall(n_new: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(params, ids_t, n_new)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    one, full = min(wall(1) for _ in range(3)), min(wall(MAX_NEW)
                                                    for _ in range(2))
    step = (full - one) / (MAX_NEW - 1)
    log(f"[profile] prefill + first token {one * 1e3:.2f} ms, decode "
        f"{step * 1e3:.3f} ms/step, whole request {full * 1e3:.1f} ms "
        f"(host clock, best of runs; {card})")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate(params, ids_t, MAX_NEW)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    if not kernels:
        log("[profile] the profiler saw no device time: device busy "
            "share not measured")
        return
    log(f"[profile] traced request {traced * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms: idle share {1 - busy / (traced * 1e3):.3f} of the "
        f"traced request (the profiler slows the host), "
        f"{1 - busy / (full * 1e3):.3f} of the untraced one")
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        log(f"[profile]   {_device_us(e) / 1e3:8.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_main = time.perf_counter()
    t_last = [t_main]

    def timed(label: str) -> None:
        # each phase's wall, against the script's time limit
        now = time.perf_counter()
        log(f"[timing] {label} {now - t_last[0]:.1f} s (total "
            f"{now - t_main:.1f} s)")
        t_last[0] = now

    card = card_line()
    log(f"[device] {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")
    phase_build()
    gen = torch.Generator().manual_seed(0)
    flash = phase_flash(gen)
    bwd_dq, bwd_dkv = phase_flash_bwd(gen)
    bwd_fused = phase_flash_bwd_fused(gen)
    phase_flash_wide()
    decode = phase_decode(gen)
    paged = phase_paged(gen)
    paged_int8 = phase_paged_int8(gen)
    log("[kernels] flash_attention_fwd, flash_attention_bwd_dq, "
        "flash_attention_bwd_dkv, flash_attention_bwd_fused, "
        "decode_attention, paged_decode_attention, "
        "paged_decode_attention_int8")
    timed("build and kernel phases")
    train = phase_train(card)
    timed("train")
    cli_run = phase_cli(card)
    timed("cli")
    launches = phase_slice(card)
    timed("slice")
    engine = phase_engine(card)
    timed("engine")
    mnist = phase_mnist(card)
    timed("mnist")
    log(f"[mnist] examples/s {mnist['examples_per_sec']:.1f}, ms per step "
        f"{mnist['ms_per_step']:.4f}, idle share {mnist['idle']:.3f}, "
        f"final test accuracy {mnist['accuracy']:.4f} ({card})")
    conv = phase_conv(card)
    timed("conv")
    bert = phase_bert(card)
    timed("bert")
    phase_train_rest(card)
    timed("train_rest")
    spec = phase_spec_chunk(card)
    timed("spec_chunk")
    phase_debug_tools(card)
    timed("debug_tools")
    http_ops = phase_http_ops(card)
    timed("http_ops")
    fleet = phase_fleet(card)
    timed("fleet")
    log(f"[bert] BERT-base {bert['seqs']:.1f} sequences/s, "
        f"{bert['tokens']:.0f} tokens/s, {bert['ms']:.2f} ms per step, idle "
        f"share {bert['idle']:.3f}, peak memory {bert['peak_mib']:.1f} MiB, "
        f"share of the bf16 peak {bert['peak_share']:.4f}; seq "
        f"{BERT_LONG_S} {bert['long_ms']:.2f} ms per step; bert_large "
        f"{bert['large_ms']:.2f} ms per step, peak "
        f"{bert['large_peak_mib']:.1f} MiB; bert_tiny card vs CPU "
        f"{bert['tiny_card_cpu']:.2e} ({card})")
    log(f"[conv] resnet50 examples/s {conv['r50_eps']:.1f}, ms per step "
        f"{conv['r50_ms']:.2f}, idle share {conv['r50_idle']:.3f}, peak "
        f"memory {conv['r50_peak_mib']:.1f} MiB, share of the bf16 peak "
        f"{conv['r50_peak_share']:.4f}; resnet20 examples/s "
        f"{conv['r20_eps']:.1f}, eval accuracy {conv['r20_accuracy']:.4f}, "
        f"card vs CPU {conv['r20_card_cpu']:.3e}; lenet examples/s "
        f"{conv['lenet_eps']:.1f}, eval accuracy "
        f"{conv['lenet_accuracy']:.4f} ({card})")
    rows = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "distributed_tensorflow_example_tpu_torch/csrc/"
                   "flash_attention_fwd.cu",
         "replaces": "distributed_tensorflow_example_tpu/ops/pallas/"
                     "flash_attention.py:142",
         "launches": launches["flash_attention_fwd"] + http_ops["b1"]
         + fleet["b1"],
         **flash},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "distributed_tensorflow_example_tpu_torch/csrc/"
                   "flash_attention_bwd_dq.cu",
         "replaces": "distributed_tensorflow_example_tpu/ops/pallas/"
                     "flash_attention.py:233",
         "launches": train["flash_attention_bwd_dq"], **bwd_dq},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "distributed_tensorflow_example_tpu_torch/csrc/"
                   "flash_attention_bwd_dkv.cu",
         "replaces": "distributed_tensorflow_example_tpu/ops/pallas/"
                     "flash_attention.py:268",
         "launches": train["flash_attention_bwd_dkv"], **bwd_dkv},
        {"name": "flash_attention_bwd_fused", "route": "cuda",
         "source": "distributed_tensorflow_example_tpu_torch/csrc/"
                   "flash_attention_bwd_fused.cu",
         "replaces": "distributed_tensorflow_example_tpu/ops/pallas/"
                     "flash_attention.py:310",
         "launches": cli_run["launches"], **bwd_fused},
        {"name": "decode_attention", "route": "cuda",
         "source": "distributed_tensorflow_example_tpu_torch/csrc/"
                   "decode_attention.cu",
         "replaces": "distributed_tensorflow_example_tpu/ops/pallas/"
                     "decode_attention.py:58",
         "launches": launches["decode_attention"], **decode},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "distributed_tensorflow_example_tpu_torch/csrc/"
                   "paged_decode_attention.cu",
         "replaces": "distributed_tensorflow_example_tpu/ops/pallas/"
                     "decode_attention.py:187",
         "launches": engine["launches"] + spec["b5"] + http_ops["b5"]
         + fleet["b5"],
         **paged},
        {"name": "paged_decode_attention_int8", "route": "cuda",
         "source": "distributed_tensorflow_example_tpu_torch/csrc/"
                   "paged_decode_attention_int8.cu",
         "replaces": "distributed_tensorflow_example_tpu/ops/pallas/"
                     "decode_attention.py:187",
         "launches": engine["launches_int8"] + spec["b6"]
         + http_ops["b6"] + fleet["b6"], **paged_int8},
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
