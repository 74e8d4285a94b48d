"""On-card check of the PyTorch/CUDA port: builds the hand-written Hopper
kernels, holds each against its plain PyTorch version at the shapes its
path gives it, trains GPT-small for a few steps through the port's sync
step and then through its training CLI (``cli/train.py`` -> ``Trainer``
-> checkpoint ring, the fused flash backward), then serves GPT-small
generation over HTTP through the port's entry points, without and with
the continuous-batching engine, and checks the kernels carried each
path; then it trains the source's MNIST MLP through the port's copy of
the reference example and through the CLI, its convolutional models
(LeNet, ResNet-20, ResNet-50) through the CLI, and last BERT's masked LM
(BERT-base, bert_large, bert_tiny) on the flash kernels' non-causal
path.

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
few steps each; bert_large's step time; bert_tiny card against CPU), a
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
    train = phase_train(card)
    cli_run = phase_cli(card)
    launches = phase_slice(card)
    engine = phase_engine(card)
    mnist = phase_mnist(card)
    log(f"[mnist] examples/s {mnist['examples_per_sec']:.1f}, ms per step "
        f"{mnist['ms_per_step']:.4f}, idle share {mnist['idle']:.3f}, "
        f"final test accuracy {mnist['accuracy']:.4f} ({card})")
    conv = phase_conv(card)
    bert = phase_bert(card)
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
         "launches": launches["flash_attention_fwd"], **flash},
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
         "launches": engine["launches"], **paged},
        {"name": "paged_decode_attention_int8", "route": "cuda",
         "source": "distributed_tensorflow_example_tpu_torch/csrc/"
                   "paged_decode_attention_int8.cu",
         "replaces": "distributed_tensorflow_example_tpu/ops/pallas/"
                     "decode_attention.py:187",
         "launches": engine["launches_int8"], **paged_int8},
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
