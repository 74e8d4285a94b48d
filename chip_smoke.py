"""On-card check of the PyTorch/CUDA port: builds the hand-written Hopper
kernels, holds each against its plain PyTorch version at the serving
path's shapes, then serves GPT-small generation over HTTP through the
port's entry points, without and with the continuous-batching engine,
and checks the kernels carried it.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``). Prints, in order:
the card's name and power limit, the kernel build (seconds and the
``-Xptxas -v`` register / shared-memory lines), one kernel phase per
kernel (error against the plain version, kernel / plain / library time,
the roofline bound), the slice phase (three ``:generate`` requests on
full-width GPT-small with launch counts, token agreement with the plain
versions, tokens/s, latency, peak memory), the engine phase (the
continuous-batching engine over HTTP on a paged and a slab export:
concurrent requests, prefix reuse, launch counts, paged-vs-slab
agreement, tokens/s, latency, peak memory, the device idle share of one
request), a ``{"kernels": [...]}`` JSON line, the card line again, and
as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line; without CUDA (or outside the repository) it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
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

# paged decode attention: the slab kernel's arithmetic through one table
# lookup per slot. Measured worst rows (H100, 700 W): 6.5e-3 at D=64 (one
# bf16 ulp of an element, as for flash), 2.2e-7 at D=128; the limit is 3x
# the worst, two ulps
PAGED_ROW_REL_TOL = 2e-2

FLASH_SHAPE = dict(b=8, s=512, h=12, d=64)
# the engine's decode step at GPT-small: 8 slots, 12 heads, 16-slot blocks,
# 40 blocks per row (prompt 512 + 128 new = 640 slots)
PAGED_SHAPE = dict(b=8, h=12, bs=16, nb=40)
FLASH_ODD_S = 500
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


def row_rel_err(o: torch.Tensor, o_ref: torch.Tensor) -> float:
    """Worst row of ``max|o - o_ref| / max|o_ref|`` over the last axis. A
    row whose reference is all zero counts 0 only where ``o`` is zero too."""
    diff = (o.float() - o_ref.float()).abs().amax(dim=-1)
    size = o_ref.float().abs().amax(dim=-1)
    return (diff / size.clamp_min(torch.finfo(torch.float32).tiny)
            ).max().item()


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


def flash_case(s: int, gen, timed: bool) -> dict:
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        flash_attention as fa
    dev = torch.device("cuda")
    b, h, d = FLASH_SHAPE["b"], FLASH_SHAPE["h"], FLASH_SHAPE["d"]
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
    log(f"[flash S={s}] worst row max|o - plain| / max|plain| {rel:.3e} "
        f"(tol {FLASH_ROW_REL_TOL}; max abs err {err:.3e}), "
        f"max|lse - plain| {lse_err:.3e} (tol {FLASH_LSE_TOL}), "
        f"fully-masked rows max|o| {dead_max} (must be 0): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"flash_attention_fwd disagrees with its plain "
                         f"version at S={s}")
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
    kms = cuda_ms(lambda *a: fa.flash_attention_fwd(*a, causal=True), sets)
    pms = cuda_ms(lambda *a: fa.flash_attention_fwd_plain(*a, causal=True),
                  sets, iters=8)
    causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    amask = (causal[None] & (mask[:, None, :] != 0))[:, None]  # [B,1,S,S]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lms = cuda_ms(lambda q_, k_, v_, _: sdpa(          # [B,H,S,D] views
        q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
        attn_mask=amask), sets)
    log(f"[flash S={s}] kernel_ms {kms:.4f}, plain_ms {pms:.4f}, "
        f"library_ms (sdpa) {lms:.4f}, bound_ms {bms:.4f} "
        f"({by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    rec.update(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
               bound_by=by)
    return rec


def phase_flash(gen) -> dict:
    rec = flash_case(FLASH_SHAPE["s"], gen, timed=True)
    odd = flash_case(FLASH_ODD_S, gen, timed=False)
    for key in ("max_abs_err", "max_row_rel_err"):
        rec[key] = max(rec[key], odd[key])
    return rec


def phase_decode(gen) -> dict:
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        decode_attention as da
    dev = torch.device("cuda")
    b, t, h, d = (DECODE_SHAPE[x] for x in ("b", "t", "h", "d"))
    q = torch.randn((b, h, d), generator=gen).to(dev, torch.bfloat16)
    k, v = (torch.randn((b, t, h, d), generator=gen).to(
        dev, torch.bfloat16) for _ in range(2))
    pad = torch.randint(0, 128, (b,), generator=gen, dtype=torch.int32)
    pos = torch.randint(t - 128, t, (b,), generator=gen, dtype=torch.int32)
    pad[0], pos[0] = 0, t - 1                  # one full-window row
    pad, pos = pad.to(dev), pos.to(dev)
    t_odd = t - 27               # odd cache length: no T % 128 gate here
    k_odd, v_odd = k[:, :t_odd].contiguous(), v[:, :t_odd].contiguous()
    err = rel = 0.0
    for name, args, p in (("[B] pos", (k, v), pos),
                          ("scalar pos", (k, v), t - 1),
                          (f"T={t_odd}", (k_odd, v_odd), t_odd - 1)):
        o = da.decode_attention(q, *args, pos=p, pad=pad)
        o_ref = da.xla_decode_attention(q, *args, pos=p, pad=pad)
        torch.cuda.synchronize()
        e = (o.float() - o_ref.float()).abs().max().item()
        r = row_rel_err(o, o_ref)
        log(f"[decode {name}] worst row max|o - plain| / max|plain| "
            f"{r:.3e} (tol {DECODE_ROW_REL_TOL}; max abs err {e:.3e})")
        err, rel = max(err, e), max(rel, r)
    if rel > DECODE_ROW_REL_TOL:
        raise SystemExit("decode_attention disagrees with its plain version")
    live = int((pos - pad + 1).sum())
    flops = 4.0 * h * d * live
    nbytes = (2 * live * h * d * 2                   # live K and V rows
              + 2 * b * h * d * 2 + 2 * b * 4)       # q in, o out; pos, pad
    bms, by = bound(flops, nbytes)
    sets = cold_sets((q, k, v))
    kms = cuda_ms(lambda *a: da.decode_attention(*a, pos=pos, pad=pad),
                  sets, iters=192)
    pms = cuda_ms(lambda *a: da.xla_decode_attention(*a, pos=pos, pad=pad),
                  sets)
    slots = torch.arange(t, device=dev)
    amask = ((slots[None, :] <= pos[:, None])
             & (slots[None, :] >= pad[:, None]))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lms = cuda_ms(lambda q_, k_, v_: sdpa(             # [B,H,T,D] views
        q_[:, :, None], k_.transpose(1, 2), v_.transpose(1, 2),
        attn_mask=amask), sets, iters=192)
    log(f"[decode] kernel_ms {kms:.4f}, plain_ms {pms:.4f}, library_ms "
        f"(sdpa) {lms:.4f}, bound_ms {bms:.4f} ({by}: {live} live "
        f"slots of {b * t}, {nbytes / 1e6:.2f} MB)")
    return {"max_abs_err": err, "max_row_rel_err": rel, "ms": kms,
            "plain_ms": pms,
            "library_ms": lms, "bound_ms": bms, "bound_by": by}


def paged_inputs(gen, d: int) -> dict:
    """B5's inputs at the engine's shapes: B rows of ~640 logical slots in
    16-slot blocks, physical blocks shuffled over the pool, rows 0-3
    sharing their first 8 blocks (a 128-token prefix), per-row pos and
    pad, and table entries outside each row's live window pointing at the
    null block 0 (random bytes here; :func:`phase_paged` also runs it
    NaN-filled)."""
    dev = torch.device("cuda")
    b, h, bs, nb = (PAGED_SHAPE[x] for x in ("b", "h", "bs", "nb"))
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


def phase_paged(gen) -> dict:
    """B5 against its plain version at D=64 and D=128 (shuffled and shared
    blocks), and against itself with the null block 0 NaN-filled: the
    output must not change by a bit, since the kernel never reads a
    masked slot. (The plain version, like the reference's gather path,
    multiplies masked V rows by zero probabilities, so it cannot take a
    NaN null block.) Then timed at D=64: the kernel, the plain version,
    and SDPA over the gathered slab with and without the gather."""
    from distributed_tensorflow_example_tpu_torch.ops.cuda import \
        paged_decode_attention as pa
    err = rel = 0.0
    for d in (128, 64):                 # the timed D=64 inputs stay below
        x = paged_inputs(gen, d)
        kw = dict(block_tables=x["bt"], pos=x["pos"], pad=x["pad"])
        o = pa.paged_decode_attention(x["q"], x["k_pool"], x["v_pool"], **kw)
        o_ref = pa.xla_paged_decode_attention(x["q"], x["k_pool"],
                                              x["v_pool"], **kw)
        k_nan, v_nan = x["k_pool"].clone(), x["v_pool"].clone()
        k_nan[0] = v_nan[0] = float("nan")
        o_nan = pa.paged_decode_attention(x["q"], k_nan, v_nan, **kw)
        torch.cuda.synchronize()
        e = (o.float() - o_ref.float()).abs().max().item()
        r = row_rel_err(o, o_ref)
        same = bool(torch.equal(o, o_nan))
        log(f"[paged D={d}] worst row max|o - plain| / max|plain| {r:.3e} "
            f"(tol {PAGED_ROW_REL_TOL}; max abs err {e:.3e}); NaN null "
            f"block leaves the output bitwise unchanged: {same}")
        if not same or r > PAGED_ROW_REL_TOL:
            raise SystemExit(f"paged_decode_attention disagrees with its "
                             f"plain version at D={d}")
        err, rel = max(err, e), max(rel, r)
    b, h, bs, nb = (PAGED_SHAPE[x] for x in ("b", "h", "bs", "nb"))
    d = 64
    pos, pad, bt = x["pos"], x["pad"], x["bt"]
    live = int((pos - pad + 1).sum())
    flops = 4.0 * h * d * live
    nbytes = (2 * live * h * d * 2                   # live K and V rows
              + 2 * b * h * d * 2                    # q in, o out
              + b * nb * 4 + 2 * b * 4)              # table, pos, pad
    bms, by = bound(flops, nbytes)
    sets = cold_sets((x["q"], x["k_pool"], x["v_pool"]))
    kw = dict(block_tables=bt, pos=pos, pad=pad)
    kms = cuda_ms(lambda *a: pa.paged_decode_attention(*a, **kw), sets,
                  iters=192)
    pms = cuda_ms(lambda *a: pa.xla_paged_decode_attention(*a, **kw), sets)
    slots = torch.arange(nb * bs, device=pos.device)
    amask = ((slots[None, :] <= pos[:, None])
             & (slots[None, :] >= pad[:, None]))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bt_l = bt.long()

    def gathered(q_, kp, vp):
        k_ = kp[bt_l].reshape(b, nb * bs, h, d)
        v_ = vp[bt_l].reshape(b, nb * bs, h, d)
        return sdpa(q_[:, :, None], k_.transpose(1, 2), v_.transpose(1, 2),
                    attn_mask=amask)

    slab_sets = [(q_, kp[bt_l].reshape(b, nb * bs, h, d),
                  vp[bt_l].reshape(b, nb * bs, h, d)) for q_, kp, vp in sets]
    lms = cuda_ms(lambda q_, k_, v_: sdpa(
        q_[:, :, None], k_.transpose(1, 2), v_.transpose(1, 2),
        attn_mask=amask), slab_sets, iters=192)
    gms = cuda_ms(gathered, sets, iters=192)
    log(f"[paged] kernel_ms {kms:.4f}, plain_ms {pms:.4f}, library_ms "
        f"(sdpa over the gathered slab) {lms:.4f}, with the gather "
        f"{gms:.4f}, bound_ms {bms:.4f} ({by}: {live} live slots of "
        f"{b * nb * bs}, {nbytes / 1e6:.2f} MB)")
    return {"max_abs_err": err, "max_row_rel_err": rel, "ms": kms,
            "plain_ms": pms, "library_ms": lms, "library_gather_ms": gms,
            "bound_ms": bms, "bound_by": by}


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
    from distributed_tensorflow_example_tpu_torch.ops.cuda import (
        decode_attention as da, flash_attention as fa)
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
            fa.flash_attention_fwd.launches = 0
            da.decode_attention.launches = 0
            outs, lat = [], []
            for srv, label, payload in requests:
                body, sec = post(srv.port, srv.name, payload)
                outs.append(np.asarray(body["generations"]))
                lat.append(sec)
            launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                        "decode_attention": da.decode_attention.launches}
            peak = torch.cuda.max_memory_allocated()
            again, _ = post(s_srv.port, s_srv.name, requests[2][2])
    n_req = len(requests)
    want = {"flash_attention_fwd": c.layers * n_req,
            "decode_attention": c.layers * (MAX_NEW - 1) * n_req}
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
    return launches


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


def _reset_launches() -> dict:
    from distributed_tensorflow_example_tpu_torch.ops.cuda import (
        decode_attention as da, flash_attention as fa,
        paged_decode_attention as pa)
    fns = {"flash_attention_fwd": fa.flash_attention_fwd,
           "decode_attention": da.decode_attention,
           "paged_decode_attention": pa.paged_decode_attention}
    for fn in fns.values():
        fn.launches = 0
    return fns


def _engine_wave(srv, label: str, prompts: list, card: str) -> dict:
    """One wave of concurrent requests through ``srv``'s engine, with
    every kernel's launch count set to 0 just before it and read just
    after, and the engine's dispatch counters over the same window."""
    eng = srv.engine
    n = len(prompts)
    results, lat = [None] * n, [0.0] * n
    d0, p0 = eng.decode_steps, eng.prefills
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fns = _reset_launches()
    wall = _post_rows(srv, prompts, results, lat)
    launches = {k: fn.launches for k, fn in fns.items()}
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
            "prefills": prefills, "wall": wall}


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
                      "paged_decode_attention": c.layers * paged["steps"]},
            "slab": {"flash_attention_fwd": c.layers * slab["prefills"],
                     "decode_attention": c.layers * slab["steps"],
                     "paged_decode_attention": 0}}
    for label, run in (("paged", paged), ("slab", slab)):
        if run["launches"] != want[label] or run["steps"] < MAX_NEW - 1:
            raise SystemExit(f"engine {label}: launches {run['launches']} "
                             f"over {run['steps']} shared steps, want "
                             f"{want[label]}")
    if shared["launches"]["paged_decode_attention"] \
            != c.layers * shared["steps"] or shared["prefills"]:
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
            "idle": idle}


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


def phase_engine_profile(eng, prompt, card: str) -> float:
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
    log(f"[engine profile] one request ({prompt.size} prompt tokens, "
        f"{MAX_NEW} new): {wall * 1e3:.1f} ms, {MAX_NEW / wall:.1f} "
        f"tokens/s ({card})")
    if not kernels:
        log("[engine profile] the profiler saw no device time: idle share "
            "not measured")
        return float("nan")
    idle = 1 - busy / (wall * 1e3)
    log(f"[engine profile] traced request {traced * 1e3:.1f} ms, device "
        f"busy {busy:.1f} ms: idle share {1 - busy / (traced * 1e3):.3f} "
        f"of the traced request, {idle:.3f} of the untraced one")
    for e in sorted(kernels, key=_device_us, reverse=True)[:6]:
        log(f"[engine profile]   {_device_us(e) / 1e3:8.2f} ms  "
            f"{e.count:6d}x  {e.key[:90]}")
    return idle


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
    decode = phase_decode(gen)
    paged = phase_paged(gen)
    log("[kernels] flash_attention_fwd, decode_attention, "
        "paged_decode_attention")
    launches = phase_slice(card)
    engine = phase_engine(card)
    rows = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "distributed_tensorflow_example_tpu_torch/csrc/"
                   "flash_attention_fwd.cu",
         "replaces": "distributed_tensorflow_example_tpu/ops/pallas/"
                     "flash_attention.py:142",
         "launches": launches["flash_attention_fwd"], **flash},
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
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
