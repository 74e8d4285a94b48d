"""On-card check of the PyTorch/CUDA port: builds the hand-written Hopper
kernels, holds each against its plain PyTorch version at the serving
path's shapes, then serves GPT-small generation over HTTP through the
port's entry points and checks the kernels carried it.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``). Prints, in order:
the card's name and power limit, the kernel build (seconds and the
``-Xptxas -v`` register / shared-memory lines), one kernel phase per
kernel (error against the plain version, kernel / plain / library time,
the roofline bound), the slice phase (three ``:generate`` requests on
full-width GPT-small with launch counts, token agreement with the plain
versions, tokens/s, latency, peak memory), a ``{"kernels": [...]}``
JSON line, the card line again, and as the last line
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

FLASH_SHAPE = dict(b=8, s=512, h=12, d=64)
FLASH_ODD_S = 500
DECODE_SHAPE = dict(b=8, t=640, h=12, d=64)
PROMPT_LEN, MAX_NEW, BATCH = 512, 128, 8


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
    log("[kernels] flash_attention_fwd, decode_attention")
    launches = phase_slice(card)
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
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
