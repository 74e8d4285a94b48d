"""Probe of the flash forward kernel B1 on the card: the lever table of
``csrc/flash_attention_fwd.cu``, each variant held bitwise to an earlier
form of the kernel before it is timed.

    git show <commit>:distributed_tensorflow_example_tpu_torch/csrc/\\
flash_attention_fwd.cu > build/probe/fwd_old.cu
    python3 probes/flash_fwd_probe.py --old build/probe/fwd_old.cu

The variants are made by text substitution on the real source (and on
``csrc/flash_attention.cuh`` for the loads), each taking one lever out:

- ``ring``: the cp.async copies (plain 16- and 4-byte loads and stores
  in their place, on the same schedule);
- ``ldmatrix``: the ldmatrix(.trans) B fragments (32- and 16-bit shared
  loads in their place);
- ``order``: the heaviest-first map (CTA x takes query tile x % nq of
  b*h x / nq, the order of a 2-D grid in blockIdx order);
- ``shortcut``: the all-valid tile's skipped predicate;
- ``branchfree``: ``expf(ok ? x - m : -inf)`` (a select after the exp
  in its place);
- ``minimum``: the launch bounds' minimum of CTAs an SM (no minimum in
  its place).

It builds the old source, the real one and, for each lever, the kernel
with only that lever, the kernel without it, and the kernel with none,
in parallel with the port's nvcc flags into ``build/probe/``; prints
each variant's registers, spills and CTAs an SM at D = 64 and 128;
checks that every variant's ``o`` and ``lse`` are ``torch.equal`` to the
old kernel's at a list of shapes (and the real one to the wrapper's);
then times the old kernel, every variant and SDPA on the device
(``chip_smoke.device_ms``, inputs past L2) in two rounds, the second in
reverse order, at three shapes. Exits non-zero if a variant's bits
differ. Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from distributed_tensorflow_example_tpu_torch.ops.cuda import (  # noqa: E402
    _build, flash_attention as fa)

OUT = ROOT / "build" / "probe"
SRC = _build.CSRC_DIR / "flash_attention_fwd.cu"
HDR = _build.CSRC_DIR / "flash_attention.cuh"
HDR_NAME = "flash_attention.cuh"
SYNC_HDR = "flash_attention_sync.cuh"

# element-wise B fragments: the loads of the kernel before ldmatrix
EW_HELPERS = r"""
template <int D>
__device__ __forceinline__ void mma_abt_ew(float (&acc)[BK / 8][4],
                                           const uint32_t (&a)[D / 16][4],
                                           const __nv_bfloat16* tile, int g,
                                           int t4) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const __nv_bfloat16* kr = tile + (n * 8 + g) * (D + PAD) + kk * 16 + t4 * 2;
      mma_bf16(acc[n], a[kk], *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
}

template <int D>
__device__ __forceinline__ void mma_xt_ew(float (&acc)[D / 8][4],
                                          const float (&x)[BK / 8][4],
                                          const __nv_bfloat16* tile, int g,
                                          int t4) {
  const uint16_t* tu = reinterpret_cast<const uint16_t*>(tile);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const uint16_t* vp = tu + (kk * 16 + t4 * 2) * (D + PAD) + dn * 8 + g;
      const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[D + PAD] << 16);
      const uint32_t b1 =
          (uint32_t)vp[8 * (D + PAD)] | ((uint32_t)vp[9 * (D + PAD)] << 16);
      mma_bf16(acc[dn], a, b0, b1);
    }
  }
}
"""

# text of the kernel -> text without the lever
LEVERS = {
    "ring": [(f'#include "{HDR_NAME}"', f'#include "{SYNC_HDR}"')],
    "ldmatrix": [
        ("constexpr float NEG_INF = -1e30f;\n",
         "constexpr float NEG_INF = -1e30f;\n" + EW_HELPERS),
        ("mma_abt<D>(s, qf, tK, lane);", "mma_abt_ew<D>(s, qf, tK, g, t4);"),
        ("mma_xt<D>(acc, s, tV, lane);", "mma_xt_ew<D>(acc, s, tV, g, t4);")],
    "order": [("  const int x = blockIdx.x / BH, bh = blockIdx.x % BH;\n"
               "  const int qt = causal ? nq - 1 - x : x;\n",
               "  const int bh = blockIdx.x / nq, qt = blockIdx.x % nq;\n")],
    "shortcut": [("    if (all_valid && (!causal || kt < qt)) {",
                  "    if (false) {")],
    "branchfree": [("        const float p =\n"
                    "            expf(x > NEG_INF * 0.5f ? x - mnew[e >> 1] "
                    ": -INFINITY);",
                    "        const float p =\n"
                    "            x > NEG_INF * 0.5f ? expf(x - mnew[e >> 1]) "
                    ": 0.f;")],
    "minimum": [("__launch_bounds__(NTHREADS, D == 64 ? 3 : 1)",
                 "__launch_bounds__(NTHREADS)")],
}

OCC_NEW = r"""
extern "C" int probe_occupancy(int D) {
  int n = -1;
  if (D == 64) {
    cudaFuncSetAttribute(flash_fwd_kernel<64>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)flash::ring_bytes<64>());
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_kernel<64>,
        flash::NTHREADS, flash::ring_bytes<64>());
  } else {
    cudaFuncSetAttribute(flash_fwd_kernel<128>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)flash::ring_bytes<128>());
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_kernel<128>,
        flash::NTHREADS, flash::ring_bytes<128>());
  }
  return n;
}
"""
OCC_OLD = r"""
extern "C" int probe_occupancy(int D) {
  int n = -1;
  if (D == 64)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_kernel<64>,
        NTHREADS, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_kernel<128>,
        NTHREADS, 0);
  return n;
}
"""


def sync_header(text: str) -> str:
    """The shared header with plain copies in place of cp.async."""
    for width, ctype in ((16, "int4"), (4, "int")):
        pat = (r"__device__ __forceinline__ void cp_async%d\(void\* dst, "
               r"const void\* src\) \{.*?\n\}" % width)
        body = (f"__device__ __forceinline__ void cp_async{width}(void* dst, "
                f"const void* src) {{\n  *reinterpret_cast<{ctype}*>(dst) = "
                f"*reinterpret_cast<const {ctype}*>(src);\n}}")
        text, n = re.subn(pat, body, text, flags=re.S)
        assert n == 1, f"cp_async{width} not found in the header"
    return text


def without(text: str, levers) -> str:
    for lever in levers:
        for old, new in LEVERS[lever]:
            assert text.count(old) == 1, f"{lever}: {old!r} not found once"
            text = text.replace(old, new)
    return text


def variants() -> dict[str, str]:
    """name -> source text: all (the real source), only-<lever>,
    no-<lever> and none."""
    src = SRC.read_text()
    names = list(LEVERS)
    out = {"all": src}
    for lever in names:
        out[f"no-{lever}"] = without(src, [lever])
        out[f"only-{lever}"] = without(src, [x for x in names if x != lever])
    out["none"] = without(src, names)
    return {k: v + OCC_NEW for k, v in out.items()}


def build(sources: dict[str, str]) -> dict[str, dict]:
    """Compile every source in parallel; returns name -> {path, log}."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / HDR_NAME).write_text(HDR.read_text())
    (OUT / SYNC_HDR).write_text(sync_header(HDR.read_text()))
    nvcc = _build._nvcc()
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"fwd_{name}.cu"
        cu.write_text(text)
        so = OUT / f"fwd_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        built[name] = {"path": so, "log": log}
    return built


def ptxas(log: str) -> dict[int, str]:
    """D -> 'R regs, spill S/L bytes' from nvcc's -Xptxas -v output."""
    out, d = {}, None
    for line in log.splitlines():
        m = re.search(r"flash_fwd_kernelILi(\d+)E", line)
        if m:
            d = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and d:
            out[d] = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and d:
            out[d] = f"{m.group(1)} regs, {out.get(d, '')}"
    return out


class Kernel:
    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        self.fn = self.lib.flash_attention_fwd
        self.fn.argtypes = _build.ENTRY_POINTS["flash_attention_fwd"]
        self.fn.restype = ctypes.c_int
        self.lib.probe_occupancy.argtypes = [ctypes.c_int]
        self.lib.probe_occupancy.restype = ctypes.c_int

    def __call__(self, q, k, v, mask, causal):
        b, s, h, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        err = self.fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      None if mask is None else mask.data_ptr(), o.data_ptr(),
                      lse.data_ptr(), b, s, h, d, int(causal),
                      1.0 / math.sqrt(d),
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return o, lse


def inputs(b, s, h, d, mask_kind, seed):
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    q, k, v = (torch.randn((b, s, h, d), generator=gen).to(
        dev, torch.bfloat16) for _ in range(3))
    if mask_kind == "pads":
        mask = cs._ragged_key_mask(gen, b, s, dev)
    elif mask_kind == "dead":
        # row 0: its first 200 keys masked (three whole tiles); row 1: every
        # key masked
        mask = torch.ones((b, s), dtype=torch.int32, device=dev)
        mask[0, :200] = 0
        mask[1] = 0
    else:
        mask = None
    return q, k, v, mask


# (label, b, s, h, d, causal, mask)
CHECKS = [
    ("B=8 S=512 H=12 D=64 causal pads", 8, 512, 12, 64, True, "pads"),
    ("B=8 S=512 non-causal pads", 8, 512, 12, 64, False, "pads"),
    ("B=8 S=500 causal pads", 8, 500, 12, 64, True, "pads"),
    ("B=8 S=500 non-causal pads", 8, 500, 12, 64, False, "pads"),
    ("B=8 S=77 causal pads", 8, 77, 12, 64, True, "pads"),
    ("B=8 S=77 non-causal pads", 8, 77, 12, 64, False, "pads"),
    ("B=8 S=512 H=6 D=128 causal no mask", 8, 512, 6, 128, True, None),
    ("B=8 S=512 H=6 D=128 non-causal no mask", 8, 512, 6, 128, False, None),
    ("B=8 S=500 H=6 D=128 causal pads", 8, 500, 6, 128, True, "pads"),
    ("B=1 S=4096 H=12 D=64 causal", 1, 4096, 12, 64, True, "pads"),
    ("B=2 S=320 non-causal, dead tiles and a dead row", 2, 320, 12, 64,
     False, "dead"),
    ("B=2 S=320 causal, dead tiles and a dead row", 2, 320, 12, 64, True,
     "dead"),
]
# (label, b, s, h, d): causal, ragged left pads (row 0 unpadded)
TIMES = [("B=8 S=512 H=12 D=64", 8, 512, 12, 64),
         ("B=1 S=4096 H=12 D=64", 1, 4096, 12, 64),
         ("B=8 S=512 H=6 D=128", 8, 512, 6, 128)]


def check(kernels: dict) -> bool:
    ok_all = True
    for i, (label, b, s, h, d, causal, mk) in enumerate(CHECKS):
        q, k, v, mask = inputs(b, s, h, d, mk, 100 + i)
        o_ref, l_ref = kernels["old"](q, k, v, mask, causal)
        wrap = fa.flash_attention_fwd(q, k, v, mask, causal)
        bad = [] if (torch.equal(wrap[0], o_ref)
                     and torch.equal(wrap[1], l_ref)) else ["wrapper"]
        for name, kern in kernels.items():
            o, lse = kern(q, k, v, mask, causal)
            if not (torch.equal(o, o_ref) and torch.equal(lse, l_ref)):
                bad.append(name)
        torch.cuda.synchronize()
        print(f"[bits] {label}: {len(kernels) + 1} kernels, "
              f"{'all torch.equal to the old kernel' if not bad else 'DIFFER: ' + ', '.join(bad)}",
              flush=True)
        ok_all = ok_all and not bad
    return ok_all


def times(kernels: dict, card: str) -> None:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, b, s, h, d in TIMES:
        q, k, v, mask = inputs(b, s, h, d, "pads", 7)
        first_live = (mask == 0).sum(dim=1)
        live_pairs = sum((s - int(p)) * (s - int(p) + 1) // 2
                         for p in first_live)
        flops = 4.0 * d * h * live_pairs
        nbytes = 4 * b * s * h * d * 2 + b * s * 4 + b * h * s * 4
        bms, by = cs.bound(flops, nbytes)
        sets = cs.cold_sets((q, k, v, mask))
        how = cs.sdpa_mask_args(mask, causal=True)
        fns = {name: (lambda kern: lambda *a: kern(*a, True))(kern)
               for name, kern in kernels.items()}
        fns[f"sdpa {', '.join(how)}"] = lambda q_, k_, v_, _: sdpa(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            **how)
        res = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                res[name].append(cs.device_ms(fns[name], sets))
        print(f"[time] {label} causal, pads {first_live.tolist()}: bound "
              f"{bms:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB); device ms, rounds 1 | 2 ({card})",
              flush=True)
        for name, (r1, r2) in res.items():
            print(f"[time]   {name:18s} {r1:.4f} | {r2:.4f}  "
                  f"(x{(r1 + r2) / 2 / bms:.2f} bound)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="an earlier flash_attention_fwd.cu to hold bits to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_probe: CUDA is not available", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"[device] {card} torch {torch.__version__}", flush=True)
    sources = {"old": Path(args.old).read_text() + OCC_OLD,
               **variants()}
    built = build(sources)
    kernels = {name: Kernel(rec["path"]) for name, rec in built.items()}
    for name, rec in built.items():
        regs = ptxas(rec["log"])
        occ = {d: kernels[name].lib.probe_occupancy(d) for d in (64, 128)}
        print(f"[regs] {name:16s} D=64: {regs.get(64)}, {occ[64]} CTAs/SM; "
              f"D=128: {regs.get(128)}, {occ[128]} CTAs/SM", flush=True)
    ok = check(kernels)
    if ok:
        times(kernels, card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
