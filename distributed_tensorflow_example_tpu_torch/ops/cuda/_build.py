"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` source has a plain C interface (pointers, ints, a
float, the stream) and is compiled on first use into its own shared
library under ``build/kernels/`` at the repository root::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<stem>-<hash>.so csrc/<stem>.cu

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited kernel is rebuilt and a
stale library is never loaded. All sources are
compiled in parallel (one ``nvcc`` process each). Each source has one
entry point, named as the source, whose C signature is bound once (see
:data:`ENTRY_POINTS`); :func:`launch` passes pointers and the CUDA stream
as ``ctypes.c_void_p`` and raises when the entry point's
``cudaGetLastError()`` is not 0.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ...utils.logging import get_logger

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: argument types of each source's entry point, the stream last; every
#: entry point returns its ``cudaGetLastError()`` as an int
ENTRY_POINTS = {
    # q, k, v, mask, o, lse, B, S, H, D, causal, sm_scale, stream
    "flash_attention_fwd": [_P] * 6 + [_I] * 5 + [_F, _P],
    # q, k, v, do, lse, dsum, mask, dq, B, S, H, D, causal, sm_scale, stream
    "flash_attention_bwd_dq": [_P] * 8 + [_I] * 5 + [_F, _P],
    # q, k, v, do, lse, dsum, mask, dk, dv, B, S, H, D, causal, sm_scale,
    # stream
    "flash_attention_bwd_dkv": [_P] * 9 + [_I] * 5 + [_F, _P],
    # q, k, v, do, lse, dsum, mask, dq, dk, dv, dq_acc, sync, B, S, H, D,
    # causal, sm_scale, stream
    "flash_attention_bwd_fused": [_P] * 12 + [_I] * 5 + [_F, _P],
    # q, k, v, pos, pad, scratch, o, B, T, H, D, per, splits, sm_scale,
    # stream
    "decode_attention": [_P] * 7 + [_I] * 6 + [_F, _P],
    # q, k_pool, v_pool, block_tables, pos, pad, part, o, B, N, Bs, NB, H,
    # D, per, splits, sm_scale, stream
    "paged_decode_attention": [_P] * 8 + [_I] * 8 + [_F, _P],
    # q, k_pool, v_pool, k_scale, v_scale, block_tables, pos, pad, part, o,
    # B, N, Bs, NB, H, D, per, splits, sm_scale, stream
    "paged_decode_attention_int8": [_P] * 10 + [_I] * 8 + [_F, _P],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}      # stem -> its bound entry point
#: per-source build record of this process: {"stem": {"seconds", "log"}}
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels are built on first use")


def _lib_path(src: Path) -> Path:
    """The library of ``src``, named by a hash of the source, the shared
    headers of ``csrc/`` (``*.cuh``) and the flags."""
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(text
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_all() -> dict[str, dict]:
    """Compile every source whose library is missing, all in parallel.
    Returns :data:`build_log` (seconds and nvcc's ``-Xptxas -v`` output per
    source built by this process). Raises naming the source on failure."""
    with _lock:
        todo = [s for s in sources() if not _lib_path(s).exists()]
        if not todo:
            return build_log
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            out = _lib_path(src)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs.append((src, out, tmp, time.perf_counter(), subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, out, tmp, t0, proc in procs:
            log, _ = proc.communicate()
            build_log[src.stem] = {"seconds": time.perf_counter() - t0,
                                   "log": log}
            if proc.returncode != 0:
                failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n"
                              f"{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)     # atomic: no half-written library
                get_logger("kernels").info(
                    "built %s in %.2f s", out.name,
                    build_log[src.stem]["seconds"])
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        return build_log


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (built on first use)."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    src = CSRC_DIR / f"{stem}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    path = _lib_path(src)
    if not path.exists():
        build_all()
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = _libs[stem] = ctypes.CDLL(str(path))
    return lib


def _bind(stem: str):
    fn = getattr(load(stem), stem)
    fn.argtypes = ENTRY_POINTS[stem]
    fn.restype = ctypes.c_int
    _fns[stem] = fn
    return fn


def launch(stem: str, device: torch.device, *args) -> None:
    """Call the entry point of ``csrc/<stem>.cu`` with ``args`` on the
    current stream of ``device``. Raises when it reports a CUDA error
    (launch refused, bad argument): such a launch never ran, and a later
    synchronize would not report it."""
    fn = _fns.get(stem) or _bind(stem)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {stem} failed to launch: cudaError "
                           f"{err}")
