"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``.cu`` source has a plain C interface and is compiled on its own by
``nvcc`` into a shared library for ``sm_90a``, loaded with ``ctypes``. The
libraries go to ``_build/`` beside the package (listed in ``.gitignore``),
named by a hash of the sources and flags, so a changed source rebuilds and
an unchanged one loads at once. :func:`build` starts one ``nvcc`` per
missing library, all at once, and waits for them.

A missing ``nvcc`` or a failed build raises; nothing falls back to the plain
versions.
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
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# kernel library -> (source, C function, argtypes)
KERNELS = {
    "attend_project": ("attend_project.cu", "dcvit_attend_project_fwd",
                       [_P] * 7 + [_I] * 6 + [_F, _P]),
    "ln_mlp": ("ln_mlp.cu", "dcvit_ln_mlp_fwd",
               [_P] * 8 + [_LL, _I, _I, _I, _P]),
    "attend_project_bwd": ("attend_project_bwd.cu", "dcvit_attend_project_bwd",
                           [_P] * 12 + [_I] * 6 + [_F, _I, _P]),
    "ln_mlp_bwd": ("ln_mlp_bwd.cu", "dcvit_ln_mlp_bwd",
                   [_P] * 17 + [_LL, _I, _I, _I, _I, _P]),
    "flash_packed": ("flash_packed.cu", "dcvit_flash_packed_fwd",
                     [_P] * 5 + [_I] * 4 + [_LL] * 3 + [_I, _F, _P]),
    "flash_packed_bwd": ("flash_packed_bwd.cu", "dcvit_flash_packed_bwd",
                         [_P] * 8 + [_I] * 4 + [_LL] * 3 + [_I, _F, _P]),
    "ln_mlp_q": ("ln_mlp_q.cu", "dcvit_ln_mlp_q_fwd", [_P] * 12 + [_LL, _I, _I, _I, _P]),
    "ln_mlp_q_bwd": ("ln_mlp_q_bwd.cu", "dcvit_ln_mlp_q_bwd",
                     [_P] * 26 + [_LL, _I, _I, _I, _I, _P]),
    # the benchmark scripts' kernels (diverse_channel_vit_torch/scripts/)
    "bench_attn_bwd": ("bench_attn_bwd.cu", "dcvit_bench_attn_bwd",
                       [_P] * 8 + [_I] * 5 + [_F, _I, _P]),
    "qkv_flash": ("qkv_flash.cu", "dcvit_qkv_flash_fwd", [_P] * 2 + [_I] * 5 + [_F, _P]),
    "int8_ln_mlp": ("int8_ln_mlp.cu", "dcvit_int8_ln_mlp", [_P] * 11 + [_LL, _I, _I, _I, _P]),
}

# further C functions of those libraries: name -> (library, C function, argtypes)
SYMBOLS = {
    # B7's GELU on a range of float bit patterns, for checking what it relies on
    "gelu_tanh_rn_table": ("ln_mlp_q", "dcvit_gelu_tanh_rn_table",
                           [_P, ctypes.c_uint, _LL, _P]),
}

# ptxas register / shared-memory / spill report of each build, by kernel
BUILD_LOG: Dict[str, str] = {}

_LOCK = threading.Lock()
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found is None:
        cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
        cand = os.path.join(cuda_home, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built")
    return found


def _library_path(name: str) -> Path:
    src = KERNELS[name][0]
    h = hashlib.sha256()
    for part in [src] + sorted(p.name for p in CSRC.glob("*.cuh")):
        h.update((CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every kernel library in ``names`` (default: all) that is not
    built yet, one ``nvcc`` each, all started together. Returns the seconds
    spent."""
    names = list(KERNELS if names is None else names)
    t0 = time.perf_counter()
    with _LOCK:
        todo = [n for n in names if not _library_path(n).exists()]
        if not todo:
            return 0.0
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            out = _library_path(n)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[n][0])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[n] = log
            if proc.returncode != 0:
                failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def function(name: str):
    """The ctypes entry point of kernel library ``name`` (or the C function
    ``SYMBOLS[name]``), built on first use."""
    fn = _FUNCS.get(name)
    if fn is None:
        lib_name, symbol, argtypes = SYMBOLS.get(name) or (name, *KERNELS[name][1:])
        build([lib_name])
        with _LOCK:
            lib = ctypes.CDLL(str(_library_path(lib_name)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FUNCS[name] = fn
    return fn
