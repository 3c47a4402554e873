"""Native (C++) host kernel of the CHAMMI loader, built on first use and
bound with ctypes (the port's own copy of the JAX package's ``native/``).

``chammi_preproc.cc`` fuses the tape unfold, the crop, the bilinear resize
and the normalisation of one train view. It is compiled by the host C++
compiler (``c++``) into ``_build/`` beside the package (listed
in ``.gitignore``), named by a hash of the source and flags, as
``ops/kernels.py`` builds the CUDA kernels. A missing compiler or a failed
build raises: the JAX package falls back to numpy there, the port does not.
The numpy pipeline (``data/morphem70k.py`` ``plain_train_view``) is this
function's plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "chammi_preproc.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_fn = None


def compiler() -> str:
    found = shutil.which("c++")
    if found is None:
        raise RuntimeError("host C++ compiler 'c++' not found on PATH: the native CHAMMI "
                           "preprocessing cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libchammi_preproc-{h.hexdigest()[:16]}.so"


def _load():
    global _fn
    with _lock:
        if _fn is not None:
            return _fn
        so = library_path()
        if not so.exists():
            cxx = compiler()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"native CHAMMI preprocessing: {cxx} exit {proc.returncode}:"
                                   f"\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        fn = ctypes.CDLL(str(so)).fold_crop_resize_normalize
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_float,
        ]
        fn.restype = None
        _fn = fn
        return fn


def fold_crop_resize_normalize(tape: np.ndarray, channel_width: int, crop: tuple, out_hw: int,
                               mean, std) -> np.ndarray:
    """Fused unfold + crop + resize + normalize of a (h, w*c) uint8 or uint16
    tape: float32 (c, out_hw, out_hw), ``crop`` = (y, x, h, w) in the
    unfolded image's coordinates."""
    if tape.dtype == np.uint8:
        elem, scale = 1, 255.0
    elif tape.dtype == np.uint16:
        elem, scale = 2, 65535.0
    else:
        raise TypeError(f"tape dtype {tape.dtype}: the native op takes uint8 or uint16")
    fn = _load()
    tape = np.ascontiguousarray(tape)
    h = tape.shape[0]
    w = int(channel_width)
    c = tape.shape[1] // w
    cy, cx, ch_, cw = (int(v) for v in crop)
    out = np.empty((c, out_hw, out_hw), np.float32)
    mean = np.ascontiguousarray(np.asarray(mean, np.float32))
    std = np.ascontiguousarray(np.asarray(std, np.float32))
    fn(tape.ctypes.data_as(ctypes.c_void_p), elem, h, w, c, cy, cx, ch_, cw,
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_hw,
       mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
       std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_float(scale))
    return out
