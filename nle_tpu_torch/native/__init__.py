"""The host Lab conversions in C (labcolor.c, a verbatim copy of the JAX
package's nle_tpu/native/labcolor.c), built with the system C compiler at
first use and loaded with ctypes.

The build tries `-O3 -march=native -fopenmp`, then the same without
OpenMP, with cc, gcc and clang in turn. It compiles to a temp name and
os.replace()s the result into nle_tpu_torch/_build/, under a thread lock
and a file lock (test workers and server threads may all be first users),
so no process ever loads a half-written library. The library's name holds
a key of the source's hash and this machine (node name and architecture):
-march=native code built on one machine must not run on another, so a
copied build directory is rebuilt, never trusted. A marker beside the
library, written after it, records the compiler and flags that built it.

`load()` returns None when no compiler can build the source; the callers
(color/lab.py) then take their NumPy path and log one warning naming it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "labcolor.c")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAG_SETS = (
    ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"),
    ("-O3", "-march=native", "-shared", "-fPIC"),     # without OpenMP
)
COMPILERS = ("cc", "gcc", "clang")

_lib = None
_tried = False
_lock = threading.Lock()


def library_path(build_dir: str = BUILD_DIR) -> str:
    """Where this source, built on this machine, lives."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    h.update(f"{platform.node()}:{platform.machine()}".encode())
    h.update(repr(FLAG_SETS).encode())
    return os.path.join(build_dir, f"labcolor-{h.hexdigest()[:16]}.so")


def build(so: str) -> str | None:
    """Compile SOURCE into `so` (temp name, then os.replace); returns the
    command line that built it, or None when no compiler and flag set
    succeeds."""
    tmp = f"{so}.tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        for flags in FLAG_SETS:
            for cc in COMPILERS:
                cmd = [cc, *flags, SOURCE, "-o", tmp]
                try:
                    subprocess.run(cmd, check=True, capture_output=True,
                                   timeout=300)
                except (OSError, subprocess.SubprocessError):
                    continue
                os.replace(tmp, so)
                return " ".join(cmd)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.bgr2lab_u8.argtypes = [u8p, u8p, ctypes.c_size_t, i32p, i32p, i32p,
                               ctypes.c_int32, ctypes.c_int32]
    lib.bgr2lab_u8.restype = None
    lib.lab2bgr_u8.argtypes = [u8p, u8p, ctypes.c_size_t, i32p, i32p, i32p,
                               ctypes.c_int32, ctypes.c_int32, i64p, u8p,
                               i32p, i32p]
    lib.lab2bgr_u8.restype = None


def load_from(build_dir: str):
    """The library built into `build_dir` (building it when it or its
    marker is missing), or None when it cannot be built. Serialized across
    processes by a file lock in `build_dir`."""
    so = library_path(build_dir)
    marker = so[:-3] + ".built"
    if not (os.path.exists(so) and os.path.exists(marker)):
        os.makedirs(build_dir, exist_ok=True)
        with open(os.path.join(build_dir, "labcolor.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if not (os.path.exists(so) and os.path.exists(marker)):
                cmd = build(so)
                if cmd is None:
                    return None
                with open(marker, "w") as fh:
                    fh.write(cmd + "\n")
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    _declare(lib)
    return lib


def load():
    """The process's library (built on first use), or None without a C
    compiler. Thread-safe; a failed build is not retried."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            _lib = load_from(BUILD_DIR)
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def bgr2lab_u8(lib, bgr: np.ndarray, gamma_tab, cbrt_tab, coeffs, l_scale,
               l_shift) -> np.ndarray:
    """(..., 3) uint8 BGR -> Lab through `lib`; the tables are color/lab.py's
    (int32, C order)."""
    bgr = np.ascontiguousarray(bgr, np.uint8)
    out = np.empty_like(bgr)
    lib.bgr2lab_u8(_ptr(bgr, ctypes.c_uint8), _ptr(out, ctypes.c_uint8),
                   bgr.size // 3, _ptr(gamma_tab, ctypes.c_int32),
                   _ptr(cbrt_tab, ctypes.c_int32),
                   _ptr(coeffs, ctypes.c_int32), int(l_scale), int(l_shift))
    return out


def lab2bgr_u8(lib, lab: np.ndarray, y_tab, ify_tab, ab_tab, min_ab, coeffs,
               gamma_tab, adiv_tab, bdiv_tab) -> np.ndarray:
    """(..., 3) uint8 Lab -> BGR through `lib` (color/lab.py's inverse
    tables: int32, coeffs int64, gamma uint8)."""
    lab = np.ascontiguousarray(lab, np.uint8)
    out = np.empty_like(lab)
    lib.lab2bgr_u8(_ptr(lab, ctypes.c_uint8), _ptr(out, ctypes.c_uint8),
                   lab.size // 3, _ptr(y_tab, ctypes.c_int32),
                   _ptr(ify_tab, ctypes.c_int32), _ptr(ab_tab, ctypes.c_int32),
                   int(min_ab), int(ab_tab.size),
                   _ptr(coeffs, ctypes.c_int64),
                   _ptr(gamma_tab, ctypes.c_uint8),
                   _ptr(adiv_tab, ctypes.c_int32),
                   _ptr(bdiv_tab, ctypes.c_int32))
    return out
