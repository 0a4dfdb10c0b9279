"""Build, load and count the port's CUDA kernels.

The sources under nle_tpu_torch/csrc compile with one nvcc process per
.cu file, all started together, and link into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), loaded
with ctypes. The build runs at first use, into
nle_tpu_torch/_build/, keyed on a hash of the sources and flags; it writes
a temp file and os.replace()s it into place under a file lock, so
concurrent first users never load a half-written library. Nothing here runs
at import time: the CPU tests import every module on machines with no nvcc.

LAUNCHES holds one plain int per kernel. A wrapper adds one right after a
successful launch of its kernel and nowhere else (its plain-PyTorch twin
never counts), so a run can prove which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel name -> launch count. K3, K4 and K14 (one CUDA template, three
# dtypes) are counted apart, and so are K15's three probe variants, K17's
# two TPU variants and K18's two modes.
LAUNCHES = {
    "affinity_matmul": 0,          # K1
    "sinkhorn_halfstep_int16": 0,  # K3
    "sinkhorn_halfstep_f32": 0,    # K4
    "sinkhorn_halfstep_bf16": 0,   # K14
    "sinkhorn_halfstep_tiled": 0,  # K13
    "sinkhorn_probe_dmaonly": 0,   # K15
    "sinkhorn_probe_wonly": 0,     # K15
    "sinkhorn_probe_wpart": 0,     # K15
    "sinkhorn_ab_unroll": 0,       # K16
    "sinkhorn_ab_parts3d": 0,      # K17
    "sinkhorn_ab_mxu_row0": 0,     # K17
    "sinkhorn_ab_vpu": 0,          # K18
    "sinkhorn_ab_xonly": 0,        # K18
    "sinkhorn_ab_2stream": 0,      # K19
    "scaled_gram": 0,              # K6
    "scaled_matmul": 0,            # K7
    "streaming_halfstep": 0,       # K8 (the unit_x s0 pass included)
    "streaming_halfstep_ptiled": 0,  # K9 (K8's kernel up to Ppad 4096)
    "streaming_ap": 0,             # K10
    "streaming_atb": 0,            # K11
    "streaming_gram": 0,           # K12
    "perm_gather_u8": 0,           # the edit's pixel order (no TPU kernel)
    "perm_scatter_u8": 0,
}

# What the last build printed (ptxas registers/spills per kernel) and how
# long it took; None when the library came from an earlier build.
build_log: str | None = None
build_seconds: float | None = None

_lib = None
_lock = threading.Lock()
# Request threads of the HTTP service launch kernels side by side: an
# unguarded += could lose a count.
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def check(status: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError_t {status}")


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from nle_tpu_torch/csrc at first use.")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libnle_kernels-{h.hexdigest()[:16]}.so")


def _compile(so: str) -> None:
    """One nvcc per source, all started together, then one link: the
    build takes as long as the slowest source, not their sum."""
    global build_log, build_seconds
    tmp = f"{so}.tmp-{os.getpid()}"
    cu = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in cu]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *compile_flags, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(cu, objs)]
    logs, failed = [], []
    for src, proc in zip(cu, procs):
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} (exit {proc.returncode})"
                          f":\n{err}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {link.returncode}):\n{link.stderr}")
        os.replace(tmp, so)
    finally:
        for path in [tmp, *objs]:
            if os.path.exists(path):
                os.unlink(path)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)


def _declare(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "nle_affinity_matmul": [p, p, p, p, i, i, i, i, i, i, f, f, p],
        "nle_sinkhorn_halfstep_i16": [p, p, p, p, p, i, i, i, i, i, i, i, f,
                                       p],
        "nle_sinkhorn_halfstep_f32": [p, p, p, p, p, i, i, i, i, i, i, i, f,
                                       p],
        "nle_sinkhorn_halfstep_bf16": [p, p, p, p, p, i, i, i, i, i, i, i, f,
                                       p],
        "nle_sinkhorn_tiled_f32": [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                   f, p],
        "nle_sinkhorn_probe_f32": [p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                                   p],
        "nle_ab_unroll": [p, p, p, p, p, i, i, i, i, f, p],
        "nle_ab_tiles": [p, p, p, p, p, i, i, i, i, f, p],
        "nle_ab_2stream": [p, p, p, i, i, i, i, i, p],
        "nle_scaled_gram": [p, p, p, p, i, i, i, i, i, p],
        "nle_scaled_matmul": [p, p, p, p, i, i, i, p],
        "nle_stream_halfstep_onebuild": [p, p, p, p, p, p, p, i, i, i, i, i,
                                         i, i, i, f, f, f, p],
        # qpad, ppad, atb_plan's 5 numbers, ap_plan's 8.
        "nle_stream_halfstep_ptiled": [p, p, p, p, p, p, p] + [i] * 15
                                      + [f, f, f, p],
        "nle_stream_ap": [p, p, p, p, p] + [i] * 11 + [f, f, p],
        "nle_stream_atb": [p, p, p, p] + [i] * 8 + [f, f, p],
        "nle_stream_gram": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                            i, i, i, f, f, p],
        "nle_permute_rows_u8": [p, p, p, i, i, i, p],
        "nle_stream_sample_gram": [p, p, p, p, p, i, i, i, i, i, f, f, p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def load():
    """The kernel library, built on first use. Raises if it cannot be
    built or loaded — callers on a CUDA tensor have no other route."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                with open(os.path.join(BUILD_DIR, "lock"), "w") as lk:
                    fcntl.flock(lk, fcntl.LOCK_EX)
                    if not os.path.exists(so):
                        _compile(so)
            lib = ctypes.CDLL(so)
            _declare(lib)
            _lib = lib
    return _lib


def stream_ptr(tensor) -> int | None:
    """Handle of torch's current stream on the tensor's device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream or None

