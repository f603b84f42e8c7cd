"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with :mod:`ctypes`
(no PyTorch headers: a build takes seconds, not minutes).  All sources
build at first use, one ``nvcc`` process each, started together, into
``build/folve_tpu_torch/`` beside the package; a library's file name
carries a hash of its sources, so an edited source never loads a stale
build.  Nothing here runs at import.
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

SOURCES = ("fft_half", "ifft_half", "fdl_mac", "conv_step")

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "folve_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict = {}
# Per-source ptxas report (registers, shared memory, spills) of the build
# that made each loaded library (kept beside it), and the build seconds
# of the last build in this process.
build_log: dict = {}
build_seconds: float | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Build every source whose library is missing (in parallel) and load
    them all; returns ``{name: ctypes.CDLL}``.  Raises on a failed build."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
                   str(_CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{log}")
                continue
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name in SOURCES:
            lib = _lib_path(name)
            _libs[name] = ctypes.CDLL(str(lib))
            if name not in build_log and lib.with_suffix(".log").exists():
                build_log[name] = lib.with_suffix(".log").read_text()
        build_seconds = time.perf_counter() - t0
        return _libs


def function(lib_name: str, fn_name: str, argtypes: list):
    """C entry point ``fn_name`` of ``csrc/<lib_name>.cu`` with its
    argument types declared (ctypes would otherwise pass each pointer as
    a 32-bit int).  Every entry point returns ``cudaGetLastError()``."""
    lib = _libs.get(lib_name) or build_all()[lib_name]
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
