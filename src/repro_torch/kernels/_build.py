"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

The sources under ``csrc/`` have a plain ``extern "C"`` interface: every
pointer and the CUDA stream pass as ``c_void_p``, every int as ``c_int``,
and each entry returns ``cudaGetLastError()`` after its launches.  At
first use each ``.cu`` compiles to an object for ``sm_90a`` — one
``nvcc`` per source, all started together — and the objects link into
``build/repro_torch_kernels/<hash of the sources>/libkernels.so`` at the
repository root, next to ``build.log`` (``-Xptxas -v``: registers,
shared memory and spills per kernel).  A later call with unchanged
sources loads the library that is already there.  Nothing is built or
loaded at import time: this module is imported on machines with no
CUDA toolkit, where ``library()`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "topk_seg_f32": [_P] * 8 + [_I] * 10 + [_P] * 4,
    "qtopk_seg_sq8": [_P] * 13 + [_I] * 7 + [_P] * 4,
    "topk_f32": [_P] * 5 + [_I] * 11 + [_P] * 4,
    "qtopk_sq8": [_P] * 8 + [_I] * 7 + [_P] * 4,
    "pairwise_f32": [_P] * 2 + [_I] * 8 + [_P] * 2,
    "beam_f32": [_P] * 8 + [_I] * 16 + [_P] * 9,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch build from "
        f"{CSRC} on a machine with the CUDA toolkit")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    """The content-addressed directory this checkout's sources build to."""
    h = hashlib.sha256(" ".join(ARCH + CFLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile and link ``libkernels.so`` unless it already exists; returns
    its path.  Raises with the compiler's output if a step fails."""
    out = build_dir()
    lib = out / "libkernels.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        units = sorted(CSRC.glob("*.cu"))
        procs = [(src, subprocess.Popen(
            [nvcc, *ARCH, *CFLAGS, "-c", str(src), "-o",
             str(tmp / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in units]
        log, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== nvcc {src.name}\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp / "libkernels.so"),
             *(str(tmp / (src.stem + ".o")) for src in units)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode:
            raise RuntimeError("linking libkernels.so failed:\n"
                               + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        out.mkdir(parents=True, exist_ok=True)
        os.replace(tmp / "build.log", out / "build.log")
        os.replace(tmp / "libkernels.so", lib)     # last: marks it done
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_log() -> str:
    """``-Xptxas -v`` output of the build in use (empty before a build)."""
    path = build_dir() / "build.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernels_error_string.argtypes = [ctypes.c_int]
            lib.kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, err: int) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err:
        msg = library().kernels_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
