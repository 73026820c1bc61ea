"""Build and load the hand-written CUDA kernels of ``cvd_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ctypes. The build runs
at first use, from the sources in the checkout only, into
``<repo>/build/kernels/<name>-<hash>/`` (git-ignored), keyed on a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is. Nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def _compile_cmd(name: str, out: Path) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str]) -> None:
    """Compile the named sources that are not built yet, in parallel.
    Raises with nvcc's output if any compile fails."""
    procs = []
    for name in names:
        path = _lib_path(name)
        if path.exists():
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        procs.append((name, path, tmp, subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Load (building first if needed) ``csrc/<name>.cu``; ``signatures``
    maps each C entry point to its ctypes argtypes. Every entry returns the
    ``cudaError_t`` of its launch as an int."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
