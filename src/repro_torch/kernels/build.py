"""Build the CUDA sources in ``csrc/`` into shared libraries, at first use.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``.  Libraries are keyed by a hash of
their sources and flags, so a changed source rebuilds and an unchanged
one loads from ``build/repro_torch/``.  ``-fmad=false`` is part of the
contract: products are never fused into adds, so the bytes a kernel
writes do not depend on how the compiler schedules a given shape.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

#: library name -> its .cu source; headers in csrc/ enter every hash.
LIBRARIES = {"thundering_block": "thundering_block.cu", "mc": "mc.cu",
             "fused_dropout": "fused_dropout.cu",
             "gumbel_argmax": "gumbel_argmax.cu"}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / LIBRARIES[name]]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def compile_library(name: str) -> Path:
    """Compile one library if its hashed .so is missing; return its path."""
    target = _library_path(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / LIBRARIES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    (target.with_suffix(".ptxas.txt")).write_text(proc.stderr)
    os.replace(tmp, target)
    return target


def build_all(names: Sequence[str] = tuple(LIBRARIES)) -> Dict[str, Path]:
    """Compile every library at once, one nvcc process per source."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = dict(zip(names, pool.map(compile_library, names)))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, compiled first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_library(name)))
            _loaded[name] = lib
        return lib
