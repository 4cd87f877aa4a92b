"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled with `nvcc`
for `sm_90a` into `build/kernels/lib<name>-<hash>.so` at the repository
root (the hash is of the source, so an edited kernel is rebuilt) and loaded
with `ctypes`.  Nothing is built when this module is imported: the first call
of `load` builds, or `build_all` builds several sources at once, one `nvcc`
process each, all started together.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start `nvcc` for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source in parallel; returns nvcc's output (the
    `-Xptxas -v` register/shared-memory report) by name.  Raises on the
    first failed build."""
    started = {n: _start_build(n) for n in names}
    logs: Dict[str, str] = {}
    failed = []
    for name, job in started.items():
        if job is None:
            logs[name] = "(already built)"
            continue
        proc, tmp, out = job
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
