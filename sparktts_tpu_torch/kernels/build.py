"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled with `nvcc`
for `sm_90a` into `build/kernels/lib<name>-<hash>.so` at the repository
root (the hash is of the source and of the `csrc/*.cuh` headers it
includes, so an edited kernel or header is rebuilt) and loaded with
`ctypes`.  Nothing is built when this module is imported: the first call of
`load` builds, or `build_all` builds several sources at once, one `nvcc`
process each, all started together.

Every wrapper launches inside `launch_stream(t)`, which makes `t`'s card the
current device and gives the handle of that card's current stream: a launch
on handle 0 (the default stream) goes to the current device, which need not
be the tensor's.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator

import torch

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


_tallies = threading.local()


def note_launch(name: str) -> None:
    """Count a launch of kernel `name` into the tallies this thread has
    open (`launch_tally`).  Every wrapper calls it beside its `launches`."""
    for tally in getattr(_tallies, "open", ()):
        tally[name] = tally.get(name, 0) + 1


@contextlib.contextmanager
def launch_tally() -> Iterator[Dict[str, int]]:
    """The launches of each kernel that this thread makes inside the block
    (the wrappers' module counts are shared by every thread)."""
    tally: Dict[str, int] = {}
    stack = _tallies.__dict__.setdefault("open", [])
    stack.append(tally)
    try:
        yield tally
    finally:
        stack.remove(tally)


@contextlib.contextmanager
def launch_stream(t: torch.Tensor) -> Iterator[int]:
    """Inside the block `t`'s card is the current device; yields the handle
    of that card's current stream, for a ctypes launch."""
    with torch.cuda.device(t.device):
        yield torch.cuda.current_stream(t.device).cuda_stream


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def library_path(name: str) -> Path:
    """The library's path, named by the hash of its source and of every
    `csrc/*.cuh` it includes (directly or through another header)."""
    h = hashlib.sha256()
    todo, seen = [f"{name}.cu"], set()
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.add(f)
        text = (CSRC / f).read_bytes()
        h.update(f.encode() + b"\0" + text)
        todo += [m.decode() for m in _INCLUDE.findall(text)]
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


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
