"""ctypes binding of the native host audio library (`csrc/sparktts_audio.cpp`).

Port of `sparktts_tpu/io/native.py`: the same C entry points (polyphase
resampling, loudness normalisation, PCM16 wav read and write), the same
signatures and the same results.  The library is built from the repo's
source with `g++` at first use into `build/native/` (named by a hash of the
source, written to a temporary name and renamed, so that two processes
building it at once do not clash); nothing is written under `csrc/`.
Where no compiler or library is available every function returns None
(False for `write_wav`) and `io/audio.py` takes its scipy paths, as the
JAX package does: this is host DSP, not device work.  `status()` says
which it is, and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "csrc" / "sparktts_audio.cpp"
BUILD_DIR = ROOT / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failure: Optional[str] = None  # why there is no library, once a load failed


def library_path() -> Path:
    """Where the library of the current source is built."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libsparkttsaudio-{digest}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", "-o", str(tmp),
           str(SOURCE)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.sparktts_resample_poly.restype = ctypes.c_int
    lib.sparktts_resample_poly.argtypes = [dptr, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(dptr), ctypes.POINTER(ctypes.c_int64)]
    lib.sparktts_volume_normalize.restype = ctypes.c_int
    lib.sparktts_volume_normalize.argtypes = [dptr, ctypes.c_int64, ctypes.c_double]
    lib.sparktts_read_wav.restype = ctypes.c_int
    lib.sparktts_read_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(dptr),
                                      ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
    lib.sparktts_write_wav.restype = ctypes.c_int
    lib.sparktts_write_wav.argtypes = [ctypes.c_char_p, dptr, ctypes.c_int64, ctypes.c_int]
    lib.sparktts_free.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None when it cannot be built or
    loaded (`status()` then says why)."""
    global _lib, _failure
    with _lock:
        if _lib is not None or _failure is not None:
            return _lib
        try:
            target = library_path()
            if not target.exists():
                _build(target)
            _lib = _bind(ctypes.CDLL(str(target)))
            logger.info("native audio library: %s", target)
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            _failure = f"{type(e).__name__}: {e} {detail.decode(errors='replace')[-300:]}".strip()
            logger.info("native audio library unavailable (%s); host audio takes the scipy "
                        "paths", _failure)
        return _lib


def status() -> str:
    """"native (<library path>)" or "scipy (<why the library is missing>)"."""
    lib = get_lib()
    return f"native ({lib._name})" if lib is not None else f"scipy ({_failure})"


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _take_buffer(lib, ptr, n: int) -> np.ndarray:
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.sparktts_free(ptr)
    return arr


def resample(audio: np.ndarray, up: int, down: int) -> Optional[np.ndarray]:
    """scipy's `resample_poly(audio, up, down)` (its kaiser window), float64."""
    lib = get_lib()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, dtype=np.float64)
    out_ptr, out_len = ctypes.POINTER(ctypes.c_double)(), ctypes.c_int64()
    rc = lib.sparktts_resample_poly(_dptr(audio), audio.shape[0], up, down,
                                    ctypes.byref(out_ptr), ctypes.byref(out_len))
    return _take_buffer(lib, out_ptr, out_len.value) if rc == 0 else None


def volume_normalize(audio: np.ndarray, coeff: float = 0.2) -> Optional[np.ndarray]:
    """`io.audio.audio_volume_normalize`, on a float64 copy."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.ascontiguousarray(audio, dtype=np.float64).copy()
    rc = lib.sparktts_volume_normalize(_dptr(buf), buf.shape[0], coeff)
    return buf if rc == 0 else None


def read_wav(path) -> Optional[Tuple[np.ndarray, int]]:
    """(float64 mono in [-1, 1], first channel; sample rate), or None."""
    lib = get_lib()
    if lib is None:
        return None
    out_ptr, out_len, sr = ctypes.POINTER(ctypes.c_double)(), ctypes.c_int64(), ctypes.c_int()
    rc = lib.sparktts_read_wav(str(path).encode(), ctypes.byref(out_ptr), ctypes.byref(out_len),
                               ctypes.byref(sr))
    return (_take_buffer(lib, out_ptr, out_len.value), sr.value) if rc == 0 else None


def write_wav(path, audio: np.ndarray, sample_rate: int) -> bool:
    """A 16-bit PCM wav of float audio in [-1, 1]; False without the library."""
    lib = get_lib()
    if lib is None:
        return False
    buf = np.ascontiguousarray(audio, dtype=np.float64)
    return lib.sparktts_write_wav(str(path).encode(), _dptr(buf), buf.shape[0],
                                  int(sample_rate)) == 0
