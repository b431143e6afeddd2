"""The port's binding of the batched edit-distance library
(``native/editdist.cc``).

Counterpart of ``dsml_thesis_tpu/metrics/native.py``: ``edit_distance_batch``
scores a corpus of token sequences in one C call, or returns None where the
library cannot be built (no C++ compiler), and the caller's pure-Python
dynamic program runs instead (``metrics/lipread.py``). The answer is the
same either way.

The source is compiled at first use with ``g++ -O3 -fPIC -shared`` (``CXX``
names another compiler) into ``dsml_thesis_tpu_torch/_build/``, under a
file name that carries a digest of the source and the flags; nothing is
written beside the source. The build holds an inter-process lock
(``fcntl.flock`` on a file in the build directory) and writes a temporary
file that ``os.replace`` puts in place, so that processes that reach it
together (pytest's workers, a script's threads) build it once and never
load a half-written library.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Sequence

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native", "editdist.cc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}   # build dir -> library or None


def library_path(build_dir: str = BUILD_DIR) -> str:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir, f"libeditdist_{h.hexdigest()[:16]}.so")


def build(build_dir: str = BUILD_DIR) -> str:
    """The library's path, compiled first if it is not there yet; raises
    with the compiler's output if the build fails."""
    path = library_path(build_dir)
    if os.path.exists(path):   # os.replace put it there whole
        return path
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"no C++ compiler {cxx!r} to build {SOURCE}")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "editdist.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if os.path.exists(path):           # another process built it
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                                 capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {SOURCE}:\n"
                                   f"{out.stdout}{out.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def _declare(lib: ctypes.CDLL) -> None:
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.edit_distance_i32.restype = ctypes.c_int64
    lib.edit_distance_i32.argtypes = [i32p, ctypes.c_int64,
                                      i32p, ctypes.c_int64]
    lib.edit_distance_batch_i32.restype = None
    lib.edit_distance_batch_i32.argtypes = [i32p, i64p, i32p, i64p,
                                            ctypes.c_int64, i64p]


def load(build_dir: str = BUILD_DIR) -> Optional[ctypes.CDLL]:
    """The library (built at the first call), or None where it cannot be
    built or loaded; the outcome is kept for the process."""
    with _lock:
        if build_dir not in _libs:
            try:
                lib = ctypes.CDLL(build(build_dir))
                _declare(lib)
            except (OSError, RuntimeError, AttributeError,
                    subprocess.SubprocessError):
                lib = None
            _libs[build_dir] = lib
        return _libs[build_dir]


def edit_distance_batch(refs: Sequence[Sequence], hyps: Sequence[Sequence],
                        build_dir: str = BUILD_DIR) -> Optional[np.ndarray]:
    """Edit distances of the pairs (int64 [n]) from the library, or None if
    it is unavailable. Tokens are any hashable values: one vocabulary maps
    equal tokens of both sides to equal ids."""
    lib = load(build_dir)
    if lib is None:
        return None
    if len(refs) != len(hyps):   # the C loop would read past the offsets
        raise ValueError(
            f"refs/hyps length mismatch: {len(refs)} vs {len(hyps)}")
    vocab: dict = {}

    def encode(seqs):
        flat, offs = [], [0]
        for s in seqs:
            for tok in s:
                flat.append(vocab.setdefault(tok, len(vocab)))
            offs.append(len(flat))
        return (np.asarray(flat or [0], np.int32), np.asarray(offs, np.int64))

    fa, oa = encode(refs)
    fb, ob = encode(hyps)
    out = np.zeros(len(refs), dtype=np.int64)
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.edit_distance_batch_i32(
        fa.ctypes.data_as(i32p), oa.ctypes.data_as(i64p),
        fb.ctypes.data_as(i32p), ob.ctypes.data_as(i64p),
        len(refs), out.ctypes.data_as(i64p))
    return out
