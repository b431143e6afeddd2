"""The port's binding of the batched edit-distance library
(``native/editdist.cc``).

Counterpart of ``dsml_thesis_tpu/metrics/native.py``: ``edit_distance_batch``
scores a corpus of token sequences in one C call, or returns None where the
library cannot be built (no C++ compiler), and the caller's pure-Python
dynamic program runs instead (``metrics/lipread.py``). The answer is the
same either way.

The source is compiled at first use into ``dsml_thesis_tpu_torch/_build/``
by ``native_lib.py`` (one locked build for all processes; nothing is written
beside the source).
"""
from __future__ import annotations

import ctypes
import subprocess
import threading
from typing import Dict, Optional, Sequence

import numpy as np

from .. import native_lib

BUILD_DIR = native_lib.BUILD_DIR

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}   # build dir -> library or None


def library_path(build_dir: str = BUILD_DIR) -> str:
    """Where the library of this source and these flags lives."""
    return native_lib.library_path("editdist", build_dir=build_dir)


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
                lib = native_lib.load("editdist", _declare,
                                      build_dir=build_dir)
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
