"""Build and load the port's native C++ libraries (sources under ``native/``).

Counterpart of ``dsml_thesis_tpu/native_lib.py``. A library is compiled at
first use with ``g++ -O3 -fPIC -std=c++17 -shared`` (``CXX`` names another
compiler) and its link libraries into ``dsml_thesis_tpu_torch/_build/``,
under a file name that carries a digest of the source, the flags and the
link libraries; nothing is written beside the source. The build holds an
inter-process lock (``fcntl.flock`` on ``<name>.lock`` in the build
directory) and writes a temporary file that ``os.replace`` puts in place, so
that processes that reach it together (pytest's workers, a loader's
threads) build it once and never load a half-written library. The JAX
package's builder locks within one process only and races across them.

``load`` raises with the compiler's output where the library cannot be built
or loaded; the caller decides what that means (the edit distance falls back
to its Python loop with the same answer; the image decoder asked for by
``DSML_NATIVE_IMAGE=1`` raises).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Sequence, Tuple

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_libs: Dict[Tuple[str, str], ctypes.CDLL] = {}   # (name, build dir) -> lib


def source(name: str) -> str:
    """``native/<name>.cc``."""
    return os.path.join(NATIVE_DIR, f"{name}.cc")


def library_path(name: str, link: Sequence[str] = (),
                 build_dir: str = BUILD_DIR) -> str:
    """Where the library of this source, these flags and these link
    libraries lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(link)).encode())
    with open(source(name), "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str, link: Sequence[str] = (),
          build_dir: str = BUILD_DIR) -> str:
    """The library's path, compiled first if it is not there yet; raises
    with the compiler's output if the build fails."""
    path = library_path(name, link, build_dir)
    if os.path.exists(path):   # os.replace put it there whole
        return path
    src = source(name)
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"no C++ compiler {cxx!r} to build {src}")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if os.path.exists(path):           # another process built it
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, src, *link],
                                 capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {src}:\n"
                                   f"{out.stdout}{out.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def load(name: str, declare: Callable[[ctypes.CDLL], None],
         link: Sequence[str] = (), build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """The library (built at the first call) with ``declare`` run on it to
    set its signatures, kept for the process; raises where it cannot be
    built or loaded (nothing is kept then, so a later call tries again)."""
    key = (name, build_dir)
    with _lock:
        if key not in _libs:
            lib = ctypes.CDLL(build(name, link, build_dir))
            declare(lib)
            _libs[key] = lib
        return _libs[key]
