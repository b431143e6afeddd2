"""Build-at-first-use of the CUDA kernels under ``csrc/``.

``load()`` compiles every source in ``SOURCES`` with ``nvcc`` for ``sm_90a``
(one ``nvcc -c`` per source, all started together), links the objects into
one shared library with a plain C interface under
``dsml_thesis_tpu_torch/_build/`` and opens it with ``ctypes``. Nothing is
built when the package is imported: only a kernel launch on a CUDA tensor
reaches ``load()``. A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# every translation unit of the library, and the headers they include
SOURCES = ("flash_attention.cu", "flash_attention_fproj.cu",
           "flash_attention_packed.cu", "flash_attention_qout.cu",
           "flash_attention_bwd.cu", "flash_attention_bwd_packed.cu",
           "flash_attention_streaming.cu", "flash_attention_streaming_bwd.cu",
           "group_norm.cu", "conv_stats.cu", "conv_stats_f32.cu")
HEADERS = ("mma_tiles.cuh", "attention_bwd.cuh", "attention_f32.cuh",
           "conv_stats.cuh")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # of this process's build, if it built
build_log: str = ""                    # nvcc's output (ptxas register report)


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or put the CUDA toolkit on PATH): the "
        "kernels are compiled from dsml_thesis_tpu_torch/csrc/ at "
        "first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(lib_path: str) -> None:
    global build_seconds, build_log
    nvcc = _nvcc()
    t0 = time.monotonic()
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    procs = []
    for name in SOURCES:
        obj = f"{tmp}.{name}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, name), "-o", obj]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    build_log = "\n".join(logs)
    objs = [obj for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build loses nothing
    finally:
        for p in objs + [tmp]:
            if os.path.exists(p):
                os.remove(p)
    build_seconds = time.monotonic() - t0


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if this tree's sources have
    not been built yet (the file name carries a digest of the sources)."""
    global _lib
    with _lock:
        if _lib is None:
            os.makedirs(BUILD_DIR, exist_ok=True)
            lib_path = os.path.join(BUILD_DIR, f"libdsml_kernels_{_digest()}.so")
            if not os.path.exists(lib_path):
                _compile(lib_path)
            lib = ctypes.CDLL(lib_path)
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.dsml_flash_attention.argtypes = [p] * 5 + [i, i, i, i, f, p]
            lib.dsml_flash_attention.restype = i
            lib.dsml_flash_attention_fproj.argtypes = (
                [p] * 8 + [i, i, i, i, i, f, p])
            lib.dsml_flash_attention_fproj.restype = i
            lib.dsml_flash_attention_packed.argtypes = (
                [p] * 5 + [i, i, i, i, i, f, p])
            lib.dsml_flash_attention_packed.restype = i
            lib.dsml_flash_attention_bwd.argtypes = (
                [p] * 10 + [i, i, i, i, f, p])
            lib.dsml_flash_attention_bwd.restype = i
            lib.dsml_flash_attention_bwd_packed.argtypes = (
                [p] * 10 + [i, i, i, i, i, f, p])
            lib.dsml_flash_attention_bwd_packed.restype = i
            lib.dsml_flash_attention_qout.argtypes = (
                [p] * 7 + [i, i, i, i, i, i, f, p])
            lib.dsml_flash_attention_qout.restype = i
            lib.dsml_flash_attention_streaming.argtypes = (
                [p] * 6 + [i, i, i, i, i, f, p])
            lib.dsml_flash_attention_streaming.restype = i
            lib.dsml_flash_attention_streaming_bwd.argtypes = (
                [p] * 10 + [i, i, i, i, f, f, p])
            lib.dsml_flash_attention_streaming_bwd.restype = i
            # the fp32 instantiations at D = 512, same arguments
            for name in ("dsml_flash_attention", "dsml_flash_attention_bwd",
                         "dsml_flash_attention_streaming",
                         "dsml_flash_attention_streaming_bwd"):
                f32 = getattr(lib, name + "_f32")
                f32.argtypes = getattr(lib, name).argtypes
                f32.restype = i
            lib.dsml_conv_stats.argtypes = (
                [p] * 11 + [i, i, i, i, i, i, i, i, f, i, p])
            lib.dsml_conv_stats.restype = i
            lib.dsml_gn_channel_stats.argtypes = [p, p, p, i, i, i, i, p]
            lib.dsml_gn_channel_stats.restype = i
            lib.dsml_group_norm_silu.argtypes = (
                [p] * 6 + [i, i, i, i, i, f, i, i, p])
            lib.dsml_group_norm_silu.restype = i
            # their fp32 instantiations (first-stage training), same arguments
            for name in ("dsml_conv_stats", "dsml_gn_channel_stats",
                         "dsml_group_norm_silu"):
                f32 = getattr(lib, name + "_f32")
                f32.argtypes = getattr(lib, name).argtypes
                f32.restype = i
            _lib = lib
        return _lib
