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
HEADERS = ("mma_tiles.cuh", "hopper_tiles.cuh", "hopper_tf32.cuh",
           "hopper_fwd.cuh", "hopper_bwd.cuh", "hopper_wide.cuh",
           "hopper_wide_f32.cuh", "hopper_wide_f32_bwd.cuh",
           "hopper_narrow_f32.cuh", "attention_f32.cuh",
           "attention_f32_narrow.cuh", "conv_stats.cuh", "conv_igemm.cuh")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ctypes argument types of every C entry point of the library, in the order
# of its declaration under csrc/ (a pointer or the stream: c_void_p, or
# ctypes would pass a 32-bit int and cut it). Every entry returns int.
SIGNATURES = {
    "dsml_flash_attention": [_P] * 5 + [_I] * 4 + [_F, _P],
    "dsml_flash_attention_fproj": [_P] * 8 + [_I] * 5 + [_F, _P],
    "dsml_flash_attention_packed": [_P] * 5 + [_I] * 5 + [_F, _P],
    "dsml_flash_attention_bwd": [_P] * 10 + [_I] * 4 + [_F, _P],
    "dsml_flash_attention_bwd_packed": [_P] * 10 + [_I] * 5 + [_F, _P],
    "dsml_flash_attention_qout": [_P] * 7 + [_I] * 6 + [_F, _P],
    "dsml_flash_attention_streaming": [_P] * 6 + [_I] * 5 + [_F, _P],
    "dsml_flash_attention_streaming_bwd": [_P] * 10 + [_I] * 4 + [_F, _F, _P],
    "dsml_conv_stats": [_P] * 11 + [_I] * 11 + [_F, _I, _P],
    "dsml_gn_channel_stats": [_P] * 2 + [_I] * 4 + [_P],
    "dsml_group_norm_silu": [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P],
}
# the fp32 instantiations (D = 512 attention and first-stage training's
# GroupNorm and conv kernels; D = 32 attention of the fp32 UNet) take the
# same arguments as their bf16 twins, the split-head, streaming and packed
# attention entries one more: scratch for their tile images (the forwards:
# after their outputs; the backwards: before the stream, at D = 512 with a
# chunk's P^T, dS^T and dS)
SIGNATURES.update({
    name + "_f32": SIGNATURES[name]
    for name in ("dsml_flash_attention_fproj", "dsml_conv_stats",
                 "dsml_gn_channel_stats", "dsml_group_norm_silu")})
SIGNATURES["dsml_flash_attention_packed_f32"] = [_P] * 6 + [_I] * 5 + [_F, _P]
SIGNATURES["dsml_flash_attention_bwd_packed_f32"] = (
    [_P] * 10 + [_I] * 5 + [_F, _P, _P])
SIGNATURES["dsml_flash_attention_f32"] = [_P] * 6 + [_I] * 4 + [_F, _P]
SIGNATURES["dsml_flash_attention_streaming_f32"] = [_P] * 7 + [_I] * 5 + [_F,
                                                                        _P]
SIGNATURES["dsml_flash_attention_bwd_f32"] = [_P] * 10 + [_I] * 4 + [_F, _P,
                                                                    _P]
SIGNATURES["dsml_flash_attention_streaming_bwd_f32"] = (
    [_P] * 10 + [_I] * 4 + [_F, _F, _P, _P])

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
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
