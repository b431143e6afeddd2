"""Design variants of the Hopper-redesigned kernels, timed in turns.

    python -m dsml_thesis_tpu_torch.tools.variants '{"base": [],
        "g1": [["flash_attention_qout.cu", "MAX_GROUPS = 8;",
                "MAX_GROUPS = 1;"]]}'

Each variant is a list of [file, old text, new text] substitutions applied
to a copy of ``csrc/`` under ``_build/variants/<name>/`` (an empty old text
replaces the whole file by the file at the path, relative to the
repository and inside it, that new text names: an earlier design unpacked
under ``_ab/``). Every variant's ``SOURCES`` (the attention kernels' entry
files) are compiled (all ``nvcc`` processes started together; ptxas's
"Performance Loss" lines are printed) and linked into a library of their
own; a name that starts with ``c_`` is compiled only. Then, for the
fused-projection op at [16, 1024, 320] x 10, [8, 1024, 320] x 10, [16, 256,
640] x 20 and [3, 200, 320] x 10, the packed forward at [16, 4096, 5 x 32],
[8, 4096, 5 x 32], [8, 4096, 2 x 80], [8, 1024, 10 x 32], [8, 256, 20 x 32]
and [2, 333, 77, 3 x 80], the packed backward at [8, 1024, 10 x 32], [8,
256, 20 x 32], [8, 4096, 5 x 32], [8, 4096, 2 x 80] and [2, 1000, 3 x 64],
the q/out-fused op at [8, 4096, 160] x 5, [16, 4096, 160] x 5 and [2, 1000,
128] x 2, the streaming forward and backward at [8, 10, 1024, 32], [8, 20,
256, 32], [8, 2, 4096, 80] and [2, 3, 333, 77, 64], and the split-head
forward and backward at [8, 10, 1024, 32], [8, 20, 256, 32], [8, 2, 4096,
80] and [2, 3, 333, 77, 80], every variant's C entry is held against the
plain version (relative error to the maximum) and timed by CUDA events, 20
calls, in three rounds of the variants in turns (a, b, b, a); the median is
printed ("not taken" where a variant's entry returns -1 for the shape, as an
earlier design does for a head width it lacks). Needs a CUDA device and
nvcc.

    python -m dsml_thesis_tpu_torch.tools.variants --conv-gn [--only TEXT] \
        '{"parent": [["conv_stats.cuh", "", "_ab/parent/.../conv_stats.cuh"],
                     ...], "new": []}'

``--conv-gn`` builds ``conv_stats.cu``, ``conv_stats_f32.cu`` and
``group_norm.cu`` alone and times rows 11 and 9 instead: the conv + statistics
op at its plan at mead-128-ldm-f4's, the headline config's and the first
stage's shapes, each normed 3 x 3 shape also forced into each design
(``design d``), and a few forced split counts; the whole-row GroupNorm at
mead-128's, the headline's and the first stage's rows at its plan and forced
into the cluster of 8 blocks and into the three passes (``cluster 0``).
A variant whose ``conv_stats.cu`` / ``group_norm.cu`` declare no plan
arguments (a parent tree before the plans came in) is called with the legacy
arguments, at its own weight layout, and takes forced cases as "not taken".
Each case also reports ``device_ms``, the summed device time of the kernels
of a call under torch.profiler (host issue left out). ``--only`` times only
the cases whose name holds the text (or one of ``a|b``); ``--ptxas TEXT``
(any mode that builds) prints ptxas's report (registers, spills) on each
kernel whose mangled name holds TEXT. The fp32
references run with cuDNN's TF32 off.

    python -m dsml_thesis_tpu_torch.tools.variants --f32-attn [--only TEXT] \
        '{"parent": [["attention_f32.cuh", "", "_ab/parent/.../attention_f32.cuh"],
                     ...], "new": []}'

``--f32-attn`` builds the four split-head and streaming attention sources
alone and times their fp32 entries (rows 2, 4, 5 and 7 of PERF.md's kernel
table), each case with ``device_ms`` and ``device_by_kernel`` (the tile
images, lse, delta, dk/dv and dq launches) beside the event time: at
D = 512 the forwards of rows 2 and 4 and the backwards of rows 7 and 5 at
[16, 1, 1024, 512] and [8, 1, 4096, 512] (the backwards also at the ragged
``F32_BWD_RAGGED``; their device time by launch: lse, delta, the tile
images, the scores and the gradient GEMMs, or a parent's dk/dv and dq
grids), the forwards also at ``F32_WIDE_SHAPES``; at D = 32 the forwards of
rows 2 and 4 at ``F32_NARROW_SHAPES``. A parent tree whose fp32 forward or
backward entries take no scratch is called without it.
``--only 512`` keeps the D = 512 cases.

    python -m dsml_thesis_tpu_torch.tools.variants --wide-attn [--only TEXT] \
        '{"parent": [["flash_attention.cu", "", "_ab/parent/.../flash_attention.cu"],
                     ...], "new": []}'

``--wide-attn`` builds ``flash_attention.cu`` and
``flash_attention_streaming.cu`` alone and times their bf16 forwards at
D = 512 (rows 2 and 4 of PERF.md's kernel table, the first stage's
AttnBlock), each case with ``device_ms`` and ``device_by_kernel`` (the
streaming forward's combine launch apart): both rows at [8, 1, 4096, 512],
[16, 1, 4096, 512] and the ragged [2, 1, 1000, 1000, 512] and [1, 2, 333,
77, 512]; row 4 also at [1, 1, 64, 2000, 512] (32 splits of the keys) and
[1, 1, 16384, 512] (a 512 px image, which streams under ``auto``).

    python -m dsml_thesis_tpu_torch.tools.variants --gn-stats [--only TEXT] \
        '{"parent": [["group_norm.cu", "", "_ab/parent/.../group_norm.cu"]],
          "new": []}'

``--gn-stats`` builds ``group_norm.cu`` alone and times the channel
statistics (row 10 of PERF.md's kernel table) at every timed shape of
``chip_smoke.py``'s kernels phase (bf16 [16, 4096, 160], [16, 1024, 640],
[16, 256, 1280], [8, 65536, 128]; fp32 [16, 16384, 128], [16, 4096, 256],
[16, 1024, 512]), mead-128-ldm-f4's fp32 UNet rows ([16, 1024, 160],
[16, 256, 960], [16, 64, 1280]), the smallest grid [1, 4096, 160] and the
ragged [3, 1000, 160], at ``stats_plan`` (a tree whose entry takes no
cluster size, the parent's two launches, is called with its own
arguments), with ``device_ms`` and ``device_by_kernel``; the sums are held
against the plain version, and a second call must give the same bits.

    python -m dsml_thesis_tpu_torch.tools.variants --f32-fproj [--only TEXT] \
        '{"parent": [["flash_attention_fproj.cu", "",
                      "_ab/parent/.../flash_attention_fproj.cu"], ...],
          "new": []}'

``--f32-fproj`` builds ``flash_attention_fproj.cu`` alone and times its
fp32 D = 32 entry (row 1 at mead-128-ldm-f4's fp32 UNet) at [16, 1024, 160]
x 5, [16, 256, 320] x 10, [16, 64, 640] x 20, [1, 1024, 160] x 5 and the
ragged [3, 200, 160] x 5 and [2, 100, 640] x 20, with ``device_ms`` and
``device_by_kernel`` (the projection launch and the attention launch); the
scratch is large enough for either tree's layout, and a second call must
give the same bits. Design switches of the kept source (``F_FILL``,
``F_QKV_FILL``, ``F_STAGES``, ``F_OUT_STAGES``, ``F_ONE_WG_ROWS``) are text
substitutions.

    python -m dsml_thesis_tpu_torch.tools.variants --f32-packed [--only TEXT] \
        '{"parent": [["flash_attention_packed.cu", "",
                      "_ab/parent/.../flash_attention_packed.cu"], ...],
          "new": []}'

``--f32-packed`` builds ``flash_attention_packed.cu`` and
``flash_attention_bwd_packed.cu`` alone and times their fp32 D = 32
entries (rows 3 and 8 of PERF.md's kernel table: mead-128-ldm-f4's
training self-attention) at ``F32_PACKED_SHAPES``: the three levels of a
``train-mead128`` step and four ragged shapes, each with ``device_ms`` and
``device_by_kernel`` (the images, attention, dk/dv and dq launches, or a
parent's delta); the outputs (o and the row log-sum-exp; dq, dk, dv) are
held against the plain versions, and a second call must give the same
bits. A parent tree whose fp32 packed entries take no scratch is called
without it. Design switches of the kept header (``FWD_KEYS``,
``FWD_STAGES``, ``DKDV_STAGES``, ``DQ_STAGES`` of
``hopper_narrow_f32.cuh``) are text substitutions.

    python -m dsml_thesis_tpu_torch.tools.variants --f32-split [--only TEXT] \
        '{"parent": [["flash_attention.cu", "",
                      "_ab/parent/.../flash_attention.cu"], ...],
          "new": []}'

``--f32-split`` builds ``flash_attention.cu`` and
``flash_attention_streaming.cu`` alone and times their fp32 D = 32
forwards (rows 2 and 4 of PERF.md's kernel table: mead-128-ldm-f4's
split-head and streaming routes) at ``F32_SPLIT_SHAPES``: the three levels
of a ``train-mead128-split`` step (batch 32), the served ones (batch 16)
and ragged ones, row 4 also with its keys cut over many splits; each with
``device_ms`` and ``device_by_kernel`` (the images, attention and combine
launches). The outputs (o, and row 2's log-sum-exp) are held against the
plain versions, and a second call must give the same bits. Both trees'
entries take the scratch of ``narrow_f32_plan`` (a tree that reads none at
D = 32 ignores it).

    python -m dsml_thesis_tpu_torch.tools.variants --f32-split-bwd \
        [--only TEXT] '{"parent": [["flash_attention_bwd.cu", "",
                      "_ab/parent/.../flash_attention_bwd.cu"], ...],
          "new": []}'

``--f32-split-bwd`` builds ``flash_attention_bwd.cu`` and
``flash_attention_streaming_bwd.cu`` alone and times their fp32 D = 32
backwards (rows 7 and 5 of PERF.md's kernel table: mead-128-ldm-f4's
split-head and streaming routes in training) at ``F32_SPLIT_BWD_SHAPES``:
the three levels of a ``train-mead128-split`` step (batch 32) and ragged
ones; each with ``device_ms`` and ``device_by_kernel`` (the images,
log-sum-exp, delta, dk/dv and dq launches). Row 7 runs on the plain
forward's output and row log-sum-exp, row 5 on the plain streaming
forward's output; dq, dk and dv are held against the plain versions, and a
second call must give the same bits. Both trees' entries take the scratch
of ``narrow_f32_plan`` (a tree that reads none at D = 32 ignores it).

    python -m dsml_thesis_tpu_torch.tools.variants --f32-attn --wrapper

``--wrapper`` builds nothing of its own and times the same D = 32 forwards
through the host path of this tree instead: each public wrapper
(``flash_attention``, ``flash_attention_streaming``; ``wrapper``) against
the same launch inside its autograd ``Function`` (``function``, the path
every call took before the wrappers launched directly when no gradient is
tracked), 200 calls a timing, host work included, with ``device_ms``
beside. Each mode prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import attention as A
from ..ops import conv_gn as C
from ..ops import groupnorm as G

ROOT = os.path.realpath(os.path.dirname(_build.PKG_DIR))
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
           "flash_attention_fproj.cu", "flash_attention_packed.cu",
           "flash_attention_bwd_packed.cu", "flash_attention_qout.cu",
           "flash_attention_streaming.cu", "flash_attention_streaming_bwd.cu",
           "conv_stats.cu", "conv_stats_f32.cu", "group_norm.cu")
ENTRIES = ("dsml_flash_attention", "dsml_flash_attention_bwd",
           "dsml_flash_attention_fproj", "dsml_flash_attention_packed",
           "dsml_flash_attention_bwd_packed", "dsml_flash_attention_qout",
           "dsml_flash_attention_streaming",
           "dsml_flash_attention_streaming_bwd", "dsml_conv_stats",
           "dsml_conv_stats_f32", "dsml_group_norm_silu",
           "dsml_group_norm_silu_f32")
# the arguments of the conv + statistics and GroupNorm entries before their
# plans (design / tile rows / channel tile / splits, and cluster blocks)
# came in: a variant whose sources declare no plan is called this way
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LEGACY = {"dsml_conv_stats": [_P] * 11 + [_I] * 8 + [_F, _I, _P],
          "dsml_group_norm_silu": [_P] * 6 + [_I] * 5 + [_F, _I, _I, _P],
          # (x, partial, sums, b, n, c, chunks, stream): two launches
          "dsml_gn_channel_stats": [_P] * 3 + [_I] * 4 + [_P]}
LEGACY.update({k + "_f32": v for k, v in list(LEGACY.items())})
# the fp32 forwards before their scratch for the tile images came in
LEGACY.update({"dsml_flash_attention_f32": [_P] * 5 + [_I] * 4 + [_F, _P],
               "dsml_flash_attention_streaming_f32": [_P] * 6 + [_I] * 5
               + [_F, _P]})
# the fp32 backwards before their scratch (tile images, a chunk's P^T, dS^T
# and dS) came in
LEGACY.update({"dsml_flash_attention_bwd_f32": [_P] * 10 + [_I] * 4
               + [_F, _P],
               "dsml_flash_attention_streaming_bwd_f32": [_P] * 10 + [_I] * 4
               + [_F, _F, _P]})
# the fp32 packed entries before their scratch for the tile images came in
LEGACY.update({"dsml_flash_attention_packed_f32": [_P] * 5 + [_I] * 5
               + [_F, _P],
               "dsml_flash_attention_bwd_packed_f32": [_P] * 10 + [_I] * 5
               + [_F, _P]})
# an entry is legacy in a tree whose source lacks the marker of its plan
MARKERS = {"dsml_conv_stats": ("conv_stats.cu", "int design"),
           "dsml_group_norm_silu": ("group_norm.cu", "int cluster"),
           "dsml_gn_channel_stats": ("group_norm.cu", "int blocks"),
           "dsml_flash_attention": ("flash_attention.cu", "void* scratch"),
           "dsml_flash_attention_streaming": ("flash_attention_streaming.cu",
                                              "void* scratch"),
           "dsml_flash_attention_bwd": ("flash_attention_bwd.cu",
                                        "void* scratch"),
           "dsml_flash_attention_streaming_bwd": (
               "flash_attention_streaming_bwd.cu", "void* scratch"),
           "dsml_flash_attention_packed": ("flash_attention_packed.cu",
                                           "void* scratch"),
           "dsml_flash_attention_bwd_packed": (
               "flash_attention_bwd_packed.cu", "void* scratch")}
# what --conv-gn builds and times
CONV_GN_SOURCES = SOURCES[-3:]
CONV_GN_ENTRIES = ENTRIES[-4:]
# what --f32-attn builds and times
F32_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
               "flash_attention_streaming.cu",
               "flash_attention_streaming_bwd.cu")
F32_ENTRIES = ("dsml_flash_attention_f32", "dsml_flash_attention_bwd_f32",
               "dsml_flash_attention_streaming_f32",
               "dsml_flash_attention_streaming_bwd_f32")
# what --f32-packed builds and times: [B, Nq, Nk, heads] at D = 32, the
# three levels of a train-mead128 step (batch 32), then ragged ones (Nk just
# past a tile, Nk != Nq, Nk past a 128-key tile, Nk < 64)
F32_PACKED_SOURCES = ("flash_attention_packed.cu",
                      "flash_attention_bwd_packed.cu")
F32_PACKED_ENTRIES = ("dsml_flash_attention_packed_f32",
                      "dsml_flash_attention_bwd_packed_f32")
F32_PACKED_SHAPES = ((32, 1024, 1024, 5), (32, 256, 256, 10),
                     (32, 64, 64, 20), (2, 1000, 1000, 5), (2, 333, 77, 10),
                     (2, 200, 129, 5), (2, 100, 50, 3))
# what --f32-split builds and times: [B, H, Nq, Nk, D] at D = 32, the three
# levels of a train-mead128-split step (batch 32), the served levels (16),
# then ragged ones (Nk != Nq, Nk just past a 128-key span, Nq just past a
# warpgroup, Nk < 64 against Nq past it, the keys cut 32 ways)
F32_SPLIT_SOURCES = ("flash_attention.cu", "flash_attention_streaming.cu")
F32_SPLIT_ENTRIES = ("dsml_flash_attention_f32",
                     "dsml_flash_attention_streaming_f32")
F32_SPLIT_SHAPES = ((32, 5, 1024, 1024, 32), (16, 5, 1024, 1024, 32),
                    (32, 10, 256, 256, 32), (16, 10, 256, 256, 32),
                    (32, 20, 64, 64, 32), (16, 20, 64, 64, 32),
                    (2, 5, 333, 77, 32), (2, 3, 200, 129, 32),
                    (3, 5, 65, 129, 32), (2, 2, 100, 50, 32),
                    (1, 2, 100, 2000, 32))
# what --f32-split-bwd builds and times: [B, H, Nq, Nk, D] at D = 32, the
# three levels of a train-mead128-split step (batch 32), then ragged ones
# (Nk != Nq, Nk just past a 128-key span, Nq just past a warpgroup, Nq < 64
# < Nk, Nk < 64 < Nq, long K)
F32_SPLIT_BWD_SOURCES = ("flash_attention_bwd.cu",
                         "flash_attention_streaming_bwd.cu")
F32_SPLIT_BWD_ENTRIES = ("dsml_flash_attention_bwd_f32",
                         "dsml_flash_attention_streaming_bwd_f32")
F32_SPLIT_BWD_SHAPES = ((32, 5, 1024, 1024, 32), (32, 10, 256, 256, 32),
                        (32, 20, 64, 64, 32), (2, 5, 333, 77, 32),
                        (2, 3, 200, 129, 32), (3, 5, 65, 129, 32),
                        (2, 2, 50, 200, 32), (2, 2, 100, 50, 32),
                        (1, 2, 100, 2000, 32))
# what --wide-attn builds and times
WIDE_SOURCES = ("flash_attention.cu", "flash_attention_streaming.cu")
WIDE_ENTRIES = ("dsml_flash_attention", "dsml_flash_attention_streaming")
# what --gn-stats and --f32-fproj build and time
GN_STATS_SOURCES = ("group_norm.cu",)
GN_STATS_ENTRIES = ("dsml_gn_channel_stats", "dsml_gn_channel_stats_f32")
GN_STATS_SHAPES = (((16, 4096, 160), "bf16"), ((16, 1024, 640), "bf16"),
                   ((16, 256, 1280), "bf16"), ((8, 65536, 128), "bf16"),
                   ((16, 16384, 128), "f32"), ((16, 4096, 256), "f32"),
                   ((16, 1024, 512), "f32"), ((16, 1024, 160), "f32"),
                   ((16, 256, 960), "f32"), ((16, 64, 1280), "f32"),
                   ((1, 4096, 160), "bf16"), ((3, 1000, 160), "bf16"))
F32_FPROJ_SOURCES = ("flash_attention_fproj.cu",)
F32_FPROJ_ENTRIES = ("dsml_flash_attention_fproj_f32",)
F32_FPROJ_SHAPES = ((16, 1024, 160, 5), (16, 256, 320, 10), (16, 64, 640, 20),
                    (1, 1024, 160, 5), (3, 200, 160, 5), (2, 100, 640, 20))
# [B, H, Nq, Nk, D] of its cases: (shape, rows 2 and 4 or row 4 alone)
WIDE_SHAPES = (((8, 1, 4096, 4096, 512), ("flash", "streaming")),
               ((16, 1, 4096, 4096, 512), ("flash", "streaming")),
               ((2, 1, 1000, 1000, 512), ("flash", "streaming")),
               ((1, 2, 333, 77, 512), ("flash", "streaming")),
               ((1, 1, 64, 2000, 512), ("streaming",)),
               ((1, 1, 16384, 16384, 512), ("streaming",)))
# [B, H, Nq, Nk, D] of the fp32 D = 512 forwards beyond the two shapes above:
# mead-128-ldm-f4's frozen first stage (training encodes at batch 32, served
# identity encode and decodes at 8) and two ragged ones
F32_WIDE_SHAPES = ((32, 1, 1024, 1024, 512), (8, 1, 1024, 1024, 512),
                   (2, 1, 1000, 1000, 512), (1, 2, 333, 77, 512))
# [B, H, Nq, Nk, D] of the ragged fp32 D = 512 backwards: Nq = 2 x 128 +
# 77, Nk = 64 + 1 against Nq past 64, Nk < 64 on two heads, and Nq, Nk just
# past one and two 128-row tiles
F32_BWD_RAGGED = ((2, 1, 333, 333, 512), (2, 1, 100, 65, 512),
                  (1, 2, 70, 9, 512), (1, 1, 130, 257, 512))
# [B, H, Nq, Nk, D] of the fp32 D = 32 forwards (mead-128-ldm-f4's UNet
# levels in training and serving, and a ragged one)
F32_NARROW_SHAPES = ((32, 20, 64, 64, 32), (16, 20, 64, 64, 32),
                     (32, 10, 256, 256, 32), (32, 5, 1024, 1024, 32),
                     (2, 3, 77, 77, 32))


def ptxas_report(out: str, text: str) -> list:
    """ptxas's lines (registers, spills, stack) about the entry functions
    whose mangled name holds ``text``."""
    lines, keep = [], False
    for ln in out.splitlines():
        if "Compiling entry function" in ln:
            keep = text in ln
        if keep:
            lines.append(ln.strip())
    return lines


def build(variants: dict, sources=SOURCES, entries=ENTRIES,
          ptxas: str = "") -> dict:
    """name -> loaded library of every variant not named ``c_*``; with
    ``ptxas``, ptxas's report on the entries whose name holds it is
    printed."""
    root = os.path.join(_build.BUILD_DIR, "variants")
    procs = []
    for name, subs in variants.items():
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, d)
        for f, old, new in subs:
            path = os.path.join(d, f)
            if old == "":  # the whole file from another tree
                other = os.path.realpath(os.path.join(ROOT, new))
                if os.path.commonpath([other, ROOT]) != ROOT:
                    raise ValueError(f"{name}: {new!r} is outside the "
                                     "repository")
                shutil.copyfile(other, path)
                continue
            src = open(path).read()
            if old not in src:
                raise ValueError(f"{name}: {old!r} not in {f}")
            open(path, "w").write(src.replace(old, new))
        for src in sources:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-c",
                   os.path.join(d, src), "-o", os.path.join(d, src + ".o")]
            procs.append((name, src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name, src, proc in procs:
        out, _ = proc.communicate()
        loss = [ln.strip() for ln in out.splitlines() if "Performance Loss" in ln]
        print(json.dumps({"variant": name, "source": src,
                          "rc": proc.returncode, "performance_loss": loss,
                          **({"ptxas": ptxas_report(out, ptxas)} if ptxas
                             else {})}),
              flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed on {src}:\n{out}")
    libs = {}
    for name in variants:
        if name.startswith("c_"):
            continue
        d = os.path.join(root, name)
        lib_path = os.path.join(d, "lib.so")
        subprocess.run([_build._nvcc(), "-shared", "-o", lib_path,
                        *(os.path.join(d, s + ".o") for s in sources)],
                       check=True)
        lib = ctypes.CDLL(lib_path)
        lib.legacy = set()
        for fn in entries:
            source, marker = MARKERS.get(fn.removesuffix("_f32"), (None, None))
            if fn in LEGACY and marker not in open(
                    os.path.join(d, source)).read():
                lib.legacy.add(fn)
            getattr(lib, fn).argtypes = (LEGACY[fn] if fn in lib.legacy
                                         else _build.SIGNATURES[fn])
        libs[name] = lib
    return libs


def cases() -> dict:
    """name -> (call(lib) returning the C entry's code, relative error of
    the last call's outputs against the plain version)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s, sc=1.0: (torch.randn(*s, generator=gen, device="cuda")
                              * sc).to(torch.bfloat16)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rel = lambda a, r: ((a.float() - r.float()).abs().max()
                        / r.float().abs().max()).item()

    def fproj(b, n, c, heads):
        d = c // heads
        h = rnd(b, n, c)
        wq, wk, wv, wo = (rnd(c, c, sc=c ** -0.5) for _ in range(4))
        bo = rnd(c, sc=0.1)
        ref = A.fproj_reference(h, wq, wk, wv, wo, bo, heads)
        qkv = torch.empty(b, n, 3 * c, dtype=h.dtype, device="cuda")
        out = torch.empty_like(h)
        call = lambda lib: lib.dsml_flash_attention_fproj(
            h.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), qkv.data_ptr(), out.data_ptr(), b,
            n, c, heads, d, d ** -0.5, stream())
        return call, lambda: rel(out, ref)

    def packed(b, nq, nk, heads, d):
        q, k, v = rnd(b, nq, heads * d), rnd(b, nk, heads * d), rnd(
            b, nk, heads * d)
        ref = A.packed_reference(q, k, v, heads)
        out = torch.empty_like(q)
        call = lambda lib: lib.dsml_flash_attention_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, b,
            nq, nk, heads, d, d ** -0.5, stream())
        return call, lambda: rel(out, ref)

    def flash(b, h, nq, nk, d):
        q, k, v = rnd(b, h, nq, d), rnd(b, h, nk, d), rnd(b, h, nk, d)
        ref = A.attention_reference(q, k, v)
        out = torch.empty_like(q)
        call = lambda lib: lib.dsml_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            b * h, nq, nk, d, d ** -0.5, stream())
        return call, lambda: rel(out, ref)

    def flash_bwd(b, h, nq, nk, d):
        q, do = rnd(b, h, nq, d), rnd(b, h, nq, d)
        k, v = rnd(b, h, nk, d), rnd(b, h, nk, d)
        scale = d ** -0.5
        o, lse = A._launch_flash_forward(q, k, v, scale, True)
        ref = A.flash_attention_bwd_reference(q, k, v, do, scale=scale)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        delta = torch.empty_like(lse)
        call = lambda lib: lib.dsml_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), b * h, nq, nk, d, scale,
            stream())
        return call, lambda: max(rel(g, r) for g, r in zip(grads, ref))

    def packed_bwd(b, n, heads, d):
        q, k, v, do = (rnd(b, n, heads * d) for _ in range(4))
        scale = d ** -0.5
        o, lse = A._launch_packed_forward(q, k, v, heads, scale, True)
        ref = A.packed_bwd_reference(q, k, v, do, heads, scale=scale)
        grads = [torch.empty_like(q) for _ in range(3)]
        delta = torch.empty_like(lse)
        call = lambda lib: lib.dsml_flash_attention_bwd_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), b, n, n, heads, d, scale,
            stream())
        return call, lambda: max(rel(g, r) for g, r in zip(grads, ref))

    def qout(b, n, c, heads):
        d = c // heads
        h, k, v = rnd(b, n, c), rnd(b, n, c), rnd(b, n, c)
        wq, wo = rnd(c, c, sc=c ** -0.5), rnd(c, c, sc=c ** -0.5)
        bo = rnd(c, sc=0.1)
        ref = A.qout_reference(h, k, v, wq, wo, bo, heads)
        out = torch.empty_like(h)
        call = lambda lib: lib.dsml_flash_attention_qout(
            h.data_ptr(), k.data_ptr(), v.data_ptr(), wq.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), out.data_ptr(), b, n, n, c, heads,
            d, d ** -0.5, stream())
        return call, lambda: rel(out, ref)

    def streaming(b, h, nq, nk, d):
        q, k, v = rnd(b, h, nq, d), rnd(b, h, nk, d), rnd(b, h, nk, d)
        ref = A.streaming_attention_reference(q, k, v)
        splits = A.streaming_splits(b * h, nq, nk)
        out = torch.empty_like(q)
        f32 = dict(dtype=torch.float32, device="cuda")
        part_o = torch.empty((splits, b * h * nq, d), **f32)
        part_ml = torch.empty((splits, 2, b * h * nq), **f32)
        factor = A._folded_factor(d ** -0.5, q.dtype)
        call = lambda lib: lib.dsml_flash_attention_streaming(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), b * h, nq, nk, d, splits,
            factor, stream())
        return call, lambda: rel(out, ref)

    def streaming_bwd(b, h, nq, nk, d):
        q, do = rnd(b, h, nq, d), rnd(b, h, nq, d)
        k, v = rnd(b, h, nk, d), rnd(b, h, nk, d)
        scale = d ** -0.5
        o = A._launch_streaming_forward(q, k, v, scale)
        ref = A.streaming_bwd_reference(q, k, v, o, do, scale=scale)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        f32 = dict(dtype=torch.float32, device="cuda")
        lse, delta = torch.empty(b * h * nq, **f32), torch.empty(b * h * nq,
                                                                 **f32)
        call = lambda lib: lib.dsml_flash_attention_streaming_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), b * h, nq, nk, d, scale,
            A._folded_factor(scale, q.dtype), stream())
        return call, lambda: max(rel(g, r) for g, r in zip(grads, ref))

    def conv(b, hh, ww, cin, cout, k, norm, res, dtype, designs=None,
             **force):
        """conv_stats at its plan (``force`` overrides fields of it; a
        legacy entry takes such a case as "not taken"), against the plain
        version in fp32 with TF32 off."""
        g = torch.Generator(device="cuda").manual_seed(1)
        r = lambda *sh, sc=1.0: (torch.randn(*sh, generator=g, device="cuda")
                                 * sc).to(dtype)
        x = r(b, hh, ww, cin, sc=2.0) + 0.5
        w = r(k, k, cin, cout, sc=(k * k * cin) ** -0.5)
        bias = 0.5 * torch.randn(b, cout, generator=g, device="cuda")
        skip = r(b, hh, ww, cout) if res else None
        kw, stats = {}, [None] * 4
        if norm:
            gamma = 1 + 0.1 * torch.randn(cin, generator=g, device="cuda")
            beta = 0.1 * torch.randn(cin, generator=g, device="cuda")
            s1, s2 = G.gn_channel_stats_reference(x.reshape(b, -1, cin))
            kw = dict(in_stats=(s1, s2), gamma=gamma, beta=beta)
            stats = [s1.contiguous(), s2.contiguous(), gamma, beta]
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        ref = C.conv_stats_reference(x, w, bias, skip, **kw)[0]
        torch.backends.cudnn.allow_tf32 = saved
        try:
            plan = C.conv_plan(b, hh, ww, cin, cout, k, dtype, norm,
                               **({} if designs is None
                                  else {"designs": designs}))
        except StopIteration:   # no design of ``designs`` takes the shape
            return (lambda lib: -1), (lambda: 0.0)
        plan = dataclasses.replace(plan, **force)
        if force and plan.design:
            total = -(-b * hh * ww // C.IG_BM)
            sl = C.IG_BM // plan.splits
            plan = dataclasses.replace(plan, partial=(
                total * plan.splits, C.ig_images(sl, hh * ww, b), 2, cout))
        wk = (w.permute(3, 0, 1, 2) if plan.design else w).contiguous()
        rows = C.conv_tile_rows(hh, k)
        tiles = -(-hh // rows) * -(-ww // C.CONV_TILE_W)
        y = torch.empty(b, hh, ww, cout, dtype=dtype, device="cuda")
        part = torch.empty(max(plan.partial[0] * plan.partial[1] * 2 * cout,
                               b * tiles * 2 * cout), device="cuda")
        sums = torch.empty(2, b, cout, device="cuda")
        ptr = lambda t: None if t is None else t.data_ptr()
        entry = "dsml_conv_stats" + ("_f32" if dtype == torch.float32 else "")

        def call(lib):
            fn = getattr(lib, entry)
            head = (x.data_ptr(), None, bias.data_ptr(), ptr(skip),
                    *map(ptr, stats), y.data_ptr(), part.data_ptr(),
                    sums.data_ptr(), b, hh, ww, cin, cout, k)
            tail = (32, 1e-5, 1, stream())
            if entry in lib.legacy:
                if force or designs is not None:
                    return -1
                return fn(head[0], w.data_ptr(), *head[2:], rows, *tail)
            return fn(head[0], wk.data_ptr(), *head[2:], plan.design,
                      plan.tile_rows, plan.block_n, plan.splits, *tail)
        return call, lambda: rel(y, ref)

    def gn(b, n, c, dtype, **force):
        """The whole-row GroupNorm + SiLU at its plan (``cluster`` forces
        the cluster blocks, 0 the three passes)."""
        g = torch.Generator(device="cuda").manual_seed(2)
        x = (torch.randn(b, n, c, generator=g, device="cuda") * 2 + 0.5
             ).to(dtype)
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device="cuda")
        beta = 0.1 * torch.randn(c, generator=g, device="cuda")
        ref = G.group_norm_silu_reference(x, gamma, beta)
        cluster = force.get("cluster", G.gn_plan(n, c, dtype))
        chunks = G.gn_chunks(n, c)
        part = torch.empty(b, chunks, 2, c, device="cuda")
        sums = torch.empty(2, b, c, device="cuda")
        y = torch.empty_like(x)
        entry = "dsml_group_norm_silu" + ("_f32" if dtype == torch.float32
                                          else "")

        def call(lib):
            fn = getattr(lib, entry)
            head = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    part.data_ptr(), sums.data_ptr(), y.data_ptr(), b, n, c,
                    32, chunks)
            tail = (1e-5, 1, 0, stream())
            if entry in lib.legacy:
                return -1 if force else fn(*head, *tail)
            return fn(*head, cluster, *tail)
        return call, lambda: rel(y, ref)

    f32, b16 = torch.float32, torch.bfloat16
    if GN_STATS_ONLY:
        return stats_cases(rel, stream)
    if F32_FPROJ_ONLY:
        return fproj_f32_cases(rel, stream)
    if F32_PACKED_ONLY:
        return f32_packed_cases(rel, stream)
    if F32_SPLIT_ONLY:
        return f32_split_cases(rel, stream)
    if F32_SPLIT_BWD_ONLY:
        return f32_split_bwd_cases(rel, stream)
    if WIDE_ONLY:
        return {f"{kind} {_tag(shape)}": {"flash": flash,
                                          "streaming": streaming}[kind](*shape)
                for shape, kinds in WIDE_SHAPES for kind in kinds}
    if F32_ONLY:
        return f32_cases(rel, stream)
    if CONV_GN_ONLY:
        out, CONV_ARGS = {}, {}
        for hh, cin, cout, k, norm, res in (
                (8, 1280, 640, 3, True, False), (16, 960, 320, 3, True, False),
                (32, 160, 160, 3, True, True), (16, 480, 320, 1, False, False),
                (8, 640, 640, 3, True, True), (8, 960, 640, 3, False, False),
                (8, 640, 640, 1, True, False), (16, 320, 320, 3, True, True)):
            name = f"conv f32 [16,{hh},{hh},{cin}->{cout}] k{k}" + (
                " norm" if norm else "") + (" skip" if res else "")
            CONV_ARGS[name] = (16, hh, hh, cin, cout, k, norm, res, f32)
            out[name] = conv(*CONV_ARGS[name])
        for b, hh, cin, cout, k, norm, res, dt in (
                (16, 64, 160, 160, 3, True, True, b16),
                (16, 64, 160, 160, 3, False, False, b16),
                (16, 32, 960, 320, 3, True, False, b16),
                (16, 16, 1280, 640, 3, True, False, b16),
                (8, 256, 128, 128, 3, True, True, b16),
                (16, 64, 160, 160, 1, False, True, b16),
                (16, 128, 128, 128, 3, True, False, f32),
                (16, 64, 256, 256, 3, True, True, f32),
                (16, 32, 512, 512, 3, True, False, f32),
                (16, 64, 128, 256, 1, False, False, f32),
                (16, 32, 512, 1536, 1, True, False, f32),
                (16, 32, 512, 512, 1, False, True, f32),
                (32, 8, 1280, 640, 3, True, False, f32)):
            name = (f"conv {'f32' if dt == f32 else 'bf16'} "
                    f"[{b},{hh},{hh},{cin}->{cout}] k{k}"
                    + (" norm" if norm else "") + (" skip" if res else ""))
            CONV_ARGS[name] = (b, hh, hh, cin, cout, k, norm, res, dt)
            out[name] = conv(*CONV_ARGS[name])
        for name in list(out):
            if " k3" in name and "norm" in name:
                for d in (0, 1, 2, 3):
                    out[f"{name} design {d}"] = conv(*CONV_ARGS[name],
                                                     designs=(d,))
        out["conv f32 [16,8,8,1280->640] k3 (no norm)"] = conv(
            16, 8, 8, 1280, 640, 3, False, False, f32)
        for name, sp in (("conv f32 [16,8,8,1280->640] k3 norm", 8),
                         ("conv f32 [16,16,16,960->320] k3 norm", 4),
                         ("conv bf16 [16,16,16,1280->640] k3 norm", 2)):
            out[f"{name} splits {sp}"] = conv(*CONV_ARGS[name], splits=sp)
        for b, n, c, dt in ((16, 1024, 160, f32), (16, 256, 960, f32),
                            (16, 64, 1280, f32), (16, 4096, 160, b16),
                            (16, 1024, 640, b16), (16, 256, 1280, b16),
                            (16, 4096, 480, b16), (16, 1024, 320, b16),
                            (16, 1024, 512, f32), (16, 4096, 256, f32)):
            name = f"gn {'f32' if dt == f32 else 'bf16'} [{b},{n},{c}]"
            out[name] = gn(b, n, c, dt)
            for cl in (8, 0):
                out[name + f" cluster {cl}"] = gn(b, n, c, dt, cluster=cl)
        return out

    return {"packed [16,4096,5x32]": packed(16, 4096, 4096, 5, 32),
            "packed [8,4096,5x32]": packed(8, 4096, 4096, 5, 32),
            "packed [8,4096,2x80]": packed(8, 4096, 4096, 2, 80),
            "packed [8,1024,10x32]": packed(8, 1024, 1024, 10, 32),
            "packed [8,256,20x32]": packed(8, 256, 256, 20, 32),
            "packed [2,333,77,3x80]": packed(2, 333, 77, 3, 80),
            "streaming_bwd [8,10,1024,32]": streaming_bwd(8, 10, 1024, 1024,
                                                          32),
            "streaming_bwd [8,20,256,32]": streaming_bwd(8, 20, 256, 256, 32),
            "streaming_bwd [2,3,333,77,64]": streaming_bwd(2, 3, 333, 77, 64),
            "streaming_bwd [8,2,4096,80]": streaming_bwd(8, 2, 4096, 4096, 80),
            "streaming [8,2,4096,80]": streaming(8, 2, 4096, 4096, 80),
            "flash [8,10,1024,32]": flash(8, 10, 1024, 1024, 32),
            "flash [8,20,256,32]": flash(8, 20, 256, 256, 32),
            "flash [8,2,4096,80]": flash(8, 2, 4096, 4096, 80),
            "flash [2,3,333,77,80]": flash(2, 3, 333, 77, 80),
            "flash_bwd [8,10,1024,32]": flash_bwd(8, 10, 1024, 1024, 32),
            "flash_bwd [8,20,256,32]": flash_bwd(8, 20, 256, 256, 32),
            "flash_bwd [8,2,4096,80]": flash_bwd(8, 2, 4096, 4096, 80),
            "flash_bwd [2,3,333,77,80]": flash_bwd(2, 3, 333, 77, 80),
            "bwd_packed [8,4096,2x80]": packed_bwd(8, 4096, 2, 80),
            "qout [8,4096,160] x 5": qout(8, 4096, 160, 5),
            "qout [16,4096,160] x 5": qout(16, 4096, 160, 5),
            "qout [2,1000,128] x 2": qout(2, 1000, 128, 2),
            "streaming [8,10,1024,32]": streaming(8, 10, 1024, 1024, 32),
            "streaming [8,20,256,32]": streaming(8, 20, 256, 256, 32),
            "streaming [2,3,333,77,64]": streaming(2, 3, 333, 77, 64),
            "fproj [16,1024,320] x 10": fproj(16, 1024, 320, 10),
            "fproj [8,1024,320] x 10": fproj(8, 1024, 320, 10),
            "fproj [16,256,640] x 20": fproj(16, 256, 640, 20),
            "fproj [3,200,320] x 10": fproj(3, 200, 320, 10),
            "bwd_packed [8,1024,10x32]": packed_bwd(8, 1024, 10, 32),
            "bwd_packed [8,256,20x32]": packed_bwd(8, 256, 20, 32),
            "bwd_packed [8,4096,5x32]": packed_bwd(8, 4096, 5, 32),
            "bwd_packed [2,1000,3x64]": packed_bwd(2, 1000, 3, 64)}


def f32_cases(rel, stream) -> dict:
    """The fp32 attention cases of ``--f32-attn`` (see the module's note)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")

    def fwd(kind, b, h, nq, nk, d):
        """The split-head (``flash``) or streaming forward; a tree from
        before the scratch argument is called without it."""
        q, k, v = rnd(b, h, nq, d), rnd(b, h, nk, d), rnd(b, h, nk, d)
        scale = d ** -0.5
        streaming = kind == "streaming"
        ref = (A.streaming_attention_reference if streaming
               else A.attention_reference)(q, k, v, scale=scale)
        splits = A.streaming_splits(b * h, nq, nk) if streaming else 1
        out = torch.empty_like(q)
        part_o = torch.empty((splits, b * h * nq, d), device="cuda")
        part_ml = torch.empty((splits, 2, b * h * nq), device="cuda")
        scratch = (torch.empty(A.wide_f32_plan(b * h, nq, nk, splits).scratch,
                               device="cuda")
                   if d == A.WIDE_F32_HEAD_DIM else None)
        name = "dsml_flash_attention" + ("_streaming" if streaming else "")
        name += "_f32"
        outs = ((out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr())
                if streaming else (out.data_ptr(), None))
        tail = ((b * h, nq, nk, d, splits, A._folded_factor(scale, q.dtype))
                if streaming else (b * h, nq, nk, d, scale))
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        sp = (None if scratch is None else scratch.data_ptr(),)

        def call(lib):
            head = ins + outs + (() if name in lib.legacy else sp) + tail
            return getattr(lib, name)(*head, stream())
        call.operands = (q, k, v, part_o, part_ml, scratch)   # kept alive
        return call, lambda: rel(out, ref)

    def bwd(kind, b, h, nq, nk, d):
        """The split-head (``flash_bwd``) or streaming backward, on this
        tree's forward output; a tree from before the scratch argument is
        called without it."""
        q, do = rnd(b, h, nq, d), rnd(b, h, nq, d)
        k, v = rnd(b, h, nk, d), rnd(b, h, nk, d)
        scale = d ** -0.5
        streaming = kind == "streaming_bwd"
        if streaming:
            o = A._launch_streaming_forward(q, k, v, scale)
            ref = A.streaming_bwd_reference(q, k, v, o, do, scale=scale)
            lse = torch.empty(b * h * nq, device="cuda")
        else:
            o, lse = A._launch_flash_forward(q, k, v, scale, True)
            ref = A.flash_attention_bwd_reference(q, k, v, do, scale=scale)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        delta = torch.empty(b * h * nq, device="cuda")
        scratch = A._f32_bwd_scratch(q, nk)[0]
        name = "dsml_flash_attention" + ("_streaming_bwd" if streaming
                                         else "_bwd") + "_f32"
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                *(g.data_ptr() for g in grads), b * h, nq, nk, d, scale,
                *((A._folded_factor(scale, q.dtype),) if streaming else ()))

        def call(lib):
            return getattr(lib, name)(
                *head, *(() if name in lib.legacy else (scratch.data_ptr(),)),
                stream())
        call.operands = (q, k, v, o, do, lse, delta, scratch)
        return call, lambda: max(rel(g, r) for g, r in zip(grads, ref))

    out = {}
    for shape in ((16, 1, 1024, 1024, 512), (8, 1, 4096, 4096, 512)):
        tag = f"[{shape[0]},{shape[1]},{shape[2]},{shape[4]}]"
        for kind in ("flash", "streaming"):
            out[f"{kind} f32 {tag}"] = fwd(kind, *shape)
        for kind in ("flash_bwd", "streaming_bwd"):
            out[f"{kind} f32 {tag}"] = bwd(kind, *shape)
    for kind in ("flash_bwd", "streaming_bwd"):
        for shape in F32_BWD_RAGGED:
            out[f"{kind} f32 {_tag(shape)}"] = bwd(kind, *shape)
    for shape in F32_WIDE_SHAPES:
        for kind in ("flash", "streaming"):
            out[f"{kind} f32 {_tag(shape)}"] = fwd(kind, *shape)
    for shape in F32_NARROW_SHAPES:
        for kind in ("flash", "streaming"):
            out[f"{kind} f32 {_tag(shape)}"] = fwd(kind, *shape)
    return out


def _repeatable(call, outs, refs, rel):
    """(call, err) of a case whose error also asks for equal bits: err runs
    the library of the last call once more, and reads inf where ``outs``
    change, else the worst relative error of ``outs`` against ``refs``."""
    last = {}

    def keep(lib):
        last["lib"] = lib
        return call(lib)

    def err():
        first = [t.clone() for t in outs]
        call(last["lib"])
        torch.cuda.synchronize()
        if not all(torch.equal(a, t) for a, t in zip(first, outs)):
            return float("inf")
        return max(rel(a, r) for a, r in zip(outs, refs))
    return keep, err


def f32_packed_cases(rel, stream) -> dict:
    """The fp32 D = 32 packed cases of ``--f32-packed`` (see the module's
    note): the forward (o and its row log-sum-exp) and the backward (on the
    plain forward's output and log-sum-exp) against the plain versions, and
    the same bits from a second call."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for b, nq, nk, heads in F32_PACKED_SHAPES:
        d, hd = 32, 32 * heads
        q, do = (torch.randn(b, nq, hd, generator=gen, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn(b, nk, hd, generator=gen, device="cuda")
                for _ in range(2))
        scale = d ** -0.5
        plan = A.narrow_f32_plan(b * heads, nq, nk)
        sp = lambda t: t.view(b, t.shape[1], heads, d).transpose(1, 2)
        s = torch.matmul(sp(q), sp(k).transpose(-1, -2)) * scale
        lse_ref = (torch.logsumexp(s, dim=-1) * A.LOG2E).reshape(-1)
        o_ref = A.packed_reference(q, k, v, heads, scale=scale)
        grads_ref = A.packed_bwd_reference(q, k, v, do, heads, scale=scale)
        o, lse = torch.empty_like(q), torch.empty(b * heads * nq,
                                                  device="cuda")
        fwd_scratch = torch.empty(plan.fwd_scratch, device="cuda")
        grads = [torch.empty_like(t) for t in (q, k, v)]
        delta = torch.empty(b * heads * nq, device="cuda")
        bwd_scratch = torch.empty(plan.bwd_scratch, device="cuda")
        tag = (f"[{b},{nq},{heads}x{d}]" if nq == nk
               else f"[{b},{nq}->{nk},{heads}x{d}]")

        def fwd(lib, q=q, k=k, v=v, o=o, lse=lse, scratch=fwd_scratch, b=b,
                nq=nq, nk=nk, heads=heads):
            name = "dsml_flash_attention_packed_f32"
            sp_ = () if name in lib.legacy else (scratch.data_ptr(),)
            return getattr(lib, name)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), *sp_, b, nq, nk, heads, 32, 32 ** -0.5,
                stream())

        def bwd(lib, q=q, k=k, v=v, do=do, o=o_ref, lse=lse_ref,
                delta=delta, grads=grads, scratch=bwd_scratch, b=b, nq=nq,
                nk=nk, heads=heads):
            name = "dsml_flash_attention_bwd_packed_f32"
            sp_ = () if name in lib.legacy else (scratch.data_ptr(),)
            return getattr(lib, name)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                *(g.data_ptr() for g in grads), b, nq, nk, heads, 32,
                32 ** -0.5, *sp_, stream())

        for kind, call, outs, refs in (
                ("packed", fwd, (o, lse), (o_ref, lse_ref)),
                ("bwd_packed", bwd, grads, grads_ref)):
            out[f"{kind} f32 {tag}"] = _repeatable(call, outs, refs, rel)
    return out


def f32_split_cases(rel, stream) -> dict:
    """The fp32 D = 32 split-head and streaming cases of ``--f32-split``
    (see the module's note): o (and row 2's log-sum-exp) against the plain
    versions, and the same bits from a second call."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for shape in F32_SPLIT_SHAPES:
        b, h, nq, nk, d = shape
        q = torch.randn(b, h, nq, d, generator=gen, device="cuda")
        k, v = (torch.randn(b, h, nk, d, generator=gen, device="cuda")
                for _ in range(2))
        scale = d ** -0.5
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
        lse_ref = (torch.logsumexp(s, dim=-1) * A.LOG2E).reshape(-1)
        splits = A.streaming_splits(b * h, nq, nk)
        plan = A.narrow_f32_plan(b * h, nq, nk, splits)
        scratch = torch.empty(plan.fwd_scratch, device="cuda")
        part_o = torch.empty((splits, b * h * nq, d), device="cuda")
        part_ml = torch.empty((splits, 2, b * h * nq), device="cuda")
        for kind in ("flash", "streaming"):
            o = torch.empty_like(q)
            lse = torch.empty(b * h * nq, device="cuda")
            if kind == "flash":
                refs = (A.attention_reference(q, k, v, scale=scale), lse_ref)
                outs = (o, lse)

                def call(lib, q=q, k=k, v=v, o=o, lse=lse, scratch=scratch,
                         bh=b * h, nq=nq, nk=nk):
                    return lib.dsml_flash_attention_f32(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), scratch.data_ptr(), bh,
                        nq, nk, 32, 32 ** -0.5, stream())
            else:
                refs = (A.streaming_attention_reference(q, k, v,
                                                        scale=scale),)
                outs = (o,)

                def call(lib, q=q, k=k, v=v, o=o, part_o=part_o,
                         part_ml=part_ml, scratch=scratch, bh=b * h, nq=nq,
                         nk=nk, splits=splits):
                    return lib.dsml_flash_attention_streaming_f32(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
                        scratch.data_ptr(), bh, nq, nk, 32, splits,
                        A._folded_factor(32 ** -0.5, torch.float32),
                        stream())
            out[f"{kind} f32 {_tag(shape)}"
                + (f" {splits} splits" if kind == "streaming" and splits > 1
                   else "")] = _repeatable(call, outs, refs, rel)
    return out


def f32_split_bwd_cases(rel, stream) -> dict:
    """The fp32 D = 32 split-head and streaming backward cases of
    ``--f32-split-bwd`` (see the module's note): dq, dk and dv against the
    plain versions, and the same bits from a second call."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for shape in F32_SPLIT_BWD_SHAPES:
        b, h, nq, nk, d = shape
        q, do = (torch.randn(b, h, nq, d, generator=gen, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn(b, h, nk, d, generator=gen, device="cuda")
                for _ in range(2))
        scale = d ** -0.5
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
        lse = (torch.logsumexp(s, dim=-1) * A.LOG2E).reshape(-1)
        # delta reaches the entries by its address alone: each call keeps
        # it (and the scratch) alive as a default argument
        delta = torch.empty(b * h * nq, device="cuda")
        scratch = torch.empty(A.narrow_f32_plan(b * h, nq, nk).bwd_scratch,
                              device="cuda")
        for kind in ("flash_bwd", "streaming_bwd"):
            grads = [torch.empty_like(t) for t in (q, k, v)]
            ptrs = (delta.data_ptr(), *(g.data_ptr() for g in grads),
                    b * h, nq, nk, d, scale)
            if kind == "flash_bwd":
                o = A.attention_reference(q, k, v, scale=scale)
                refs = A.flash_attention_bwd_reference(q, k, v, do,
                                                       scale=scale)

                def call(lib, q=q, k=k, v=v, o=o, do=do, lse=lse, ptrs=ptrs,
                         delta=delta, scratch=scratch):
                    return lib.dsml_flash_attention_bwd_f32(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), do.data_ptr(), lse.data_ptr(), *ptrs,
                        scratch.data_ptr(), stream())
            else:
                o = A.streaming_attention_reference(q, k, v, scale=scale)
                refs = A.streaming_bwd_reference(q, k, v, o, do, scale=scale)
                lse_out = torch.empty(b * h * nq, device="cuda")

                def call(lib, q=q, k=k, v=v, o=o, do=do, lse=lse_out,
                         ptrs=ptrs, delta=delta, scratch=scratch):
                    return lib.dsml_flash_attention_streaming_bwd_f32(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), do.data_ptr(), lse.data_ptr(), *ptrs,
                        A._folded_factor(32 ** -0.5, torch.float32),
                        scratch.data_ptr(), stream())
            out[f"{kind} f32 {_tag(shape)}"] = _repeatable(call, grads, refs,
                                                          rel)
    return out


def stats_cases(rel, stream) -> dict:
    """The channel statistics cases of ``--gn-stats`` (see the module's
    note): the sums against the plain version, and the same bits twice."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for (b, n, c), tname in GN_STATS_SHAPES:
        dtype = torch.float32 if tname == "f32" else torch.bfloat16
        x = (torch.randn(b, n, c, generator=gen, device="cuda") * 2 + 0.5
             ).to(dtype)
        ref = torch.stack(G.gn_channel_stats_reference(x))
        entry = "dsml_gn_channel_stats" + ("_f32" if tname == "f32" else "")
        chunks = G.gn_chunks(n, c)
        partial = torch.empty(b * chunks * 2 * c, device="cuda")
        sums = torch.empty(2, b, c, device="cuda")
        blocks = G.stats_plan(b, n, c)
        last = {}

        def call(lib, x=x, sums=sums, blocks=blocks, entry=entry,
                 chunks=chunks, partial=partial, last=last, b=b, n=n, c=c):
            fn = getattr(lib, entry)
            last["lib"] = lib
            if entry in lib.legacy:
                return fn(x.data_ptr(), partial.data_ptr(), sums.data_ptr(),
                          b, n, c, chunks, stream())
            return fn(x.data_ptr(), sums.data_ptr(), b, n, c, blocks,
                      stream())

        def err(sums=sums, ref=ref, call=call, last=last):
            first = sums.clone()
            call(last["lib"])
            torch.cuda.synchronize()
            if not torch.equal(first, sums):
                return float("inf")
            return max(rel(sums[i], ref[i]) for i in range(2))
        out[f"stats {tname} [{b},{n},{c}]"] = (call, err)
    return out


def fproj_f32_cases(rel, stream) -> dict:
    """The fp32 D = 32 fused-projection cases of ``--f32-fproj`` (see the
    module's note): against the plain version, and the same bits twice."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for b, n, c, heads in F32_FPROJ_SHAPES:
        hd = c
        h = torch.randn(b, n, c, generator=gen, device="cuda")
        wq, wk, wv = (torch.randn(hd, c, generator=gen, device="cuda")
                      * c ** -0.5 for _ in range(3))
        wo = torch.randn(c, hd, generator=gen, device="cuda") * hd ** -0.5
        bo = torch.randn(c, generator=gen, device="cuda") * 0.1
        ref = A.fproj_reference(h, wq, wk, wv, wo, bo, heads)
        scratch = torch.empty(max(b * n * 3 * hd, A.fproj_scratch_shape(
            b, n, c, hd, torch.float32)[0]), device="cuda")
        res = torch.empty_like(h)
        last = {}

        def call(lib, h=h, wq=wq, wk=wk, wv=wv, wo=wo, bo=bo, res=res,
                 scratch=scratch, b=b, n=n, c=c, heads=heads, last=last):
            last["lib"] = lib
            return lib.dsml_flash_attention_fproj_f32(
                h.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
                wo.data_ptr(), bo.data_ptr(), scratch.data_ptr(),
                res.data_ptr(), b, n, c, heads, 32, 32 ** -0.5, stream())

        def err(res=res, ref=ref, call=call, last=last):
            first = res.clone()
            call(last["lib"])
            torch.cuda.synchronize()
            return rel(res, ref) if torch.equal(first, res) else float("inf")
        out[f"fproj f32 [{b},{n},{c}] x {heads}"] = (call, err)
    return out


def _tag(shape) -> str:
    b, h, nq, nk, d = shape
    return f"[{b},{h},{nq},{d}]" if nq == nk else f"[{b},{h},{nq},{nk},{d}]"


def wrapper_cases(rel) -> dict:
    """The cases of ``--f32-attn --wrapper`` (see the module's note): a call
    takes the host path ``wrapper`` or ``function`` in place of a library."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for shape in F32_NARROW_SHAPES:
        b, h, nq, nk, d = shape
        q, k, v = (torch.randn(b, h, n, d, generator=gen, device="cuda")
                   for n in (nq, nk, nk))
        scale = d ** -0.5
        for kind, wrapper, function, reference in (
                ("flash", A.flash_attention, A._FlashAttention,
                 A.attention_reference),
                ("streaming", A.flash_attention_streaming,
                 A._StreamingAttention, A.streaming_attention_reference)):
            last = {}

            def call(path, q=q, k=k, v=v, scale=scale, wrapper=wrapper,
                     function=function, last=last):
                last["out"] = (wrapper(q, k, v, scale) if path == "wrapper"
                               else function.apply(q, k, v, scale))
                return 0
            ref = reference(q, k, v, scale=scale)
            out[f"{kind} f32 {_tag(shape)}"] = (
                call, lambda last=last, ref=ref: rel(last["out"], ref))
    return out


def event_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels_ms(fn, iters: int = 10) -> dict:
    """Device ms a call of ``fn`` by kernel name, from ``iters`` warm calls
    under torch.profiler (host issue left out): each kernel's mean over the
    launches the profile kept (it can drop some), times its launches a call
    (the kept launches over ``iters``, rounded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    from .measure import is_annotation

    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA" and not is_annotation(ev.key):
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            # the kernel's name without namespaces, arguments and return
            # type (template arguments kept)
            name = ev.key.replace("(anonymous namespace)::", "")
            name, _, targs = name.split("(")[0].partition("<")
            name = name.split(" ")[-1].split("::")[-1] + (
                "<" + targs if targs else "")
            # launches a call: a kernel can run more than once a call
            per_call = max(1, round(ev.count / iters))
            out[name] = out.get(name, 0.0) + (
                us / 1e3 / max(ev.count, 1) * per_call)
    return out


def device_ms(fn, iters: int = 10) -> float:
    """Device time a call of ``fn``: every kernel it launches (each once a
    call), summed."""
    return sum(device_kernels_ms(fn, iters).values())


# only the conv + statistics and GroupNorm cases (set by --conv-gn), only
# the fp32 attention cases (set by --f32-attn), only the bf16 D = 512
# forwards (set by --wide-attn)
CONV_GN_ONLY = False
F32_ONLY = False
WIDE_ONLY = False
GN_STATS_ONLY = False     # set by --gn-stats
F32_FPROJ_ONLY = False    # set by --f32-fproj
F32_PACKED_ONLY = False   # set by --f32-packed
F32_SPLIT_ONLY = False    # set by --f32-split
F32_SPLIT_BWD_ONLY = False   # set by --f32-split-bwd


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def main():
    global CONV_GN_ONLY, F32_ONLY, WIDE_ONLY, GN_STATS_ONLY, F32_FPROJ_ONLY
    global F32_PACKED_ONLY, F32_SPLIT_ONLY, F32_SPLIT_BWD_ONLY
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        sys.exit(2)
    args = sys.argv[1:]
    if "--conv-gn" in args:
        args.remove("--conv-gn")
        CONV_GN_ONLY = True
    if "--f32-attn" in args:
        args.remove("--f32-attn")
        F32_ONLY = True
    if "--wide-attn" in args:
        args.remove("--wide-attn")
        WIDE_ONLY = True
    if "--gn-stats" in args:
        args.remove("--gn-stats")
        GN_STATS_ONLY = True
    if "--f32-fproj" in args:
        args.remove("--f32-fproj")
        F32_FPROJ_ONLY = True
    if "--f32-packed" in args:
        args.remove("--f32-packed")
        F32_PACKED_ONLY = True
    if "--f32-split" in args:
        args.remove("--f32-split")
        F32_SPLIT_ONLY = True
    if "--f32-split-bwd" in args:
        args.remove("--f32-split-bwd")
        F32_SPLIT_BWD_ONLY = True
    wrapper = "--wrapper" in args
    if wrapper:
        args.remove("--wrapper")
        if not F32_ONLY:
            raise SystemExit("variants: --wrapper goes with --f32-attn")
    only = ""
    if "--only" in args:   # only the cases whose name holds one of a|b|..
        only = args.pop(args.index("--only") + 1)
        args.remove("--only")
    ptxas = ""
    if "--ptxas" in args:  # ptxas's report on the entries named with it
        ptxas = args.pop(args.index("--ptxas") + 1)
        args.remove("--ptxas")
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"card": card()}), flush=True)
    if wrapper:   # the host paths stand in for libraries
        libs = {"function": "function", "wrapper": "wrapper"}
        rel = lambda a, r: ((a - r).abs().max() / r.abs().max()).item()
        todo, iters = wrapper_cases(rel), 200
    else:
        libs = build(json.loads(args[0]),
                     *((CONV_GN_SOURCES, CONV_GN_ENTRIES) if CONV_GN_ONLY else
                       (F32_SOURCES, F32_ENTRIES) if F32_ONLY else
                       (WIDE_SOURCES, WIDE_ENTRIES) if WIDE_ONLY else
                       (GN_STATS_SOURCES, GN_STATS_ENTRIES) if GN_STATS_ONLY
                       else (F32_FPROJ_SOURCES, F32_FPROJ_ENTRIES)
                       if F32_FPROJ_ONLY else
                       (F32_PACKED_SOURCES, F32_PACKED_ENTRIES)
                       if F32_PACKED_ONLY else
                       (F32_SPLIT_SOURCES, F32_SPLIT_ENTRIES)
                       if F32_SPLIT_ONLY else
                       (F32_SPLIT_BWD_SOURCES, F32_SPLIT_BWD_ENTRIES)
                       if F32_SPLIT_BWD_ONLY else
                       (SOURCES, ENTRIES)), ptxas=ptxas)
        todo, iters = cases(), 20
    names = list(libs)
    for case, (call, err) in todo.items():
        if not any(o in case for o in only.split("|")):
            continue
        res, taking = {}, []
        for name in names:
            code = call(libs[name])
            if code == -1:   # a shape this variant's entry does not take
                res[name] = "not taken"
                continue
            if code != 0:
                raise RuntimeError(f"{name}: launch failed on {case}")
            torch.cuda.synchronize()
            res[name] = {"rel_err": err()}
            taking.append(name)
        times = {name: [] for name in taking}
        for _ in range(3):
            for name in taking + taking[::-1]:
                times[name].append(event_ms(lambda: call(libs[name]),
                                            iters))
        for name in taking:
            res[name]["ms"] = sorted(times[name])[len(times[name]) // 2]
            if CONV_GN_ONLY:
                res[name]["device_ms"] = device_ms(lambda: call(libs[name]))
            if (F32_ONLY or WIDE_ONLY or GN_STATS_ONLY or F32_FPROJ_ONLY
                    or F32_PACKED_ONLY or F32_SPLIT_ONLY
                    or F32_SPLIT_BWD_ONLY):
                # and by kernel (lse, combine, the two launches, ..)
                kernels = device_kernels_ms(lambda: call(libs[name]))
                res[name]["device_ms"] = sum(kernels.values())
                res[name]["device_by_kernel"] = {
                    k: round(ms, 4) for k, ms in kernels.items()}
        print(json.dumps({"case": case, **res}), flush=True)


if __name__ == "__main__":
    main()
