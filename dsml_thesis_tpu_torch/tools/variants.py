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
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import attention as A

ROOT = os.path.realpath(os.path.dirname(_build.PKG_DIR))
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
           "flash_attention_fproj.cu", "flash_attention_packed.cu",
           "flash_attention_bwd_packed.cu", "flash_attention_qout.cu",
           "flash_attention_streaming.cu", "flash_attention_streaming_bwd.cu")
ENTRIES = ("dsml_flash_attention", "dsml_flash_attention_bwd",
           "dsml_flash_attention_fproj", "dsml_flash_attention_packed",
           "dsml_flash_attention_bwd_packed", "dsml_flash_attention_qout",
           "dsml_flash_attention_streaming",
           "dsml_flash_attention_streaming_bwd")


def build(variants: dict) -> dict:
    """name -> loaded library of every variant not named ``c_*``."""
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
        for src in SOURCES:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-c",
                   os.path.join(d, src), "-o", os.path.join(d, src + ".o")]
            procs.append((name, src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name, src, proc in procs:
        out, _ = proc.communicate()
        loss = [ln.strip() for ln in out.splitlines() if "Performance Loss" in ln]
        print(json.dumps({"variant": name, "source": src,
                          "rc": proc.returncode, "performance_loss": loss}),
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
                        *(os.path.join(d, s + ".o") for s in SOURCES)],
                       check=True)
        lib = ctypes.CDLL(lib_path)
        for fn in ENTRIES:
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
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


def main():
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        sys.exit(2)
    libs = build(json.loads(sys.argv[1]))
    names = list(libs)
    for case, (call, err) in cases().items():
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
                times[name].append(event_ms(lambda: call(libs[name])))
        for name in taking:
            res[name]["ms"] = sorted(times[name])[len(times[name]) // 2]
        print(json.dumps({"case": case, **res}), flush=True)


if __name__ == "__main__":
    main()
