"""``ctypes`` bindings of the native image decoder (``native/imagepipe.cc``).

Counterpart of ``dsml_thesis_tpu/data/native_image.py``: the library fuses
decode (libjpeg / libpng), Pillow's bicubic smallest-side resize (its
two-pass design, the horizontal pass quantized to uint8), the crop and the
[-1, 1] fp32 scaling, resampling only the crop window, with the GIL released
during each call and a thread pool for a batch. Its pixels are within 1-2 /
255 of Pillow's (fp64 filter weights against Pillow's fixed point).

``DSML_NATIVE_IMAGE=1`` (``enabled``) routes ``data/datasets.py``'s
``load_image`` / ``load_images`` here. The library is built from the source
by ``native_lib.py`` with ``-ljpeg -lpng -lpthread`` (as ``native/Makefile``
links it) at the first image; where it cannot be built or loaded, the call
raises with the compiler's output (the JAX package falls back to Pillow for
the whole run instead). A single file the library rejects (a corrupt
stream, CMYK) is not an error here: ``load_image_native`` returns None and
``load_image_batch`` a nonzero status, and the caller decodes that file
with Pillow.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import native_lib
from ..flags import env_flag

LINK = ("-ljpeg", "-lpng", "-lpthread")


def _declare(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ip_load_image.restype = ctypes.c_int
    lib.ip_load_image.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
    ]
    lib.ip_probe_resized.restype = ctypes.c_int
    lib.ip_probe_resized.argtypes = [
        ctypes.c_char_p, ctypes.c_int, i32p, i32p,
    ]
    lib.ip_load_batch.restype = ctypes.c_int
    lib.ip_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        i32p, f32p, ctypes.c_int, i32p,
    ]


def library(build_dir: Optional[str] = None) -> ctypes.CDLL:
    """The decoder library, built at the first call into ``build_dir``
    (default ``native_lib.BUILD_DIR``, read at the call); raises with the
    compiler's output where it cannot be built or loaded."""
    return native_lib.load("imagepipe", _declare, LINK,
                           build_dir or native_lib.BUILD_DIR)


def enabled() -> bool:
    """Whether ``DSML_NATIVE_IMAGE=1`` asks for the native decoder."""
    return env_flag("DSML_NATIVE_IMAGE", False)


def probe_resized(path: str, size: int) -> Optional[Tuple[int, int]]:
    """(w, h) after the smallest-side resize to ``size``, from the file's
    header alone, or None where the library cannot read it. Random crop
    offsets are drawn from it with the same ``rng`` calls as on Pillow's
    path."""
    w, h = ctypes.c_int32(0), ctypes.c_int32(0)
    rc = library().ip_probe_resized(os.fsencode(path), int(size),
                                    ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return int(w.value), int(h.value)


def load_image_native(path: str, size: int,
                      crop_xy: Optional[Tuple[int, int]] = None
                      ) -> Optional[np.ndarray]:
    """Decode, resize, crop and scale: fp32 [size, size, 3] in [-1, 1], or
    None where the library rejects the file. ``crop_xy`` is the crop origin
    in the resized image; None = the center crop."""
    out = np.empty((size, size, 3), dtype=np.float32)
    x0, y0 = crop_xy if crop_xy is not None else (-1, -1)
    rc = library().ip_load_image(
        os.fsencode(path), int(size), int(x0), int(y0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    return out


def load_image_batch(paths: Sequence[str], size: int,
                     crop_xy: Optional[np.ndarray] = None,
                     threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a batch through the library's thread pool: (images
    [N, size, size, 3] fp32, status [N] int32: 0 decoded, negative rejected;
    a rejected row is undefined and must be refilled by the caller)."""
    n = len(paths)
    if n <= 0 or size <= 0:
        # the C entry returns early without writing the status then: an
        # empty buffer would read as decoded
        raise ValueError(f"load_image_batch needs n > 0 and size > 0 "
                         f"(got n={n}, size={size})")
    lib = library()
    out = np.empty((n, size, size, 3), dtype=np.float32)
    status = np.zeros(n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    i32p = ctypes.POINTER(ctypes.c_int32)
    xy = None
    if crop_xy is not None:
        xy = np.ascontiguousarray(crop_xy, dtype=np.int32)
        if xy.shape != (n, 2):
            raise ValueError(f"crop_xy must be [N, 2], got {xy.shape}")
    lib.ip_load_batch(
        arr, n, int(size),
        xy.ctypes.data_as(i32p) if xy is not None else None,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(threads), status.ctypes.data_as(i32p))
    return out, status
