"""The port's native image decoder (``data/native_image.py``, its own build of
``native/imagepipe.cc`` through ``native_lib.py``) and the
``DSML_NATIVE_IMAGE`` dispatch of ``data/datasets.py``, on JPEG and PNG files
the test writes.

* The port's library against the JAX package's ``load_image_native`` /
  ``load_image_batch`` / ``probe_resized`` on the same files: equal bits
  (one source, two builds).
* ``load_image`` / ``load_images`` under the flag against Pillow's path
  within 2 / 255 (the library's fp64 filter weights against Pillow's fixed
  point); random crops from one ``rng`` seed take the same offsets on both
  backends and on the JAX package's, and leave the ``rng`` in one state.
* A file the library rejects (BMP, 16-bit PNG, a bad header) is refilled by
  Pillow, equal to Pillow's own; without Pillow that raises and names the
  file; a library that cannot be built (``CXX=false``) raises with the
  compiler's words; two processes that build at once build once, and
  nothing is written beside the source.
"""
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from dsml_thesis_tpu.data import datasets as JD
from dsml_thesis_tpu.data import native_image as jni
from dsml_thesis_tpu_torch import native_lib
from dsml_thesis_tpu_torch.data import datasets as TD
from dsml_thesis_tpu_torch.data import native_image as tni
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2.0 / 127.5   # two uint8 steps in [-1, 1]


def _smooth(w, h, seed=0):
    """A smooth RGB image (noise halved and brought back up bilinearly):
    raw noise maximises the differences between libjpeg builds."""
    a = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    small = Image.fromarray(a).resize((max(1, w // 2), max(1, h // 2)),
                                      Image.BILINEAR)
    return np.asarray(small.resize((w, h), Image.BILINEAR))


def _save(tmp_path, name, arr, **kw):
    p = str(tmp_path / name)
    Image.fromarray(arr).save(p, **kw)
    return p


@pytest.fixture
def files(tmp_path):
    """JPEG and PNG files of several shapes and modes."""
    out = [_save(tmp_path, "land.jpg", _smooth(300, 200, 1), quality=95),
           _save(tmp_path, "port.jpg", _smooth(129, 257, 2), quality=90),
           _save(tmp_path, "up.jpg", _smooth(64, 48, 3), quality=95),
           _save(tmp_path, "sq.png", _smooth(256, 256, 4)),
           _save(tmp_path, "wide.png", _smooth(500, 123, 5))]
    rs = np.random.RandomState(6)
    out.append(_save(tmp_path, "gray.jpg",
                     (rs.rand(120, 160) * 255).astype(np.uint8), quality=95))
    out.append(_save(tmp_path, "rgba.png",
                     (rs.rand(90, 110, 4) * 255).astype(np.uint8)))
    return out


@pytest.fixture
def native(monkeypatch):
    monkeypatch.setenv("DSML_NATIVE_IMAGE", "1")
    return monkeypatch


def _jax_available():
    if not jni.available():
        pytest.fail("the JAX package's imagepipe library did not build")


@pytest.mark.parametrize("size", [64, 128])
def test_library_equals_the_jax_packages_library(files, size):
    _jax_available()
    for p in files:
        assert tni.probe_resized(p, size) == jni.probe_resized(p, size)
        got, want = tni.load_image_native(p, size), jni.load_image_native(
            p, size)
        assert got.shape == (size, size, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=p)
        w, h = tni.probe_resized(p, size)
        xy = (w - size, h - size)
        np.testing.assert_array_equal(tni.load_image_native(p, size, xy),
                                      jni.load_image_native(p, size, xy))
    xy = np.asarray([tni.probe_resized(p, size) for p in files],
                    np.int32) - size
    got, st = tni.load_image_batch(files, size, crop_xy=xy // 2, threads=3)
    want, jst = jni.load_image_batch(files, size, crop_xy=xy // 2, threads=3)
    assert (st == 0).all() and (jst == 0).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [64, 128])
def test_dispatch_is_pillows_image_within_two_steps(files, native, size):
    for p in files:
        native.setenv("DSML_NATIVE_IMAGE", "0")
        pil = TD.load_image(p, size)
        native.setenv("DSML_NATIVE_IMAGE", "1")
        nat = TD.load_image(p, size)
        assert nat.shape == pil.shape == (size, size, 3)
        assert np.abs(pil - nat).max() <= TOL, p
        # the library's own image: the dispatch went through it
        np.testing.assert_array_equal(nat, tni.load_image_native(p, size))
    stack = TD.load_images(files, size)
    native.setenv("DSML_NATIVE_IMAGE", "0")
    assert np.abs(stack - TD.load_images(files, size)).max() <= TOL
    native.setenv("DSML_NATIVE_IMAGE", "1")
    np.testing.assert_array_equal(stack, np.stack(
        [tni.load_image_native(p, size) for p in files]))


def test_random_crops_take_the_same_offsets_on_every_backend(tmp_path,
                                                             native):
    p = _save(tmp_path, "rc.png", _smooth(420, 260, 5))
    out, states = {}, {}
    for name, flag, mod in (("port-native", "1", TD), ("port-pil", "0", TD),
                            ("jax-native", "1", JD), ("jax-pil", "0", JD)):
        native.setenv("DSML_NATIVE_IMAGE", flag)
        rng = np.random.RandomState(7)
        out[name] = mod.load_image(p, 128, random_crop=True, rng=rng)
        states[name] = rng.randint(0, 1 << 30)
    assert len(set(states.values())) == 1      # the same draws everywhere
    np.testing.assert_array_equal(out["port-native"], out["jax-native"])
    np.testing.assert_array_equal(out["port-pil"], out["jax-pil"])
    assert np.abs(out["port-native"] - out["port-pil"]).max() <= TOL
    # the offsets are random: another seed crops elsewhere
    other = TD.load_image(p, 128, random_crop=True,
                          rng=np.random.RandomState(8))
    assert np.abs(other - out["port-native"]).max() > 0.1


def _bad_header_png(path):
    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", 60000, 60000, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IEND", b""))
    return path


def test_rejected_files_are_refilled_by_pillow(tmp_path, native):
    good = [_save(tmp_path, f"g{i}.jpg", _smooth(160, 120, i), quality=95)
            for i in range(2)]
    bmp = _save(tmp_path, "x.bmp", _smooth(100, 90, 9))
    deep = str(tmp_path / "deep.png")
    Image.fromarray(np.linspace(0, 65535, 80 * 60).reshape(60, 80).astype(
        np.uint16), mode="I;16").save(deep)
    bomb = _bad_header_png(str(tmp_path / "bomb.png"))
    _, status = tni.load_image_batch(good + [bmp, deep, bomb], 32, threads=2)
    assert (status[:2] == 0).all() and (status[2:] < 0).all()
    assert tni.load_image_native(bomb, 32) is None
    native.setenv("DSML_NATIVE_IMAGE", "0")
    pil = {p: TD.load_image(p, 32) for p in good + [bmp, deep]}
    native.setenv("DSML_NATIVE_IMAGE", "1")
    stack = TD.load_images(good + [bmp, deep], 32)
    for i, p in enumerate(good + [bmp, deep]):
        single = TD.load_image(p, 32)
        if p in (bmp, deep):   # Pillow's own decode, both ways
            np.testing.assert_array_equal(stack[i], pil[p])
            np.testing.assert_array_equal(single, pil[p])
        else:
            assert np.abs(stack[i] - pil[p]).max() <= TOL

    def no_pillow():
        raise ImportError("No module named 'PIL'")

    native.setattr(TD, "_pil_image", no_pillow)
    with pytest.raises(RuntimeError, match="x.bmp"):
        TD.load_image(bmp, 32)
    with pytest.raises(RuntimeError, match="deep.png"):
        TD.load_images(good + [deep], 32)
    TD.load_images(good, 32)   # nothing rejected: no Pillow needed


def test_a_library_that_cannot_be_built_raises(tmp_path, native):
    p = _save(tmp_path, "a.png", _smooth(40, 30))
    native.setattr(native_lib, "BUILD_DIR", str(tmp_path / "build"))
    native.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed on .*imagepipe.cc"):
        TD.load_image(p, 16)
    with pytest.raises(RuntimeError, match="imagepipe"):
        TD.load_images([p], 16)
    native.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tni.library()
    native.delenv("CXX")
    native.setenv("DSML_NATIVE_IMAGE", "0")   # the flag unset: Pillow
    assert TD.load_image(p, 16).shape == (16, 16, 3)
    assert not os.path.exists(tmp_path / "build" / os.path.basename(
        native_lib.library_path("imagepipe", tni.LINK)))


def test_two_processes_build_the_library_at_once(tmp_path):
    before = sorted(os.listdir(os.path.join(ROOT, "native")))
    build_dir = str(tmp_path / "build")
    p = _save(tmp_path, "a.jpg", _smooth(48, 40), quality=95)
    code = ("import sys\n"
            "from dsml_thesis_tpu_torch.data import native_image as n\n"
            "lib = n.library(sys.argv[1])\n"
            "print(n.native_lib.load('imagepipe', n._declare, n.LINK, "
            "sys.argv[1]) is lib)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, build_dir],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        assert out.split() == ["True"]
    name = os.path.basename(native_lib.library_path("imagepipe", tni.LINK))
    assert sorted(os.listdir(build_dir)) == sorted([name, "imagepipe.lock"])
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == before
    # the library built there decodes as the default build does
    np.testing.assert_array_equal(
        _decode_with(build_dir, p), tni.load_image_native(p, 32))


def _decode_with(build_dir, path, size=32):
    import ctypes

    lib = tni.library(build_dir)
    out = np.empty((size, size, 3), np.float32)
    assert lib.ip_load_image(os.fsencode(path), size, -1, -1,
                             out.ctypes.data_as(
                                 ctypes.POINTER(ctypes.c_float))) == 0
    return out
