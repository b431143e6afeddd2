"""What the port may and may not depend on: no JAX, no Flax, nothing of the
JAX package; no library attention; every CUDA source built; and a smoke
script that refuses to run without a card."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dsml_thesis_tpu_torch")
FORBIDDEN = ("jax", "flax", "dsml_thesis_tpu")


def _package_modules():
    names = ["dsml_thesis_tpu_torch"]
    for m in pkgutil.walk_packages([PKG], prefix="dsml_thesis_tpu_torch."):
        names.append(m.name)
    return names


def _python_sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "scripts", "serve_torch.py")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)  # one order for every test worker


def test_package_has_the_expected_modules():
    names = set(_package_modules())
    for want in ("flags", "config", "convert", "utils_io", "server",
                 "ops.attention", "ops.groupnorm", "ops._build",
                 "diffusion.schedules", "diffusion.ddim", "diffusion.video",
                 "models.unet", "models.quantize", "models.autoencoder",
                 "models.encoders", "models.ldm"):
        assert f"dsml_thesis_tpu_torch.{want}" in names


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for n in {_package_modules()!r}:\n"
        "    importlib.import_module(n)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", _python_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_of_jax(path):
    src = open(path).read()
    pat = re.compile(r"^\s*(?:from|import)\s+(jax|flax|dsml_thesis_tpu)(?:[.\s]|$)",
                     re.M)
    assert not pat.search(src), pat.search(src).group(0)


def test_no_library_attention_in_the_package():
    """The port launches its own kernels: the library's fused attention and
    the compiler stay out of the package (the smoke script times the library
    call as a yardstick and uses it nowhere else)."""
    for path in _python_sources():
        if os.path.basename(path) == "chip_smoke.py":
            continue
        src = open(path).read()
        assert "scaled_dot_product_attention" not in src, path
        assert "torch.compile" not in src, path


def test_every_cuda_source_is_built():
    from dsml_thesis_tpu_torch.ops import _build

    on_disk = set(os.listdir(_build.CSRC_DIR))
    assert on_disk == set(_build.SOURCES) | set(_build.HEADERS)
    assert all(s.endswith(".cu") for s in _build.SOURCES)
    for name in _build.SOURCES:
        src = open(os.path.join(_build.CSRC_DIR, name)).read()
        assert 'extern "C"' in src and "cudaGetLastError" in src
        assert "torch/extension.h" not in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_directory_is_ignored_by_git():
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert "dsml_thesis_tpu_torch/_build/" in ignored


def test_smoke_script_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""  # no result line of any kind
    assert "no CUDA device" in r.stderr


def test_cuda_tensor_never_reaches_a_plain_version():
    """The wrappers branch on the tensor's device alone: the plain version
    is behind ``device.type == "cpu"`` and nothing catches a failed launch."""
    src = open(os.path.join(PKG, "ops", "attention.py")).read()
    assert src.count('device.type == "cpu"') == 2
    assert "except" not in src
    assert "is_available" not in src
