"""What the port may and may not depend on: no JAX, no Flax, nothing of the
JAX package; no library attention or GroupNorm; every CUDA source built; a
routing rule that is the JAX package's; and a smoke script that refuses to
run without a card."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dsml_thesis_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one thread for a module of the port's tests (every
    ``test_torch_port_*`` module imports this fixture): their tensors are
    tiny, and the suite runs several workers on the machine's cores at once,
    so intra-op threads only add contention. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
FORBIDDEN = ("jax", "flax", "optax", "orbax", "dsml_thesis_tpu")


def _package_modules():
    names = ["dsml_thesis_tpu_torch"]
    for m in pkgutil.walk_packages([PKG], prefix="dsml_thesis_tpu_torch."):
        names.append(m.name)
    return names


def _python_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    out += [os.path.join(ROOT, "scripts", f"{name}_torch.py")
            for name in ("serve", "train", "sample_affectnet",
                         "compute_latents", "latent_manipulation",
                         "mead_audio_features", "progressive_sampling",
                         "sample_mead_frame", "streaming_pipeline",
                         "image_metrics", "fid_metrics")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)  # one order for every test worker


def test_package_has_the_expected_modules():
    names = set(_package_modules())
    for want in ("flags", "config", "convert", "utils_io", "server",
                 "ops.attention", "ops.groupnorm", "ops.conv_gn", "ops._build",
                 "diffusion.schedules", "diffusion.ddim", "diffusion.video",
                 "models.unet", "models.quantize", "models.autoencoder",
                 "models.encoders", "models.ldm", "diffusion.gaussian",
                 "data.datasets", "training.ema", "training.lr_scheduler",
                 "training.train_state", "training.checkpointing",
                 "training.loggers", "training.trainer", "tools.measure",
                 "losses.discriminator", "losses.lpips", "losses.vqperceptual",
                 "losses.contperceptual", "training.vqgan", "training.kl_ae",
                 "training.vqgan_trainer", "cli", "diffusion.dpm_solver",
                 "diffusion.plms", "diffusion.tiling", "reenactment",
                 "data.clip_tokenizer", "losses.guidance", "models.clip",
                 "models.insight_face", "models.diffclip",
                 "training.finetune_trainer", "models.wav2vec2",
                 "models.lipreader", "models.lipread_tune",
                 "metrics.image", "metrics.native", "metrics.lipread",
                 "metrics.inception", "metrics.fid"):
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
    pat = re.compile(r"^\s*(?:from|import)\s+"
                     r"(jax|flax|optax|orbax|dsml_thesis_tpu)(?:[.\s]|$)", re.M)
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


def test_no_library_group_norm_in_the_package():
    """GroupNorm is the port's own plain ops or its own kernels: PyTorch's
    fused operator and module stay out (the smoke script times the operator
    as a yardstick and uses it nowhere else)."""
    for path in _python_sources():
        if os.path.basename(path) == "chip_smoke.py":
            continue
        src = open(path).read()
        assert not re.search(r"\bgroup_norm\(", src), path
        assert "nn.GroupNorm" not in src and "var_mean" not in src, path


def test_every_cuda_source_is_built():
    from dsml_thesis_tpu_torch.ops import _build

    on_disk = set(os.listdir(_build.CSRC_DIR))
    assert on_disk == set(_build.SOURCES) | set(_build.HEADERS)
    assert {"flash_attention_packed.cu", "flash_attention_qout.cu",
            "flash_attention_bwd.cu", "flash_attention_bwd_packed.cu",
            "flash_attention_streaming.cu", "flash_attention_streaming_bwd.cu",
            "group_norm.cu", "conv_stats.cu"} <= set(_build.SOURCES)
    assert all(s.endswith(".cu") for s in _build.SOURCES)
    for name in _build.SOURCES:
        src = open(os.path.join(_build.CSRC_DIR, name)).read()
        assert 'extern "C"' in src and "cudaGetLastError" in src
        assert "torch/extension.h" not in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


_C_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(dsml_\w+)\s*\(([^)]*)\)')


def _c_kind(param: str):
    """The ctypes type a C parameter declaration must be bound as."""
    import ctypes

    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    kind = decl.rsplit(" ", 1)[0].replace("const ", "")
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


def test_c_entry_points_match_their_signatures():
    """Every ``extern "C" int dsml_*(...)`` under csrc/ is bound with the
    argument count and kinds it declares (a pointer as c_void_p, int as
    c_int, float as c_float), and nothing else is bound: a mismatch cuts a
    pointer or shifts an argument, and shows only on the card."""
    import ctypes

    from dsml_thesis_tpu_torch.ops import _build

    declared = {}
    for name in _build.SOURCES:
        src = open(os.path.join(_build.CSRC_DIR, name)).read()
        for fn, params in _C_ENTRY.findall(src):
            assert fn not in declared, f"{fn} declared twice"
            declared[fn] = [_c_kind(p) for p in params.split(",")]
    assert declared.keys() == _build.SIGNATURES.keys()
    for fn, kinds in declared.items():
        assert _build.SIGNATURES[fn] == kinds, fn
    assert all(k in (ctypes.c_void_p, ctypes.c_int, ctypes.c_float)
               for kinds in declared.values() for k in kinds)


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
    """The wrappers branch on the tensor's device alone: each of the eleven
    plain versions is called once behind ``device.type == "cpu"`` (at most
    one statement between the test and the call), and nothing catches a
    failed launch. (``conv_stats_reference`` shares its branch with the JAX
    package's own routing rule for convs of fewer than 32 output channels,
    and is what the conv op's backward differentiates, as that package's
    does. ``group_norm_silu_reference`` is also what
    ``DSML_PALLAS_GN=0`` selects by name, as in the JAX package, and what the
    kernel modes' backward differentiates, as that package's does: neither is
    a fallback. Likewise ``fproj_reference`` / ``qout_reference`` inside
    ``_KernelForward.backward``.)"""
    plain = {
        "attention.py": ("attention_reference", "fproj_reference",
                         "packed_reference", "qout_reference",
                         "flash_attention_bwd_reference",
                         "packed_bwd_reference",
                         "streaming_attention_reference",
                         "streaming_bwd_reference"),
        "groupnorm.py": ("group_norm_silu_reference",
                         "gn_channel_stats_reference"),
        "conv_gn.py": ("conv_stats_reference",),
    }
    for name, versions in plain.items():
        src = open(os.path.join(PKG, "ops", name)).read()
        assert src.count('device.type == "cpu"') == len(versions)
        for fn in versions:
            guarded = re.findall(
                r'device\.type == "cpu"(?: or cout < CONV_MIN_COUT)?:\n'
                r"(?:\s+\S.*\n)?\s+(?:return|out =) (?:\(\*)?" + fn + r"\(",
                src)
            assert len(guarded) == 1, fn
        assert "except" not in src
        assert "is_available" not in src


class _OnCard(torch.Tensor):
    """A tensor that says it lies on a CUDA device (this machine has none):
    what a wrapper sees of a tensor on the card before it launches."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("op", ["streaming", "streaming-bwd", "conv-stats",
                                "conv-stats-norm"])
def test_new_wrappers_raise_for_a_cuda_tensor_without_a_library(monkeypatch,
                                                                op):
    """For a CUDA tensor a wrapper launches or raises: with no kernel library
    to load, the error of the build comes out, and no plain version runs."""
    from dsml_thesis_tpu_torch.ops import _build
    from dsml_thesis_tpu_torch.ops import attention as A
    from dsml_thesis_tpu_torch.ops import conv_gn as C

    def no_library():
        raise RuntimeError("no kernel library on this machine")

    def plain(*args, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(_build, "load", no_library)
    for mod, name in ((A, "streaming_attention_reference"),
                      (A, "streaming_bwd_reference"),
                      (A, "attention_reference"),
                      (C, "conv_stats_reference")):
        monkeypatch.setattr(mod, name, plain)
    card = lambda *shape, dtype=torch.bfloat16: torch.zeros(
        *shape, dtype=dtype).as_subclass(_OnCard)
    q = card(1, 2, 16, 32)
    x, w, bias = card(1, 4, 4, 32), card(3, 3, 32, 32), card(
        1, 32, dtype=torch.float32)
    stats = (card(1, 32, dtype=torch.float32),) * 2
    call = {
        "streaming": lambda: A.flash_attention_streaming(q, q, q),
        "streaming-bwd": lambda: A.flash_attention_streaming_bwd(q, q, q, q, q),
        "conv-stats": lambda: C.conv_stats(x, w, bias, skip=x),
        "conv-stats-norm": lambda: C.conv_stats(
            x, w, bias, in_stats=stats, gamma=stats[0][0], beta=stats[0][0]),
    }[op]
    with pytest.raises(RuntimeError, match="no kernel library"):
        call()
    assert not any(A.LAUNCHES.values())


def test_kernel_flags_are_the_flags_the_code_reads():
    """``KERNEL_FLAGS`` (what a measurement records and the smoke script
    resets) against the DSML_* names the package's code passes to
    ``env_flag`` / ``env_mode``: every flag that chooses between kernels is
    listed, and nothing is listed that no code reads."""
    from dsml_thesis_tpu_torch.flags import KERNEL_FLAGS

    read = set()
    for path in _python_sources():
        read |= set(re.findall(r'env_(?:flag|mode)\(\s*"(DSML_\w+)"',
                               open(path).read()))
    # a formula, a batch, an image decoder the data path refuses
    not_kernels = {"DSML_GELU_EXACT", "DSML_CFG_DEDUP", "DSML_NATIVE_IMAGE"}
    assert set(KERNEL_FLAGS) == read - not_kernels
    assert {"DSML_FLASH_STREAMING", "DSML_GN_EPILOGUE"} <= set(KERNEL_FLAGS)
    doc = open(os.path.join(PKG, "flags.py")).read()
    for name in read:
        assert name in doc
    # every DSML_* name the JAX package's code mentions is read here or named
    # in flags.py with its reason
    jax_names = set()
    for base, _, files in os.walk(os.path.join(ROOT, "dsml_thesis_tpu")):
        for f in files:
            if f.endswith(".py"):
                jax_names |= set(re.findall(r"DSML_[A-Z0-9_]+",
                                            open(os.path.join(base, f)).read()))
    assert len(jax_names) >= 32
    assert not [n for n in sorted(jax_names) if n not in read and n not in doc]


@pytest.mark.parametrize("name", ["DSML_FLASH_ATTN", "DSML_XATTN_1TOK"])
def test_flags_of_routes_the_port_lacks_raise(name, monkeypatch):
    """A flag whose non-default value selects a route the port does not have
    raises where the JAX package reads it; its default spelled out does
    not."""
    from dsml_thesis_tpu_torch.flags import REFUSED_FLAGS
    from dsml_thesis_tpu_torch.models.unet import CrossAttention
    from dsml_thesis_tpu_torch.ops import attention as A

    assert REFUSED_FLAGS[name] is True
    x = torch.randn(1, 8, 16)
    q = torch.randn(1, 1, 8, 32)
    if name == "DSML_FLASH_ATTN":
        calls = [lambda: A.multi_head_attention(q, q, q),
                 lambda: A.packed_multi_head_attention(x, x, x, 2)]
    else:
        attn = CrossAttention(16, context_dim=4, heads=2, dim_head=8)
        calls = [lambda: attn(x, torch.randn(1, 1, 4))]
    monkeypatch.setenv(name, "1")
    for call in calls:
        call()
    monkeypatch.setenv(name, "0")
    for call in calls:
        with pytest.raises(ValueError, match="route"):
            call()


def _self_attention_shapes(path):
    """(tokens, channels, H*D) of every self-attention of a model YAML's
    UNet at its own latent size."""
    import yaml

    p = yaml.safe_load(open(path))["model"]["params"]
    u = p["unet_config"]["params"]
    size = u.get("image_size", p["image_size"])
    out = set()
    for level, mult in enumerate(u["channel_mult"]):
        ds = 2 ** level
        if ds in u["attention_resolutions"]:
            c = u["model_channels"] * mult
            out.add(((size // ds) ** 2, c, c))
    last = len(u["channel_mult"]) - 1
    c = u["model_channels"] * u["channel_mult"][last]
    out.add(((size // 2 ** last) ** 2, c, c))   # the middle block
    return sorted(out)


def test_routing_rule_is_the_jax_packages_on_the_shipped_configs():
    """``fproj_one_q_block`` decides by the token count alone; on every
    self-attention shape of the eight shipped model configs it is the JAX
    package's ``fproj_eligible`` (one q-block fits its fast memory)."""
    import glob

    from dsml_thesis_tpu.ops.attention import fproj_eligible
    from dsml_thesis_tpu_torch.ops.attention import (FPROJ_MAX_TOKENS,
                                                     fproj_one_q_block)

    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "latent-diffusion",
                                          "*.yaml")))
    assert len(paths) == 8
    seen = set()
    for path in paths:
        for n, c, hd in _self_attention_shapes(path):
            seen.add(n)
            assert fproj_one_q_block(n) == fproj_eligible(n, c, hd), (path, n)
    assert FPROJ_MAX_TOKENS == 1024
    assert {256, 1024, 4096} <= seen
    assert fproj_one_q_block(1024) and not fproj_one_q_block(4096)
