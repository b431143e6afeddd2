"""The identity towers of the port (``models/arcface.py``: iResNet;
``models/insight_face.py``: MobileFaceNet, the face ViT) and
``scripts/csim_torch.py`` against the JAX package, on the CPU in fp32.

Each tower gets one random state_dict in the reference layout (the port's
modules carry the reference's names, so their own ``state_dict`` keys are
that layout; values from a seed: He-normal convolutions, BatchNorm
statistics and scales around 1, PReLU slopes 0.1-0.3); the port loads it with
``load_state_dict`` (through ``convert_*``, which fills what a checkpoint
may lack), the JAX package through its ``convert_*``, and both embed the
same numpy images: embeddings within 1e-4 of their maximum. Each port
converter reads exactly the keys the JAX converter reads.

* ``iresnet18`` at batch 2, 112 px; an iResNet of one block a stage;
* MobileFaceNet as ``mbf`` (blocks (1, 4, 6, 2)) and with a residual stem
  (blocks (2, 1, 1, 1)); the face ViT at depth 2 (width 64, 8 heads), with
  and without qkv biases;
* ``csim_torch.py --cpu`` against ``scripts/csim.py``'s ``build_tower`` on
  two directories of PNGs, for ``iresnet18``, ``mbf`` and ``vit_t``: the
  pairs' cosines within 1e-4, the printed mean equal.
"""
import importlib.util
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from PIL import Image

from dsml_thesis_tpu.data import load_image as jax_load_image
from dsml_thesis_tpu.metrics import cosine_similarity as jax_cosine
from dsml_thesis_tpu.models import arcface as jarc
from dsml_thesis_tpu.models import insight_face as jinf
from dsml_thesis_tpu_torch.models import arcface as tarc
from dsml_thesis_tpu_torch.models import insight_face as tinf
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def random_reference_sd(model: nn.Module, seed: int):
    """A random state_dict of ``model`` (whose names are the reference's)."""
    g = torch.Generator().manual_seed(seed)
    n = lambda t, std: torch.randn(t.shape, generator=g) * std
    u = lambda t, lo, hi: lo + (hi - lo) * torch.rand(t.shape, generator=g)
    sd = {}
    for prefix, m in model.named_modules():
        p = f"{prefix}." if prefix else ""
        own = dict(m.named_parameters(recurse=False))
        own.update(m.named_buffers(recurse=False))
        for k, t in own.items():
            if k == "num_batches_tracked":
                v = torch.tensor(7)
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                v = {"weight": lambda: u(t, 0.8, 1.2),
                     "bias": lambda: n(t, 0.1),
                     "running_mean": lambda: n(t, 0.1),
                     "running_var": lambda: u(t, 0.5, 1.5)}[k]()
            elif isinstance(m, nn.PReLU):
                v = u(t, 0.1, 0.3)
            elif isinstance(m, nn.LayerNorm):
                v = u(t, 0.8, 1.2) if k == "weight" else n(t, 0.1)
            elif isinstance(m, (nn.Conv2d, nn.Linear)) and k == "weight":
                fan_in = t[0].numel()
                v = n(t, (2.0 / fan_in) ** 0.5)
            elif k == "bias":
                v = n(t, 0.1)
            else:   # the ViT's position embedding and mask token
                v = n(t, 0.02)
            sd[p + k] = v
    assert set(sd) == set(model.state_dict())
    return sd


class _Reads(dict):
    """A state_dict that records the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def _images(seed, b=2, size=112):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


def _compare(tmodel, jmodel, variables, x):
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    assert got.shape == want.shape
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("layers", [(2, 2, 2, 2), (1, 1, 1, 1)],
                         ids=["iresnet18", "one-block-stages"])
def test_iresnet_matches_jax(layers):
    model = tarc.IResNet(layers)
    sd = _Reads(random_reference_sd(model, seed=sum(layers)))
    model.load_state_dict(sd)                       # the reference layout
    loaded = tarc.IResNet(layers)
    loaded.load_state_dict(tarc.convert_iresnet(
        {k: v for k, v in sd.items() if "num_batches" not in k}, layers))
    for a, b in zip(model.state_dict().values(),
                    loaded.state_dict().values()):
        assert torch.equal(a, b.to(a.dtype)) or a.dtype == torch.long
    sd.read.clear()
    params, stats = jarc.convert_iresnet(sd, layers)
    assert sd.read == set(tarc.iresnet_keys(layers))
    x = _images(1)
    _compare(loaded, jarc.IResNet(layers=layers),
             {"params": params, "batch_stats": stats}, x)


@pytest.mark.parametrize("blocks", [(1, 4, 6, 2), (2, 1, 1, 1)],
                         ids=["mbf", "residual-stem"])
def test_mobilefacenet_matches_jax(blocks):
    model = tinf.MobileFaceNet(blocks=blocks, scale=2)
    sd = _Reads(random_reference_sd(model, seed=3))
    model.load_state_dict(tinf.convert_mobilefacenet(sd, blocks))
    assert sd.read == set(tinf.mobilefacenet_keys(blocks))
    sd.read.clear()
    params, stats = jinf.convert_mobilefacenet(sd, blocks=blocks)
    assert sd.read == set(tinf.mobilefacenet_keys(blocks))
    _compare(model, jinf.MobileFaceNet(blocks=blocks, scale=2),
             {"params": params, "batch_stats": stats}, _images(2))


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["no-bias", "bias"])
def test_face_vit_matches_jax(qkv_bias):
    kw = dict(embed_dim=64, depth=2, num_heads=8, num_classes=32,
              qkv_bias=qkv_bias)
    model = tinf.FaceViT(**kw)
    sd = _Reads(random_reference_sd(model, seed=4))
    model.load_state_dict(sd)
    sd.read.clear()
    params, stats = jinf.convert_face_vit(sd, depth=2)
    assert sd.read == set(tinf.face_vit_keys(2, qkv_bias))
    loaded = tinf.FaceViT(**kw)
    loaded.load_state_dict(tinf.convert_face_vit(
        {k: v for k, v in sd.items() if k != "mask_token"}, depth=2))
    _compare(loaded, jinf.FaceViT(**kw),
             {"params": params, "batch_stats": stats}, _images(3))
    assert tinf.FACE_VIT_FACTORIES == jinf.FACE_VIT_FACTORIES


def test_embed_fn_is_frozen_and_in_eval_mode():
    model = tarc.IResNet((1, 1, 1, 1))
    model.load_state_dict(random_reference_sd(model, seed=5))
    fn = tinf.make_embed_fn(model.train())
    x = torch.from_numpy(_images(6))
    y = fn(x)
    assert not model.training and not y.requires_grad
    assert not any(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        assert torch.equal(y, model(x))


NETWORKS = {"iresnet18": lambda: tarc.iresnet("iresnet18"),
            "mbf": lambda: tinf.MobileFaceNet(),
            "vit_t": lambda: tinf.FaceViT(**tinf.FACE_VIT_FACTORIES["vit_t"])}


@pytest.mark.parametrize("network", sorted(NETWORKS))
def test_csim_script_matches_the_jax_script(tmp_path, network):
    weights = str(tmp_path / f"{network}.pth")
    torch.save(random_reference_sd(NETWORKS[network](), seed=11), weights)
    rng = np.random.default_rng(12)
    for d, n in (("a", 3), ("b", 4)):    # b has one more: the first 3 pair
        os.makedirs(tmp_path / d)
        for i in range(n):
            img = (rng.uniform(0, 255, (120, 136, 3))).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / d / f"{i:02d}.png")
    argv = ["--dir-a", str(tmp_path / "a"), "--dir-b", str(tmp_path / "b"),
            "--weights", weights, "--network", network, "--cpu",
            "--batch", "2"]
    out = io.StringIO()
    with redirect_stdout(out):
        sims = _script("csim_torch").main(argv)

    jcsim = _script("csim")
    embed = jcsim.build_tower(weights, network)
    load = lambda d, i: jax_load_image(str(tmp_path / d / f"{i:02d}.png"),
                                       112)
    a = jnp.asarray(np.stack([load("a", i) for i in range(3)]))
    b = jnp.asarray(np.stack([load("b", i) for i in range(3)]))
    want = np.asarray(jax_cosine(embed(a), embed(b)))
    assert len(sims) == 3
    np.testing.assert_allclose(sims, want, rtol=0, atol=1e-4)
    lines = out.getvalue().splitlines()
    assert lines[0] == "note: pairing first 3 of 3/4 images"
    assert lines[1].startswith(f"CSIM over 3 pairs: {np.mean(want):.4f} ± ")
