"""First-stage training pieces of the port against the JAX package's, on
the CPU: the fp32 head-width-512 attention ops, the quantizer's loss and
straight-through gradient, the KL posterior, LPIPS, the discriminator, the
GAN losses, the adaptive weight and both first-stage objectives.

Inputs are made with numpy from seeds; weights cross by
``convert.from_jax_tree``. The JAX attention kernels run in Pallas interpret
mode (``interpret=True``), the rest of the JAX code as it runs on the CPU.
Tolerances are stated per assert: fp32 sums taken in another order by the two
frameworks agree to some 1e-6 relative; the head-width-512 backward sums 512
products of unit-variance values (2e-4 absolute).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.losses import contperceptual as jcont
from dsml_thesis_tpu.losses import discriminator as jdisc
from dsml_thesis_tpu.losses import lpips as jlpips
from dsml_thesis_tpu.losses import vqperceptual as jvq
from dsml_thesis_tpu.models import autoencoder as jae
from dsml_thesis_tpu.models import quantize as jquant
from dsml_thesis_tpu.ops import attention as jatt
from dsml_thesis_tpu_torch.convert import from_jax_tree, to_jax_tree
from dsml_thesis_tpu_torch.losses import (LPIPS, KLAutoencoderLoss,
                                          NLayerDiscriminator, VQGANLoss,
                                          adaptive_d_weight, adopt_weight,
                                          hinge_d_loss, load_lpips_weights,
                                          lpips_weight_files, vanilla_d_loss)
from dsml_thesis_tpu_torch.models.autoencoder import DiagonalGaussian
from dsml_thesis_tpu_torch.models.quantize import VectorQuantizer
from dsml_thesis_tpu_torch.ops import attention as tatt

T = torch.from_numpy


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, atol, rtol=0.0):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _images(seed, b=2, size=16):
    return _rng(seed).uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


# ------------------------------------------------------------------ ops

# [B, H, Nq, Nk] at the first stage's head width (one head as wide as the
# 512 channels); the ragged case leaves a partial tile on both sides
ATTN_SHAPES = [(1, 1, 64, 64), (1, 1, 50, 37)]


def _qkvo(seed, b, h, nq, nk, d=512):
    r = _rng(seed)
    return [r.standard_normal((b, h, n, d)).astype(np.float32)
            for n in (nq, nk, nk, nq)]


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=["square", "ragged"])
def test_fp32_d512_forward_matches_jax_kernels(shape):
    """Rows 2 and 4 in fp32 at D = 512: the port's plain versions (what the
    TF32 kernels are held to on the card) against the Pallas kernels in
    interpret mode. 1e-5 absolute on outputs within [-4, 4]."""
    q, k, v, _ = _qkvo(0, *shape)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(tatt.flash_attention(T(q), T(k), T(v)),
           jatt.flash_attention(jq, jk, jv, block_q=32, interpret=True), 1e-5)
    _close(tatt.flash_attention_streaming(T(q), T(k), T(v)),
           jatt.flash_attention_streaming(jq, jk, jv, block_q=32, block_k=64,
                                          interpret=True), 1e-5)


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=["square", "ragged"])
def test_fp32_d512_backward_matches_jax_kernel(shape):
    """Row 7 at D = 512 in fp32: ``flash_attention_bwd_reference`` and the
    ``Function``'s backward against ``flash_attention_bwd`` in interpret
    mode (2e-4 absolute); the Function's backward is the plain formula (the
    same bits)."""
    q, k, v, do = _qkvo(1, *shape)
    want = jatt.flash_attention_bwd(*map(jnp.asarray, (q, k, v, do)),
                                    block_q=32, interpret=True)
    plain = tatt.flash_attention_bwd_reference(T(q), T(k), T(v), T(do))
    leaves = [T(a).requires_grad_() for a in (q, k, v)]
    through = torch.autograd.grad(tatt.flash_attention(*leaves), leaves, T(do))
    for w, p, t in zip(want, plain, through):
        _close(p, w, 2e-4)
        assert torch.equal(p, t)


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=["square", "ragged"])
def test_fp32_d512_streaming_backward_matches_jax_kernel(shape):
    """Row 5 at D = 512 in fp32: the port's plain streaming backward
    against ``flash_attention_streaming_bwd`` in interpret mode, both on the
    JAX streaming forward's output (2e-4 absolute), and the port's streaming
    ``Function`` differentiated by autograd (the same bits as the plain
    backward on its own forward's output)."""
    q, k, v, do = _qkvo(2, *shape)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o = jatt.flash_attention_streaming(jq, jk, jv, block_q=32, block_k=64,
                                       interpret=True)
    want = jatt.flash_attention_streaming_bwd(jq, jk, jv, o, jdo, block_q=32,
                                              block_k=64, interpret=True)
    got = tatt.flash_attention_streaming_bwd(T(q), T(k), T(v),
                                             T(np.array(o)), T(do))
    for g, w in zip(got, want):
        _close(g, w, 2e-4)
    leaves = [T(a).requires_grad_() for a in (q, k, v)]
    out = tatt.flash_attention_streaming(*leaves)
    through = torch.autograd.grad(out, leaves, T(do))
    again = tatt.streaming_bwd_reference(T(q), T(k), T(v), out.detach(),
                                         T(do))
    for t, a in zip(through, again):
        assert torch.equal(t, a)


class _OnCard(torch.Tensor):
    """A tensor that says it lies on a CUDA device (this machine has none):
    what a wrapper sees of a tensor on the card before it launches."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("op", ["forward", "backward", "streaming",
                                "streaming-backward"])
def test_fp32_wrappers_route_d512_and_refuse_other_widths(op, monkeypatch):
    """fp32 at D = 512 goes to the ``_f32`` entry point of each kernel (the
    fp32 instantiations exist at the first stage's head width alone); on a
    CUDA tensor of another fp32 head width the wrapper raises before the
    library is built."""
    from dsml_thesis_tpu_torch.ops import _build

    name, dims = {"forward": ("dsml_flash_attention", tatt.FLASH_HEAD_DIMS),
                  "backward": ("dsml_flash_attention_bwd", tatt.BWD_HEAD_DIMS),
                  "streaming": ("dsml_flash_attention_streaming",
                                tatt.STREAMING_HEAD_DIMS),
                  "streaming-backward": ("dsml_flash_attention_streaming_bwd",
                                         tatt.STREAMING_BWD_HEAD_DIMS)}[op]
    assert tatt.F32_HEAD_DIMS == (512,)
    t = lambda d, dtype: torch.zeros(1, 1, 8, d, dtype=dtype)
    assert tatt._entry(name, t(512, torch.float32), dims, op) == name + "_f32"
    assert tatt._entry(name, t(64, torch.bfloat16), dims, op) == name

    def no_build():
        raise AssertionError("the library was built for a refused shape")

    monkeypatch.setattr(_build, "load", no_build)
    q = torch.zeros(1, 1, 8, 64).as_subclass(_OnCard)
    lse = torch.zeros(8).as_subclass(_OnCard)
    call = {
        "forward": lambda: tatt._launch_flash_forward(q, q, q, 0.1, True),
        "backward": lambda: tatt.flash_attention_bwd(q, q, q, q, lse, q, 0.1),
        "streaming": lambda: tatt._launch_streaming_forward(q, q, q, 0.1),
        "streaming-backward": lambda: tatt.flash_attention_streaming_bwd(
            q, q, q, q, q, 0.1),
    }[op]
    with pytest.raises(ValueError, match="head width 64"):
        call()
    assert not any(tatt.LAUNCHES.values())


# ------------------------------------------------------------------ quantizer

def test_quantizer_loss_and_straight_through_gradient_match_jax():
    """Loss (legacy and not), codes, values and the gradients of a loss of
    z_q + commitment with respect to z and the codebook, against jax.grad;
    1e-6 absolute."""
    r = _rng(3)
    z = r.standard_normal((2, 4, 4, 3)).astype(np.float32)
    gz = r.standard_normal((2, 4, 4, 3)).astype(np.float32)
    for legacy in (True, False):
        jq = jquant.VectorQuantizer(16, 3, beta=0.25, legacy=legacy)
        params = jq.init(jax.random.PRNGKey(0), jnp.asarray(z))["params"]
        tq = VectorQuantizer(16, 3, beta=0.25, legacy=legacy)
        tq.load_state_dict(from_jax_tree(params))

        def jfn(p, zz):
            zq, loss, _ = jq.apply({"params": p}, zz)
            return jnp.sum(zq * gz) + loss

        (jgp, jgz) = jax.grad(jfn, argnums=(0, 1))(params, jnp.asarray(z))
        zt = T(z).requires_grad_()
        zq, loss, idx = tq(zt)
        zq_j, loss_j, idx_j = jq.apply({"params": params}, jnp.asarray(z))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        _close(zq, zq_j, 1e-6)
        _close(loss, loss_j, 1e-6)
        (torch.sum(zq * T(gz)) + loss).backward()
        _close(zt.grad, jgz, 1e-6)
        _close(tq.embedding.weight.grad, jgp["embedding"], 1e-6)


# ------------------------------------------------------------------ posterior

def test_diagonal_gaussian_sample_mode_kl_match_jax():
    """Sample with the JAX draw injected as noise, mode, KL and the log
    variance clamp (the input reaches past -30 and 20); 1e-5 relative."""
    r = _rng(4)
    params = r.standard_normal((2, 4, 4, 6)).astype(np.float32) * 3
    params[0, 0, 0, 3:] = [-40.0, 25.0, 0.0]
    jp = jae.DiagonalGaussian.from_params(jnp.asarray(params))
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, jp.mean.shape))
    tp = DiagonalGaussian.from_params(T(params))
    _close(tp.logvar, jp.logvar, 0.0)
    _close(tp.sample(noise=T(noise)), jp.sample(key), 1e-5, 1e-5)
    _close(tp.mode(), jp.mode(), 0.0)
    _close(tp.kl(), jp.kl(), 0.0, 1e-5)
    g = torch.Generator().manual_seed(0)
    drawn = tp.sample(generator=g)
    assert drawn.shape == tp.mean.shape and not torch.equal(drawn, tp.mean)


# ------------------------------------------------------------------ LPIPS

@pytest.fixture(scope="module")
def lpips_pair():
    x = jnp.zeros((1, 16, 16, 3))
    params = jlpips.LPIPS().init(jax.random.PRNGKey(6), x, x)["params"]
    t = LPIPS()
    t.load_state_dict(from_jax_tree(params))
    return params, t


def test_lpips_matches_jax(lpips_pair):
    """Per-image distance on random VGG / head weights; 1e-5 relative."""
    params, t = lpips_pair
    a, b = _images(7), _images(8)
    want = jlpips.LPIPS().apply({"params": params}, jnp.asarray(a),
                                jnp.asarray(b))
    _close(t(T(a), T(b)), want, 0.0, 1e-5)


def test_lpips_weight_files_load_as_jax_converts_them(lpips_pair):
    """The two files in the torchvision / taming key layout (written by
    ``lpips_weight_files``), through ``load_lpips_weights`` and through the
    JAX package's ``convert_lpips_weights``: the same parameters."""
    _, t = lpips_pair
    vgg_sd, lin_sd = lpips_weight_files(t.state_dict())
    assert len(vgg_sd) == 26 and "features.28.bias" in vgg_sd
    ours = load_lpips_weights(vgg_sd, lin_sd)
    theirs = from_jax_tree(jlpips.convert_lpips_weights(vgg_sd, lin_sd))
    assert ours.keys() == theirs.keys() == t.state_dict().keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


# ------------------------------------------------------------------ GAN parts

def test_discriminator_matches_jax():
    """Patch logits of the GroupNorm PatchGAN (odd channel counts take the
    largest dividing group count); 1e-5 absolute."""
    x = _images(9, b=2, size=32)
    for ndf, layers in ((8, 3), (24, 2)):
        jd = jdisc.NLayerDiscriminator(ndf=ndf, n_layers=layers)
        params = jd.init(jax.random.PRNGKey(10), jnp.asarray(x))["params"]
        td = NLayerDiscriminator(ndf=ndf, n_layers=layers)
        td.load_state_dict(from_jax_tree(params))
        _close(td(T(x)), jd.apply({"params": params}, jnp.asarray(x)), 1e-5)
        back = to_jax_tree(td)
        assert jax.tree.structure(back) == jax.tree.structure(
            jax.tree.map(np.asarray, params))


def test_discriminator_init_is_normal_002():
    td = NLayerDiscriminator(ndf=64, n_layers=3)
    w = td.conv2.weight.detach()
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert not td.conv0.bias.detach().any()


@pytest.mark.parametrize("fn", ["hinge", "vanilla"])
def test_gan_d_losses_and_adopt_weight_match_jax(fn):
    r = _rng(11)
    real, fake = (r.standard_normal((2, 3, 3, 1)).astype(np.float32) * 2
                  for _ in range(2))
    tfn, jfn = {"hinge": (hinge_d_loss, jdisc.hinge_d_loss),
                "vanilla": (vanilla_d_loss, jdisc.vanilla_d_loss)}[fn]
    _close(tfn(T(real), T(fake)), jfn(jnp.asarray(real), jnp.asarray(fake)),
           1e-6)
    for step in (0, 4, 5, 9):   # JAX gives the weight as an fp32 array
        assert np.float32(adopt_weight(0.8, step, 5)) == np.asarray(
            jdisc.adopt_weight(0.8, step, 5))


def test_adaptive_d_weight_matches_jax():
    """The weight from gradients on the step's own graph against the JAX
    package's re-decode and pullbacks, through a last conv and a nonlinear
    loss pair; 1e-5 relative."""
    r = _rng(12)
    h = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    kernel = (r.standard_normal((3, 3, 4, 3)) * 0.3).astype(np.float32)
    x = _images(13, size=8)

    def jdecode(k):
        return jax.lax.conv_general_dilated(
            jnp.asarray(h), k, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    jnll = lambda rec: jnp.mean(jnp.abs(jnp.asarray(x) - rec))
    jgan = lambda rec: -jnp.mean(jnp.tanh(rec) ** 3)
    want = jdisc.adaptive_d_weight(jnll, jgan, jdecode, jnp.asarray(kernel),
                                   0.8)
    w = T(kernel).permute(3, 2, 0, 1).contiguous().requires_grad_()
    rec = torch.nn.functional.conv2d(T(h).permute(0, 3, 1, 2), w,
                                     padding=1).permute(0, 2, 3, 1)
    got = adaptive_d_weight((T(x) - rec).abs().mean(),
                            -(torch.tanh(rec) ** 3).mean(), w, 0.8)
    assert not got.requires_grad
    _close(got, want, 0.0, 1e-5)


# ------------------------------------------------------------------ objectives

def _loss_pair(kind, perceptual):
    common = dict(disc_start=3, disc_num_layers=2, disc_ndf=16,
                  disc_weight=0.8, perceptual_weight=perceptual)
    if kind == "vq":
        jl = jvq.VQGANLoss(codebook_weight=0.7, **common)
        tl = VQGANLoss(codebook_weight=0.7, **common)
    else:
        jl = jcont.KLAutoencoderLoss(kl_weight=1e-3, logvar_init=0.3,
                                     **common)
        tl = KLAutoencoderLoss(kl_weight=1e-3, logvar_init=0.3, **common)
    lp = jl.init_params(jax.random.PRNGKey(14), (2, 16, 16, 3))
    tl.load_state_dict(from_jax_tree(lp))
    return jl, lp, tl


@pytest.mark.parametrize("kind", ["vq", "kl"])
@pytest.mark.parametrize("perceptual", [0.0, 1.0], ids=["pixel", "lpips"])
def test_objective_generator_and_discriminator_losses_match_jax(kind,
                                                                perceptual):
    """Generator loss in validation form (d_weight 0) and in training form
    (the adaptive weight through a last conv), every logged value, before
    and after disc_start, and the discriminator loss; 1e-5 relative."""
    jl, lp, tl = _loss_pair(kind, perceptual)
    x = _images(15)
    r = _rng(16)
    h = r.standard_normal((2, 16, 16, 4)).astype(np.float32)
    kernel = (r.standard_normal((3, 3, 4, 3)) * 0.2).astype(np.float32)
    reg = np.asarray(np.abs(r.standard_normal(2 if kind == "kl" else ())),
                     np.float32)

    def jdecode(k):
        return jnp.tanh(jax.lax.conv_general_dilated(
            jnp.asarray(h), k, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")))

    w = T(kernel).permute(3, 2, 0, 1).contiguous().requires_grad_()
    rec_t = torch.tanh(torch.nn.functional.conv2d(
        T(h).permute(0, 3, 1, 2), w, padding=1)).permute(0, 2, 3, 1)
    rec_j = jdecode(jnp.asarray(kernel))
    for step in (0, 3):
        for val in (True, False):
            jkw = ({} if val else dict(decode_from_last=jdecode,
                                       last_kernel=jnp.asarray(kernel)))
            jtot, jlog = jl.generator_loss(lp, jnp.asarray(reg),
                                           jnp.asarray(x), rec_j, step,
                                           val=val, **jkw)
            ttot, tlog = tl.generator_loss(T(reg), T(x), rec_t, step,
                                           last_layer=None if val else w,
                                           val=val)
            _close(ttot, jtot, 1e-6, 1e-5)
            assert tlog.keys() == jlog.keys()
            for key in jlog:
                _close(tlog[key], jlog[key], 1e-6, 1e-5)
            assert (float(tlog["d_weight"]) > 0) == (not val)
        jd, jdlog = jl.discriminator_loss(lp, jnp.asarray(x), rec_j, step)
        td, tdlog = tl.discriminator_loss(T(x), rec_t, step)
        _close(td, jd, 1e-6, 1e-5)
        for key in jdlog:
            _close(tdlog[key], jdlog[key], 1e-6, 1e-5)


@pytest.mark.parametrize("kind", ["vq", "kl"])
def test_training_without_a_last_layer_raises_while_the_gan_is_on(kind):
    _, _, tl = _loss_pair(kind, 0.0)
    x = T(_images(17))
    reg = torch.ones(2) if kind == "kl" else torch.ones(())
    with pytest.raises(ValueError, match="last_layer"):
        tl.generator_loss(reg, x, x * 0.5, 0)
    tl.disc_factor = 0.0   # no GAN term: the weight is not needed
    _, log = tl.generator_loss(reg, x, x * 0.5, 0)
    assert float(log["d_weight"]) == 0.0
