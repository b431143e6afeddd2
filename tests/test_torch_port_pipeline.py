"""The ported serving slice as a whole, held against the JAX package on the
CPU in fp32: one set of weights (a JAX tree filled from a numpy seed and
carried over by ``from_jax_params``),
one set of numpy inputs and injected noise through both pipelines.

Tolerances: latents 1e-3 after 2 frames x 4 DDIM steps with guidance 2.0
(fp32 sums taken in another order, compounded through eight UNet calls and
the identity carry). Decoded frames are compared BEFORE the quantizer
(``force_not_quantize``) at 1e-2: the decode quantizes to the nearest code
first, and a latent that sits near a code boundary may legitimately flip to
the neighbouring code under a 1e-3 difference, which would show as a large
pixel difference that says nothing about the port. The quantized decode is
checked separately on the JAX latents (same input, so same codes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu.config import build_model as jax_build_model
from dsml_thesis_tpu.diffusion import (make_ddim_schedule as jax_ddim_schedule,
                                       make_video_pipeline as jax_pipeline)
from dsml_thesis_tpu_torch.config import build_model
from dsml_thesis_tpu_torch.convert import from_jax_params
from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                             make_video_pipeline)
from test_ldm import TINY_MEAD_CFG
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

B, F, STEPS, WINDOW = 2, 2, 4, 2


def random_params(tree, rng):
    """A JAX parameter tree refilled from a numpy generator: matrices and
    conv kernels at 1/sqrt(fan_in), norm scales near 1, biases small."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = random_params(v, rng)
            continue
        r = rng.standard_normal(v.shape).astype(np.float32)
        if v.ndim > 1:
            r *= 1.0 / np.sqrt(np.prod(v.shape[:-1]))
        else:
            r = 0.1 * r + (1.0 if name == "scale" else 0.0)
        out[name] = jnp.asarray(r)
    return out


@pytest.fixture(scope="module")
def both():
    cfg = yaml.safe_load(TINY_MEAD_CFG)
    jldm = jax_build_model(cfg["model"])
    batch = {
        "image": jnp.zeros((2, 16, 16, 3)),
        "masked_image": jnp.zeros((2, 16, 16, 3)),
        "identity": jnp.zeros((2, 16, 16, 3)),
        "class_label": jnp.array([1, 5]),
        "audio": jnp.zeros((2, 5, 32)),
    }
    params = jax.jit(jldm.init_params)(jax.random.PRNGKey(0), batch)
    # the JAX init zeroes every block-final conv, which would hide most of
    # the network from a comparison: fill all weights from a numpy seed
    rng = np.random.default_rng(0)
    params = random_params(params, rng)
    tldm = build_model(cfg["model"])
    missing = tldm.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params)), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    tldm.eval()

    inputs = {
        "masked_frames": rng.uniform(-1, 1, (B, F, 16, 16, 3)),
        "audio": rng.standard_normal((B, F + WINDOW, 32)),
        "identity": rng.uniform(-1, 1, (B, 16, 16, 3)),
        "x_T": rng.standard_normal((B, F, 8, 8, 3)),
    }
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    inputs["class_label"] = np.array([1, 5], np.int32)
    return jldm, params, tldm, inputs


def _run_jax(jldm, params, inputs, decode):
    ddim = jax_ddim_schedule(jldm.schedule, STEPS, eta=0.0)
    pipe = jax_pipeline(jldm, ddim, WINDOW, guidance_scale=2.0, decode=decode)
    out = jax.jit(pipe)(
        params, jnp.asarray(inputs["masked_frames"]),
        jnp.asarray(inputs["audio"]), jnp.asarray(inputs["identity"]),
        jnp.asarray(inputs["class_label"]), jax.random.PRNGKey(0),
        jnp.asarray(inputs["x_T"]))
    return np.array(out)  # a writable copy


def _run_torch(tldm, inputs, decode):
    ddim = make_ddim_schedule(tldm.schedule, STEPS, eta=0.0)
    pipe = make_video_pipeline(tldm, ddim, WINDOW, guidance_scale=2.0,
                               decode=decode)
    t = lambda k: torch.from_numpy(inputs[k])
    out = pipe(t("masked_frames"), t("audio"), t("identity"),
               t("class_label").long(), None, x_T=t("x_T"))
    return out.numpy()


@pytest.mark.parametrize("flash_interpret", [False, True],
                         ids=["jnp-attention", "pallas-interpret"])
def test_pipeline_latents_match_jax(both, monkeypatch, flash_interpret):
    """Latents of the whole chain; once with the JAX attention running its
    Pallas kernels in interpret mode (the production dispatch), once through
    its plain path."""
    jldm, params, tldm, inputs = both
    if flash_interpret:
        monkeypatch.setenv("DSML_FLASH_INTERPRET", "1")
    want = _run_jax(jldm, params, inputs, decode=False)
    got = _run_torch(tldm, inputs, decode=False)
    assert got.shape == want.shape == (B, F, 8, 8, 3)
    assert np.isfinite(got).all()
    assert np.abs(want).max() > 0.1  # a comparison of zeros proves nothing
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_pipeline_frames_match_jax_before_the_quantizer(both):
    jldm, params, tldm, inputs = both
    lat_j = _run_jax(jldm, params, inputs, decode=False)
    lat_t = _run_torch(tldm, inputs, decode=False)
    for f in range(F):
        want = np.asarray(jldm.decode_first_stage(
            params, jnp.asarray(lat_j[:, f]), force_not_quantize=True))
        with torch.no_grad():
            got = tldm.decode_first_stage(torch.from_numpy(lat_t[:, f]),
                                          force_not_quantize=True).numpy()
        assert got.shape == want.shape == (B, 16, 16, 3)
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)


def test_pipeline_decoded_frames_match_on_equal_latents(both):
    """The full decode (quantize first, clip to [-1, 1]) on the SAME latents:
    equal codes, so frames agree to fp32 rounding."""
    jldm, params, tldm, inputs = both
    want = _run_jax(jldm, params, inputs, decode=True)
    lat = _run_jax(jldm, params, inputs, decode=False)
    with torch.no_grad():
        got = np.stack([
            tldm.decode_first_stage(torch.from_numpy(lat[:, f])).clamp(-1, 1)
            .numpy() for f in range(F)], axis=1)
    assert got.shape == want.shape == (B, F, 16, 16, 3)
    assert np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_pipeline_draws_noise_from_the_generator(both):
    """Without injected noise the generator decides: equal seeds agree bit
    for bit, different seeds do not."""
    _, _, tldm, inputs = both
    ddim = make_ddim_schedule(tldm.schedule, 2, eta=0.0)
    pipe = make_video_pipeline(tldm, ddim, WINDOW, guidance_scale=2.0,
                               decode=False)
    t = lambda k: torch.from_numpy(inputs[k])
    run = lambda seed: pipe(
        t("masked_frames"), t("audio"), t("identity"),
        t("class_label").long(), torch.Generator().manual_seed(seed)).numpy()
    a, b, c = run(7), run(7), run(8)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # the DPM-Solver++ chain draws its frames' noise the same way
    dpm = lambda seed: make_video_pipeline(
        tldm, ddim, WINDOW, guidance_scale=2.0, decode=False, sampler="dpm",
        sampler_steps=2)(
            t("masked_frames"), t("audio"), t("identity"),
            t("class_label").long(), torch.Generator().manual_seed(seed)
        ).numpy()
    d7 = dpm(7)
    assert np.array_equal(d7, dpm(7)) and not np.array_equal(d7, dpm(8))
    assert not np.array_equal(d7, a)
