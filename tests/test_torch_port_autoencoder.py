"""The port's VQGAN first stage against the JAX package's on the CPU in fp32,
weights carried by ``from_jax_tree``. 1e-4: the same sums in another order
through the encoder or the decoder."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.models.autoencoder import VQModel as JVQModel
from dsml_thesis_tpu.models.quantize import _nearest_code as j_nearest_code
from dsml_thesis_tpu_torch.convert import from_jax_tree
from dsml_thesis_tpu_torch.models.autoencoder import DownsampleAE, VQModel
from dsml_thesis_tpu_torch.models.quantize import (VectorQuantizer,
                                                   _nearest_code)
from test_torch_port_pipeline import random_params

DDCONFIG = dict(double_z=False, z_channels=3, resolution=16, in_channels=3,
                out_ch=3, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                attn_resolutions=(8,), dropout=0.0)


@pytest.fixture(scope="module")
def vq():
    jm = JVQModel(ddconfig=DDCONFIG, n_embed=64, embed_dim=3)
    x = jnp.zeros((2, 16, 16, 3))
    params = random_params(jm.init(jax.random.PRNGKey(0), x)["params"],
                           np.random.default_rng(0))
    tm = VQModel(ddconfig=DDCONFIG, n_embed=64, embed_dim=3)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)),
                       strict=True)
    return jm, params, tm.eval()


def _images(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)


def test_encode_matches_jax(vq):
    jm, params, tm = vq
    x = _images(1)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               method="encode"))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 3)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_decode_without_quantizer_matches_jax(vq):
    jm, params, tm = vq
    z = np.random.default_rng(2).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(z),
                               force_not_quantize=True, method="decode"))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z), force_not_quantize=True).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _away_from_ties(z, codebook, margin=1e-3):
    """Keep the rows of z whose nearest and second-nearest codes differ in
    distance by more than ``margin``: there both frameworks must pick the
    same code whatever the order of their sums."""
    d = ((z[:, None, :] - codebook[None]) ** 2).sum(-1)
    d.sort(axis=1)
    return z[d[:, 1] - d[:, 0] > margin]


def test_code_indices_equal_away_from_ties(vq):
    jm, params, tm = vq
    codebook = np.array(params["quantize"]["embedding"])
    z = np.random.default_rng(3).standard_normal((4096, 3)).astype(np.float32)
    z = z * codebook.std() * 2
    z = _away_from_ties(z, codebook)[:1024].reshape(4, 16, 16, 3)
    want = np.asarray(j_nearest_code(jnp.asarray(z.reshape(-1, 3)),
                                     jnp.asarray(codebook)))
    got = _nearest_code(torch.from_numpy(z.reshape(-1, 3)),
                        torch.from_numpy(codebook)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 8  # the inputs reach many codes
    # the module: quantized values, indices, and the codebook lookup
    zq_j, _, idx_j = jm.apply({"params": params}, jnp.asarray(z),
                              method=lambda m, v: m.quantize(v))
    with torch.no_grad():
        zq_t, _, idx_t = tm.quantize(torch.from_numpy(z))
        looked_up = tm.quantize.get_codebook_entry(idx_t, (4, 16, 16, 3))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(zq_t.numpy(), np.asarray(zq_j), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(looked_up.numpy(), np.asarray(zq_j), atol=1e-6,
                               rtol=0)


def test_decode_quantizes_first(vq):
    """decode() on latents kept away from ties: same codes, so the images
    agree like the un-quantized decode does."""
    jm, params, tm = vq
    codebook = np.array(params["quantize"]["embedding"])
    z = np.random.default_rng(4).standard_normal((2048, 3)).astype(np.float32)
    z = _away_from_ties(z * codebook.std() * 2, codebook)[:128].reshape(
        2, 8, 8, 3)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(z),
                               method="decode"))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z)).numpy()
        unq = tm.decode(torch.from_numpy(z), force_not_quantize=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(got - unq).max() > 1e-3  # the quantizer did something


def test_full_forward_matches_jax(vq):
    jm, params, tm = vq
    x = _images(5)
    rec_j, _, idx_j = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        rec_t, _, idx_t = tm(torch.from_numpy(x))
    same = idx_t.numpy() == np.asarray(idx_j)
    assert same.mean() > 0.95  # a tie may flip a code; most must agree
    if same.all():
        np.testing.assert_allclose(rec_t.numpy(), np.asarray(rec_j), atol=1e-4,
                                   rtol=0)


def test_downsample_pads_bottom_and_right_only():
    ds = DownsampleAE(1)
    with torch.no_grad():
        ds.conv.weight.fill_(1.0)
        ds.conv.bias.zero_()
        out = ds(torch.ones(1, 1, 4, 4))
    # 3x3 windows at stride 2 over a 4x4 map padded to 5x5 on the far sides
    np.testing.assert_array_equal(out.numpy()[0, 0], [[9, 6], [6, 4]])


def test_quantizer_init_range():
    q = VectorQuantizer(64, 3)
    assert float(q.embedding.weight.detach().abs().max()) <= 1.0 / 64
