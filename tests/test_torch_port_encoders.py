"""Conditioning encoders and the audio windows of the port against the JAX
package's on the CPU in fp32 (1e-5), weights carried by ``from_jax_tree``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.diffusion.video import audio_windows as j_audio_windows
from dsml_thesis_tpu.models import encoders as jenc
from dsml_thesis_tpu_torch.convert import from_jax_tree
from dsml_thesis_tpu_torch.diffusion.video import audio_windows
from dsml_thesis_tpu_torch.models import encoders as tenc
from test_torch_port_pipeline import random_params
from test_torch_port_hygiene import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("labels", [[0, 3, 7, 3], [5]])
def test_class_embedder_and_null_row(labels):
    labels = np.array(labels, np.int32)
    jm = jenc.ClassEmbedder(embed_dim=16, n_classes=8)
    params = random_params(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(labels))["params"],
        np.random.default_rng(0))
    tm = tenc.ClassEmbedder(embed_dim=16, n_classes=8, p_uncond=0.2)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)),
                       strict=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(labels)))
    want_null = np.asarray(jm.apply({"params": params}, method="null_token",
                                    batch_size=3))
    with torch.no_grad():
        got = tm(torch.from_numpy(labels)).numpy()
        got_null = tm.null_token(3).numpy()
    assert got.shape == want.shape == (len(labels), 1, 16)
    assert got_null.shape == want_null.shape == (3, 1, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_null, want_null)
    assert not np.array_equal(got_null[0], got[0])
    # the null row is the table's extra row
    np.testing.assert_array_equal(
        got_null[0, 0], np.asarray(params["embedding"]["embedding"])[8])


def test_unported_encoder_options_raise():
    with pytest.raises(NotImplementedError):
        tenc.Conv1DTemporalAttention(5, 32, subspace2hidden=True)


@pytest.mark.parametrize("seq_len,dim", [(5, 32), (17, 48)])
def test_conv1d_temporal_attention(seq_len, dim):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, seq_len, dim)).astype(np.float32)
    jm = jenc.Conv1DTemporalAttention(seq_len=seq_len, subspace_dim=dim)
    params = random_params(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tm = tenc.Conv1DTemporalAttention(seq_len=seq_len, subspace_dim=dim)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)),
                       strict=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 1, dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_conv1d_temporal_attention_promotes_cast_weights():
    """Weights cast to bf16 for sampling, fp32 input: the result stays fp32,
    as the JAX module promotes."""
    from dsml_thesis_tpu_torch.utils_io import cast_sampling_params

    tm = cast_sampling_params(tenc.Conv1DTemporalAttention(5, 32))
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    with torch.no_grad():
        out = tm(torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(0)))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("frames,window,T", [(4, 2, 6), (3, 8, 11), (5, 1, 5)])
def test_audio_windows(frames, window, T):
    a = np.random.default_rng(2).standard_normal((2, T, 7)).astype(np.float32)
    want = np.asarray(j_audio_windows(jnp.asarray(a), frames, window))
    got = audio_windows(torch.from_numpy(a), frames, window).numpy()
    assert got.shape == want.shape == (2, frames, 2 * window + 1, 7)
    np.testing.assert_array_equal(got, want)
    # the first frame's window starts clamped at the clip's first feature
    np.testing.assert_array_equal(got[:, 0, 0], a[:, 0])
