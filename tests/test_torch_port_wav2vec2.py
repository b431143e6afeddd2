"""wav2vec2, the ``AudioEmbedder`` cond stage and the audio front end of
``scripts/mead_audio_features_torch.py`` against the JAX package, on the
CPU in fp32.

* ``Wav2Vec2`` at a tiny config (3 convs, hidden 32, 2 layers, 4 heads, an
  even positional-conv kernel of 16 in 4 groups) with one JAX parameter
  tree carried over by ``convert.from_jax_tree``: native length, resampled
  to 9 frames, with a CTC head; 1e-5 of the output's maximum.
* ``AudioEmbedder``: int and [B] ``frame_idx`` at the clip's edges (the
  replicate padding), the out-of-range refusal, and the gradient against
  ``jax.grad`` with the extractor frozen (1e-4 of each leaf's maximum); its
  ``frozen_paths`` keep the extractor out of the optimizer and the EMA of a
  model built from a config.
* ``interp_align_corners`` against JAX; ``convert_wav2vec2`` on synthetic
  ``transformers``-named state dicts (weight norm as g / v and as the
  parametrized pair, ForCTC's ``wav2vec2.`` prefix) against the JAX
  converter; ``config_from_hf`` on a plain dict; ``transformers``' own
  ``Wav2Vec2Model`` and ``Wav2Vec2FeatureExtractor`` where the library is
  installed.
* ``load_wav_16k`` against the JAX script's at 16, 44.1 and 48 kHz (the
  antialiased linear resample of ``jax.image.resize``), mono and stereo,
  16- and 32-bit PCM.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import types
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.models import wav2vec2 as jw
from dsml_thesis_tpu_torch.convert import from_jax_tree, to_jax_tree
from dsml_thesis_tpu_torch.models import wav2vec2 as tw
from test_torch_port_lipread import _rel_close
from test_torch_port_pipeline import random_params
from test_torch_port_training import _leaves
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(conv_dim=(16, 16, 24), conv_kernel=(10, 3, 3),
            conv_stride=(5, 2, 2), conv_bias=False, hidden_size=32,
            num_layers=2, num_heads=4, intermediate_size=48,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _audio(b=2, s=1600, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s)).astype(
        np.float32)


def _pair(ctc=None, seed=1):
    """(JAX config, JAX params, the port's module) from one random tree."""
    jcfg = jw.Wav2Vec2Config(**TINY, ctc_vocab=ctc)
    params = jax.jit(jw.Wav2Vec2(jcfg).init)(jax.random.PRNGKey(0),
                                             jnp.asarray(_audio(1)))["params"]
    params = random_params(params, np.random.default_rng(seed))
    tm = tw.Wav2Vec2(tw.Wav2Vec2Config(**TINY, ctc_vocab=ctc))
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)),
                       strict=True)
    return jcfg, params, tm.eval()


@pytest.mark.parametrize("num_frames,ctc", [(None, None), (9, None),
                                            (None, 10)],
                         ids=["native", "9-frames", "ctc-head"])
def test_wav2vec2_matches_jax(num_frames, ctc):
    jcfg, params, tm = _pair(ctc)
    x = _audio()
    want = jax.jit(jw.Wav2Vec2(jcfg).apply, static_argnames="num_frames")(
        {"params": params}, jnp.asarray(x), num_frames=num_frames)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), num_frames=num_frames)
    assert got.shape == want.shape
    if num_frames is not None:
        assert got.shape == (2, num_frames, 32)
    if ctc is not None:
        assert got.shape[-1] == ctc
    _rel_close(got.numpy(), want)


@pytest.fixture(scope="module")
def embedders():
    jcfg = jw.Wav2Vec2Config(**TINY)
    jm = jw.AudioEmbedder(win_len=2, cfg=jcfg)
    x = jnp.asarray(_audio(2, 1600))
    params = jax.jit(jm.init, static_argnames="num_frames")(
        jax.random.PRNGKey(0), x, num_frames=12, frame_idx=0)["params"]
    params = random_params(params, np.random.default_rng(2))
    tm = tw.AudioEmbedder(win_len=2, cfg=tw.Wav2Vec2Config(**TINY))
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)),
                       strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("frame_idx", [0, 1, 6, 11, (0, 11), (10, 3)],
                         ids=["int-0", "int-1", "int-6", "int-11",
                              "per-row-edges", "per-row-inside"])
def test_audio_embedder_matches_jax(embedders, frame_idx):
    """A 5-frame window around ``frame_idx`` of a 12-frame clip: an int for
    the batch or one a row, at the first and last frames (indices clamped,
    the replicate padding) and inside."""
    jm, params, tm = embedders
    x = _audio(2, 1600, seed=3)
    fi = frame_idx if isinstance(frame_idx, int) else np.asarray(frame_idx)
    want = jax.jit(jm.apply, static_argnames="num_frames")(
        {"params": params}, jnp.asarray(x), num_frames=12,
        frame_idx=fi if isinstance(fi, int) else jnp.asarray(fi))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), num_frames=12,
                 frame_idx=fi if isinstance(fi, int) else torch.from_numpy(fi))
    assert got.shape == want.shape == (2, 1, 32)
    _rel_close(got.numpy(), want)


def test_audio_embedder_default_window_and_range_check(embedders):
    """Without ``num_frames`` / ``frame_idx`` the audio is the window itself
    (centre token); a static index outside the clip raises on both
    sides."""
    jm, params, tm = embedders
    x = _audio(2, 1600, seed=4)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), training=True)
    _rel_close(got.numpy(), want)
    with pytest.raises(ValueError):
        tm(torch.from_numpy(x), num_frames=12, frame_idx=12)
    with pytest.raises(ValueError):
        jm.apply({"params": params}, jnp.asarray(x), num_frames=12,
                 frame_idx=-1)


def test_audio_embedder_gradient_matches_jax(embedders):
    """jax.grad of a weighted sum of the pooled tokens: every leaf; the
    frozen extractor gets no gradient on either side."""
    jm, params, tm = embedders
    x = _audio(2, 1600, seed=5)
    w = np.random.default_rng(6).standard_normal((2, 1, 32)).astype(
        np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(
        {"params": p}, jnp.asarray(x), num_frames=12,
        frame_idx=jnp.asarray([2, 9])) * w)))(params)
    tm.zero_grad(set_to_none=True)
    (tm(torch.from_numpy(x), num_frames=12,
        frame_idx=torch.tensor([2, 9])) * torch.from_numpy(w)).sum().backward()
    grads = {n: p.grad for n, p in tm.named_parameters()
             if p.grad is not None}
    tm.zero_grad(set_to_none=True)
    assert not any(n.startswith("audio_encoder.feature_extractor")
                   for n in grads)
    want_l = _leaves(want)
    got_l = _leaves(to_jax_tree(tm, grads))
    for k in set(want_l) - set(got_l):
        assert not want_l[k].any(), k
    assert len(got_l) > 20
    # the training tests' standard: 1e-4 of each leaf's maximum, and a leaf
    # of rounding noise (the key bias, which the softmax removes) held to
    # 1e-6 of the tree's largest
    top = max(np.abs(w).max() for w in want_l.values())
    for k, g in got_l.items():
        np.testing.assert_allclose(g, want_l[k], rtol=0, err_msg=k,
                                   atol=max(1e-4 * np.abs(want_l[k]).max(),
                                            1e-6 * top))


def test_audio_embedder_cond_stage_keeps_its_extractor_frozen():
    """``AudioEmbedder`` as a config's trainable cond stage: its conv
    extractor is outside the optimizer and the EMA (``frozen_paths``), the
    rest of it inside."""
    from dsml_thesis_tpu_torch.config import build_model
    from dsml_thesis_tpu_torch.training.train_state import (
        create_train_state, make_optimizer)
    from test_torch_port_lipread import tune_cfg

    cfg = tune_cfg()
    p = cfg["model"]["params"]
    p["cond_stage_config_2"] = {
        "target": "ldm.modules.encoders.modules.AudioEmbedder",
        "params": {"win_len": 2, "subspace_dim": 768}}
    with torch.device("meta"):
        ldm = build_model(cfg["model"])
    emb = ldm.cond["audio"]
    assert isinstance(emb, tw.AudioEmbedder) and emb.win_len == 2
    assert emb.audio_encoder.freeze_extractor
    assert ldm.frozen_subpaths() == {
        "cond/audio": ("audio_encoder/feature_extractor",)}
    names = {f"{g}.{n}" for g, n, _ in ldm.named_trainable_parameters()}
    assert "cond/audio.att_fc.weight" in names
    assert "cond/audio.audio_encoder.layer_0.q_proj.weight" in names
    assert not any("feature_extractor" in n for n in names)
    ldm = ldm.to_empty(device="cpu")
    state = create_train_state(ldm, make_optimizer(ldm, 1e-4), 1e-4)
    assert not any("feature_extractor" in n for n in state.names)
    in_opt = {id(q) for g in state.optimizer.param_groups
              for q in g["params"]}
    assert not any(id(q) in in_opt
                   for q in emb.audio_encoder.feature_extractor.parameters())


@pytest.mark.parametrize("t,out", [(10, 5), (7, 30), (5, 1), (6, 6),
                                   (49, 30)])
def test_interp_align_corners_matches_jax(t, out):
    x = np.random.default_rng(t).standard_normal((2, t, 3)).astype(np.float32)
    want = jw.interp_align_corners(jnp.asarray(x), out)
    got = tw.interp_align_corners(torch.from_numpy(x), out)
    assert got.shape == (2, out, 3)
    _rel_close(got.numpy(), want)


# --------------------------------------------------------------------------
# the transformers weight bridge
# --------------------------------------------------------------------------

def hf_state_dict(cfg, seed=0, parametrized=False, ctc_prefix=False):
    """A synthetic state dict in ``transformers``' Wav2Vec2Model
    (``ctc_prefix``: Wav2Vec2ForCTC) naming, random weights."""
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                    / np.sqrt(s[-1] if len(s) > 1 else 1.0))
    d, sd, cin = cfg.hidden_size, {}, 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = r(c, cin, k)
        cin = c
    sd["feature_extractor.conv_layers.0.layer_norm.weight"] = 1 + 0.1 * r(
        cfg.conv_dim[0])
    sd["feature_extractor.conv_layers.0.layer_norm.bias"] = 0.1 * r(
        cfg.conv_dim[0])
    sd["feature_projection.layer_norm.weight"] = 1 + 0.1 * r(cin)
    sd["feature_projection.layer_norm.bias"] = 0.1 * r(cin)
    sd["feature_projection.projection.weight"] = r(d, cin)
    sd["feature_projection.projection.bias"] = 0.1 * r(d)
    k, g = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    base = "encoder.pos_conv_embed.conv"
    wg, wv = r(1, 1, k).abs() + 0.5, r(d, d // g, k)
    if parametrized:
        sd[f"{base}.parametrizations.weight.original0"] = wg
        sd[f"{base}.parametrizations.weight.original1"] = wv
    else:
        sd[f"{base}.weight_g"], sd[f"{base}.weight_v"] = wg, wv
    sd[f"{base}.bias"] = 0.1 * r(d)
    sd["encoder.layer_norm.weight"] = 1 + 0.1 * r(d)
    sd["encoder.layer_norm.bias"] = 0.1 * r(d)
    sd["masked_spec_embed"] = r(d)
    for i in range(cfg.num_layers):
        t = f"encoder.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{t}.attention.{p}.weight"] = r(d, d)
            sd[f"{t}.attention.{p}.bias"] = 0.1 * r(d)
        for n, (o, i_) in (("feed_forward.intermediate_dense",
                            (cfg.intermediate_size, d)),
                           ("feed_forward.output_dense",
                            (d, cfg.intermediate_size))):
            sd[f"{t}.{n}.weight"] = r(o, i_)
            sd[f"{t}.{n}.bias"] = 0.1 * r(o)
        for n in ("layer_norm", "final_layer_norm"):
            sd[f"{t}.{n}.weight"] = 1 + 0.1 * r(d)
            sd[f"{t}.{n}.bias"] = 0.1 * r(d)
    if ctc_prefix:
        sd = {f"wav2vec2.{k}": v for k, v in sd.items()}
    if cfg.ctc_vocab is not None:
        sd["lm_head.weight"] = r(cfg.ctc_vocab, d)
        sd["lm_head.bias"] = 0.1 * r(cfg.ctc_vocab)
    return sd


@pytest.mark.parametrize("parametrized,ctc", [(False, None), (True, None),
                                              (True, 10)],
                         ids=["weight-g-v", "parametrized", "for-ctc"])
def test_convert_wav2vec2_matches_the_jax_converter(parametrized, ctc):
    """Key for key against the JAX converter followed by ``from_jax_tree``
    (the weight norm folded the same way), and the converted model's output
    against JAX's on those weights."""
    cfg = tw.Wav2Vec2Config(**TINY, ctc_vocab=ctc)
    sd = hf_state_dict(cfg, seed=7, parametrized=parametrized,
                       ctc_prefix=ctc is not None)
    got = tw.convert_wav2vec2(sd, cfg)
    jcfg = jw.Wav2Vec2Config(**TINY, ctc_vocab=ctc)
    jparams = jw.convert_wav2vec2(sd, jcfg)
    want = from_jax_tree(jparams)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    tm = tw.Wav2Vec2(cfg)
    tm.load_state_dict(got, strict=True)
    x = _audio(1, 1600, seed=8)
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x), num_frames=7)
    _rel_close(out.numpy(), jw.Wav2Vec2(jcfg).apply(
        {"params": jparams}, jnp.asarray(x), num_frames=7))


def test_convert_refuses_the_layer_norm_extractor_layout():
    cfg = tw.Wav2Vec2Config(**TINY)
    sd = hf_state_dict(cfg)
    sd["feature_extractor.conv_layers.1.layer_norm.weight"] = torch.ones(16)
    with pytest.raises(ValueError):
        tw.convert_wav2vec2(sd, cfg)


@pytest.mark.parametrize("ctc", [False, True])
def test_config_from_hf_reads_a_plain_dict(ctc):
    """A snapshot's config.json as a dict, against the JAX reader of the same
    values as attributes; the layouts that are not implemented raise."""
    hf = {"vocab_size": 32, "conv_dim": [16, 16, 24],
          "conv_kernel": [10, 3, 3], "conv_stride": [5, 2, 2],
          "conv_bias": False, "hidden_size": 32, "num_hidden_layers": 2,
          "num_attention_heads": 4, "intermediate_size": 48,
          "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4,
          "do_stable_layer_norm": False, "feat_extract_norm": "group"}
    got = tw.config_from_hf(hf, ctc=ctc)
    want = jw.config_from_hf(types.SimpleNamespace(**hf), ctc=ctc)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.ctc_vocab == (32 if ctc else None)
    for bad in ({"do_stable_layer_norm": True}, {"feat_extract_norm": "layer"}):
        with pytest.raises(ValueError):
            tw.config_from_hf(dict(hf, **bad))


def test_transformers_model_through_the_converter():
    """``transformers``' own random Wav2Vec2Model (where installed) against
    the port loaded through ``convert_wav2vec2``: the reference flow, CNN
    features resampled to 7 frames, then projection and encoder (1e-5)."""
    transformers = pytest.importorskip("transformers")
    import torch.nn.functional as F

    hf = transformers.Wav2Vec2Config(
        vocab_size=32, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=48, conv_dim=(16, 16, 24),
        conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), conv_bias=False,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        do_stable_layer_norm=False, feat_extract_norm="group",
        hidden_act="gelu", feat_proj_dropout=0.0, hidden_dropout=0.0,
        attention_dropout=0.0, layerdrop=0.0, apply_spec_augment=False)
    torch.manual_seed(0)
    ref = transformers.Wav2Vec2Model(hf).eval()
    cfg = tw.config_from_hf(hf.to_dict())
    tm = tw.Wav2Vec2(cfg)
    tm.load_state_dict(tw.convert_wav2vec2(ref.state_dict(), cfg),
                       strict=True)
    x = torch.from_numpy(_audio(1, 1600, seed=9))
    with torch.no_grad():
        h = ref.feature_extractor(x)
        h = F.interpolate(h, size=7, mode="linear", align_corners=True)
        want = ref.encoder(ref.feature_projection(h.transpose(1, 2))[0]
                           ).last_hidden_state
        got = tm.eval()(x, num_frames=7)
    _rel_close(got.numpy(), want.numpy())


# --------------------------------------------------------------------------
# the audio front end of the features script
# --------------------------------------------------------------------------

def write_wav(path, rate, seconds, channels=1, width=2, seed=0):
    """A PCM wav of a few tones and noise at full scale of its width."""
    n = int(rate * seconds)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    sig = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(
        2 * np.pi * 3100 * t))[:, None] + 0.1 * rng.standard_normal(
        (n, channels))
    sig = sig / np.abs(sig).max()
    dtype = {2: np.int16, 4: np.int32}[width]
    data = (sig * (np.iinfo(dtype).max - 1)).astype(dtype)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


@pytest.fixture(scope="module")
def scripts():
    return load_script("mead_audio_features"), load_script(
        "mead_audio_features_torch")


@pytest.mark.parametrize("rate", [16000, 44100, 48000])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("width", [2, 4])
def test_load_wav_16k_matches_the_jax_script(scripts, tmp_path, rate,
                                             channels, width):
    """0.1 s of audio: the port's triangle kernel widened by the rate's
    ratio against ``jax.image.resize(..., "linear")`` (1e-5 of the
    maximum), the same length."""
    jax_script, torch_script = scripts
    path = str(tmp_path / "a.wav")
    write_wav(path, rate, 0.1, channels, width, seed=rate + channels)
    want = jax_script.load_wav_16k(path)
    got = torch_script.load_wav_16k(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert abs(len(got) - 1600) <= 1
    _rel_close(got, want)


def test_normalize_audio_is_the_feature_extractors():
    """Zero mean, unit variance, eps 1e-7 under the root: as
    ``transformers``' ``Wav2Vec2FeatureExtractor`` (where installed)
    normalizes one unpadded clip; ``do_normalize=False`` passes it on."""
    torch_script = load_script("mead_audio_features_torch")
    x = (np.random.default_rng(10).standard_normal(4000) * 0.3 + 0.1
         ).astype(np.float32)
    got = torch_script.normalize_audio(x)
    np.testing.assert_allclose(got.mean(), 0.0, atol=1e-6)
    np.testing.assert_allclose(got.std(), 1.0, atol=1e-5)
    np.testing.assert_array_equal(torch_script.normalize_audio(x, False), x)
    transformers = pytest.importorskip("transformers")
    fe = transformers.Wav2Vec2FeatureExtractor(do_normalize=True,
                                               sampling_rate=16000)
    want = np.asarray(fe(x, sampling_rate=16000)["input_values"][0],
                      np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
