"""The metrics layer of the port against the JAX package on the CPU.

* PSNR, SSIM, the cosine similarity and the range map against
  ``dsml_thesis_tpu.metrics`` in fp32 (1e-5), SSIM also in fp64 against the
  numpy re-derivation of skimage's algorithm of ``tests/test_metrics.py``
  (1e-10), with piq's pre-pooling at 512 px;
* the FID InceptionV3 at 75 x 75, batch 2, on one random torchvision-layout
  state_dict whose features tell the two images apart (``chip_smoke.py``'s
  He-normal weights with calibrated BatchNorm statistics): the JAX model
  (jitted once for the module) against the port's (pool and logits within
  1e-4 of their maximum), the JAX tree carried back
  through ``from_jax_variables`` and the BatchNorm names to the same
  state_dict; ``preprocess`` against the JAX one, up and down;
* FID, KID, PRC and IS on the same features (1e-9 relative), and
  ``compute_features`` over a PNG directory;
* WER, CER, viseme and macro rates equal to the JAX module's;
* the edit-distance library built into the build directory and used, equal
  to the pure-Python dynamic program; two processes that build it at once
  both load it, and nothing is left beside it.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu import metrics as JM
from dsml_thesis_tpu.metrics import fid as jfid
from dsml_thesis_tpu.metrics import inception as jinc
from dsml_thesis_tpu.metrics import lipread as jlr
from dsml_thesis_tpu_torch import metrics as TM
from dsml_thesis_tpu_torch.convert import from_jax_variables
from dsml_thesis_tpu_torch.metrics import fid as tfid
from dsml_thesis_tpu_torch.metrics import inception as tinc
from dsml_thesis_tpu_torch.metrics import lipread as tlr
from dsml_thesis_tpu_torch.metrics import native as tnat
from test_torch_port_hygiene import ROOT, one_torch_thread  # noqa: F401


def _pair(shape, seed=0, noise=0.1):
    rs = np.random.RandomState(seed)
    a = rs.rand(*shape).astype(np.float32)
    b = np.clip(a + noise * rs.randn(*shape).astype(np.float32), 0, 1)
    return a, b


# ------------------------------------------------------------------ image


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 64, 48, 3),
                                   (1, 512, 512, 1)],
                         ids=["32", "64x48", "512-pooled"])
def test_psnr_ssim_match_jax(shape):
    a, b = _pair(shape)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(TM.psnr(ta, tb).numpy(),
                               np.asarray(JM.psnr(a, b)), rtol=1e-5)
    np.testing.assert_allclose(TM.ssim(ta, tb).numpy(),
                               np.asarray(JM.ssim(a, b)), atol=1e-5)
    assert TM.ssim(ta, tb).dtype == torch.float32


def test_psnr_of_a_known_difference_and_of_equal_images():
    a = torch.zeros(1, 8, 8, 3)
    np.testing.assert_allclose(TM.psnr(a, a + 0.1).item(), 20.0, rtol=1e-5)
    assert TM.psnr(a, a).item() > 100   # the 1e-12 floor, not inf


def test_ssim_matches_the_skimage_golden_in_fp64():
    """``tests/test_metrics.py``'s numpy re-derivation of skimage's SSIM
    (separable 'valid' Gaussian, population covariance, 5-pixel crop) at
    fp64, which the port's fp64 filter reproduces to rounding."""
    a, b = _pair((1, 64, 64, 3))
    r = np.arange(-5, 6, dtype=np.float64)
    k = np.exp(-(r ** 2) / (2 * 1.5 ** 2))
    k /= k.sum()

    def filt(x):
        x = np.apply_along_axis(lambda v: np.convolve(v, k, "valid"), 0, x)
        return np.apply_along_axis(lambda v: np.convolve(v, k, "valid"), 1, x)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    vals = []
    for ch in range(3):
        x = a[0, :, :, ch].astype(np.float64)
        y = b[0, :, :, ch].astype(np.float64)
        ux, uy = filt(x), filt(y)
        vx, vy = filt(x * x) - ux * ux, filt(y * y) - uy * uy
        vxy = filt(x * y) - ux * uy
        vals.append((((2 * ux * uy + c1) * (2 * vxy + c2)) / (
            (ux * ux + uy * uy + c1) * (vx + vy + c2))).mean())
    got = TM.ssim(torch.from_numpy(a).double(), torch.from_numpy(b).double())
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), np.mean(vals), rtol=0, atol=1e-10)


def test_cosine_similarity_and_unit_range_match_jax():
    rs = np.random.RandomState(1)
    a = rs.randn(4, 16).astype(np.float32)
    b = rs.randn(4, 16).astype(np.float32)
    a[2] = 0.0   # a zero embedding scores 0, not NaN
    got = TM.cosine_similarity(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JM.cosine_similarity(a, b)),
                               atol=1e-6)
    assert got[2].item() == 0.0
    x = np.array([-2.0, -1.0, 0.0, 0.3, 1.0, 2.0], np.float32)
    np.testing.assert_array_equal(TM.to_unit_range(torch.from_numpy(x)),
                                  np.asarray(JM.to_unit_range(x)))


def test_ssim_restores_the_callers_tf32_settings():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with TM.image.full_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        a, b = _pair((1, 16, 16, 3))
        TM.ssim(torch.from_numpy(a), torch.from_numpy(b))
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -------------------------------------------------------------- inception

_BN = {"bn_scale": "bn.weight", "bn_bias": "bn.bias",
       "bn_mean": "bn.running_mean", "bn_var": "bn.running_var"}


def state_dict_from_jax(params, stats):
    """The JAX (params, batch_stats) tree as a torchvision-layout
    state_dict: ``from_jax_variables`` for the kernels, the Flax
    BatchNorm names mapped to torchvision's."""
    out = {}
    for k, v in from_jax_variables({"params": params,
                                    "batch_stats": stats}).items():
        stem, _, leaf = k.rpartition(".")
        out[f"{stem}.{_BN[leaf]}" if leaf in _BN else k] = v
    return out


@pytest.fixture(scope="module")
def inception():
    """One random torchvision-layout state_dict (every weight and running
    statistic off its init, the statistics those of the network's own
    activations, so that the features depend on the image), the JAX
    model's outputs at 75 x 75 from one jit, and the inputs."""
    import chip_smoke

    sd = chip_smoke.random_inception_state_dict(tinc, 30)
    params, stats = jinc.convert_fid_inception(sd)
    x = np.random.RandomState(31).rand(2, 75, 75, 3).astype(np.float32) * 2 - 1
    apply = jax.jit(lambda v, im: jinc.FIDInceptionV3().apply(v, im))
    pool, logits = apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x))
    return sd, params, stats, x, np.asarray(pool), np.asarray(logits)


def test_inception_matches_jax(inception):
    sd, params, stats, x, pool, logits = inception
    model = tinc.convert_fid_inception(sd)
    with torch.no_grad():
        got_pool, got_logits = model(torch.from_numpy(x))
    assert got_pool.shape == (2, 2048) and got_logits.shape == (2, 1008)
    for got, want in ((got_pool, pool), (got_logits, logits)):
        # the two images' features differ far beyond the tolerance
        assert np.abs(want[0] - want[1]).max() > 0.1 * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_inception_weights_cross_both_ways(inception):
    """The JAX tree the JAX converter built from the state_dict carries back
    to the same state_dict, which the port's module loads with
    strict=True."""
    sd, params, stats, *_ = inception
    back = state_dict_from_jax(params, stats)
    want = {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    tinc.FIDInceptionV3().load_state_dict(sd, strict=True)
    # a torchvision checkpoint's auxiliary head is not the network's
    extra = dict(sd, **{"AuxLogits.fc.weight": torch.zeros(1000, 768)})
    tinc.convert_fid_inception(extra)
    with pytest.raises(KeyError):
        tinc.convert_fid_inception(
            {k: v for k, v in sd.items() if not k.startswith("fc.")})


def test_feature_fn_runs_preprocess_and_matches_jax(inception):
    """``make_feature_fn`` resizes to 299 and runs the network: the port's
    module against the JAX ``make_feature_fn`` on the same weights."""
    sd, params, stats, x, *_ = inception
    want_pool, want_logits = jinc.make_feature_fn(params, stats)(
        jnp.asarray(x))
    got_pool, got_logits = tinc.make_feature_fn(
        tinc.convert_fid_inception(sd))(x)
    for got, want in ((got_pool, want_pool), (got_logits, want_logits)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("hw", [(75, 75), (128, 128), (320, 350), (299, 299)],
                         ids=["up-75", "up-128", "down-320x350", "same"])
def test_preprocess_matches_jax(hw):
    """Bilinear at half-pixel centres, no antialiasing, upward and
    downward (the JAX side's antialias=False)."""
    x = np.random.RandomState(2).rand(2, *hw, 3).astype(np.float32) * 2 - 1
    got = tinc.preprocess(torch.from_numpy(x)).numpy()
    want = np.asarray(jinc.preprocess(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# -------------------------------------------------------------------- fid


@pytest.fixture(scope="module")
def features():
    rs = np.random.RandomState(3)
    a = rs.randn(40, 16)
    b = 0.7 * rs.randn(40, 16) + 0.3
    return a, b


def test_fid_kid_prc_is_match_jax(features):
    a, b = features
    rel = dict(rtol=1e-9, atol=0)
    np.testing.assert_allclose(tfid.fid_from_features(a, b),
                               jfid.fid_from_features(a, b), **rel)
    np.testing.assert_allclose(tfid.kid_from_features(a, b, n_subsets=20),
                               jfid.kid_from_features(a, b, n_subsets=20),
                               **rel)
    assert tfid.precision_recall(a, b) == jfid.precision_recall(a, b)
    assert tfid.precision_recall(a, a.copy()) == (1.0, 1.0)
    logits = np.concatenate([a, b], axis=1)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(tfid.inception_score(probs),
                               jfid.inception_score(probs), **rel)
    mu, sigma = tfid.activation_statistics(a)
    # one Gaussian against itself: 0 up to the eps on the diagonal and the
    # square roots' rounding (the trace is 16 here)
    assert abs(tfid.frechet_distance(mu, sigma, mu, sigma)) < 1e-4
    with pytest.raises(ValueError):
        tfid.precision_recall(a[:3], b)


def test_compute_features_over_a_png_directory(tmp_path):
    """Pillow's bilinear squash to ``size``, batches with a ragged tail:
    the same rows as the JAX function (which pads its tail)."""
    from PIL import Image

    rs = np.random.RandomState(4)
    for i in range(5):
        Image.fromarray((rs.rand(20, 24, 3) * 255).astype(np.uint8)).save(
            tmp_path / f"{i:02d}.png")
    extract = lambda imgs: imgs.reshape(len(imgs), -1)[:, :7] * 2.0
    got = tfid.compute_features(str(tmp_path), extract, batch=2, size=16)
    want = jfid.compute_features(str(tmp_path), extract, batch=2, size=16)
    assert got.shape == (5, 7)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tfid.compute_features(str(tmp_path / "none"), extract)


# ---------------------------------------------------------------- lipread

REFS = ["the cat sat on the mat", "a quick brown fox", "x",
        "lorem ipsum dolor", ""]
HYPS = ["the cat sat on a mat", "a quick fox", "y",
        "lorem  ipsum dolor sit", "extra words"]


def test_word_and_character_rates_match_jax():
    for fn in ("wer", "cer", "macro_wer", "macro_cer"):
        assert getattr(tlr, fn)(REFS, HYPS) == getattr(jlr, fn)(REFS, HYPS), fn
    refs = [t.split() for t in REFS]
    hyps = [t.split() for t in HYPS]
    assert tlr.error_rate(refs, hyps) == jlr.error_rate(refs, hyps)
    for r, h in zip(refs, hyps):
        assert tlr.edit_distance(r, h) == jlr.edit_distance(r, h)
    with pytest.raises(ValueError):
        tlr.wer(REFS, HYPS[:2])


def test_viseme_rates_match_jax(monkeypatch):
    phones = [["th", "ih1", "ng", "k"], ["dh", "ax", "sil", "k", "ae2", "t"]]
    hyps = [["t", "ih", "ng"], ["dh", "ax", "g", "ae", "t"]]
    assert tlr.viseme_error_rate(phones, hyps) == \
        jlr.viseme_error_rate(phones, hyps)
    for p in phones:
        assert tlr.phonemes_to_visemes(p) == jlr.phonemes_to_visemes(p)

    class FakeBackend:   # espeak's IPA with Separator(phone='-')
        def phonemize(self, texts, separator=None):
            return ["θ-ɪ-ŋ-k- t-ɔː-l- ʔ-"]

    monkeypatch.setattr(tlr, "_BACKEND", FakeBackend())
    monkeypatch.setattr(jlr, "_BACKEND", FakeBackend())
    # the glottal stop's empty class keeps its (empty) word, as in JAX
    assert tlr.text_to_visemes("think tall") == \
        jlr.text_to_visemes("think tall") == "Tikk tOt "


# ---------------------------------------------------------- edit distance


def test_native_edit_distance_is_built_and_used():
    rs = np.random.RandomState(0)
    refs = [list(rs.randint(0, 5, rs.randint(0, 30))) for _ in range(30)]
    hyps = [list(rs.randint(0, 5, rs.randint(0, 30))) for _ in range(30)]
    got = tnat.edit_distance_batch(refs, hyps)
    assert got is not None, "g++ is on this host: the library must build"
    assert tnat.load() is not None
    path = tnat.library_path()
    assert os.path.dirname(path) == tnat.BUILD_DIR and os.path.exists(path)
    np.testing.assert_array_equal(
        got, [tlr.edit_distance(r, h) for r, h in zip(refs, hyps)])
    words = tnat.edit_distance_batch([["the", "cat", "sat"], []],
                                     [["the", "dog", "sat"], ["a"]])
    assert list(words) == [1, 1]
    with pytest.raises(ValueError):
        tnat.edit_distance_batch([[1]], [[1], [2]])


def test_two_processes_build_the_library_at_once(tmp_path):
    """Both wait on the file lock, one compiles, both load the same file;
    no temporary file is left, and nothing is written beside the
    source."""
    before = sorted(os.listdir(os.path.join(ROOT, "native")))
    build_dir = str(tmp_path / "build")
    code = ("import sys\n"
            "from dsml_thesis_tpu_torch.metrics import native\n"
            "lib = native.load(sys.argv[1])\n"
            "d = native.edit_distance_batch([[1, 2, 3]], [[1, 3]], "
            "sys.argv[1])\n"
            "print(lib is not None, int(d[0]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, build_dir],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["True", "1"]
    assert sorted(os.listdir(build_dir)) == sorted(
        [os.path.basename(tnat.library_path(build_dir)), "editdist.lock"])
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == before
