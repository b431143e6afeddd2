"""The talking-face generate-and-score entry points of the port on the CPU,
on the tiny MEAD config of ``tests/test_torch_port_pipeline.py``.

* ``progressive_sampling_torch.sample_clip`` (a clip shorter than
  ``--frames``, padded) against the JAX ``make_video_pipeline`` on the
  JAX script's padding, one set of weights, injected ``x_T``: latents to
  1e-3, frames before the quantizer to 1e-2 (the tolerances and reasons of
  ``test_torch_port_pipeline.py``), and the decoded frames equal to the
  decode of the latents; ``sample_mead_frame_torch.sample_frame`` against
  the JAX script's calls the same way;
* ``progressive_sampling_torch.py --cpu`` on a MEAD fixture tree: the
  pickles as the JAX ``scripts/image_metrics.py:load_frames`` reads them,
  each clip reproduced by ``sample_clip`` from its seed;
* ``streaming_pipeline_torch.py --synthetic 3 --batch 2 --cpu``: each
  written clip equal to a direct pipeline call on the same inputs and
  generator, the padded copy not counted; a producer's exception raised
  by the consumer; ``--metrics`` on the fixture tree against the JAX
  PSNR / SSIM of the written frames;
* ``image_metrics_torch.py`` and ``fid_metrics_torch.py`` (``--torch-
  extractor`` and ``--inception-ckpt``) on PNG directories against the
  numbers the JAX scripts print;
* every script refuses to run without a card unless ``--cpu``.
"""
from __future__ import annotations

import os
import pickle
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu.config import build_model as jax_build_model
from dsml_thesis_tpu.diffusion import (make_ddim_schedule as jax_ddim_schedule,
                                       make_video_pipeline as jax_pipeline)
from dsml_thesis_tpu.metrics import psnr as jpsnr
from dsml_thesis_tpu.metrics import ssim as jssim
from dsml_thesis_tpu.metrics import to_unit_range as junit
from dsml_thesis_tpu_torch.config import build_model
from dsml_thesis_tpu_torch.convert import from_jax_params
from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                             make_video_pipeline)
from dsml_thesis_tpu_torch.metrics import inception as tinc
from dsml_thesis_tpu_torch.server import batch_seed
from dsml_thesis_tpu_torch.utils_io import cast_sampling_params
from test_ldm import TINY_MEAD_CFG
from test_torch_port_affectnet import script
from test_torch_port_hygiene import one_torch_thread  # noqa: F401
from test_torch_port_mead_data import SIZE, build_tree
from test_torch_port_pipeline import random_params

FRAMES, STEPS, WINDOW, ADIM = 2, 4, 2, 32


@pytest.fixture(scope="module")
def both():
    """The tiny MEAD model in both packages on one set of weights (a JAX
    tree filled from a numpy seed), and a one-frame clip to pad."""
    cfg = yaml.safe_load(TINY_MEAD_CFG)
    jldm = jax_build_model(cfg["model"])
    batch = {"image": jnp.zeros((1, SIZE, SIZE, 3)),
             "masked_image": jnp.zeros((1, SIZE, SIZE, 3)),
             "identity": jnp.zeros((1, SIZE, SIZE, 3)),
             "class_label": jnp.array([3]),
             "audio": jnp.zeros((1, 2 * WINDOW + 1, ADIM))}
    params = jax.jit(jldm.init_params)(jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(5)
    params = random_params(params, rng)
    tldm = build_model(cfg["model"])
    tldm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)),
                         strict=True)
    tldm.eval()
    f32 = lambda a: a.astype(np.float32)
    example = {   # one frame, two audio rows: padded to FRAMES + WINDOW
        "masked_image": f32(rng.uniform(-1, 1, (1, SIZE, SIZE, 3))),
        "audio": f32(rng.standard_normal((2, ADIM))),
        "identity": f32(rng.uniform(-1, 1, (SIZE, SIZE, 3))),
        "class_label": np.int32(3), "num_frames": np.int32(1),
    }
    x_T = f32(rng.standard_normal((1, FRAMES, 8, 8, 3)))
    return jldm, params, tldm, example, x_T


def _jax_padded(example):
    """The JAX script's padding (progressive_sampling.py:95-107)."""
    masked = example["masked_image"][:FRAMES]
    masked = np.concatenate(
        [masked, np.repeat(masked[-1:], FRAMES - masked.shape[0], 0)])
    audio = example["audio"][:FRAMES + WINDOW]
    audio = np.concatenate(
        [audio, np.repeat(audio[-1:], FRAMES + WINDOW - audio.shape[0], 0)])
    return masked, audio


@pytest.fixture(scope="module")
def jax_latents(both):
    jldm, params, _, example, x_T = both
    masked, audio = _jax_padded(example)
    ddim = jax_ddim_schedule(jldm.schedule, STEPS, eta=0.0)
    pipe = jax.jit(jax_pipeline(jldm, ddim, WINDOW, guidance_scale=2.0,
                                decode=False))
    out = pipe(params, jnp.asarray(masked)[None], jnp.asarray(audio)[None],
               jnp.asarray(example["identity"])[None], jnp.asarray([3]),
               jax.random.PRNGKey(0), jnp.asarray(x_T))
    return np.array(out)[0]


def _torch_clip(tldm, example, x_T, decode):
    mod = script("progressive_sampling_torch")
    ddim = make_ddim_schedule(tldm.schedule, STEPS, eta=0.0)
    pipe = make_video_pipeline(tldm, ddim, WINDOW, guidance_scale=2.0,
                               decode=decode)
    return mod.sample_clip(pipe, example, FRAMES, WINDOW, None,
                           x_T=torch.from_numpy(x_T))


def test_sample_clip_latents_match_jax(both, jax_latents):
    _, _, tldm, example, x_T = both
    got = _torch_clip(tldm, example, x_T, decode=False)
    assert got.shape == jax_latents.shape == (FRAMES, 8, 8, 3)
    assert np.abs(jax_latents).max() > 0.1
    np.testing.assert_allclose(got, jax_latents, atol=1e-3, rtol=0)


def test_sample_clip_frames_match_jax_before_the_quantizer(both, jax_latents):
    jldm, params, tldm, example, x_T = both
    lat = _torch_clip(tldm, example, x_T, decode=False)
    frames = _torch_clip(tldm, example, x_T, decode=True)
    with torch.no_grad():
        dec = torch.stack([tldm.decode_first_stage(
            torch.from_numpy(lat[f:f + 1])).float().clamp(-1, 1)[0]
            for f in range(FRAMES)]).numpy()
        soft = tldm.decode_first_stage(torch.from_numpy(lat),
                                       force_not_quantize=True).numpy()
    assert frames.shape == (FRAMES, SIZE, SIZE, 3)
    assert frames.dtype == np.float32
    np.testing.assert_array_equal(frames, dec)
    want = np.asarray(jldm.decode_first_stage(
        params, jnp.asarray(jax_latents), force_not_quantize=True))
    np.testing.assert_allclose(soft, want, atol=1e-2, rtol=0)


def test_sample_frame_matches_the_jax_scripts_calls(both):
    """``sample_mead_frame_torch.sample_frame`` against the JAX script's
    encode_conditioning / null_conditioning / sample_ddim on one frame
    (latents 1e-3), the clamped window at the clip's start."""
    jldm, params, tldm, example, _ = both
    mod = script("sample_mead_frame_torch")
    rng = np.random.default_rng(9)
    audio = rng.standard_normal((6, ADIM)).astype(np.float32)
    x_T = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    masked, identity = example["masked_image"][0], example["identity"]
    window = mod.audio_window_rows(audio, 1, WINDOW)
    np.testing.assert_array_equal(window, audio[[0, 0, 1, 2, 3]])
    batch = {"image": jnp.zeros((1, SIZE, SIZE, 3)),
             "masked_image": jnp.asarray(masked)[None],
             "identity": jnp.asarray(identity)[None],
             "class_label": jnp.asarray([3], jnp.int32),
             "audio": jnp.asarray(window)[None]}
    cond = jldm.encode_conditioning(params, batch)
    uncond = jldm.null_conditioning(params, batch, batch_size=1)
    want = np.asarray(jldm.sample_ddim(
        params, cond, (1, 8, 8, 3), jax.random.PRNGKey(0), steps=STEPS,
        uncond=uncond, guidance_scale=2.0, x_T=jnp.asarray(x_T)))[0]
    args = (tldm, masked, identity, audio, 1, 3, WINDOW, 8, STEPS, 2.0, None)
    got = mod.sample_frame(*args, x_T=torch.from_numpy(x_T), decode=False)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    img = mod.sample_frame(*args, x_T=torch.from_numpy(x_T))
    assert img.shape == (SIZE, SIZE, 3) and np.abs(img).max() <= 1.0


# --------------------------------------------------------- the scripts


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "tiny-mead.yaml"
    p.write_text(TINY_MEAD_CFG)
    return str(p)


@pytest.fixture(scope="module")
def mead(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mead"))
    tuples, audio_dir = build_tree(root, adim=ADIM)
    return root, tuples, audio_dir


def _model(tiny_yaml, seed=0):
    """The model a script builds from ``--seed`` without ``--ckpt``."""
    cfg = yaml.safe_load(open(tiny_yaml))
    torch.manual_seed(seed)
    return cast_sampling_params(build_model(cfg["model"])).eval()


COMMON = ["--steps", "2", "--size", str(SIZE), "--audio-window",
          str(WINDOW)]


def test_progressive_sampling_pickles_read_in_jax_load_frames(
        tmp_path, tiny_yaml, mead):
    root, tuples, audio_dir = mead
    out = str(tmp_path / "out")
    script("progressive_sampling_torch").main(
        ["--config", tiny_yaml, "--tuples", tuples, "--data-root", root,
         "--audio-dir", audio_dir, "--outdir", out, "--frames", "5",
         "--clips", "2", "--cpu"] + COMMON)
    load_frames = script("image_metrics").load_frames   # the JAX script's
    files = sorted(os.listdir(out))
    assert files == ["M003_angry_level_2_001.pkl",
                     "M003_happy_level_1_002.pkl"]   # the 4-frame clip pads
    from dsml_thesis_tpu_torch.data import MEADTalkingFace

    ds = MEADTalkingFace(tuples, root, audio_dir, audio_window=WINDOW,
                         size=SIZE, mode="sample")
    ldm = _model(tiny_yaml)
    pipe = make_video_pipeline(ldm, make_ddim_schedule(ldm.schedule, 2),
                               WINDOW, guidance_scale=2.0)
    mod = script("progressive_sampling_torch")
    for ci, name in enumerate(files):
        vid = load_frames(os.path.join(out, name))
        with open(os.path.join(out, name), "rb") as f:
            obj = pickle.load(f)
        assert vid.shape == (5, SIZE, SIZE, 3) and vid.dtype == np.float32
        assert np.abs(vid).max() <= 1.0 and np.isfinite(vid).all()
        assert obj["info"]["subj"] == "M003" and obj["identity"].shape == (
            SIZE, SIZE, 3)
        again = mod.sample_clip(pipe, ds[ci], 5, WINDOW,
                                torch.Generator().manual_seed(
                                    batch_seed(0, ci)))
        np.testing.assert_array_equal(vid, again)


def test_sample_mead_frame_writes_the_frame(tmp_path, tiny_yaml):
    """``sample_mead_frame_torch.py --cpu`` on image files and a feature
    pickle: the ``.npy`` (and the PNG) of ``sample_frame`` on the same
    decoded inputs and seed; a window of other than seq_len rows is
    refused."""
    from PIL import Image

    from dsml_thesis_tpu_torch.data import load_image

    rs = np.random.RandomState(0)
    paths = {}
    for name in ("masked", "identity"):
        paths[name] = str(tmp_path / f"{name}.png")
        Image.fromarray((rs.rand(20, 20, 3) * 255).astype(np.uint8)).save(
            paths[name])
    audio = rs.randn(7, ADIM).astype(np.float32)
    with open(tmp_path / "a.pkl", "wb") as f:
        pickle.dump(audio, f)
    mod = script("sample_mead_frame_torch")
    argv = ["--config", tiny_yaml, "--masked", paths["masked"], "--identity",
            paths["identity"], "--audio-pkl", str(tmp_path / "a.pkl"),
            "--frame-idx", "6", "--class-label", "2", "--steps", "2",
            "--size", str(SIZE), "--out", str(tmp_path / "f.png"), "--cpu"]
    mod.main(argv)
    got = np.load(tmp_path / "f.npy")
    assert os.path.exists(tmp_path / "f.png")
    want = mod.sample_frame(
        _model(tiny_yaml), load_image(paths["masked"], SIZE),
        load_image(paths["identity"], SIZE), audio, 6, 2, WINDOW, 8, 2, 2.0,
        torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit, match="seq_len=5"):
        mod.main(argv + ["--audio-window", "3"])


def _stream(tiny_yaml, out, extra=()):
    return script("streaming_pipeline_torch").main(
        ["--config", tiny_yaml, "--synthetic", "3", "--batch", "2",
         "--frames", str(FRAMES), "--outdir", out, "--cpu"] + COMMON
        + list(extra))


def test_streaming_batches_equal_direct_pipeline_calls(tmp_path, tiny_yaml):
    mod = script("streaming_pipeline_torch")
    out = str(tmp_path / "out")
    summary = _stream(tiny_yaml, out)
    assert summary["batches"] == 2
    assert summary["frames"] == 3 * FRAMES   # the padded copy not counted
    assert summary["steady_frames_per_s"] > 0
    assert len(summary["lines"]) == 2 and "steady" in summary["lines"][1]
    names = [f"synth{i}_neutral_level_1_001.npy" for i in range(3)]
    assert sorted(os.listdir(out)) == names
    ldm = _model(tiny_yaml)
    pipe = make_video_pipeline(ldm, make_ddim_schedule(ldm.schedule, 2),
                               WINDOW, guidance_scale=2.0)
    ds = mod._SyntheticClips(3, SIZE, FRAMES, WINDOW, ADIM)
    batches, n_real = mod.batch_plan(len(ds), 2)
    assert batches == [[0, 1], [2, 2]] and n_real == 1
    for bi, idxs in enumerate(batches):
        masked, feats, ids, labels, _, _ = mod.prepare(ds, idxs, FRAMES,
                                                       WINDOW)
        t = torch.from_numpy
        want = pipe(t(masked), t(feats), t(ids), t(labels),
                    torch.Generator().manual_seed(batch_seed(0, bi))).numpy()
        for i, ci in enumerate(idxs[:2 if bi == 0 else n_real]):
            np.testing.assert_array_equal(
                np.load(os.path.join(out, names[ci])), want[i])


def test_streaming_raises_the_producers_exception(tmp_path, tiny_yaml,
                                                  monkeypatch):
    mod = script("streaming_pipeline_torch")
    real = mod._SyntheticClips.__getitem__

    def broken(self, i):
        if i == 2:
            raise RuntimeError("clip 2 unreadable")
        return real(self, i)

    monkeypatch.setattr(mod._SyntheticClips, "__getitem__", broken)
    with pytest.raises(RuntimeError, match="clip 2 unreadable"):
        mod.main(["--config", tiny_yaml, "--synthetic", "3", "--batch", "2",
                  "--frames", str(FRAMES), "--cpu"] + COMMON)


def test_streaming_metrics_match_jax(tmp_path, tiny_yaml, mead, capsys):
    """``--metrics`` on the fixture tree: each batch's line scores its
    first clip's written frames against the clip's frames, as the JAX
    metrics score them."""
    root, tuples, audio_dir = mead
    out = str(tmp_path / "out")
    summary = script("streaming_pipeline_torch").main(
        ["--config", tiny_yaml, "--tuples", tuples, "--data-root", root,
         "--audio-dir", audio_dir, "--outdir", out, "--batch", "2",
         "--frames", "3", "--metrics", "--cpu"] + COMMON)
    from dsml_thesis_tpu_torch.data import MEADTalkingFace, load_images

    ds = MEADTalkingFace(tuples, root, audio_dir, audio_window=WINDOW,
                         size=SIZE, mode="sample")
    assert summary["frames"] == 3 * 3
    for bi, line in enumerate(summary["lines"]):
        ex = ds[2 * bi]
        name = f"{ex['subj']}_{ex['human_label']}_{ex['lvl']}_{ex['nbr']}"
        clip = ds._clip_dir(ex["subj"], ex["human_label"], ex["lvl"],
                            ex["nbr"])
        gt = load_images([os.path.join(clip, f)
                          for f in sorted(os.listdir(clip))[:3]], SIZE)
        a = junit(np.load(os.path.join(out, f"{name}.npy")))
        b = junit(gt)
        p = float(jnp.mean(jpsnr(a, b)))
        s = float(jnp.mean(jssim(a, b)))
        got = re.search(r"psnr=([-\d.]+) ssim=([-\d.]+)", line)
        assert got, line
        assert abs(float(got.group(1)) - p) <= 0.006, (line, p)
        assert abs(float(got.group(2)) - s) <= 0.0006, (line, s)


def _pngs(d, n, seed, size=SIZE):
    from PIL import Image

    rs = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        Image.fromarray((rs.rand(size, size, 3) * 255).astype(np.uint8)).save(
            os.path.join(d, f"{i:03d}.png"))


def _numbers(text):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", text)]


def _run_jax_script(name, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    script(name).main()
    return capsys.readouterr().out


def test_image_metrics_match_the_jax_script(tmp_path, monkeypatch, capsys):
    gen, gt = tmp_path / "gen", tmp_path / "gt"
    for i, name in enumerate(["a", "b"]):
        _pngs(str(gen / name), 3 + i, seed=i)
        _pngs(str(gt / name), 4, seed=10 + i)
    _pngs(str(gen / "c"), 2, seed=7)   # no ground truth: skipped
    argv = ["--gen", str(gen), "--gt", str(gt)]
    want = _run_jax_script("image_metrics", argv + [
        "--log", str(tmp_path / "jax.txt")], monkeypatch, capsys)
    log = str(tmp_path / "port.txt")
    scores = script("image_metrics_torch").main(argv + ["--log", log,
                                                        "--cpu"])
    got = capsys.readouterr().out
    assert sorted(scores) == ["a", "b"] and "skip c" in got
    assert [ln.split()[0] for ln in got.splitlines()] == \
        [ln.split()[0] for ln in want.splitlines()]
    np.testing.assert_allclose(_numbers(got), _numbers(want), atol=1e-3)
    assert open(log).read().splitlines()[-1].startswith("MEAN psnr=")


@pytest.fixture(scope="module")
def fid_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fid")
    _pngs(str(root / "gen"), 6, seed=20, size=40)
    _pngs(str(root / "ref"), 5, seed=21, size=40)
    return str(root / "gen"), str(root / "ref")


def test_fid_metrics_with_a_torch_extractor_match_the_jax_script(
        tmp_path, fid_dirs, monkeypatch, capsys):
    torch.manual_seed(0)
    ext = torch.nn.Sequential(torch.nn.Conv2d(3, 6, 3, stride=4),
                              torch.nn.AdaptiveAvgPool2d(2),
                              torch.nn.Flatten())
    path = str(tmp_path / "extractor.pth")
    torch.save(ext, path)
    argv = ["--gen", fid_dirs[0], "--ref", fid_dirs[1], "--torch-extractor",
            path, "--size", "32", "--batch", "4", "--isc"]
    want = _run_jax_script("fid_metrics", argv, monkeypatch, capsys)
    out = script("fid_metrics_torch").main(argv + ["--cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert set(out) == {"fid", "kid", "prc", "is"}


def test_fid_metrics_with_the_inception_match_the_jax_script(
        tmp_path, fid_dirs, monkeypatch, capsys):
    """A random pt_inception-layout state_dict whose features depend on the
    image (``chip_smoke.py``'s): FID, KID and a PRC between 0 and 1 (k = 2
    among 5 and 6 images) as the JAX script prints them. IS is 1 at this
    count (10 splits of at most one image); its math is held in
    ``test_torch_port_metrics.py``."""
    import chip_smoke

    path = str(tmp_path / "pt_inception.pth")
    torch.save(chip_smoke.random_inception_state_dict(tinc, 40), path)
    argv = ["--gen", fid_dirs[0], "--ref", fid_dirs[1], "--inception-ckpt",
            path, "--size", "40", "--batch", "4", "--prc-k", "2"]
    want = _run_jax_script("fid_metrics", argv, monkeypatch, capsys)
    out = script("fid_metrics_torch").main(argv + ["--cpu"])
    got = capsys.readouterr().out
    assert out["fid"] > 1.0 and out["kid"][0] > 0
    assert 0.0 < out["prc"][0] < 1.0
    assert [ln.split(":")[0] for ln in got.splitlines()] == \
        ["FID", "KID", "PRC", "IS"]
    g, w = _numbers(got), _numbers(want)
    np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("name,argv", [
    ("progressive_sampling_torch", ["--config", "c", "--tuples", "t",
                                    "--data-root", "d", "--audio-dir", "a",
                                    "--outdir", "o"]),
    ("sample_mead_frame_torch", ["--config", "c", "--masked", "m",
                                 "--identity", "i", "--audio-pkl", "a",
                                 "--out", "o.png"]),
    ("streaming_pipeline_torch", ["--config", "c", "--synthetic", "2"]),
    ("image_metrics_torch", ["--gen", "g", "--gt", "t"]),
    ("fid_metrics_torch", ["--gen", "g", "--ref", "r", "--torch-extractor",
                           "e.pt"]),
])
def test_scripts_refuse_to_run_without_a_card(name, argv):
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match="no CUDA device"):
        script(name).main(argv)


# ----------------------------------------- chip_smoke.py's video-eval counts


def _meta(cfg_text):
    with torch.device("meta"):
        return build_model(yaml.safe_load(cfg_text)["model"])


def test_video_eval_launches_are_the_cpu_runs_wrapper_calls(
        tmp_path, tiny_yaml, monkeypatch):
    """The three calls of the video-eval phase on the tiny model, with
    spies on the kernel wrappers, against the counts ``expected_launches``
    takes from the model's blocks (a streaming run of two batches, a clip,
    a frame)."""
    import chip_smoke
    from test_torch_port_mead128 import _wrapper_spy

    meta = _meta(TINY_MEAD_CFG)
    B, F, S = 2, FRAMES, 2
    with chip_smoke.flags():
        calls = _wrapper_spy(monkeypatch)
        _stream(tiny_yaml, str(tmp_path / "out"), ["--synthetic", "4"])
        stream = dict(calls)
        ldm = _model(tiny_yaml)
        pipe = make_video_pipeline(ldm, make_ddim_schedule(ldm.schedule, S),
                                   WINDOW, guidance_scale=2.0)
        ex = script("streaming_pipeline_torch")._SyntheticClips(
            1, SIZE, F, WINDOW, ADIM)[0]
        calls.update(dict.fromkeys(calls, 0))
        script("progressive_sampling_torch").sample_clip(
            pipe, ex, F, WINDOW, torch.Generator().manual_seed(0))
        clip = dict(calls)
        calls.update(dict.fromkeys(calls, 0))
        script("sample_mead_frame_torch").sample_frame(
            ldm, ex["masked_image"][0], ex["identity"], ex["audio"], 1, 0,
            WINDOW, 8, S, 2.0, torch.Generator().manual_seed(0))
        frame = dict(calls)
    nz = lambda d: {k: v for k, v in d.items() if v}
    assert nz(stream) == nz(chip_smoke.expected_launches(
        meta, {}, unet_calls=2 * F * S, encodes=2 * 2, decodes=2 * F))
    assert nz(clip) == nz(chip_smoke.expected_launches(
        meta, {}, unet_calls=F * S, encodes=2, decodes=F))
    # the null branch encodes the masked and identity frames again
    assert nz(frame) == nz(chip_smoke.expected_launches(
        meta, {}, unet_calls=S, encodes=4, decodes=1))
    assert stream["flash_attention_fproj"] > 0 and stream["flash_attention"]


def test_video_eval_counts_of_the_real_yaml():
    """mead-128-ldm-f4.yaml on the meta device: a streaming run of two
    batches of 2 clips x 4 frames at DDIM-10 is 80 UNet calls of 16 row-1
    launches, 4 encodes of 3 and 8 decodes of 4 row-2 launches."""
    import chip_smoke

    cfg = open(chip_smoke.CONFIG_128).read()
    ldm = _meta(cfg)
    n = chip_smoke.VIDEO_CLIPS // chip_smoke.VIDEO_BATCH
    calls = n * chip_smoke.VIDEO_FRAMES * chip_smoke.VIDEO_STEPS
    expect = chip_smoke.expected_launches(
        ldm, {}, unet_calls=calls, encodes=2 * n,
        decodes=n * chip_smoke.VIDEO_FRAMES)
    assert (n, calls) == (2, 80)
    assert {k: v for k, v in expect.items() if v} == {
        "flash_attention_fproj": 1280, "flash_attention": 44}
