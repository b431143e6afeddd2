"""The DPM-Solver++ serving mode and split-input tiling of the port, as the
serving slice uses them, against the JAX package on the CPU in fp32: one set
of weights (a JAX tree filled from a numpy seed, carried over by
``from_jax_params``), one set of numpy inputs and injected x_T.

Tolerances, as for the DDIM pipeline (``test_torch_port_pipeline.py``):
latents 1e-3 after 2 frames x 3 DPM-Solver++ evaluations with guidance 2.0
(fp32 sums in another order, compounded through six UNet calls and the
identity carry); decoded frames 1e-2 before the quantizer (a latent near a
code boundary may flip codes under a 1e-3 difference). The tiled model
calls: 1e-4 of each output's maximum (one encode, decode or UNet call over
patches, fp32).
"""
import copy
import io
import os
import socket
import subprocess
import sys
import time
import urllib.request

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
                                             make_video_pipeline,
                                             progressive_video_sample)
from test_ldm import TINY_MEAD_CFG
from test_torch_port_hygiene import one_torch_thread  # noqa: F401
from test_torch_port_pipeline import random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F, EVALS, WINDOW = 2, 2, 3, 2
SPLIT = {"ks": [4, 4], "stride": [2, 2], "vqf": 2}


def _cfg(split=None):
    cfg = yaml.safe_load(TINY_MEAD_CFG)
    if split is not None:
        cfg["model"]["params"]["split_input_params"] = copy.deepcopy(split)
    return cfg


@pytest.fixture(scope="module")
def both():
    """The tiny MEAD model in both packages with one set of weights, its
    tiled twins (the same weights with ``split_input_params``), inputs."""
    jldm = jax_build_model(_cfg()["model"])
    batch = {
        "image": jnp.zeros((2, 16, 16, 3)),
        "masked_image": jnp.zeros((2, 16, 16, 3)),
        "identity": jnp.zeros((2, 16, 16, 3)),
        "class_label": jnp.array([1, 5]),
        "audio": jnp.zeros((2, 5, 32)),
    }
    params = jax.jit(jldm.init_params)(jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(1)
    params = random_params(params, rng)
    state = from_jax_params(jax.tree.map(np.asarray, params))
    tldm = build_model(_cfg()["model"])
    tldm.load_state_dict(state, strict=True)
    tiled = build_model(_cfg(SPLIT)["model"])
    tiled.load_state_dict(state, strict=True)
    jtiled = jax_build_model(_cfg(SPLIT)["model"])
    inputs = {
        "masked_frames": rng.uniform(-1, 1, (B, F, 16, 16, 3)),
        "audio": rng.standard_normal((B, F + WINDOW, 32)),
        "identity": rng.uniform(-1, 1, (B, 16, 16, 3)),
        "x_T": rng.standard_normal((B, F, 8, 8, 3)),
    }
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    inputs["class_label"] = np.array([1, 5], np.int32)
    return {"jax": jldm, "params": params, "torch": tldm.eval(),
            "jax_tiled": jtiled, "torch_tiled": tiled.eval(),
            "inputs": inputs}


def _jax_latents(jldm, params, inputs, order=2, evals=EVALS):
    ddim = jax_ddim_schedule(jldm.schedule, 4, eta=0.0)
    pipe = jax_pipeline(jldm, ddim, WINDOW, guidance_scale=2.0, decode=False,
                        sampler="dpm", sampler_steps=evals,
                        sampler_order=order)
    out = jax.jit(pipe)(
        params, jnp.asarray(inputs["masked_frames"]),
        jnp.asarray(inputs["audio"]), jnp.asarray(inputs["identity"]),
        jnp.asarray(inputs["class_label"]), jax.random.PRNGKey(0),
        jnp.asarray(inputs["x_T"]))
    return np.array(out)


def _torch_latents(tldm, inputs, order=2, evals=EVALS):
    ddim = make_ddim_schedule(tldm.schedule, 4, eta=0.0)
    pipe = make_video_pipeline(tldm, ddim, WINDOW, guidance_scale=2.0,
                               decode=False, sampler="dpm",
                               sampler_steps=evals, sampler_order=order)
    t = lambda k: torch.from_numpy(inputs[k])
    return pipe(t("masked_frames"), t("audio"), t("identity"),
                t("class_label").long(), None, x_T=t("x_T")).numpy()


@pytest.fixture(scope="module")
def dedup_latents(both):
    """Latents of both pipelines with the guidance-pair dedup on (the
    default), shared by the latent and frame comparisons."""
    return (_jax_latents(both["jax"], both["params"], both["inputs"]),
            _torch_latents(both["torch"], both["inputs"]))


def test_dpm_pipeline_latents_match_jax(dedup_latents):
    want, got = dedup_latents
    assert got.shape == want.shape == (B, F, 8, 8, 3)
    assert np.isfinite(got).all()
    assert np.abs(want).max() > 0.1  # a comparison of zeros proves nothing
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_dpm_pipeline_latents_match_jax_without_dedup(both, monkeypatch):
    """DSML_CFG_DEDUP=0: the batch-doubled guidance call on both sides."""
    monkeypatch.setenv("DSML_CFG_DEDUP", "0")
    want = _jax_latents(both["jax"], both["params"], both["inputs"], order=3)
    got = _torch_latents(both["torch"], both["inputs"], order=3)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_dpm_pipeline_frames_match_jax_before_the_quantizer(both,
                                                            dedup_latents):
    lat_j, lat_t = dedup_latents
    jldm, params, tldm = both["jax"], both["params"], both["torch"]
    decode = jax.jit(lambda p, z: jldm.decode_first_stage(
        p, z, force_not_quantize=True))
    for f in range(F):
        want = np.asarray(decode(params, jnp.asarray(lat_j[:, f])))
        with torch.no_grad():
            got = tldm.decode_first_stage(torch.from_numpy(lat_t[:, f]),
                                          force_not_quantize=True).numpy()
        assert got.shape == want.shape == (B, 16, 16, 3)
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)


def test_dpm_chain_makes_one_unet_call_an_evaluation(both):
    """A frame's DPM chain calls the UNet once per evaluation, with a float
    timestep, the guidance pair in one call."""
    tldm, inputs = both["torch"], both["inputs"]
    calls = []
    real = tldm.apply_model

    def spy(x, t, cond, cfg_pairs=False):
        calls.append((t.dtype, cfg_pairs, x.shape[0]))
        return real(x, t, cond, cfg_pairs=cfg_pairs)

    tldm.apply_model = spy
    try:
        _torch_latents(tldm, inputs)
    finally:
        del tldm.apply_model
    assert calls == [(torch.float32, True, B)] * (F * EVALS)


def test_dpm_sampler_arguments_raise_like_jax(both):
    tldm, inputs = both["torch"], both["inputs"]
    ddim = make_ddim_schedule(tldm.schedule, 2, eta=0.0)
    t = lambda k: torch.from_numpy(inputs[k])
    args = (t("masked_frames"), t("audio"), t("identity"),
            t("class_label").long(), None)
    for kw, match in (({"sampler": "euler"}, "unknown sampler"),
                      ({"sampler": "dpm", "sampler_order": 4},
                       "sampler_order")):
        with pytest.raises(ValueError, match=match):
            make_video_pipeline(tldm, ddim, WINDOW, guidance_scale=2.0,
                                decode=False, **kw)(*args, x_T=t("x_T"))
    lat = torch.zeros(B, F, 8, 8, 3)
    with pytest.raises(ValueError, match="DiffusionSchedule"):
        progressive_video_sample(ddim, None, lat, torch.zeros(B, F, 1, 48),
                                 lat[:, 0], x_T=lat, sampler="dpm")


# --------------------------------------------------------------------------
# split-input tiling on the LatentDiffusion
# --------------------------------------------------------------------------

def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-3
    assert float(np.abs(got - want).max()) <= rel * scale


def test_tiled_encode_decode_and_apply_model_match_jax(both):
    jt, tt, params = both["jax_tiled"], both["torch_tiled"], both["params"]
    rng = np.random.default_rng(7)
    img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    cc = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    ctx = rng.standard_normal((2, 1, 48)).astype(np.float32)
    t = np.array([3, 71], np.int32)
    want_enc = jax.jit(jt.encode_first_stage)(params, jnp.asarray(img))
    want_dec = jax.jit(lambda p, v: jt.decode_first_stage(
        p, v, force_not_quantize=True))(params, jnp.asarray(z))
    want_eps = jax.jit(lambda p, x, tt_, c, k: jt.apply_model(
        p, x, tt_, {"crossattn": c, "concat": k}))(
        params, jnp.asarray(z), jnp.asarray(t), jnp.asarray(ctx),
        jnp.asarray(cc))
    with torch.no_grad():
        got_enc = tt.encode_first_stage(torch.from_numpy(img))
        got_dec = tt.decode_first_stage(torch.from_numpy(z),
                                        force_not_quantize=True)
        got_eps = tt.apply_model(torch.from_numpy(z),
                                 torch.from_numpy(t).long(),
                                 {"crossattn": torch.from_numpy(ctx),
                                  "concat": torch.from_numpy(cc)})
        plain_eps = both["torch"].apply_model(
            torch.from_numpy(z), torch.from_numpy(t).long(),
            {"crossattn": torch.from_numpy(ctx),
             "concat": torch.from_numpy(cc)})
    _close(got_enc, want_enc)
    _close(got_dec, want_dec)
    _close(got_eps, want_eps)
    assert got_enc.shape == (2, 8, 8, 3) and got_dec.shape == (2, 16, 16, 3)
    # the blend of 4 x 4 patches is not the whole-frame UNet call
    assert float((got_eps - plain_eps).abs().max()) > 1e-3
    pair = {"crossattn": torch.zeros(4, 1, 48), "concat": torch.zeros(2, 8, 8, 6)}
    with pytest.raises(NotImplementedError, match="split_input_params"):
        tt.apply_model(torch.zeros(2, 8, 8, 3), torch.zeros(2).long(), pair,
                       cfg_pairs=True)
    with pytest.raises(NotImplementedError, match="split_input_params"):
        jt.apply_model(params, jnp.zeros((2, 8, 8, 3)), jnp.zeros(2, jnp.int32),
                       {"crossattn": jnp.zeros((4, 1, 48)),
                        "concat": jnp.zeros((2, 8, 8, 6))}, cfg_pairs=True)


def test_tiled_pipeline_drops_the_pair_dedup(both):
    """With tiling the pipeline batch-doubles the guidance pair whatever
    DSML_CFG_DEDUP says (the dedup does not tile), as the JAX pipeline does;
    the tiled call itself is held against JAX above."""
    tt, inputs = both["torch_tiled"], both["inputs"]
    calls = []
    real = tt.apply_model

    def spy(x, t, cond, cfg_pairs=False):
        calls.append((cfg_pairs, x.shape[0]))
        return real(x, t, cond, cfg_pairs=cfg_pairs)

    tt.apply_model = spy
    try:
        out = _torch_latents(tt, inputs, evals=2)
    finally:
        del tt.apply_model
    assert calls == [(False, 2 * B)] * (F * 2)
    assert np.isfinite(out).all() and out.shape == (B, F, 8, 8, 3)


# --------------------------------------------------------------------------
# scripts/serve_torch.py --sampler dpm
# --------------------------------------------------------------------------

def test_serve_torch_serves_with_the_dpm_sampler(tmp_path):
    """The script on the CPU with the tiny config: warm-up batch, then one
    HTTP request answered through the DPM-Solver++ chain."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_MEAD_CFG)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "serve_torch.py"),
         "--config", str(cfg), "--device", "cpu", "--batch", "1",
         "--frames", "1", "--audio-window", "2", "--host", "127.0.0.1",
         "--port", str(port), "--max-wait-ms", "1", "--sampler", "dpm",
         "--sampler-steps", "3", "--sampler-order", "3"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        lines = []
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("# listening"):
                break
        assert any("DPM-Solver++ o3 3 evals" in ln for ln in lines), lines
        assert lines and lines[-1].startswith("# listening"), lines
        rng = np.random.default_rng(0)
        buf = io.BytesIO()
        np.savez(buf, masked_frames=rng.uniform(-1, 1, (1, 16, 16, 3)
                                                ).astype(np.float32),
                 audio=rng.standard_normal((3, 32)).astype(np.float32),
                 identity=rng.uniform(-1, 1, (16, 16, 3)).astype(np.float32),
                 class_label=np.int32(2))
        req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            frames = np.load(io.BytesIO(resp.read()))["frames"]
        assert frames.shape == (1, 16, 16, 3)
        assert np.isfinite(frames).all() and np.abs(frames).max() <= 1.0
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
