"""The talking-face audio and lip-reading entry points of the port on the
CPU.

* ``scripts/train_torch.py --cpu`` on the tiny tune YAML of
  ``tests/test_finetune_cli.py`` over a ``MEADBase5`` fixture tree with an
  LRS3-layout ``model.pth`` written from random weights: the
  ``FinetuneTrainer``, two steps, ``val/lr_loss`` finite, checkpoints, the
  lipreader and the first stage as loaded and outside the optimizer; without
  the checkpoint ``val/l2_loss`` alone; a synthetic node that carries
  ``landmarks`` (the data of the card's smoke run).
* ``scripts/mead_audio_features_torch.py --cpu`` on a fixture tree (48 kHz
  stereo wavs, frame directories of empty ``*.jpg`` names): the pickles'
  names, shapes and dtype, and their rows against the JAX ``Wav2Vec2`` on the
  same normalized audio (1e-5 of the maximum) for a ``base`` snapshot, a
  ``bundle`` (CTC) snapshot and ``--seed`` weights; the refusals.
"""
from __future__ import annotations

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu.models import wav2vec2 as jw
from dsml_thesis_tpu_torch.convert import to_jax_tree
from dsml_thesis_tpu_torch.models import lipreader as tlr
from dsml_thesis_tpu_torch.models import wav2vec2 as tw
from test_finetune_cli import TUNE_CFG
from test_torch_port_affectnet import script
from test_torch_port_lipread import MOUTH
from test_torch_port_mead_data import build_tree
from test_torch_port_wav2vec2 import TINY, hf_state_dict, write_wav
from test_torch_port_hygiene import one_torch_thread  # noqa: F401


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _tune_yaml(tmp_path, ckpt=None, data=None):
    root = str(tmp_path / "mead")
    tuples, audio = build_tree(root, adim=32)
    cfg = yaml.safe_load(TUNE_CFG.format(tuples=tuples, root=root,
                                         audio=audio))
    cfg["model"]["params"].update(MOUTH, decode_steps=2)
    cfg["lightning"]["trainer"]["max_epochs"] = 2   # a step an epoch here
    if ckpt is not None:
        cfg["model"]["params"]["lipread_ckpt"] = ckpt
    if data is not None:
        cfg["data"]["params"].update(train=data, validation=data)
    path = tmp_path / "tune.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _lrs3(tmp_path):
    torch.manual_seed(3)
    front = tlr.LipreaderFrontend()
    path = str(tmp_path / "model.pth")
    torch.save(tlr.reference_state_dict(front), path)
    return path, front


def _train(tmp_path, config, steps=2):
    return script("train_torch").main(
        ["--base", config, "-t", "--max-steps", str(steps), "--cpu",
         "--logdir", str(tmp_path / "logs"), "--seed", "0", "--log-every",
         "1", "--no-test", "--scale_lr", "false"])


def test_tune_trains_on_mead_clips_with_the_lipreader(tmp_path):
    ckpt, front = _lrs3(tmp_path)
    trainer = _train(tmp_path, _tune_yaml(tmp_path, ckpt=ckpt))
    assert type(trainer).__name__ == "FinetuneTrainer"
    state, ft = trainer._state, trainer.finetune
    assert state.step == 2
    assert {n.split(".")[0] for n in state.names} == {"unet", "cond"}
    reader = ft.lipreader
    assert isinstance(reader, tlr.LipreaderFeatures) and not reader.training
    in_opt = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert not any(id(p) in in_opt or p.requires_grad
                   for p in reader.parameters())
    for n, p in front.state_dict().items():
        assert torch.equal(reader.tower.state_dict()[n], p), n
    recs = _records(trainer.logdir)
    train = [r for r in recs if r["split"] == "train"]
    assert len(train) == 2 and all(r["train/lr_loss"] > 0 for r in train)
    val = [r for r in recs if r["split"] == "val"]
    assert val and all(np.isfinite(r["val/lr_loss"]) and
                       np.isfinite(r["val/l2_loss"]) for r in val)
    assert np.isfinite(val[-1]["val_loss_ema"])
    ckpts = os.listdir(os.path.join(trainer.logdir, "checkpoints"))
    assert "last" in ckpts and any(c.startswith("step=") for c in ckpts)
    saved = torch.load(os.path.join(trainer.logdir, "checkpoints", "last",
                                    "state.pt"), weights_only=True)
    assert not any(k.startswith("lipreader") for k in saved["model"])


def test_tune_without_a_checkpoint_is_l2_only(tmp_path):
    trainer = _train(tmp_path, _tune_yaml(tmp_path), steps=1)
    assert trainer.finetune.lipreader is None
    val = [r for r in _records(trainer.logdir) if r["split"] == "val"]
    assert val and "val/l2_loss" in val[-1] and "val/lr_loss" not in val[-1]


def test_tune_on_a_synthetic_node_with_landmarks(tmp_path):
    """The data of the card's smoke run: synthetic tensors whose spec adds
    ``landmarks`` [68, 2]; the lr term is live."""
    ckpt, _ = _lrs3(tmp_path)
    node = {"target": "dsml_thesis_tpu_torch.data.SyntheticDataset",
            "params": {"length": 4, "spec": {
                "image": [[16, 16, 3], "float32"],
                "masked_image": [[16, 16, 3], "float32"],
                "identity": [[16, 16, 3], "float32"],
                "class_label": [[], "int32"],
                "audio": [[5, 32], "float32"],
                "landmarks": [[68, 2], "float32"]}}}
    trainer = _train(tmp_path, _tune_yaml(tmp_path, ckpt=ckpt, data=node),
                     steps=1)
    train = [r for r in _records(trainer.logdir) if r["split"] == "train"]
    assert len(train) == 1 and train[0]["train/lr_loss"] > 0


# --------------------------------------------------------------------------
# the audio features script
# --------------------------------------------------------------------------

FRAMES = {"001": 7, "002": 11}


def audio_tree(root, rate=48000, seconds=0.3):
    """Two clips of 48 kHz stereo 16-bit audio and frame directories of
    empty ``*.jpg`` names; returns the tuples path."""
    tuples = []
    for i, (clip, n) in enumerate(sorted(FRAMES.items())):
        subj, emo, lvl = "M005", "fear", "level_3"
        wav_dir = os.path.join(root, subj, "audio", emo, lvl)
        frame_dir = os.path.join(root, subj, "video", "front", emo, lvl, clip)
        os.makedirs(wav_dir, exist_ok=True)
        os.makedirs(frame_dir, exist_ok=True)
        write_wav(os.path.join(wav_dir, f"{clip}.wav"), rate,
                  seconds + 0.05 * i, channels=2, seed=i)
        for k in range(n):
            open(os.path.join(frame_dir, f"{k:03d}.jpg"), "w").close()
        tuples.append((subj, emo, lvl, clip))
    path = os.path.join(root, "tuples.pkl")
    with open(path, "wb") as f:
        pickle.dump(tuples, f)
    return path


def snapshot(d, ctc=None, weights=True):
    """A local snapshot directory: config.json (a tiny wav2vec2), and
    pytorch_model.bin in the ``transformers`` naming."""
    os.makedirs(d, exist_ok=True)
    cfg = tw.Wav2Vec2Config(**TINY, ctc_vocab=ctc)
    hf = {"vocab_size": ctc or 32, "conv_dim": list(cfg.conv_dim),
          "conv_kernel": list(cfg.conv_kernel),
          "conv_stride": list(cfg.conv_stride), "conv_bias": False,
          "hidden_size": cfg.hidden_size,
          "num_hidden_layers": cfg.num_layers,
          "num_attention_heads": cfg.num_heads,
          "intermediate_size": cfg.intermediate_size,
          "num_conv_pos_embeddings": cfg.num_conv_pos_embeddings,
          "num_conv_pos_embedding_groups": cfg.num_conv_pos_embedding_groups,
          "do_stable_layer_norm": False, "feat_extract_norm": "group"}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)
    sd = None
    if weights:
        sd = hf_state_dict(cfg, seed=11, ctc_prefix=ctc is not None)
        torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    return cfg, sd


def _normalized(path, features_script):
    wav = features_script.load_wav_16k(path)
    return (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)


def _run_features(tmp_path, variant, extra):
    root = str(tmp_path / "tree")
    tuples = audio_tree(root)
    out = str(tmp_path / "feats")
    mod = script("mead_audio_features_torch")
    got = mod.main(["--tuples", tuples, "--audio-root", root,
                    "--frames-root", root, "--outdir", out, "--variant",
                    variant, "--cpu", *extra])
    return root, out, mod, got


@pytest.mark.parametrize("variant", ["base", "bundle", "seed"])
def test_audio_features_match_jax(tmp_path, variant):
    """One pickle a clip, [frames, D] float32, named
    ``<subj>_<emo>_<lvl>_<clip>.pkl``; rows against JAX ``Wav2Vec2`` (the
    JAX converter's weights, or the seeded model's through
    ``to_jax_tree``): ``base`` resamples the CNN features before the
    encoder, ``bundle`` the CTC logits after the model."""
    ctc = 10 if variant == "bundle" else None
    cfg, sd = snapshot(str(tmp_path / "snap"), ctc=ctc,
                       weights=variant != "seed")
    extra = ["--model", str(tmp_path / "snap")]
    if variant == "seed":
        extra += ["--seed", "4"]
    root, out, mod, got = _run_features(
        tmp_path, "bundle" if ctc else "base", extra)
    jcfg = jw.Wav2Vec2Config(**TINY, ctc_vocab=ctc)
    if sd is not None:
        params = jw.convert_wav2vec2(sd, jcfg)
    else:
        params = to_jax_tree(mod.build_model("base", str(tmp_path / "snap"),
                                             seed=4)[0])
    model = jw.Wav2Vec2(jcfg)
    assert sorted(os.listdir(out)) == [f"M005_fear_level_3_{c}.pkl"
                                       for c in sorted(FRAMES)]
    for clip, n in FRAMES.items():
        name = f"M005_fear_level_3_{clip}"
        with open(os.path.join(out, f"{name}.pkl"), "rb") as f:
            feats = pickle.load(f)
        assert feats.dtype == np.float32
        assert feats.shape == (n, ctc or TINY["hidden_size"])
        np.testing.assert_array_equal(feats, got[name])
        wav = _normalized(os.path.join(root, "M005", "audio", "fear",
                                       "level_3", f"{clip}.wav"), mod)
        x = jnp.asarray(wav)[None]
        if ctc:
            want = jw.interp_align_corners(
                model.apply({"params": params}, x), n)[0]
        else:
            want = model.apply({"params": params}, x, num_frames=n)[0]
        np.testing.assert_allclose(feats, np.asarray(want), rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_audio_features_refusals(tmp_path):
    """Neither weights nor a seed: an error; no card without ``--cpu``: an
    error (the script never falls back to the CPU)."""
    mod = script("mead_audio_features_torch")
    base = ["--tuples", "t", "--audio-root", "a", "--frames-root", "f",
            "--outdir", str(tmp_path / "o")]
    with pytest.raises(SystemExit):
        mod.main(base + ["--cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            mod.main(base + ["--seed", "0"])
