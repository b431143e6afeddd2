"""The MEAD talking-face clips of the port (``MEADTalkingFace``, the
reference's ``MEADBase3`` / ``MEADBase5``) against the JAX package's, on a
fixture tree the test writes (JPEG frames of varied sizes, landmark
pickles, one of them empty, per-frame audio-feature pickles) with
``DSML_NATIVE_IMAGE`` unset, so that both decode with Pillow.

* every key of ``train`` items (with and without landmarks and random
  crops, two epochs) and of ``sample`` items (with and without
  ``force_align``) equals JAX's exactly, the ``_item_rng`` stream
  included;
* the mean-landmark fallback of an empty landmark pickle (with and without
  ``mean_landmarks.pkl``), a missing pickle raises, an empty audio pickle
  and a frame count that disagrees with the audio rows raise;
* the config's ``taming.data.custom.MEADBase3`` / ``MEADBase5`` targets and
  the loader's batches; ``DSML_NATIVE_IMAGE=1`` raises where the native
  decoder cannot be built.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import pytest

from dsml_thesis_tpu.data import datasets as JD
from dsml_thesis_tpu_torch.config import instantiate_from_config
from dsml_thesis_tpu_torch.data import datasets as TD
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

SIZE = 16
CLIPS = (("M003", "angry", "level_2", "001", 6),
         ("M003", "happy", "level_1", "002", 4),
         ("W011", "sad", "level_3", "001", 9))


def build_tree(root, adim=24, empty_landmark=True, mean_landmarks=False,
               seed=0):
    """Frames (JPEG, a little larger than SIZE, so that crops move), a
    landmark pickle a frame (one empty), the audio features and the tuples
    pickle; returns (tuples path, audio dir)."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    audio_dir = os.path.join(root, "audio")
    os.makedirs(audio_dir, exist_ok=True)
    tuples = []
    for subj, emo, lvl, nbr, frames in CLIPS:
        clip = os.path.join(root, subj, "video", "front", emo, lvl, nbr)
        lmd = os.path.join(root, subj, "landmarks", "front", emo, lvl, nbr)
        os.makedirs(clip, exist_ok=True)
        os.makedirs(lmd, exist_ok=True)
        for k in range(frames):
            Image.fromarray((rs.rand(SIZE + 4, SIZE + 2, 3) * 255).astype(
                np.uint8)).save(os.path.join(clip, f"{k:03d}.jpg"))
            path = os.path.join(lmd, f"{k:03d}.pkl")
            if empty_landmark and k == 1:
                open(path, "wb").close()
                continue
            lm = rs.uniform(-2, SIZE + 2, (68, 2)).astype(np.float32)
            with open(path, "wb") as f:
                pickle.dump(lm, f)
        with open(os.path.join(audio_dir, f"{subj}_{emo}_{lvl}_{nbr}.pkl"),
                  "wb") as f:
            pickle.dump(rs.randn(frames, adim).astype(np.float32), f)
        tuples.append((subj, emo, lvl, nbr))
    if mean_landmarks:
        with open(os.path.join(root, "mean_landmarks.pkl"), "wb") as f:
            pickle.dump(rs.uniform(0, SIZE, (68, 2)).astype(np.float32), f)
    tuples_path = os.path.join(root, "tuples.pkl")
    with open(tuples_path, "wb") as f:
        pickle.dump(set(tuples), f)   # the reference's tuples are a set
    return tuples_path, audio_dir


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mead"))
    tuples, audio = build_tree(root)
    return root, tuples, audio


@pytest.fixture(autouse=True)
def no_native_decoder(monkeypatch):
    monkeypatch.delenv("DSML_NATIVE_IMAGE", raising=False)


def assert_items_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
            continue
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=k)


def _pair(tree, **kw):
    root, tuples, audio = tree
    args = (tuples, root, audio)
    kw = dict(dict(audio_window=2, size=SIZE, seed=5), **kw)
    return TD.MEADTalkingFace(*args, **kw), JD.MEADTalkingFace(*args, **kw)


@pytest.mark.parametrize("landmarks", [False, True], ids=["base3", "base5"])
@pytest.mark.parametrize("random_crop", [False, True],
                         ids=["center", "random-crop"])
@pytest.mark.parametrize("epoch", [0, 1])
def test_train_items_equal_jax(tree, landmarks, random_crop, epoch):
    """Target, identity (at most ``max_shortcut`` ahead), masked target and
    landmarks, the audio window, labels and indices of every clip, in an
    epoch the loader stamps."""
    t, j = _pair(tree, include_landmarks=landmarks, random_crop=random_crop,
                 max_shortcut=3)
    for ds in (t, j):
        ds._epoch = epoch
    assert len(t) == len(j) == len(CLIPS)
    for i in range(len(t)):
        got, want = t[i], j[i]
        assert_items_equal(got, want)
        assert got["audio"].shape == (5, 24)
        assert ("landmarks" in got) == landmarks


@pytest.mark.parametrize("landmarks", [False, True], ids=["base3", "base5"])
@pytest.mark.parametrize("force_align", [False, True])
def test_sample_items_equal_jax(tree, landmarks, force_align):
    """Every frame's masked image and landmarks, the whole audio track, the
    identity frame (pinned to 0 by ``force_align``)."""
    t, j = _pair(tree, mode="sample", include_landmarks=landmarks,
                 force_align=force_align)
    for i in range(len(t)):
        got, want = t[i], j[i]
        assert_items_equal(got, want)
        n = int(got["num_frames"])
        assert got["masked_image"].shape == (n, SIZE, SIZE, 3)
        assert got["audio"].shape == (n, 24)
        if force_align:
            assert int(got["identity_idx"]) == 0


@pytest.mark.parametrize("mean_file", [False, True],
                         ids=["image-centre", "mean-landmarks-pkl"])
def test_empty_landmark_pickle_takes_the_mean_landmarks(tmp_path,
                                                        mean_file):
    """Frame 1's empty pickle: the mean landmarks (the file's, else the
    image centre) and the middle row as the mask's top, on both sides."""
    root = str(tmp_path / "m")
    tuples, audio = build_tree(root, mean_landmarks=mean_file, seed=1)
    t, j = _pair((root, tuples, audio), mode="sample", include_landmarks=True)
    got, want = t[0], j[0]
    assert_items_equal(got, want)
    mean = t._mean_lm()
    np.testing.assert_array_equal(got["landmarks"][1], mean)
    if not mean_file:
        assert (mean == SIZE / 2).all()
    assert (got["masked_image"][1][SIZE // 2:] == -1.0).all()


def test_missing_landmark_pickle_raises(tree, tmp_path):
    root = str(tmp_path / "m")
    tuples, audio = build_tree(root, seed=2)
    subj, emo, lvl, nbr, _ = sorted(CLIPS)[0]
    os.remove(os.path.join(root, subj, "landmarks", "front", emo, lvl, nbr,
                           "000.pkl"))
    t, j = _pair((root, tuples, audio), mode="sample")
    for ds in (t, j):
        with pytest.raises(FileNotFoundError):
            ds[0]


def test_audio_rows_must_match_the_frames(tmp_path):
    """One row too few raises (AssertionError on both sides); an empty
    audio pickle raises ValueError."""
    root = str(tmp_path / "m")
    tuples, audio = build_tree(root, seed=3)
    subj, emo, lvl, nbr, n = sorted(CLIPS)[0]
    path = os.path.join(audio, f"{subj}_{emo}_{lvl}_{nbr}.pkl")
    with open(path, "wb") as f:
        pickle.dump(np.zeros((n - 1, 24), np.float32), f)
    t, j = _pair((root, tuples, audio))
    for ds in (t, j):
        with pytest.raises(AssertionError):
            ds[0]
    open(path, "wb").close()
    for ds in (t, j):
        with pytest.raises(ValueError):
            ds[0]


def test_config_targets_and_the_loader(tree, monkeypatch, tmp_path):
    """``taming.data.custom.MEADBase3`` / ``MEADBase5`` through
    ``instantiate_from_config`` (landmarks only in the latter), the
    loader's batches of every array field, and the refusal of the native
    decoder."""
    root, tuples, audio = tree
    params = {"audio_window": 2, "size": SIZE, "tuples_path": tuples,
              "data_root": root, "audio_dir": audio, "mode": "train"}
    b3 = instantiate_from_config({"target": "taming.data.custom.MEADBase3",
                                  "params": params})
    b5 = instantiate_from_config({"target": "taming.data.custom.MEADBase5",
                                  "params": dict(params, max_shortcut=2)})
    assert not b3.include_landmarks and b5.include_landmarks
    assert b5.max_shortcut == 2
    batch = next(iter(TD.DataLoader(b5, batch_size=2, num_workers=2,
                                    seed=0)))
    for k in ("image", "identity", "masked_image"):
        assert batch[k].shape == (2, SIZE, SIZE, 3) and batch[k].dtype == \
            np.float32
    assert batch["audio"].shape == (2, 5, 24)
    assert batch["landmarks"].shape == (2, 68, 2)
    assert batch["class_label"].dtype == np.int32
    assert batch["masked_landmarks"].shape == (2, 96)
    # the native decoder asked for where it cannot be built raises
    from dsml_thesis_tpu_torch import native_lib

    monkeypatch.setenv("DSML_NATIVE_IMAGE", "1")
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native_lib, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="imagepipe"):
        b3[0]
    with pytest.raises(ValueError):
        TD.MEADTalkingFace(tuples, root, audio, mode="eval")
