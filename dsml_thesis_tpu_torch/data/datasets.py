"""Datasets and a minimal threaded loader (shuffling, batching, prefetch).

Counterpart of ``dsml_thesis_tpu/data/datasets.py`` for what the port's
trainers drive: ``SyntheticDataset`` (random tensors of a given spec, the
same numpy draws as the JAX package's, so both trainers see the same
batches), the AffectNet path-list dataset (label from the file name's
prefix), the MEAD talking-face clips (``MEADTalkingFace``, the reference's
``MEADBase3`` / ``MEADBase5``: frames, landmark pickles and the per-frame
audio features of ``scripts/mead_audio_features_torch.py``), the latent
caches that ``scripts/compute_latents_torch.py`` writes
(``LatentDataset``), ``collate`` and ``DataLoader`` for one process, and
``pad_clip``, a sampled clip brought to a fixed frame count. Batches
are dicts of numpy arrays; the trainer moves them to the device. Images are
float32 NHWC in [-1, 1].

Pillow decodes and resizes images; it is imported where an image is opened
or resized, never when this module is imported. Where ``LatentDataset``
must resize and Pillow is missing, it raises (the JAX package skips the
resize then). Not ported: the native image decoder (``DSML_NATIVE_IMAGE=1``
raises ``NotImplementedError``).
"""
from __future__ import annotations

import os
import pickle
import queue as queue_mod
import threading
from typing import Dict, List, Optional

import numpy as np

from ..flags import env_flag

EMOTION2LABEL = {
    "angry": 6, "contempt": 7, "disgusted": 5, "fear": 4,
    "happy": 1, "neutral": 0, "sad": 2, "surprised": 3,
}
HUMAN_LABELS = {
    0: "neutral", 1: "happy", 2: "sad", 3: "surprise",
    4: "fear", 5: "disgust", 6: "anger", 7: "contempt",
}


def _pil_image():
    """PIL.Image, imported at the first image the data path touches."""
    from PIL import Image

    return Image


def _refuse_native_decoder():
    if env_flag("DSML_NATIVE_IMAGE", False):
        raise NotImplementedError(
            "DSML_NATIVE_IMAGE=1: the native image decoder is not ported; "
            "unset it to decode with Pillow")


def load_image(path: str, size: Optional[int], random_crop: bool = False,
               rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Resize the smallest side to ``size`` (bicubic), center or random crop
    (offsets from ``rng``), scale to [-1, 1]: float32 [size, size, 3]."""
    _refuse_native_decoder()
    Image = _pil_image()
    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    if size is not None and size > 0:
        w, h = img.size
        scale = size / min(w, h)
        img = img.resize((max(size, round(w * scale)),
                          max(size, round(h * scale))), Image.BICUBIC)
        w, h = img.size
        if random_crop and rng is not None:
            x0 = rng.randint(0, w - size + 1)
            y0 = rng.randint(0, h - size + 1)
        else:
            x0, y0 = (w - size) // 2, (h - size) // 2
        img = img.crop((x0, y0, x0 + size, y0 + size))
    arr = np.asarray(img, dtype=np.uint8)
    return (arr / 127.5 - 1.0).astype(np.float32)


def load_images(paths, size: Optional[int]) -> np.ndarray:
    """Stack of center-cropped images [N, size, size, 3] in [-1, 1]."""
    return np.stack([load_image(p, size) for p in paths])


def _item_rng(seed: int, epoch: int, idx) -> np.random.RandomState:
    """Per-item RandomState, reproducible under the loader's threads and
    varying by epoch (the loader stamps ``dataset._epoch``)."""
    return np.random.RandomState(
        (seed * 1000003 + epoch * 10007 + int(idx)) % (2 ** 31 - 1))


def _label_of(path: str) -> int:
    """AffectNet's class label: the file name's prefix, ``<label>_...``."""
    return int(os.path.basename(path).split("_")[0])


class AffectnetDataset:
    """AffectNet aligned crops listed in a file, one path a line; the class
    label is the file name's prefix. With ``shape_root`` each example also
    carries the DECA / EMOCA geometry render, cropped as the image is."""

    SHAPE_FILES = {"emoca": "geometry_detail.png",
                   "deca": "shape_detail_images.jpg"}

    def __init__(self, images_list_file: str, size: int = 128,
                 random_crop: bool = False, shape_root: Optional[str] = None,
                 shape_model: str = "emoca", seed: int = 0):
        with open(images_list_file) as f:
            self.paths = [ln for ln in f.read().splitlines() if ln]
        if shape_model not in self.SHAPE_FILES:
            raise ValueError(f"unknown shape model {shape_model!r}")
        self.size, self.random_crop = size, random_crop
        self.shape_root, self.shape_model = shape_root, shape_model
        self.seed = seed

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i) -> Dict:
        path = self.paths[i]
        label = _label_of(path)
        rng = _item_rng(self.seed, getattr(self, "_epoch", 0), i)
        ex = {
            "image": load_image(path, self.size, self.random_crop, rng),
            "class_label": np.int32(label),
            "human_label": HUMAN_LABELS[label],
            "file_path": path,
        }
        if self.shape_root is not None:
            name = os.path.splitext(os.path.basename(path))[0]
            ex["shape_image"] = load_image(
                os.path.join(self.shape_root, name,
                             self.SHAPE_FILES[self.shape_model]),
                self.size, self.random_crop, rng)
        return ex


def AffectnetTrain(size=128, training_images_list_file=None, model="emoca",
                   random_crop=False, seed=0, **kw):
    return AffectnetDataset(training_images_list_file, size=size,
                            random_crop=random_crop,
                            shape_root=kw.get("shape_root"),
                            shape_model=model, seed=seed)


def AffectnetTest(size=128, test_images_list_file=None, model="emoca",
                  random_crop=False, seed=0, **kw):
    return AffectnetDataset(test_images_list_file, size=size,
                            random_crop=random_crop,
                            shape_root=kw.get("shape_root"),
                            shape_model=model, seed=seed)


def _load_pickle(path: str):
    """A pickle's object; None for an empty file. A missing file raises."""
    if os.path.getsize(path) > 0:
        with open(path, "rb") as f:
            return pickle.load(f)
    return None


class MEADTalkingFace:
    """The MEAD clips of a list of (subject, emotion, level, clip) tuples,
    under ``<data_root>/<subj>/video/front/<emo>/<lvl>/<clip>/`` (frames),
    ``.../landmarks/front/...`` (a landmark pickle a frame) and
    ``<audio_dir>/<subj>_<emo>_<lvl>_<clip>.pkl`` (one feature row a frame).

    ``mode='train'``: one random target frame a clip, an identity frame drawn
    among the first ``anchor + max_shortcut``, the target with everything
    below the mouth masked, the normalized non-mouth landmarks, the
    (2 * audio_window + 1)-row audio window (clamped at the clip's edges),
    the emotion label. ``mode='sample'``: every frame's masked image and
    landmarks and the whole audio track (``force_align`` pins the identity
    to frame 0). ``include_landmarks`` adds the raw landmarks (MEADBase5,
    the lip-reading finetune). A missing landmark pickle raises; an empty
    one falls back to the dataset's mean landmarks."""

    def __init__(self, tuples_path: str, data_root: str, audio_dir: str,
                 audio_window: int = 8, size: int = 128, mode: str = "train",
                 max_shortcut: int = 60, include_landmarks: bool = False,
                 force_align: bool = False, random_crop: bool = False,
                 seed: int = 0):
        if mode not in ("train", "sample"):
            raise ValueError(f"unknown mode {mode!r}")
        with open(tuples_path, "rb") as f:
            self.tuples = sorted(list(pickle.load(f)))
        self.data_root, self.audio_dir = data_root, audio_dir
        self.audio_window, self.size, self.mode = audio_window, size, mode
        self.max_shortcut = max_shortcut
        self.include_landmarks = include_landmarks
        self.force_align, self.random_crop = force_align, random_crop
        self.seed = seed
        self._mean_landmarks = None

    def _mean_lm(self) -> np.ndarray:
        """The dataset's mean landmarks (``mean_landmarks.pkl`` under the
        data root; the image centre where there is none)."""
        if self._mean_landmarks is None:
            p = os.path.join(self.data_root, "mean_landmarks.pkl")
            self._mean_landmarks = (
                np.asarray(_load_pickle(p), np.float32) if os.path.exists(p)
                else np.full((68, 2), self.size / 2, np.float32))
        return self._mean_landmarks

    def __len__(self):
        return len(self.tuples)

    def _clip_dir(self, subj, emotion, lvl, nbr):
        return os.path.join(self.data_root, subj, "video", "front", emotion,
                            lvl, nbr)

    def _landmarks_dir(self, subj, emotion, lvl, nbr):
        return os.path.join(self.data_root, subj, "landmarks", "front",
                            emotion, lvl, nbr)

    def _mask_mouth(self, image: np.ndarray, landmarks):
        """(image with every row from 5 px above the mouth's top masked to
        -1, the non-mouth landmarks 0-48 in [-1, 1] raveled). Without
        landmarks the mean ones and the image's middle row stand in. A
        negative row keeps Python's slicing, as the reference's unclamped
        index does."""
        masked = image.copy()
        if landmarks is not None:
            min_y = int(np.min(landmarks[48:68][:, 1])) - 5
        else:
            landmarks = self._mean_lm()
            min_y = self.size // 2
        masked[min_y:, :, :] = -1.0
        mlm = np.clip(np.asarray(landmarks[0:48], np.float32), 0, self.size)
        return masked, (mlm / (self.size / 2) - 1.0).ravel()

    def _audio_window_at(self, audio_features: np.ndarray,
                         t: int) -> np.ndarray:
        n = len(audio_features)
        idx = [min(max(t + i, 0), n - 1)
               for i in range(-self.audio_window, self.audio_window + 1)]
        return audio_features[idx]

    def __getitem__(self, idx) -> Dict:
        subj, emotion, lvl, nbr = self.tuples[idx]
        clip_dir = self._clip_dir(subj, emotion, lvl, nbr)
        lm_dir = self._landmarks_dir(subj, emotion, lvl, nbr)
        audio = _load_pickle(
            os.path.join(self.audio_dir, f"{subj}_{emotion}_{lvl}_{nbr}.pkl"))
        frames = sorted(os.listdir(clip_dir))
        n = len(frames)

        def lm(k):
            return _load_pickle(
                os.path.join(lm_dir, frames[k].replace("jpg", "pkl")))

        if audio is None:
            raise ValueError(
                f"empty audio features for {subj}/{emotion}/{lvl}/{nbr}: "
                "regenerate with scripts/mead_audio_features_torch.py")
        audio = np.asarray(audio)
        if n != audio.shape[0]:
            raise AssertionError(
                f"{subj}/{emotion}/{lvl}/{nbr}: {n} frames but "
                f"{audio.shape[0]} audio feature rows")

        rng = _item_rng(self.seed, getattr(self, "_epoch", 0), idx)
        anchor = rng.randint(n) if self.mode == "train" else 0
        if self.mode == "sample" and self.force_align:
            id_idx = 0
        else:
            id_idx = rng.randint(min(n, anchor + self.max_shortcut))
        if self.mode == "sample" and not self.random_crop:
            all_imgs = load_images(
                [os.path.join(clip_dir, f) for f in frames], self.size)
            image, identity = all_imgs[anchor], all_imgs[id_idx]
        else:
            all_imgs = None
            image = load_image(os.path.join(clip_dir, frames[anchor]),
                               self.size, self.random_crop, rng)
            identity = load_image(os.path.join(clip_dir, frames[id_idx]),
                                  self.size, self.random_crop, rng)

        ex: Dict = {
            "image": image,
            "identity": identity,
            "class_label": np.int32(EMOTION2LABEL[emotion]),
            "human_label": emotion,
            "frame_idx": np.int32(anchor),
            "num_frames": np.int32(n),
            "subj": subj, "lvl": lvl, "nbr": nbr,
            "identity_idx": np.int32(id_idx),
        }
        if self.mode == "train":
            landmarks = lm(anchor)
            ex["masked_image"], ex["masked_landmarks"] = self._mask_mouth(
                image, landmarks)
            ex["audio"] = self._audio_window_at(audio, anchor).astype(
                np.float32)
            if self.include_landmarks:
                ex["landmarks"] = np.asarray(
                    landmarks if landmarks is not None else self._mean_lm(),
                    dtype=np.float32)
            return ex
        masked, mlms, lms = [], [], []
        for k in range(n):
            img_k = (all_imgs[k] if all_imgs is not None else load_image(
                os.path.join(clip_dir, frames[k]), self.size,
                self.random_crop, rng))
            landmarks = lm(k)
            m, mlm = self._mask_mouth(img_k, landmarks)
            masked.append(m)
            mlms.append(mlm)
            lms.append(np.asarray(
                landmarks if landmarks is not None else self._mean_lm(),
                dtype=np.float32))
        ex["masked_image"] = np.stack(masked)
        ex["masked_landmarks"] = np.stack(mlms)
        ex["audio"] = np.asarray(audio, dtype=np.float32)
        if self.include_landmarks:
            ex["landmarks"] = np.stack(lms)
        return ex


def pad_clip(example: Dict, frames: Optional[int],
             audio_window: int):
    """(masked frames [F, H, W, 3], audio [F + w, D]) of a ``sample``-mode
    ``MEADTalkingFace`` example, cut to F = ``frames`` (the clip's own
    length when None) or padded by repeating the last row: the last frames'
    audio windows reach w rows past the clip, where repeating its last row
    is the reference's clamp at the clip's end."""
    F = int(example["num_frames"]) if frames is None else frames
    masked = np.asarray(example["masked_image"], np.float32)[:F]
    if masked.shape[0] < F:
        masked = np.concatenate(
            [masked, np.repeat(masked[-1:], F - masked.shape[0], 0)])
    n = F + audio_window
    audio = np.asarray(example["audio"], np.float32)[:n]
    if audio.shape[0] < n:
        audio = np.concatenate(
            [audio, np.repeat(audio[-1:], n - audio.shape[0], 0)])
    return masked, audio


def _mead_base(include_landmarks, audio_window, size=128, tuples_path=None,
               mode="train", data_root=None, audio_dir=None,
               force_align=False, random_crop=False, seed=0, **kw):
    return MEADTalkingFace(tuples_path, data_root, audio_dir,
                           audio_window=audio_window, size=size, mode=mode,
                           force_align=force_align,
                           include_landmarks=include_landmarks,
                           random_crop=random_crop, seed=seed,
                           max_shortcut=kw.get("max_shortcut", 60))


def MEADBase3(audio_window, **kw):
    return _mead_base(False, audio_window, **kw)


def MEADBase5(audio_window, **kw):
    """MEADBase3 with the raw landmarks (the lip-reading finetune's)."""
    return _mead_base(True, audio_window, **kw)


class LatentDataset:
    """The ``.npy`` caches of ``compute_latents``: DDIM-inverted latents and
    the origin images in [0, 1] (brought to [-1, 1] after the reference's
    uint8 rounding, smallest-side bilinear resize and center crop to
    ``size``), with the file paths the labels come from. ``n_samples``
    takes a seeded random subset."""

    def __init__(self, precomputed_latents_path: str, origin_path: str,
                 files_path: Optional[str] = None,
                 n_samples: Optional[int] = None, size: Optional[int] = None,
                 seed: int = 0):
        self.latents = np.load(precomputed_latents_path)
        self.origin = np.load(origin_path)
        self.fp = np.load(files_path) if files_path is not None else None
        self.size = size
        idx = np.arange(len(self.latents))
        if n_samples is not None and n_samples < len(idx):
            idx = np.random.RandomState(seed).choice(idx, n_samples,
                                                     replace=False)
        self.idx = idx

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i) -> Dict:
        j = int(self.idx[i])
        u8 = (np.asarray(self.origin[j], dtype=np.float32) * 255.0
              ).astype(np.uint8)
        h, w = u8.shape[:2]
        if self.size is not None and (min(h, w) != self.size or h != w):
            Image = _pil_image()   # raises where Pillow is missing
            s = self.size / min(h, w)
            u8 = np.asarray(Image.fromarray(u8).resize(
                (max(self.size, int(round(w * s))),
                 max(self.size, int(round(h * s)))), Image.BILINEAR))
            h, w = u8.shape[:2]
            top, left = (h - self.size) // 2, (w - self.size) // 2
            u8 = u8[top:top + self.size, left:left + self.size]
        ex = {
            "latent": np.asarray(self.latents[j], dtype=np.float32),
            "original": u8.astype(np.float32) / 127.5 - 1.0,
        }
        if self.fp is not None:
            path = str(self.fp[j])
            ex["file_path"] = path
            ex["class_label"] = np.int32(_label_of(path))
        return ex


def LatentTrain(training_precomputed_latents_path=None,
                training_origin_path=None, training_files_path=None,
                n_samples=None, size=None, seed=0, **kw):
    return LatentDataset(training_precomputed_latents_path,
                         training_origin_path, training_files_path,
                         n_samples, size, seed=seed)


def LatentTest(test_precomputed_latents_path=None, test_origin_path=None,
               test_files_path=None, n_samples=None, size=None, seed=0, **kw):
    return LatentDataset(test_precomputed_latents_path, test_origin_path,
                         test_files_path, n_samples, size, seed=seed)


class SyntheticDataset:
    """Random tensors with a given spec ``{key: (shape, dtype)}``: integers
    uniform in [0, 8), floats unit normal, example i from seed + i."""

    def __init__(self, spec: Dict[str, tuple], length: int = 64, seed: int = 0):
        self.spec = spec
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, i) -> Dict:
        rng = np.random.RandomState(self.seed + i)
        out = {}
        for k, (shape, dtype) in self.spec.items():
            if np.issubdtype(np.dtype(dtype), np.integer):
                out[k] = rng.randint(0, 8, size=shape).astype(dtype)
            else:
                out[k] = rng.randn(*shape).astype(dtype)
        return out


def collate(examples: List[Dict]) -> Dict:
    """Stack array fields; keep str fields as lists."""
    out = {}
    for k in examples[0]:
        vals = [e[k] for e in examples]
        if isinstance(vals[0], (np.ndarray, np.integer, np.floating, int, float)):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


class DataLoader:
    """Seeded shuffle per epoch, batches of ``batch_size``, a producer thread
    with ``num_workers`` threads fetching examples and a prefetch queue."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 123,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        end = len(idx) - (len(idx) % self.batch_size if self.drop_last else 0)
        for s in range(0, end, self.batch_size):
            yield idx[s:s + self.batch_size]

    def __iter__(self):
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        # per-item randomness keys off (dataset.seed, epoch, index)
        self.dataset._epoch = self.epoch
        batches = list(self._batches())
        self.epoch += 1

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            from concurrent.futures import ThreadPoolExecutor

            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        if not put(collate(list(
                                pool.map(self.dataset.__getitem__, b)))):
                            return
            except BaseException as e:  # surface to the consumer: a dead
                put(e)                  # producer would hang q.get() forever
                return
            put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # the consumer stopped early: release the producer
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue_mod.Empty:
                pass
            t.join()
