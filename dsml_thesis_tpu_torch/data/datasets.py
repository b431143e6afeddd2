"""Datasets and a minimal threaded loader (shuffling, batching, prefetch).

Counterpart of ``dsml_thesis_tpu/data/datasets.py`` for what the port's
trainers drive: ``SyntheticDataset`` (random tensors of a given spec, the
same numpy draws as the JAX package's, so both trainers see the same
batches), the AffectNet path-list dataset (label from the file name's
prefix), the latent caches that ``scripts/compute_latents_torch.py`` writes
(``LatentDataset``), ``collate`` and ``DataLoader`` for one process. Batches
are dicts of numpy arrays; the trainer moves them to the device. Images are
float32 NHWC in [-1, 1].

Pillow decodes and resizes images; it is imported where an image is opened
or resized, never when this module is imported. Where ``LatentDataset``
must resize and Pillow is missing, it raises (the JAX package skips the
resize then). Not ported: the MEAD datasets and the native image decoder
(``DSML_NATIVE_IMAGE=1`` raises ``NotImplementedError``).
"""
from __future__ import annotations

import os
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
