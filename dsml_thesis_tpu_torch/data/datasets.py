"""Datasets and a minimal threaded loader (shuffling, batching, prefetch).

Counterpart of ``dsml_thesis_tpu/data/datasets.py`` for what the port's
trainer drives today: ``SyntheticDataset`` (random tensors of a given spec,
the same numpy draws as the JAX package's, so both trainers see the same
batches), ``collate`` and ``DataLoader`` for one process. The MEAD, AffectNet
and cached-latent datasets are not ported yet. Batches are dicts of numpy
arrays; the trainer moves them to the device.
"""
from __future__ import annotations

import queue as queue_mod
import threading
from typing import Dict, List

import numpy as np


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
