"""Config-driven training harness of the port.

Counterpart of ``dsml_thesis_tpu/training/trainer.py``:
  - LR scaling: lr = accumulate x batch_size x base_lr (``scale_lr: false``
    in the config turns it off);
  - the ``lightning.trainer`` keys a reference YAML drives a run through
    (``max_epochs``, ``max_steps``, ``accumulate_grad_batches``,
    ``check_val_every_n_epoch``, ``limit_val_batches``,
    ``limit_test_batches``) and ``lightning.modelcheckpoint.params``
    (``save_top_k``, ``mode``);
  - validation with the raw and the EMA weights over the full split: a ragged
    last batch is padded to the batch size and its padding masked out of the
    means;
  - a checkpoint is a directory under ``checkpoints/`` holding ``state.pt``
    (``torch.save`` of model, optimizer, EMA shadows and step); ``last`` after
    every epoch, the best ``save_top_k`` by the model's monitor with the
    metric in the name;
  - SIGTERM / SIGUSR1 save ``last`` and stop.

One process on one device: no mesh, no sharding. Not ported, each raising
``NotImplementedError`` where a config or caller asks for it: periodic image
logging (``log_images``), warm start from ``model.params.ckpt_path`` or a
first-stage ``ckpt_path``, tensor / fully-sharded parallelism, the step
profiler, and the finetune trainer. First-stage training is
``training/vqgan_trainer.py``.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import build_model, instantiate_from_config
from .checkpointing import save_topk
from .loggers import build_logger
from .train_state import (TrainState, create_train_state, fold_seed,
                          make_eval_step, make_optimizer, make_train_step)

CHECKPOINT_FILE = "state.pt"


def _array_fields(batch: Dict) -> Dict[str, np.ndarray]:
    """The array-valued fields of a batch (str metadata such as file paths
    is dropped)."""
    return {k: np.asarray(v) for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}


class Trainer:
    def __init__(self, config: Dict, logdir: str, seed: int = 123,
                 max_steps: Optional[int] = None,
                 device: Optional[torch.device] = None):
        """``device=None`` means the card: it raises when there is none. A
        caller that wants the CPU says so."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Trainer: no CUDA device (pass device='cpu' to train on "
                    "the CPU)")
            device = torch.device("cuda")
        self.device = torch.device(device)
        self.config = config
        self.logdir = logdir
        self.seed = seed
        os.makedirs(os.path.join(logdir, "checkpoints"), exist_ok=True)

        self.model_cfg = config["model"]
        self.data_cfg = config.get("data", {}).get("params", {})
        self.lightning_cfg = config.get("lightning", {})
        self.max_steps = max_steps

        mp = self.model_cfg.get("params", {})
        fs_cfg = mp.get("first_stage_config")
        fs_p = fs_cfg.get("params", {}) if isinstance(fs_cfg, dict) else {}
        for what, path in (("model.params.ckpt_path", mp.get("ckpt_path")),
                           ("first_stage_config.params.ckpt_path",
                            fs_p.get("ckpt_path"))):
            if path:
                raise NotImplementedError(
                    f"{what}={path!r}: warm start from a checkpoint is not "
                    "ported")
        torch.manual_seed(seed)
        self.ldm = build_model(self.model_cfg).to(self.device)
        self.loss_module = self.ldm

        from ..data import DataLoader

        bs = self.data_cfg.get("batch_size", 4)
        nw = self.data_cfg.get("num_workers", 4)
        self.train_data = self.val_data = self.test_data = None
        if "train" in self.data_cfg:
            self.train_data = DataLoader(
                instantiate_from_config(self.data_cfg["train"]),
                batch_size=bs, shuffle=True, num_workers=nw, seed=seed)
        # eval splits keep the ragged tail: validate() pads and masks it
        for split in ("validation", "test"):
            if split in self.data_cfg:
                loader = DataLoader(
                    instantiate_from_config(self.data_cfg[split]),
                    batch_size=bs, shuffle=False, num_workers=nw, seed=seed,
                    drop_last=False)
                setattr(self, "val_data" if split == "validation"
                        else "test_data", loader)

        base_lr = self.model_cfg.get("base_learning_rate", 1e-6)
        trainer_cfg = self.lightning_cfg.get("trainer", {})
        accumulate = trainer_cfg.get("accumulate_grad_batches", 1)
        self.lr = (accumulate * bs * base_lr if config.get("scale_lr", True)
                   else base_lr)
        self.grad_accum = accumulate
        self.max_epochs = trainer_cfg.get("max_epochs")
        if self.max_steps is None and trainer_cfg.get("max_steps") is not None:
            self.max_steps = int(trainer_cfg["max_steps"])
        self.check_val_every_n_epoch = int(
            trainer_cfg.get("check_val_every_n_epoch", 1))
        # Lightning semantics: int = batch count, float = fraction of batches
        self.limit_val_batches = trainer_cfg.get("limit_val_batches")
        self.limit_test_batches = trainer_cfg.get("limit_test_batches")
        il = self.lightning_cfg.get("callbacks", {}).get(
            "image_logger", {}).get("params", {})
        if il.get("batch_frequency"):
            raise NotImplementedError(
                "lightning.callbacks.image_logger: periodic image logging "
                "(log_images) is not ported")

        self._state: Optional[TrainState] = None
        self._train_step = None
        self._eval_step = None
        self._should_stop = False
        self._metrics_file = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._ext_logger = build_logger(self.lightning_cfg, logdir)
        mc = self.lightning_cfg.get("modelcheckpoint", {}).get("params", {})
        self.save_top_k = mc.get("save_top_k", 5)
        self.monitor_mode = mc.get("mode", "min")
        self._topk: list = []  # [(score, name)] sorted best-first

    # ---------- setup ----------

    def init_state(self) -> TrainState:
        """Build optimizer, EMA shadows and the step functions (the model was
        built, and seeded, by the constructor)."""
        optimizer = make_optimizer(self.ldm, base_lr=self.lr)
        self._state = create_train_state(
            self.ldm, optimizer, base_lr=self.lr,
            scheduler_config=self.model_cfg.get("params", {}).get(
                "scheduler_config"),
            grad_accum=self.grad_accum)
        self._train_step = make_train_step(self.loss_module)
        self._eval_step = make_eval_step(self.loss_module)
        return self._state

    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in _array_fields(batch).items()}

    def _install_signal_handlers(self):
        def rescue(*_a):
            self._should_stop = True
            if self._state is None:
                print("Signal before first step: nothing to checkpoint.")
                return
            print("Summoning checkpoint (signal).")
            self.save_checkpoint("last")

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                signal.signal(sig, rescue)
            except (ValueError, OSError):  # not the main thread
                pass

    # ---------- checkpointing ----------

    def _checkpoint_path(self, name: str) -> str:
        return os.path.join(self.logdir, "checkpoints", name)

    def save_checkpoint(self, name: str) -> None:
        """Model, optimizer, EMA shadows and step into
        ``checkpoints/<name>/state.pt`` (written beside and renamed, so a
        killed save leaves the previous file whole)."""
        path = self._checkpoint_path(name)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
        torch.save({"model": self.ldm.state_dict(),
                    **self._state.state_dict()}, tmp)
        os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))

    def _rebuild_topk_from_disk(self):
        """Re-derive the top-k bookkeeping from the metric-embedded names
        ("step=NNNNNNNN-<monitor>=<score>"), so ``save_top_k`` keeps its
        meaning across restarts."""
        ckdir = os.path.join(self.logdir, "checkpoints")
        found = []
        for name in os.listdir(ckdir):
            if not (name.startswith("step=") and name.count("=") >= 2):
                continue
            try:
                found.append((float(name.rsplit("=", 1)[1]), name))
            except ValueError:
                continue
        self._topk = sorted(found, reverse=(self.monitor_mode == "max"))

    def restore_checkpoint(self, name: str) -> TrainState:
        if self._state is None:
            self.init_state()
        self._rebuild_topk_from_disk()
        sd = torch.load(os.path.join(self._checkpoint_path(name),
                                     CHECKPOINT_FILE),
                        map_location=self.device, weights_only=True)
        self.ldm.load_state_dict(sd["model"])
        self._state.load_state_dict(sd)
        return self._state

    def save_topk_checkpoint(self, score: float, monitor: str, step: int):
        """Keep the best ``save_top_k`` checkpoints, metric in the name."""
        safe_monitor = monitor.replace("/", "_")  # no nested directories
        save_topk(self._topk, self.save_top_k, score,
                  f"step={step:08d}-{safe_monitor}={score:.5f}",
                  self.save_checkpoint,
                  os.path.join(self.logdir, "checkpoints"),
                  mode=self.monitor_mode)

    # ---------- logging ----------

    def log_metrics(self, metrics: Dict, step: int, split: str = "train"):
        values = {k: float(v) for k, v in metrics.items()}
        rec = {"step": step, "split": split, **values}
        self._metrics_file.write(json.dumps(rec) + "\n")
        self._metrics_file.flush()
        if self._ext_logger is not None:
            self._ext_logger.log_metrics(values, step, split)

    def log_images(self, *_a, **_kw):
        raise NotImplementedError("log_images is not ported")

    def close(self) -> None:
        """Close the metrics file and the logger backend."""
        self._metrics_file.close()
        if self._ext_logger is not None:
            self._ext_logger.finalize()
            self._ext_logger = None

    # ---------- loops ----------

    def _resolve_val_batches(self, max_batches, data, lim=None) -> Optional[int]:
        """An explicit argument wins; else the limit (int = count, float =
        fraction, 0 = skip the split)."""
        if max_batches is not None:
            return max_batches
        if lim is None:
            lim = self.limit_val_batches
        if lim is None:
            return None
        if lim == 0:
            return 0
        if isinstance(lim, float) and lim <= 1.0:
            return max(1, int(lim * len(data)))
        return int(lim)

    def validate(self, seed: int, max_batches: Optional[int] = None,
                 data=None, limit=None) -> Dict:
        data = data if data is not None else self.val_data
        max_batches = self._resolve_val_batches(max_batches, data, lim=limit)
        bs = getattr(data, "batch_size", None) or self.data_cfg.get(
            "batch_size", 4)
        # a ragged tail can only be masked when the loss honours the weights
        pad_ok = getattr(self.loss_module, "supports_sample_weights", False)
        sums, n = {}, 0.0
        for i, batch in enumerate(data):
            if max_batches is not None and i >= max_batches:
                break
            nb = _array_fields(batch)
            n_real = next(iter(nb.values())).shape[0]
            if n_real < bs and not pad_ok:
                continue
            if pad_ok:
                pad = bs - n_real
                if pad:
                    nb = {k: np.concatenate(
                        [v, np.repeat(v[-1:], pad, axis=0)], axis=0)
                        for k, v in nb.items()}
                nb["_sample_weights"] = np.concatenate(
                    [np.ones(n_real, np.float32), np.zeros(pad, np.float32)])
            m = self._eval_step(self._state, self._to_device(nb),
                                fold_seed(seed, i))
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v) * n_real
            n += n_real
        return {k: v / max(n, 1) for k, v in sums.items()}

    def test(self, seed: int = 0) -> Optional[Dict]:
        """Evaluate the test split under ``limit_test_batches`` (default:
        the full split)."""
        if self.test_data is None:
            return None
        metrics = self.validate(
            seed, data=self.test_data,
            limit=(self.limit_test_batches
                   if self.limit_test_batches is not None else 1.0))
        self.log_metrics(metrics, self._state.step, split="test")
        return metrics

    def fit(self, epochs: Optional[int] = None, log_every: int = 100,
            image_every: Optional[int] = None,
            val_max_batches: Optional[int] = None,
            profile_at_step: Optional[int] = None) -> TrainState:
        if self.train_data is None:
            raise ValueError("fit: the config has no data.params.train")
        if image_every:
            raise NotImplementedError("image_every: log_images is not ported")
        if profile_at_step is not None:
            raise NotImplementedError(
                "profile_at_step: the step profiler is not ported (see "
                "tools/measure.py --train)")
        if epochs is None:
            # max_epochs = 0 trains nothing; max_steps with max_epochs unset
            # trains until the step limit, not one epoch
            if self.max_epochs is not None:
                epochs = self.max_epochs
            elif self.max_steps is not None:
                epochs = 10 ** 9
            else:
                epochs = 1
        self._install_signal_handlers()
        try:
            self._fit_epochs(epochs, log_every, val_max_batches)
        except BaseException:
            if self._state is not None:
                print("Summoning checkpoint (exception).")
                self.save_checkpoint("last")
            raise
        return self._state

    def _hit_max_steps(self, step: int) -> bool:
        """``max_steps`` counts optimizer steps: under accumulation the
        micro-step counter divides down."""
        if self.max_steps is None:
            return False
        return step // max(1, self.grad_accum) >= self.max_steps

    def _fit_epochs(self, epochs, log_every, val_max_batches):
        if self._state is None:
            self.init_state()
        state = self._state
        # a restored state re-enters at the epoch its step count implies;
        # a resume in mid-epoch rounds down and replays the partial epoch
        start_epoch = state.step // max(1, len(self.train_data))
        if start_epoch:
            self.train_data.epoch = max(self.train_data.epoch, start_epoch)
        monitor = self.ldm.monitor
        for epoch in range(start_epoch, epochs):
            t_epoch = time.time()
            for batch in self.train_data:
                metrics = self._train_step(state, self._to_device(batch),
                                           self.seed)
                if state.step % log_every == 0:
                    self.log_metrics(metrics, state.step)
                if self._should_stop or self._hit_max_steps(state.step):
                    break
            epoch_s = time.time() - t_epoch
            run_val = (epoch + 1) % max(1, self.check_val_every_n_epoch) == 0
            if self._should_stop:
                run_val = False  # the signal already saved 'last'
            if self.val_data is not None and run_val:
                val = self.validate(fold_seed(self.seed, epoch),
                                    max_batches=val_max_batches)
                score = val.get(monitor, val.get("val_loss"))
                val["epoch_seconds"] = epoch_s
                if self.device.type == "cuda":
                    val["peak_bytes_in_use"] = float(
                        torch.cuda.max_memory_allocated(self.device))
                self.log_metrics(val, state.step, split="val")
                if score is not None:  # val split smaller than one batch
                    self.save_topk_checkpoint(float(score), monitor,
                                              state.step)
            self.save_checkpoint("last")
            if self._should_stop or self._hit_max_steps(state.step):
                break

