"""First-stage training harness (config-driven): ``VQGANTrainer`` for a
``VQModel`` target, ``KLAETrainer`` for an ``AutoencoderKL`` one.

Counterpart of ``dsml_thesis_tpu/training/vqgan_trainer.py``:
  - ``_loss_cfg``: the loss parameters with the same defaults; a perceptual
    weight above 0 needs the LPIPS files (``lossconfig.params.vgg_ckpt``, a
    torchvision ``vgg16().features`` state_dict, and ``lpips_lin_ckpt``, the
    taming heads) when training, or the loss would optimise a random VGG;
  - lr = accumulate x batch x base_lr under ``scale_lr`` (the default);
  - ``fit`` over ``max_steps`` / ``max_epochs`` (``lightning.trainer`` or the
    arguments), validation after every epoch, top-k checkpoints on
    ``val/rec_loss`` named ``step=%08d-val_rec_loss=%.5f`` and ``last``;
  - a checkpoint is ``checkpoints/<name>/state.pt``: ``torch.save`` of the
    autoencoder's parameters, the discriminator's (and the KL loss's
    log-variance), both optimizers and the step;
  - ``metrics.jsonl``; ``log_reconstructions`` writes inputs | reconstructions
    as ``.npy`` and ``.png``.

One process on one card: ``fsdp=True`` raises. ``device=None`` means the
card and raises without one; a caller that wants the CPU says so.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import instantiate_from_config
from ..losses.contperceptual import KLAutoencoderLoss
from ..losses.lpips import load_lpips_weights
from ..losses.vqperceptual import VQGANLoss
from ..models.autoencoder import AutoencoderKL, VQModel
from .checkpointing import save_topk
from .kl_ae import make_kl_ae_eval_step, make_kl_ae_train_step
from .vqgan import (create_first_stage_state, make_vqgan_eval_step,
                    make_vqgan_train_step)

CHECKPOINT_FILE = "state.pt"


def _loss_cfg(p: Dict, require_perceptual_weights: bool) -> Dict:
    lp = dict(p.get("lossconfig", {}).get("params", {}))
    lp.setdefault("disc_start", 10000)
    lp.setdefault("perceptual_weight", 0.0)
    if (require_perceptual_weights and lp["perceptual_weight"] > 0
            and not (lp.get("vgg_ckpt") and lp.get("lpips_lin_ckpt"))):
        raise ValueError(
            "perceptual_weight > 0 needs pretrained LPIPS weights: set "
            "lossconfig.params.vgg_ckpt (torchvision vgg16 features "
            "state_dict) and lpips_lin_ckpt (taming lin heads), or the loss "
            "would optimise a random-init VGG")
    return lp


def _gan_kw(lp: Dict) -> Dict:
    return dict(disc_weight=lp.get("disc_weight", 1.0),
                disc_factor=lp.get("disc_factor", 1.0),
                disc_num_layers=lp.get("disc_num_layers", 3),
                disc_in_channels=lp.get("disc_in_channels", 3),
                disc_ndf=lp.get("disc_ndf", 64),
                disc_loss=lp.get("disc_loss", "hinge"),
                perceptual_weight=lp["perceptual_weight"])


def build_vqgan(model_cfg: Dict, require_perceptual_weights: bool = False):
    p = model_cfg["params"]
    model = VQModel(ddconfig=dict(p["ddconfig"]), n_embed=p["n_embed"],
                    embed_dim=p["embed_dim"])
    lp = _loss_cfg(p, require_perceptual_weights)
    loss = VQGANLoss(lp["disc_start"],
                     codebook_weight=lp.get("codebook_weight", 1.0),
                     pixel_loss=lp.get("pixel_loss", "l1"), **_gan_kw(lp))
    return model, loss


def build_kl_ae(model_cfg: Dict, require_perceptual_weights: bool = False):
    p = model_cfg["params"]
    model = AutoencoderKL(ddconfig=dict(p["ddconfig"]),
                          embed_dim=p["embed_dim"])
    lp = _loss_cfg(p, require_perceptual_weights)
    loss = KLAutoencoderLoss(lp["disc_start"],
                             logvar_init=lp.get("logvar_init", 0.0),
                             kl_weight=lp.get("kl_weight", 1.0),
                             **_gan_kw(lp))
    return model, loss


class VQGANTrainer:
    _build = staticmethod(build_vqgan)
    _make_train_step = staticmethod(make_vqgan_train_step)
    _make_eval_step = staticmethod(make_vqgan_eval_step)

    def __init__(self, config: Dict, logdir: str, seed: int = 123,
                 max_steps: Optional[int] = None, fsdp: bool = False,
                 device: Optional[torch.device] = None):
        if fsdp:
            raise NotImplementedError("fsdp: the port trains on one card")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"{type(self).__name__}: no CUDA device (pass "
                    "device='cpu' to train on the CPU)")
            device = torch.device("cuda")
        self.device = torch.device(device)
        self.config, self.logdir, self.seed = config, logdir, seed
        self.max_steps = max_steps
        os.makedirs(os.path.join(logdir, "checkpoints"), exist_ok=True)

        torch.manual_seed(seed)
        model, loss = type(self)._build(config["model"],
                                        require_perceptual_weights=True)
        self.model, self.loss = model.to(self.device), loss.to(self.device)
        lp = self._lossconfig()
        if lp.get("vgg_ckpt") and lp.get("lpips_lin_ckpt"):
            load = lambda f: torch.load(f, map_location="cpu",
                                        weights_only=True)
            self.loss.lpips.load_state_dict(load_lpips_weights(
                load(lp["vgg_ckpt"]), load(lp["lpips_lin_ckpt"])))

        from ..data import DataLoader

        data_cfg = config.get("data", {}).get("params", {})
        self.batch_size = data_cfg.get("batch_size", 8)
        nw = data_cfg.get("num_workers", 4)
        self.train_data = self.val_data = None
        if "train" in data_cfg:
            self.train_data = DataLoader(
                instantiate_from_config(data_cfg["train"]),
                batch_size=self.batch_size, shuffle=True, num_workers=nw,
                seed=seed)
        if "validation" in data_cfg:
            self.val_data = DataLoader(
                instantiate_from_config(data_cfg["validation"]),
                batch_size=self.batch_size, shuffle=False, num_workers=nw,
                seed=seed)
        base_lr = config["model"].get("base_learning_rate", 4.5e-6)
        trainer_cfg = config.get("lightning", {}).get("trainer", {})
        accumulate = trainer_cfg.get("accumulate_grad_batches", 1)
        self.max_epochs = trainer_cfg.get("max_epochs")
        if self.max_steps is None and trainer_cfg.get("max_steps") is not None:
            self.max_steps = int(trainer_cfg["max_steps"])
        self.lr = (accumulate * self.batch_size * base_lr
                   if config.get("scale_lr", True) else base_lr)
        self._metrics_file = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self.save_top_k = config.get("lightning", {}).get(
            "modelcheckpoint", {}).get("params", {}).get("save_top_k", 5)
        self._topk: list = []
        self._state = None

    def _lossconfig(self) -> Dict:
        return self.config["model"].get("params", {}).get(
            "lossconfig", {}).get("params", {})

    # ---------- setup ----------

    def _extra_ae_params(self):
        return ()

    def init_state(self):
        """The two optimizers and the step functions."""
        self._state = create_first_stage_state(
            self.model, self.loss, self.lr, seed=self.seed,
            extra_ae_params=self._extra_ae_params())
        self._step = type(self)._make_train_step(self.model, self.loss)
        self._eval_step = type(self)._make_eval_step(self.model, self.loss)
        return self._state

    def _to_device(self, batch) -> torch.Tensor:
        return torch.from_numpy(np.asarray(batch["image"])).to(self.device)

    # ---------- checkpoints ----------

    def _checkpoint_path(self, name: str) -> str:
        return os.path.join(self.logdir, "checkpoints", name, CHECKPOINT_FILE)

    def _loss_state(self) -> Dict[str, torch.Tensor]:
        """The loss's trained tensors: the discriminator (and the KL loss's
        log-variance); the frozen LPIPS comes from its files."""
        return {k: v for k, v in self.loss.state_dict().items()
                if not k.startswith("lpips.")}

    def save_checkpoint(self, name: str) -> None:
        """Written beside and renamed, so a killed save leaves the previous
        file whole."""
        path = self._checkpoint_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"model": self.model.state_dict(),
                    "loss": self._loss_state(), **self._state.state_dict()},
                   path + ".tmp")
        os.replace(path + ".tmp", path)

    def restore_checkpoint(self, name: str):
        if self._state is None:
            self.init_state()
        sd = torch.load(self._checkpoint_path(name), map_location=self.device,
                        weights_only=True)
        self.model.load_state_dict(sd["model"])
        missing, unexpected = self.loss.load_state_dict(sd["loss"],
                                                        strict=False)
        if unexpected or any(not k.startswith("lpips.") for k in missing):
            raise KeyError(f"checkpoint {name}: loss tensors missing "
                           f"{missing} or unexpected {unexpected}")
        self._state.load_state_dict(sd)
        return self._state

    def save_topk_checkpoint(self, score: float, step: int) -> None:
        save_topk(self._topk, self.save_top_k, score,
                  f"step={step:08d}-val_rec_loss={score:.5f}",
                  self.save_checkpoint,
                  os.path.join(self.logdir, "checkpoints"))

    # ---------- logging ----------

    def log_metrics(self, metrics: Dict, step: int, split: str = "train"):
        rec = {"step": step, "split": split,
               **{k: float(v) for k, v in metrics.items()}}
        self._metrics_file.write(json.dumps(rec) + "\n")
        self._metrics_file.flush()

    def close(self) -> None:
        self._metrics_file.close()

    def _reconstruct(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)[0]

    def log_reconstructions(self, batch, step: int, n: int = 4) -> None:
        """inputs | reconstructions of the first n images of a batch, as
        ``images/recon_step%08d.npy`` and, where PIL is installed, ``.png``."""
        x = self._to_device(batch)[:n]
        with torch.no_grad():
            rec = self._reconstruct(x)
        arr = torch.cat([x, rec.to(x.dtype)]).clamp(-1, 1).cpu().numpy()
        outdir = os.path.join(self.logdir, "images")
        os.makedirs(outdir, exist_ok=True)
        stem = os.path.join(outdir, f"recon_step{step:08d}")
        np.save(stem + ".npy", arr)
        try:
            from PIL import Image
        except ImportError:
            return
        row = np.concatenate(list((arr + 1) * 127.5), axis=1).astype(np.uint8)
        Image.fromarray(row).save(stem + ".png")

    # ---------- loops ----------

    def validate(self, max_batches: Optional[int] = None) -> Dict:
        """Means of the eval step's metrics over the validation batches."""
        if self.val_data is None:
            return {}
        sums, n = {}, 0
        for i, batch in enumerate(self.val_data):
            if max_batches is not None and i >= max_batches:
                break
            m = self._eval_step(self._state, self._to_device(batch), i)
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in sums.items()}

    def fit(self, epochs: Optional[int] = None, log_every: int = 100,
            image_every: Optional[int] = None,
            val_max_batches: Optional[int] = None):
        if self.train_data is None:
            raise ValueError("fit: the config has no data.params.train")
        if epochs is None:
            if self.max_epochs is not None:
                epochs = self.max_epochs
            elif self.max_steps is not None:
                epochs = 10 ** 9
            else:
                epochs = 1
        if self._state is None:
            self.init_state()
        state = self._state
        done = lambda: self.max_steps is not None and state.step >= self.max_steps
        first_batch = None
        for epoch in range(epochs):
            if done():
                break
            t0 = time.time()
            for batch in self.train_data:
                first_batch = first_batch or batch
                metrics = self._step(state, self._to_device(batch))
                if state.step % log_every == 0:
                    self.log_metrics(metrics, state.step)
                if image_every and state.step % image_every == 0:
                    self.log_reconstructions(first_batch, state.step)
                if done():
                    break
            print(f"epoch {epoch}: {time.time() - t0:.1f}s, step {state.step}")
            val = self.validate(max_batches=val_max_batches)
            if val:   # {} when the split is smaller than one batch
                self.log_metrics(val, state.step, split="val")
                self.save_topk_checkpoint(val["val/rec_loss"], state.step)
            self.save_checkpoint("last")
        return state


class KLAETrainer(VQGANTrainer):
    """The AutoencoderKL harness: the same two-optimizer shape;
    ``lossconfig.params.train_logvar: true`` moves the loss's log-variance
    under the autoencoder's optimizer (frozen by default, as upstream)."""

    _build = staticmethod(build_kl_ae)
    _make_train_step = staticmethod(make_kl_ae_train_step)
    _make_eval_step = staticmethod(make_kl_ae_eval_step)

    def _extra_ae_params(self):
        if not self._lossconfig().get("train_logvar", False):
            return ()
        self.loss.logvar.requires_grad_(True)
        return (self.loss.logvar,)

    def _reconstruct(self, x: torch.Tensor) -> torch.Tensor:
        """The posterior's mode, decoded."""
        return self.model(x, sample_posterior=False)[0]


# the first-stage model targets of the configs, and the trainer of each
TRAINERS = {"ldm.models.autoencoder.VQModel": VQGANTrainer,
            "ldm.models.autoencoder.AutoencoderKL": KLAETrainer}
