"""The face-reenactment (AffectNet) entry points' library calls.

Counterparts of the model-side work of ``scripts/sample_affectnet.py``,
``scripts/compute_latents.py`` and ``scripts/latent_manipulation.py``, so
that the port's scripts and the smoke run on the card drive one code path:

  - ``sample_class``: a batch of one emotion class by classifier-free-guided
    sampling (DDIM, PLMS or DPM-Solver(++) multistep; the unconditional
    branch is the class embedder's null embedding), decoded and clamped;
  - ``compute_latent_cache``: the first-stage encode, the strength-scaled
    deterministic DDIM inversion under each image's source label and,
    optionally, the reconstruction; the arrays of a latent cache
    (``LatentDataset`` reads them);
  - ``manipulate``: inversion under the source class (or cached inverted
    latents) and the reverse chain under a target class, decoded;
  - ``load_weights``: any checkpoint ``utils_io.load_params`` reads (a
    reference Lightning ``.ckpt``, a trainer checkpoint of the port, a
    state_dict of its model), EMA weights unless told otherwise.

Each runs where the model's parameters lie and draws from a
``torch.Generator`` on that device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .diffusion import (ddim_invert, ddim_reverse_from, ddim_sample,
                        dpm_solver_sample_suite, make_ddim_schedule,
                        plms_sample)
from .diffusion.schedules import DDIMSchedule
from .models.ldm import LatentDiffusion
from .utils_io import load_params

SAMPLERS = ("ddim", "plms", "dpm++", "dpm")


def _device(ldm: LatentDiffusion) -> torch.device:
    return next(ldm.parameters()).device


def _labels(label, n: int, device) -> Dict[str, torch.Tensor]:
    return {"class_label": torch.full((n,), int(label), dtype=torch.long,
                                      device=device)}


def load_weights(ldm: LatentDiffusion, path: str, model_cfg: Dict,
                 use_ema: bool = True) -> LatentDiffusion:
    """Load ``path`` into ``ldm`` (built from ``model_cfg``) through
    ``utils_io.load_params``: a reference Lightning checkpoint, a checkpoint
    of the port's trainers or a state_dict of the model; the EMA weights
    replace the trained ones where the file has them, unless ``use_ema`` is
    False."""
    ldm.load_state_dict(load_params(path, ldm, model_cfg, use_ema=use_ema))
    return ldm


@torch.no_grad()
def sample_class(ldm: LatentDiffusion, label: int, n: int, steps: int = 50,
                 scale: float = 3.0, sampler: str = "ddim", order: int = 2,
                 eta: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``n`` images of class ``label``, [n, H, W, 3] in [-1, 1]: the
    sampler's chain over latents under classifier-free guidance at
    ``scale`` (``steps`` DDIM / PLMS steps or DPM-Solver evaluations of
    ``order``; ``dpm++`` predicts the data, ``dpm`` the noise), then the
    first-stage decode. ``x_T`` replaces the initial draw."""
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be one of {SAMPLERS}")
    batch = _labels(label, n, _device(ldm))
    eps_fn = ldm.make_eps_fn(ldm.encode_conditioning(batch),
                             ldm.null_conditioning(batch, batch_size=n), scale)
    shape = (n, ldm.image_size, ldm.image_size, ldm.channels)
    if sampler == "ddim":
        ddim = make_ddim_schedule(ldm.schedule, steps, eta=eta)
        z = ddim_sample(ddim, ldm.schedule, eps_fn, shape, generator, x_T=x_T,
                        eta_noise=eta > 0)
    elif sampler == "plms":
        ddim = make_ddim_schedule(ldm.schedule, steps, eta=0.0)
        z = plms_sample(ddim, eps_fn, shape, generator, x_T=x_T)
    else:
        z = dpm_solver_sample_suite(ldm.schedule, eps_fn, shape, generator,
                                    steps=steps, order=order,
                                    method="multistep",
                                    predict_x0=sampler == "dpm++", x_T=x_T)
    return torch.clamp(ldm.decode_first_stage(z), -1.0, 1.0)


def inversion_schedule(ldm: LatentDiffusion, steps: int,
                       strength: float) -> DDIMSchedule:
    """The editing stack's DDIM schedule: ``steps`` steps over the first
    ``strength`` of the diffusion (the whole of it at 1 or more)."""
    return make_ddim_schedule(ldm.schedule, steps, eta=0.0,
                              strength=None if strength >= 1.0 else strength)


@torch.no_grad()
def compute_latent_cache(ldm: LatentDiffusion, images: np.ndarray,
                         labels: np.ndarray, steps: int = 40,
                         strength: float = 0.5, reconstruct: bool = False,
                         batch_size: int = 16) -> Dict[str, np.ndarray]:
    """A latent cache of ``images`` ([N, H, W, 3] in [-1, 1]) under their
    source ``labels`` ([N]): ``origin`` (the images in [0, 1]), ``latents``
    (the DDIM inversion of their first-stage encodings over the strength-
    scaled schedule) and, with ``reconstruct``, ``recon`` (the reverse chain
    from those latents, decoded and clamped). Batches of ``batch_size``; the
    last is padded with zero images of label 0, whose rows are dropped."""
    device = _device(ldm)
    ddim = inversion_schedule(ldm, steps, strength)
    images = np.asarray(images, np.float32)
    labels = np.asarray(labels, np.int64)
    out = {"origin": [], "latents": [], "recon": []}
    for s in range(0, len(images), batch_size):
        x, y = images[s:s + batch_size], labels[s:s + batch_size]
        n, pad = len(x), batch_size - len(x)
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            y = np.concatenate([y, np.zeros((pad,), y.dtype)])
        x_t = torch.from_numpy(x).to(device)
        cond = ldm.encode_conditioning(
            {"class_label": torch.from_numpy(y).to(device)})
        eps_fn = ldm.make_eps_fn(cond)
        x_lat = ddim_invert(ddim, eps_fn, ldm.encode_first_stage(x_t))
        out["origin"].append((x[:n] + 1.0) / 2.0)
        out["latents"].append(x_lat[:n].float().cpu().numpy())
        if reconstruct:
            z_rec = ddim_reverse_from(ddim, eps_fn, x_lat)
            rec = torch.clamp(ldm.decode_first_stage(z_rec), -1.0, 1.0)
            out["recon"].append(rec[:n].float().cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items() if v}


@torch.no_grad()
def manipulate(ldm: LatentDiffusion, ddim: DDIMSchedule, trg_label: int,
               src_label: Optional[int] = None,
               z0: Optional[torch.Tensor] = None,
               x_lat: Optional[torch.Tensor] = None,
               scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edit toward ``trg_label``: invert the first-stage latents ``z0``
    under ``src_label`` (or start from the inverted latents ``x_lat``),
    then run the reverse chain under the target, both guided at ``scale``
    against the null embedding. Returns (images in [-1, 1], x_lat)."""
    if (z0 is None) == (x_lat is None):
        raise ValueError("pass exactly one of z0 and x_lat")
    device = _device(ldm)
    b = (z0 if z0 is not None else x_lat).shape[0]
    uncond = (ldm.null_conditioning({"class_label": None}, batch_size=b)
              if scale != 1.0 else None)

    def eps_for(label):
        return ldm.make_eps_fn(
            ldm.encode_conditioning(_labels(label, b, device)), uncond, scale)

    if x_lat is None:
        x_lat = ddim_invert(ddim, eps_for(src_label), z0)
    z_edit = ddim_reverse_from(ddim, eps_for(trg_label), x_lat)
    return torch.clamp(ldm.decode_first_stage(z_edit), -1.0, 1.0), x_lat
