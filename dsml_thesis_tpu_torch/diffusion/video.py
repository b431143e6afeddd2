"""Frame-progressive talking-face video synthesis.

Counterpart of ``dsml_thesis_tpu/diffusion/video.py``. Per frame: the
conditionings (class + audio-window cross-attention token; masked-frame and
running-identity latents channel-concatenated), a full reverse chain (DDIM,
or DPM-Solver++ multistep in the fewer-steps serving mode), then the
generated latent becomes the next frame's identity latent. All
masked-frame encodes and audio-window encodings are hoisted out of the frame
loop and a leading batch axis carries independent clips.

The JAX package compiles the frame loop and the step loop as nested scans;
here both are Python loops under ``torch.no_grad()``. Noise comes from an
explicit ``torch.Generator``, one draw per frame in frame order (the JAX
package splits a key per frame, so the two do not give the same noise from
the same seed: tests inject ``x_T`` into both).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..flags import env_flag
from .ddim import p_sample_ddim
from .dpm_solver import dpm_solver_sample_suite
from .schedules import DDIMSchedule, DiffusionSchedule

# apply_fn(x_noisy, t, context, concat) -> eps
ApplyFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                   torch.Tensor]


@torch.no_grad()
def progressive_video_sample(
    ddim: DDIMSchedule,
    apply_fn: ApplyFn,
    masked_latents: torch.Tensor,   # [B, F, h, w, c] latents of masked frames
    contexts: torch.Tensor,         # [B, F, L, D] cross-attention tokens
    z_id0: torch.Tensor,            # [B, h, w, c] initial identity latent
    generator: Optional[torch.Generator] = None,
    uncond_contexts: Optional[torch.Tensor] = None,  # [B, F, L, D]
    guidance_scale: float = 1.0,
    x_T: Optional[torch.Tensor] = None,  # [B, F, h, w, c] injected noise
    pair_apply_fn: Optional[ApplyFn] = None,
    sampler: str = "ddim",
    sched: Optional[DiffusionSchedule] = None,
    sampler_steps: int = 20,
    sampler_order: int = 2,
) -> torch.Tensor:
    """Generate all frames; returns latents [B, F, h, w, c] in fp32.

    Guidance swaps only the cross-attention branch; the concat branch is
    shared by both halves. With ``pair_apply_fn`` (and DSML_CFG_DEDUP not 0)
    the UNet gets the B-batch inputs plus the 2B context pair and computes
    the shared prefix once; otherwise the call is batch-doubled.

    sampler="ddim" runs ``ddim``'s chain per frame. sampler="dpm" runs
    DPM-Solver++ multistep instead, ``sampler_steps`` UNet calls of order
    ``sampler_order`` a frame on the same trained model; it needs ``sched``,
    the full training schedule. Initial noise, guidance (with the pair
    dedup) and the identity carry are the same for both.
    """
    if sampler not in ("ddim", "dpm"):
        raise ValueError(f"unknown sampler {sampler!r} (want 'ddim' or 'dpm')")
    if sampler == "dpm" and sched is None:
        raise ValueError("sampler='dpm' needs the full DiffusionSchedule "
                         "(pass sched=ldm.schedule)")
    if sampler == "dpm" and sampler_order not in (1, 2, 3):
        raise ValueError(f"sampler_order must be 1, 2, or 3 "
                         f"(got {sampler_order})")
    if x_T is None and generator is None:
        raise ValueError("pass a torch.Generator (or inject x_T)")

    F = masked_latents.shape[1]
    S = ddim.num_steps
    use_cfg = uncond_contexts is not None and guidance_scale != 1.0
    dedup = pair_apply_fn is not None and env_flag("DSML_CFG_DEDUP", True)

    z_id = z_id0.float()
    frames = []
    for f in range(F):
        concat = torch.cat([masked_latents[:, f].float(), z_id], dim=-1)
        ctx = contexts[:, f]
        if use_cfg:
            ctx_in = torch.cat([uncond_contexts[:, f], ctx], dim=0)
            cc_in = torch.cat([concat, concat], dim=0)

            def eps_fn(x, t):
                if dedup:
                    out = pair_apply_fn(x, t, ctx_in, concat)
                else:
                    out = apply_fn(torch.cat([x, x], dim=0),
                                   torch.cat([t, t], dim=0), ctx_in, cc_in)
                e_u, e_c = out.chunk(2, dim=0)
                return e_u + guidance_scale * (e_c - e_u)
        else:
            def eps_fn(x, t):
                return apply_fn(x, t, ctx, concat)

        if x_T is not None:
            img = x_T[:, f].float()
        else:
            img = torch.randn(z_id0.shape, generator=generator,
                              device=z_id0.device, dtype=torch.float32)
        if sampler == "dpm":
            img = dpm_solver_sample_suite(
                sched, eps_fn, img.shape, steps=sampler_steps,
                order=sampler_order, method="multistep", predict_x0=True,
                x_T=img)
        else:
            for i in range(S):
                img, _ = p_sample_ddim(ddim, eps_fn, img, S - 1 - i)
        z_id = img  # the identity carry
        frames.append(img)
    return torch.stack(frames, dim=1)


def audio_windows(audio_feats: torch.Tensor, num_frames: int,
                  window: int) -> torch.Tensor:
    """Per-frame audio windows [B, F, 2w+1, D] from clip features [B, T, D],
    clamped at the clip's edges."""
    T = audio_feats.shape[1]
    dev = audio_feats.device
    idx = (torch.arange(num_frames, device=dev)[:, None]
           + torch.arange(-window, window + 1, device=dev)).clamp(0, T - 1)
    return audio_feats[:, idx]


def make_video_pipeline(ldm, ddim: DDIMSchedule, audio_window: int,
                        guidance_scale: float = 1.0, decode: bool = True,
                        sampler: str = "ddim", sampler_steps: int = 20,
                        sampler_order: int = 2):
    """The full talking-face synthesis pipeline as one function:

        pipeline(masked_frames[B,F,H,W,3], audio_feats[B,T,D],
                 identity[B,H,W,3], class_label[B], generator, x_T=None)
            -> [B,F,H,W,3] images in [-1, 1] (latents when decode=False)

    Masked-frame encodes (batched over B*F), the identity encode, the
    audio-window conditioning, class / null embeddings, the frame and
    sampler loops, and one first-stage decode per frame. Tensors must lie
    where the model lies.

    sampler="dpm" swaps each frame's DDIM chain for DPM-Solver++ multistep
    at ``sampler_steps`` UNet calls of order ``sampler_order`` (see
    ``progressive_video_sample``); ``ddim`` sets the chain when
    sampler="ddim". With ``split_input_params`` the UNet runs tiled and the
    guidance pair is batch-doubled (the dedup does not tile).
    """

    @torch.no_grad()
    def pipeline(masked_frames, audio_feats, identity, class_label,
                 generator=None, x_T=None):
        B, F = masked_frames.shape[:2]
        m_lat = ldm.encode_first_stage(
            masked_frames.reshape((B * F,) + masked_frames.shape[2:]))
        m_lat = m_lat.reshape((B, F) + m_lat.shape[1:])
        z_id0 = ldm.encode_first_stage(identity)

        windows = audio_windows(audio_feats, F, audio_window)
        bf_batch = {
            "class_label": class_label.repeat_interleave(F),
            "audio": windows.reshape((B * F,) + windows.shape[2:]),
        }
        ctx = ldm.encode_crossattn_tokens(bf_batch)
        ctxs = ctx.reshape((B, F) + ctx.shape[1:])
        uctxs = None
        if guidance_scale != 1.0:
            uctx = ldm.encode_crossattn_tokens(bf_batch, null=True)
            uctxs = uctx.to(ctx.dtype).reshape((B, F) + uctx.shape[1:])

        apply_fn = lambda x, t, c, cc: ldm.apply_model(
            x, t, {"crossattn": c, "concat": cc})
        pair_fn = None if ldm.split_input_params is not None else (
            lambda x, t, c, cc: ldm.apply_model(
                x, t, {"crossattn": c, "concat": cc}, cfg_pairs=True))
        frames = progressive_video_sample(
            ddim, apply_fn, m_lat, ctxs, z_id0, generator,
            uncond_contexts=uctxs, guidance_scale=guidance_scale,
            pair_apply_fn=pair_fn, x_T=x_T, sampler=sampler,
            sched=ldm.schedule, sampler_steps=sampler_steps,
            sampler_order=sampler_order)
        if not decode:
            return frames
        imgs = [ldm.decode_first_stage(frames[:, f]) for f in range(F)]
        return torch.stack(imgs, dim=1).float().clamp(-1.0, 1.0)

    return pipeline
