"""PyTorch / CUDA port of dsml_thesis_tpu: latent-diffusion talking-face
synthesis on one NVIDIA GPU (written for H100).

A package of its own beside the JAX package, which stays the reference the
port is tested against. It imports ``torch`` and never ``jax``, ``flax`` or
``dsml_thesis_tpu``. The TPU package's Pallas kernels become CUDA kernels
under ``csrc/``, built at first use (``ops/_build.py``); on a CPU tensor a
kernel's wrapper runs the kernel's plain PyTorch version instead.

Ported so far: the serving path of the talking-face pipeline
(``configs/latent-diffusion/mead-256-ldm-f4.yaml`` and its ``-fullattn``
twin): first-stage VQGAN, conditioning encoders, UNet, DDIM sampler, the
frame-progressive video pipeline and the micro-batching server; and LDM
training of the same configs (``training/``, ``scripts/train_torch.py``):
the diffusion loss, AdamW, EMA, LR schedules, validation, checkpoints; and
first-stage training of ``configs/autoencoder/{vqgan-f4,kl-f4}.yaml``
(``losses/``, ``training/vqgan_trainer.py``), in fp32.
"""
