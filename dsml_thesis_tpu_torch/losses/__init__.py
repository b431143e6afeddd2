"""First-stage training losses of the port: the PatchGAN discriminator and
its losses, LPIPS, and the VQGAN and KL-autoencoder objectives."""
from .contperceptual import KLAutoencoderLoss  # noqa: F401
from .discriminator import (NLayerDiscriminator, adaptive_d_weight,  # noqa: F401
                            adopt_weight, hinge_d_loss, vanilla_d_loss)
from .lpips import LPIPS, load_lpips_weights, lpips_weight_files  # noqa: F401
from .vqperceptual import VQGANLoss  # noqa: F401
