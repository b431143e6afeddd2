"""Model modules of the port."""
from .autoencoder import AutoencoderKL, DiagonalGaussian, VQModel  # noqa: F401
from .encoders import ClassEmbedder, Conv1DTemporalAttention  # noqa: F401
from .ldm import CondSpec, LatentDiffusion  # noqa: F401
from .quantize import VectorQuantizer  # noqa: F401
from .unet import UNetModel, timestep_embedding  # noqa: F401
