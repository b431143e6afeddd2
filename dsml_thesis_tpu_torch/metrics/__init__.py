"""Evaluation metrics of the port: PSNR / SSIM (``image``), the FID
InceptionV3 (``inception``) and the FID / KID / IS / PRC math (``fid``),
WER / CER / viseme rates (``lipread``) over the edit-distance library
(``native``)."""
from .image import cosine_similarity, psnr, ssim, to_unit_range  # noqa: F401
