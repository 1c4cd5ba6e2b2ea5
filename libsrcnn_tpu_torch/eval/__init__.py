"""Quality evaluation: PSNR / SSIM vs reference goldens."""

from .metrics import psnr, ssim  # noqa: F401
