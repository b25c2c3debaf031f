from .metrics import mse, psnr, ssim

__all__ = ["mse", "psnr", "ssim"]
