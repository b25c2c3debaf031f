from .losses import loss_dict, mse_loss
from .lr_schedule import get_lr_schedule
from .metrics import mse, psnr, ssim
from .optimizers import apply_updates, get_optimizer

__all__ = ["apply_updates", "get_lr_schedule", "get_optimizer", "loss_dict",
           "mse", "mse_loss", "psnr", "ssim"]
