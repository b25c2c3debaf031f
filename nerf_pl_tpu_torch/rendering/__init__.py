from .render import (ModelConfig, RenderConfig, TrainDraws,
                     fused_mse_train_step, render_rays, render_rays_chunked,
                     volume_quadrature)

__all__ = ["ModelConfig", "RenderConfig", "TrainDraws",
           "fused_mse_train_step", "render_rays", "render_rays_chunked",
           "volume_quadrature"]
