from .occupancy import (CulledRenderer, OccupancyGrid, load_or_build_grid,
                        rays_aabb)
from .render import (ModelConfig, RenderConfig, TrainDraws,
                     fused_mse_train_step, render_rays, render_rays_chunked,
                     volume_quadrature)

__all__ = ["CulledRenderer", "ModelConfig", "OccupancyGrid", "RenderConfig",
           "TrainDraws", "fused_mse_train_step", "load_or_build_grid",
           "rays_aabb", "render_rays", "render_rays_chunked",
           "volume_quadrature"]
