from .render import (ModelConfig, RenderConfig, render_rays,
                     render_rays_chunked, volume_quadrature)

__all__ = ["ModelConfig", "RenderConfig", "render_rays",
           "render_rays_chunked", "volume_quadrature"]
