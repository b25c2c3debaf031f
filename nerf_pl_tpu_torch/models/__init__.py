from .embedding import EmbeddingConfig, embed
from .nerf import (NeRF, NeRFConfig, init_nerf_params, nerf_apply,
                   params_from_numpy)

__all__ = ["EmbeddingConfig", "embed", "NeRF", "NeRFConfig",
           "init_nerf_params", "nerf_apply", "params_from_numpy"]
