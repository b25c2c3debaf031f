from .render import make_render_fn
from .spmd import Trainer, TrainState

__all__ = ["make_render_fn", "Trainer", "TrainState"]
