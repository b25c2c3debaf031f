from .render import make_render_fn

__all__ = ["make_render_fn"]
