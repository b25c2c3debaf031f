"""Host utilities: the port's own copies of the JAX package's synthetic
scenes and depth visualisation (numpy only), and the port's tracing
(profiling.py)."""
