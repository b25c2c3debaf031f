"""Host utilities: the port's own copies of the JAX package's synthetic
scenes, depth visualisation and phase timer (numpy only)."""
