"""Camera geometry in torch. The dataset classes are shared with the JAX
package (nerf_pl_tpu.datasets, numpy + PIL)."""
