"""Kernels of the port and their plain versions: sample_pdf, fused-MLP
packing, and the fused render kernels (CUDA, built on first use)."""
