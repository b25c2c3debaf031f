"""Kernels of the port and their plain versions: sample_pdf, the fused
point MLP (packing and its three kernels), the fused render kernels and
the three training render kernels (CUDA, built on first use)."""
