"""Hand-written device kernels: the fused FM chain for NVIDIA GPUs
(Pallas through Triton)."""
