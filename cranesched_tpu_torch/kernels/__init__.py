"""Build-and-load plumbing for the port's hand-written CUDA kernels."""
