"""Tensor ops: activations, sampling, compositing, and the CUDA kernels."""
