"""Tensor ops and the CUDA kernel wrappers."""
