"""Polynomial engine and the CUDA kernel wrappers."""
