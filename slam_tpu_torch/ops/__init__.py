"""Estimation math: plane algebra, resampling, and the CUDA kernels."""
