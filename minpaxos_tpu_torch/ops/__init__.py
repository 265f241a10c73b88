"""Batched tensor ops of the consensus step; hot ones launch CUDA kernels."""
