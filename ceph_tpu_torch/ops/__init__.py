"""Placement kernels and engines of the CUDA port."""
