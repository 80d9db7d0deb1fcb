"""Neighbor ranges, pair formulas, plain sweeps and the CUDA sweep kernels."""
