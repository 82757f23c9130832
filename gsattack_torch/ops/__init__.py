"""Projection, tile binning with its static caps and probes, the blend and
its backward's per-gaussian sum, and the row gather (plain PyTorch and
CUDA); `_cuda` builds and loads the kernel library."""

from .knn import mean_knn_dist2

__all__ = ["mean_knn_dist2"]
