"""Projection, tile binning, the blend and the row gather (plain PyTorch and
CUDA); `_cuda` builds and loads the kernel library."""
