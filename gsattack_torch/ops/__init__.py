"""Projection, tile binning and the blend (plain PyTorch and CUDA)."""
