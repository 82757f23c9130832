"""gsattack_torch — the PyTorch / CUDA port of `gsattack`.

The same 3D Gaussian Splat attack pipeline as the JAX package, written for
one NVIDIA Hopper card: plain tensor code is PyTorch, and the tile blend,
which `gsattack` runs as a Pallas TPU kernel, is a hand-written CUDA kernel
pair (`csrc/blend.cu`) behind a `torch.autograd.Function`.

Layout mirrors `gsattack/`:
  core/     GaussianScene, Camera, SH / quaternion / covariance math
  ops/      projection, tile binning, the blend (plain PyTorch + CUDA)
  render/   render() with the reference output schema
  attack/   PGD steps, silhouette boxes, the DAGGER attack loop
  models/   detector protocol, NMS, success rule, the toy detector
  io/       byte-compatible scene PLY
  convert   numpy weights/state from `gsattack` into this package

Importing the package needs neither CUDA nor a compiler: the kernel library
is built and loaded on the first launch on a CUDA tensor. Constructors take
an explicit `device` (default "cuda") and raise when no card is present
unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
