"""gsattack_torch — the PyTorch / CUDA port of `gsattack`.

The same 3D Gaussian Splat attack pipeline as the JAX package, written for
one NVIDIA Hopper card: plain tensor code is PyTorch, and each kernel that
`gsattack` runs in Pallas on a TPU is a hand-written CUDA kernel: the tile
blend's pair (`csrc/blend.cu`) behind a `torch.autograd.Function`, and the
row gather (`csrc/gather.cu`).

Layout mirrors `gsattack/`:
  cli       the command line, `python -m gsattack_torch.cli <command>`: the
            JAX package's ten commands, `--device` (default cuda)
  core/     GaussianScene (with `keep_only` / `removal_setup`), Camera, SH /
            quaternion / covariance math; `edit.py`: combine PLYs, grouped
            object masks, inpaint, recolour
  ops/      projection, tile binning, the blend, the row gather (plain
            PyTorch + CUDA; `ops/_cuda.py` builds and loads the kernels),
            the 3-NN distances that size a new scene's splats, the convex
            hull of a selection (`hull.py`)
  render/   render() with the reference output schema, `to_chw`, and the
            exact per-pixel `render_oracle`
  attack/   PGD steps, silhouette boxes, the DAGGER attack loop, CLOAK
            (poisoned training views, then retraining)
  train/    the 3DGS trainer (L1 + D-SSIM, Adam, the grouping
            regulariser), densify/prune over a fixed capacity
  evals/    ASR and COCO AP over render logs, the adversarial-render
            evaluation, the Gaussian-Grouping renders
  utils/    the YAML config (its own reader, no PyYAML), image losses and
            metrics, the learning-rate schedule
  models/   detector protocol, NMS, success rule; the detector zoo (toy,
            YOLO v3u / v5u / v8 / v11, Faster R-CNN R50-FPN, DETR) behind
            `load_detector`, with the upstream checkpoint loaders
  io/       byte-compatible scene and point PLY, COLMAP and Blender
            datasets, training checkpoints, a PNG codec on the standard
            library (`png.py`)
  convert   numpy weights/state from `gsattack` into this package (scenes,
            cameras, training states, every detector's flax variables)
  scripts/  micro-benches (`python -m gsattack_torch.scripts.micro_gather`)

Importing the package needs neither CUDA nor a compiler: the kernel library
is built and loaded on the first launch on a CUDA tensor. Constructors take
an explicit `device` (default "cuda") and raise when no card is present
unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
