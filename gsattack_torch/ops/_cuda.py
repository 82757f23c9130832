"""Build and load the port's CUDA kernels (`gsattack_torch/csrc/*.cu`).

Every `.cu` file is compiled with `nvcc` for `sm_90a` into one shared
library with plain C entry points, on first use, into
`build/gsattack_torch/` under the repository root, named after the package
and a hash of the sources (an edited source rebuilds). The library is loaded
with ctypes; each ops module sets the `argtypes` of its own entry points.
Importing this module needs neither CUDA nor a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build" / "gsattack_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(verbose: bool = False) -> Path:
    """Compile `csrc/*.cu` into one shared library (once per source
    content) and return its path. `verbose` adds `-Xptxas -v`, which
    prints each kernel's registers, shared memory and spills."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD / f"libgsattack_torch_{digest.hexdigest()[:16]}.so"
    if out.exists() and not verbose:
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
    return _lib


def stream(device) -> int:
    """The current CUDA stream of `device`, as the C entry points take it."""
    return torch.cuda.current_stream(device).cuda_stream
