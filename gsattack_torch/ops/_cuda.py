"""Build and load the port's CUDA kernels (`gsattack_torch/csrc/*.cu`).

Every `.cu` file is compiled with `nvcc` for `sm_90a` (one `nvcc` per
source, all started together) and linked into one shared library with plain
C entry points, on first use, into `build/gsattack_torch/` under the
repository root, named after the package and a hash of the sources (an
edited source rebuilds). The library is loaded with ctypes; each ops module
sets the `argtypes` of its own entry points. Importing this module needs
neither CUDA nor a compiler.
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
    "-Xcompiler", "-fPIC",
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
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD / f"{src.stem}_{tag}.o" for src in sources]
    compiles = [
        [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c", "-o", str(obj),
         str(src)]
        for src, obj in zip(sources, objs)
    ]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in compiles]
    results = [(cmd, *proc.communicate(), proc.returncode) for cmd, proc in zip(compiles, procs)]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        for cmd, _, err, rc in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{err}")
            if verbose:
                print(err, end="")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                               f"{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
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
