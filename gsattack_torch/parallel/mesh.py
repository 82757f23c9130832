"""The (views, splats) device mesh over `torch.distributed`. Port of
`gsattack/parallel/mesh.py`.

The JAX package runs one controller over a `jax.sharding.Mesh`. The port
runs one process per device (SPMD, as `torchrun` starts them) and a
`DeviceMesh` with `mesh_dim_names=("views", "splats")`, laid out C-order
over the global ranks (rank = views_index * splats + splats_index):

- the **splats** axis is the inner one, so its ranks are neighbours on a
  host (NVLink). It carries the heavy collectives: the projected-array
  all-gather and its gradient's reduce-scatter (`parallel/shard.py`);
- the **views** axis is the outer one and may cross hosts. It carries one
  gradient all-reduce a step, for the views-replicated scene shards, and
  the gather of the rendered view blocks.

`run_local` starts the ranks of one host as processes (the tests' gloo
groups and the card's one-card rehearsal use it); `torchrun` starts them
for a real multi-card run, and `initialize_distributed()` reads its
environment.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import tempfile
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

VIEWS_AXIS = "views"
SPLATS_AXIS = "splats"
BACKENDS = ("nccl", "gloo")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(
    backend: str = "nccl",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    expect_devices: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Join this process to the process group, on `backend` ("nccl" or
    "gloo"). The counterpart of `jax.distributed.initialize`.

    `init_method` (a `tcp://host:port` or `file://path` rendezvous),
    `world_size` and `rank` are given together or not at all. Without them
    the process reads `torchrun`'s environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) or, outside `torchrun`, forms a group of one.
    A process that has joined a group already keeps it, and its rank.
    On a CUDA `device`, rank r runs on `cuda:LOCAL_RANK` (LOCAL_RANK
    defaults to the global rank; modulo the cards present, so that gloo
    ranks can share one card); NCCL needs a CUDA device. After the join,
    the world size must equal `expect_devices` when it is given. Returns
    {distributed, process_id, num_processes, devices, local_devices,
    local_rank, backend, device}."""
    explicit = [init_method, world_size, rank]
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            raise ValueError(
                "init_method, world_size and rank must be given together for "
                "an explicit process group"
            )
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} out of range for {world_size} processes")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    elif init_method is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
            rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        else:
            init_method, rank, world_size = f"tcp://127.0.0.1:{_free_port()}", 0, 1
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    n = dist.get_world_size()
    if expect_devices is not None and n != expect_devices:
        raise RuntimeError(
            f"expected {expect_devices} global devices after init, found {n} "
            f"(processes up: {n})"
        )
    return {
        "distributed": n > 1,
        "process_id": dist.get_rank(),
        "num_processes": n,
        "devices": n,
        "local_devices": 1,
        "local_rank": local_rank,
        "backend": dist.get_backend(),
        "device": dev,
    }


def local_mesh_shape(n_devices: Optional[int] = None, views: Optional[int] = None
                     ) -> tuple[int, int]:
    """Pick a (views, splats) mesh shape: the requested view-parallel
    degree, else as much of it as divides the device count (capped at 8);
    the rest goes to splat sharding. The device count defaults to the
    world size of the process group."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized()
                      else max(torch.cuda.device_count(), 1))
    if views is None:
        views = 1
        for cand in (8, 4, 2):
            if n % cand == 0:
                views = cand
                break
    if n % views:
        raise ValueError(f"{n} devices not divisible by views={views}")
    return views, n // views


def make_mesh(shape: Optional[tuple[int, int]] = None, device_type: str = "cuda") -> DeviceMesh:
    """The (views, splats) `DeviceMesh` over every rank of the process
    group (`initialize_distributed` first). `shape` defaults to
    `local_mesh_shape()` and must multiply to the world size."""
    n = dist.get_world_size()
    shape = tuple(shape) if shape is not None else local_mesh_shape(n)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not hold the {n} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=(VIEWS_AXIS, SPLATS_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along the named mesh axis."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _rank_main(rank, world_size, init_method, backend, device, threads, fn, args, results):
    try:
        torch.set_num_threads(threads)
        info = initialize_distributed(backend, init_method, world_size, rank, device=device)
        results.put((rank, True, fn(info, *args)))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local(fn: Callable, world_size: int, args: tuple = (), backend: str = "gloo",
              device: str | torch.device = "cuda", threads: int = 1,
              timeout: float = 600.0) -> list:
    """Run `fn(info, *args)` on `world_size` ranks of one host, each a
    spawned process joined by `initialize_distributed` (a `file://`
    rendezvous in a fresh temporary directory; `info` is its summary,
    with the rank's device), and return each rank's result in rank
    order. `fn` and its arguments and result must pickle. The ranks run
    on the card unless `device` is the CPU; without a card a CUDA
    `device` raises here, before any rank starts. Raises with the rank's
    traceback if a rank raised, or if the ranks have not all answered
    within `timeout` seconds; no process outlives the call."""
    device = resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rdzv")
        procs = [
            ctx.Process(target=_rank_main, args=(r, world_size, init_method, backend, device,
                                                 threads, fn, args, results))
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        got, done = {}, False
        try:
            for _ in procs:
                r, ok, value = results.get(timeout=timeout)
                if not ok:
                    raise RuntimeError(f"rank {r} of {world_size} failed:\n{value}")
                got[r] = value
            done = True
        except queue.Empty:
            raise RuntimeError(
                f"ranks {sorted(set(range(world_size)) - set(got))} of {world_size} did "
                f"not answer within {timeout} s"
            ) from None
        finally:
            # After a failure the other ranks may wait in a collective.
            for p in procs:
                p.join(timeout=30 if done else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world_size)]
