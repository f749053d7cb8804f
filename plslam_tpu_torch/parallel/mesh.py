"""The port's device mesh: one `torch.distributed` process per rank.

The JAX package lays a `jax.sharding.Mesh` over the devices of one program
and lets XLA insert the collectives (`psum`). Here each rank is a process
of a `torch.distributed` process group and owns one device; a `Mesh`
names the rank, the world size, the axis, the group and the rank's
device, and the collectives are explicit.

Backends: NCCL runs one rank per card (it refuses two ranks on one card),
gloo runs ranks that share a card or the CPU. gloo takes CUDA tensors only
in `all_reduce` and `broadcast`, so every collective here is an
all-reduce: `psum` sums, `gather` sums zero-filled full tensors. Nothing
picks a backend or a device by itself: the caller names the backend, and
a rank runs on the card unless the caller names another device; a failed
initialization or collective fails the run.

Launch: `spawn(fn, world, backend)` starts one process per rank (the
`spawn` start method, a `file://` rendezvous in a temporary directory, so
no TCP port is taken) and returns each rank's `fn(mesh, *args)`; under
`torchrun`, call `init_process(backend=...)` (it reads RANK and
WORLD_SIZE) and then `make_mesh`.
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..utils.dist import psum, ranges  # noqa: F401


class Mesh(NamedTuple):
    """One rank's view of a one-axis mesh over a process group."""
    rank: int
    world: int
    axis: str
    group: object          # the process group (None: the default group)
    device: torch.device


def init_process(rank: int | None = None, world: int | None = None,
                 backend: str = "nccl", store_path: str | None = None):
    """Join the default process group as `rank` of `world` through the
    file `store_path` (a `file://` rendezvous); with `rank` None, as
    `torchrun` starts it (RANK, WORLD_SIZE and its rendezvous in the
    environment)."""
    if rank is None:
        dist.init_process_group(backend, init_method="env://")
        return
    if store_path is None:
        raise ValueError("init_process needs a store_path with a rank")
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            rank=rank, world_size=world)


def make_mesh(n_devices: int | None = None, axis: str = "stream",
              device=None) -> Mesh:
    """This rank's mesh over the default process group (`init_process`
    first). `n_devices`, where given, must be the world size. `device`:
    the rank's device, by default card `rank % device_count` (a rank
    without a card raises; ranks that share a card run over gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_process (or run under torchrun) first")
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over a world of "
                         f"{world} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh rank runs on a CUDA device; pass "
                               "device='cpu' for the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(rank, world, axis, None, device)


def share(mesh: Mesh, n: int) -> tuple[int, int]:
    """This rank's range of n items (`ranges`)."""
    return ranges(n, mesh.world)[mesh.rank]


def gather(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's equal share of `x` along `dim`, in rank order, on
    every rank: one all-reduce of zero-filled full tensors (gloo has no
    all-gather of CUDA tensors). Bools travel as bytes."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * mesh.world
    wire = torch.uint8 if x.dtype == torch.bool else x.dtype
    full = torch.zeros(shape, dtype=wire, device=x.device)
    full.narrow(dim, mesh.rank * n, n).copy_(x)
    (full,) = psum(mesh, full)
    return full.to(x.dtype)


def _rank_main(fn, rank, world, backend, store, device, threads, args,
               conn):
    """A spawned rank: join the group, run `fn(mesh, *args)`, send
    ("ok", result) or ("error", traceback) to the parent."""
    try:
        if threads:
            torch.set_num_threads(threads)
        init_process(rank, world, backend, store)
        out = fn(make_mesh(device=device), *args)
        conn.send(("ok", out))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


def spawn(fn, world: int, backend: str, args: tuple = (), device=None,
          threads: int | None = None, timeout: float = 1800.0) -> list:
    """Run `fn(mesh, *args)` on `world` new processes (the `spawn` start
    method; `fn` and `args` are pickled, so `fn` is a module-level
    function), each a rank of a `backend` process group on `device` (as
    `make_mesh` takes it), with `threads` torch threads where given.
    Returns the ranks' results in rank order. A rank that raises or dies
    fails the call: its traceback is raised here and every other rank is
    ended."""
    ctx = multiprocessing.get_context("spawn")
    procs, conns = [], []
    with tempfile.TemporaryDirectory(prefix="plslam_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        try:
            for rank in range(world):
                recv, send = ctx.Pipe(duplex=False)
                p = ctx.Process(target=_rank_main, daemon=True, args=(
                    fn, rank, world, backend, store, device, threads, args,
                    send))
                p.start()
                send.close()
                procs.append(p)
                conns.append(recv)
            results = _collect(procs, conns, timeout)
            for p in procs:
                p.join(timeout=60)
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {procs.index(p)} exited with "
                                       f"code {p.exitcode}")
            return results
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
            for c in conns:
                c.close()


def _collect(procs, conns, timeout: float) -> list:
    """Each rank's result, read as it comes; the first failure raises."""
    results = [None] * len(conns)
    pending = dict(enumerate(conns))
    deadline = time.monotonic() + timeout
    while pending:
        left = deadline - time.monotonic()
        ready = multiprocessing.connection.wait(list(pending.values()),
                                                timeout=max(left, 0))
        if not ready:
            raise TimeoutError(f"ranks {sorted(pending)} gave no result in "
                               f"{timeout:.0f} s")
        for rank, c in list(pending.items()):
            if c not in ready:
                continue
            try:
                status, payload = c.recv()
            except EOFError:
                procs[rank].join(timeout=10)
                raise RuntimeError(f"rank {rank} ended (exit code "
                                   f"{procs[rank].exitcode}) without a "
                                   f"result") from None
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            results[rank] = payload
            del pending[rank]
    return results
