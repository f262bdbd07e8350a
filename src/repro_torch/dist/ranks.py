"""Rank processes on one host for the port's distributed paths.

The reference runs its pipeline and its meshes as one SPMD program over
fake CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count``).
The torch counterpart of "one device per stage" is one process per rank
over ``torch.distributed``: :func:`spawn_ranks` starts ``world`` processes
(``spawn``), joins them through a ``FileStore`` in a work directory, runs
one function in each and returns what each returned, in rank order.  A
rank that raises, dies or outlives the timeout fails the call; the other
ranks are then stopped.

The backend follows one fixed rule (:func:`backend_for`): NCCL when every
rank has a CUDA card of its own; otherwise gloo.  NCCL refuses two ranks
on one card, and gloo's point-to-point and collectives carry host tensors,
so ranks that compute on a shared card send every message through a pinned
host buffer.  The rule is printed by the callers, and a failed init raises:
nothing retries on another backend.
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback
import uuid
from dataclasses import dataclass
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Rank", "backend_for", "init_rank", "spawn_ranks"]


def backend_for(world: int, device: str) -> Tuple[str, str]:
    """``(backend, hop route)`` for ``world`` ranks computing on ``device``
    (``"cpu"`` or ``"cuda"``): gloo with host tensors on the CPU; NCCL on the
    cards when each rank has one; gloo through pinned host buffers when the
    ranks share fewer cards than there are ranks."""
    if device == "cpu":
        return "gloo", "host"
    if device != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    if cards >= world:
        return "nccl", "device"
    return "gloo", "pinned host"


@dataclass(frozen=True)
class Rank:
    """One rank's place: its number, the world, its compute device and the
    backend and hop route :func:`backend_for` chose."""

    rank: int
    world: int
    device: torch.device
    backend: str
    route: str

    @property
    def mesh_device(self) -> str:
        """The device type of a ``DeviceMesh`` over these ranks: where the
        backend's messages live (gloo's on the host)."""
        return "cuda" if self.backend == "nccl" else "cpu"

    def describe(self) -> str:
        hops = {"host": "host tensors", "device": "device tensors",
                "pinned host": "pinned host buffers"}[self.route]
        return f"{self.world} ranks on {self.device.type} | backend {self.backend} | hops through {hops}"


def init_rank(rank: int, world: int, store_path: str, device: str = "cuda",
              timeout_s: float = 300.0) -> Rank:
    """Join the process group of ``world`` ranks rendezvousing on the
    ``FileStore`` at ``store_path``.  The rank computes on
    ``cuda:{rank % device_count}``, or on the CPU when ``device`` is
    ``"cpu"``."""
    backend, route = backend_for(world, device)
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend,
        store=dist.FileStore(store_path, world),
        rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return Rank(rank, world, dev, backend, route)


def _entry(target, rank, world, store_path, device, timeout_s, args, results) -> None:
    try:
        info = init_rank(rank, world, store_path, device, timeout_s)
        out = target(info, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(
    target: Callable[..., Any],
    world: int,
    workdir: str,
    *,
    args: Sequence[Any] = (),
    device: str = "cuda",
    timeout_s: float = 300.0,
) -> List[Any]:
    """``[target(Rank, *args) for each rank]``, each in a process of its
    own.  ``target`` and ``args`` are pickled (a module-level function).
    Raises ``RuntimeError`` naming the rank if one raises or dies, and
    ``TimeoutError`` if the ranks have not all reported after
    ``timeout_s``; every process is joined or stopped before it returns."""
    backend_for(world, device)  # an impossible device raises here, before any spawn
    os.makedirs(workdir, exist_ok=True)
    store_path = os.path.join(workdir, f"rendezvous-{uuid.uuid4().hex[:8]}")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_entry, args=(target, r, world, store_path, device, timeout_s, tuple(args), results))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got = {}
    grace = 3.0  # seconds a rank gets to exit once another has failed
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(got)} of {world} ranks did not report within {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        grace = 30.0
    finally:
        for p in procs:
            p.join(timeout=max(1.0, min(grace, deadline - time.monotonic())))
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(store_path):
            os.remove(store_path)
    return [got[r] for r in range(world)]
