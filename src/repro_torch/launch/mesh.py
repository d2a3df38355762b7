"""The graph mesh: the ranks a vertex-partitioned fixpoint runs over.

The counterpart of ``repro/launch/mesh.py``'s ``make_graph_mesh``.
The reference is single-controller: one process drives D devices
through a ``("graph",)`` jax mesh.  Here each shard is a rank of a
``torch.distributed`` process group (multi-controller SPMD): every rank
calls the same function with the same full arguments, works on its own
destination-row block and returns the full answer
(:mod:`repro_torch.distributed.datalog`).

* :class:`GraphMesh` — a process group, its size ``d``, this rank's
  shard index and the device the rank computes on.
* :func:`make_graph_mesh` — the mesh over the first ``d`` ranks of the
  default group; with no group initialized and ``d`` in ``(None, 1)``
  it starts a one-rank world on a ``HashStore`` (NCCL for CUDA tensors,
  gloo for CPU ones), so one rank runs the same collectives code path
  as D ranks.
* :func:`spawn_graph_world` — start ``d`` local ranks, one process
  each, over gloo, run ``fn(mesh, *args)`` on every rank and return
  each rank's result.  Gloo is the backend that runs several ranks on
  one card (NCCL refuses two ranks on one GPU) and on the CPU.

The reference's ``make_production_mesh``, ``make_host_mesh`` and
``make_datalog_mesh`` serve XLA sharding rules and are not ported
(ROADMAP A7, with ``distributed/sharding.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import device as device_mod

#: how long a rank of a spawned world waits on a peer in a collective
WORLD_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True, eq=False)
class GraphMesh:
    """``d`` ranks of a process group along the graph axis; this process
    is shard ``rank`` and computes on ``device``."""

    group: object            # a ProcessGroup; None is the default world
    d: int
    rank: int
    device: torch.device

    @property
    def key(self) -> tuple:
        """Hashable identity for caches keyed on the mesh."""
        return ("graph", self.d, self.rank, str(self.device))

    def __repr__(self) -> str:
        return f"GraphMesh(D={self.d}, rank={self.rank}, {self.device})"


def make_graph_mesh(d: int | None = None, *, device=None) -> GraphMesh:
    """The graph mesh over the first ``d`` ranks of the default process
    group (default: all of them) on ``device`` (default: the GPU).

    With no process group initialized, ``d`` of None or 1 starts a
    one-rank world on a ``HashStore`` — backend ``"cpu:gloo,cuda:nccl"``
    for a CUDA device, ``"gloo"`` for the CPU — and any larger ``d``
    raises: D ranks are D processes, started by the caller
    (:func:`spawn_graph_world`, or ``torch.distributed.
    init_process_group`` with an address, a world size and a rank).
    A ``d`` below the world's size makes a subgroup, a collective call
    every rank of the world must make."""
    dev = device_mod.resolve(device)
    if not dist.is_initialized():
        if d not in (None, 1):
            raise ValueError(
                f"graph mesh needs {d} ranks and no process group is "
                f"initialized — start one process per rank "
                f"(launch.mesh.spawn_graph_world)")
        dist.init_process_group(
            "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    d = world if d is None else int(d)
    if d < 1:
        raise ValueError(f"device count must be ≥ 1, got {d}")
    if d > world:
        raise ValueError(f"graph mesh needs {d} ranks, the process group "
                         f"has {world}")
    group = None if d == world else dist.new_group(list(range(d)))
    rank = dist.get_rank()
    if rank >= d:
        raise ValueError(f"rank {rank} is outside a {d}-rank graph mesh")
    return GraphMesh(group, d, rank, dev)


def _rank_main(rank: int, d: int, store_path: str, out_dir: str, fn, args,
               device) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // d))
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, d), rank=rank,
        world_size=d, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        out = fn(make_graph_mesh(d, device=device), *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_graph_world(fn, d: int, *args, device=None,
                      workdir: str | None = None) -> list:
    """Run ``fn(mesh, *args)`` on ``d`` ranks, one spawned process each,
    joined by gloo over a ``FileStore`` in a temporary directory (under
    ``workdir``, else the system's).  ``fn`` and ``args`` are pickled,
    so ``fn`` is a module-level function; each rank's result comes back
    through ``torch.save``.  Returns the results in rank order.  A rank
    that raises ends the world: the other ranks are killed and the
    error is raised here."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        mp.start_processes(
            _rank_main, args=(d, os.path.join(tmp, "store"), tmp, fn, args,
                              device),
            nprocs=d, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{k}.pt"),
                           weights_only=False) for k in range(d)]
