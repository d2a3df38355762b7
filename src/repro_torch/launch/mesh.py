"""Meshes: the ranks a sharded run spans (counterpart of
``repro/launch/mesh.py``).

The reference is single-controller: one process drives D devices
through a jax mesh.  Here each device is a rank of a
``torch.distributed`` process group (multi-controller SPMD): every rank
calls the same function, works on its own block and, where the caller
asks, returns the full answer.

* :class:`GraphMesh` and :func:`make_graph_mesh` — the ``("graph",)``
  axis a vertex-partitioned fixpoint runs over
  (:mod:`repro_torch.distributed.datalog`): a process group, its size
  ``d``, this rank's shard index and the device it computes on.
* :class:`ShardMesh` — named axes over the world for the logical-axis
  rules (:mod:`repro_torch.distributed.sharding`): a
  ``torch.distributed.device_mesh.DeviceMesh``, each axis's size and
  process group, this rank's coordinates and its device.
  :func:`make_host_mesh` is ``(world // model, model)`` over ``("data",
  "model")``, :func:`make_datalog_mesh` a flat ``("data",)`` axis for
  query-batch serving, :func:`make_production_mesh` the reference's
  ``(16, 16)`` or ``(2, 16, 16)``, which raises on a smaller world
  instead of shrinking; :func:`make_mesh` any shape (a ``("stage",)``
  axis for :mod:`repro_torch.distributed.pipeline`).
* With no process group initialized, a maker asked for one rank starts
  a one-rank world on a ``HashStore`` — backend
  ``"cpu:gloo,cuda:nccl"`` for a CUDA device, ``"gloo"`` for the CPU —
  so one rank runs the same collectives as W ranks; more ranks are
  more processes, started by the caller.
* :func:`spawn_world` — start ``d`` local ranks, one process each, over
  gloo, build each rank's mesh with ``mesh_fn`` and run ``fn(mesh,
  *args)`` on every rank; :func:`spawn_graph_world` is its graph-mesh
  form.  Gloo is the backend that runs several ranks on one card (NCCL
  refuses two ranks on one GPU) and on the CPU; a collective of a CUDA
  tensor over gloo goes through an explicit host copy
  (:mod:`repro_torch.distributed.collectives`).  Several cards take a
  ``torchrun``-style start instead: ``init_process_group("nccl",
  init_method="tcp://<host>:<port>", world_size=W, rank=r)`` in each
  rank's process, then the same makers.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import math
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import device as device_mod

#: how long a rank of a spawned world waits on a peer in a collective
WORLD_TIMEOUT_S = 600


def _ensure_world(dev: torch.device, want: int | None, what: str) -> int:
    """The world's size, starting a one-rank world when no process group
    exists and ``want`` is None or 1 (any larger ``want`` raises)."""
    if not dist.is_initialized():
        if want not in (None, 1):
            raise ValueError(
                f"{what} needs {want} ranks and no process group is "
                f"initialized — start one process per rank "
                f"(launch.mesh.spawn_world, or init_process_group)")
        dist.init_process_group(
            "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


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
    one-rank world and any larger ``d`` raises.  A ``d`` below the
    world's size makes a subgroup, a collective call every rank of the
    world must make."""
    dev = device_mod.resolve(device)
    world = _ensure_world(dev, d, "graph mesh")
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


@dataclasses.dataclass(frozen=True, eq=False)
class ShardMesh:
    """Named axes over every rank of the world.  ``shape`` and
    ``coords`` map an axis name to its size and to this rank's index
    along it, ``groups`` to the axis's process group (the ranks that
    differ from this one along that axis only); ``device_mesh`` is the
    ``DeviceMesh`` they come from."""

    device_mesh: object
    axis_names: tuple
    shape: dict
    groups: dict
    coords: dict
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"ShardMesh({axes}; rank {self.rank}, {self.device})"


def make_mesh(shape: tuple, axis_names: tuple, *, device=None
              ) -> ShardMesh:
    """A :class:`ShardMesh` of ``shape`` over ``axis_names``, ranks laid
    out row-major (the last axis fastest, as ``jax.make_mesh``); the
    shape's product must be the world's size.  A collective call every
    rank makes."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ "
                         f"in length")
    dev = device_mod.resolve(device)
    need = math.prod(shape)
    world = _ensure_world(dev, need, f"a {shape} mesh")
    if need != world:
        raise ValueError(f"a {shape} mesh over {axis_names} needs {need} "
                         f"ranks, the process group has {world}")
    if dev.type == "cuda" and not torch.cuda.is_initialized():
        # the rank's card before its communicators (several ranks on
        # one card all take card 0)
        torch.cuda.set_device(dev.index if dev.index is not None else
                              dist.get_rank() % torch.cuda.device_count())
    dm = DeviceMesh(dev.type, torch.arange(need).reshape(shape),
                    mesh_dim_names=axis_names)
    coord = dm.get_coordinate()
    return ShardMesh(dm, axis_names, dict(zip(axis_names, shape)),
                     {a: dm.get_group(a) for a in axis_names},
                     dict(zip(axis_names, coord)), dist.get_rank(), dev)


def make_host_mesh(model: int = 1, *, device=None) -> ShardMesh:
    """``(world // model, model)`` over ``("data", "model")``."""
    dev = device_mod.resolve(device)
    world = _ensure_world(dev, None if model == 1 else model, "host mesh")
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"world's {world} ranks")
    return make_mesh((world // model, model), ("data", "model"),
                     device=dev)


def make_datalog_mesh(data: int | None = None, *, device=None
                      ) -> ShardMesh:
    """A flat ``("data",)`` mesh for batched query serving: every rank
    of the world (``data``, when given, must be its size)."""
    dev = device_mod.resolve(device)
    world = _ensure_world(dev, data, "datalog mesh")
    return make_mesh((world if data is None else data,), ("data",),
                     device=dev)


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> ShardMesh:
    """The reference's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``.
    A world of another size raises, naming the ranks it needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks and no process group "
                         f"is initialized")
    return make_mesh(shape, axes, device=device)


def _rank_main(rank: int, d: int, store_path: str, out_dir: str, fn, args,
               device, mesh_fn) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // d))
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, d), rank=rank,
        world_size=d, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        out = fn(mesh_fn(device=device), *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_world(fn, d: int, *args, mesh_fn=make_host_mesh, device=None,
                workdir: str | None = None) -> list:
    """Run ``fn(mesh_fn(device=device), *args)`` on ``d`` ranks, one
    spawned process each, joined by gloo over a ``FileStore`` in a
    temporary directory (under ``workdir``, else the system's).
    ``fn``, ``mesh_fn`` and ``args`` are pickled, so they are
    module-level functions (or partials of them); each rank's result
    comes back through ``torch.save``.  Returns the results in rank
    order.  A rank that raises ends the world: the other ranks are
    killed and the error is raised here."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        mp.start_processes(
            _rank_main, args=(d, os.path.join(tmp, "store"), tmp, fn, args,
                              device, mesh_fn),
            nprocs=d, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{k}.pt"),
                           weights_only=False) for k in range(d)]


def run_cli(fn, model: int, *args, device=None):
    """``fn(mesh, *args)`` for a command line whose run asks for a model
    axis of ``model`` ranks: across the ranks a ``torchrun``-style
    launcher started (``WORLD_SIZE`` in the environment; one process a
    rank, NCCL for cards), else on ``model`` local gloo ranks
    (:func:`spawn_world`; they may share one card), else (``model`` 1,
    no launcher) in this process with no mesh.  Returns rank 0's
    result (this rank's under a launcher)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if not dist.is_initialized():
            dev = device_mod.resolve(device)
            dist.init_process_group("nccl" if dev.type == "cuda" else
                                    "gloo", init_method="env://")
        return fn(make_host_mesh(model, device=device), *args)
    if model > 1:
        return spawn_world(fn, model, *args, device=device,
                           mesh_fn=functools.partial(make_host_mesh,
                                                     model))[0]
    return fn(None, *args)


def spawn_graph_world(fn, d: int, *args, device=None,
                      workdir: str | None = None) -> list:
    """:func:`spawn_world` with each rank's :class:`GraphMesh` over the
    whole world."""
    return spawn_world(fn, d, *args, mesh_fn=functools.partial(
        make_graph_mesh, None), device=device, workdir=workdir)
