"""Collectives over a mesh axis, and compressed gradient reduction
(counterpart of ``repro/distributed/collectives.py``).

The primitives — :func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter`, :func:`broadcast` and the point-to-point
:func:`send_recv` — run over one named axis of a
:class:`~repro_torch.launch.mesh.ShardMesh` (that axis's process group).
Where the group's backend for a tensor's device cannot take it (gloo
and a CUDA tensor: the several-ranks-on-one-card worlds), the payload
goes through an explicit host copy, chosen from the backend before the
call (a one-rank group's collective is a copy on the device); a real
multi-card NCCL world takes the same code with the copies off.  Gloo's reduce-scatter is an all-reduce of which each rank keeps
its block.  :data:`STATS` counts the calls, the payload bytes (each
call's full tensor), the bytes staged through the host, and the most
bytes of gathered parameters alive at once (``gathered_peak_bytes``,
below).

ZeRO-3 on ``"data"`` (the sharded train step) goes through
:func:`gather_param`, an autograd function: forward, the all-gather of a
parameter block's ``"data"`` dimension; backward, the reduce-scatter of
its gradient back to the block's shape, so each layer's gradient leaves
the rank as the backward leaves the layer.  A gathered tensor carries
what it was gathered from, so that :func:`reshard_after_forward` (saved-
tensor hooks around the forward) can drop every saved view of a layer's
gathered weights and gather them again when the backward reaches the
layer.  Every gathered tensor counts in :data:`STATS` while it lives.

The model axis's operators (Megatron's ``f`` and ``g``) are
``torch.autograd.Function`` objects over ``mesh.groups["model"]``, where the
reference's GSPMD would partition a product over ``"model"``:

* :func:`copy_to_model` — the identity forward, a sum over the axis
  backward: the entry of a column-parallel region, where every rank
  holds the whole input and computes on its own columns (and where a
  replicated weight meets the rank's block, so that its gradient sums
  every rank's share);
* :func:`reduce_from_model` — a sum over the axis forward, the identity
  backward: after a row-parallel product, whose ranks each hold a
  partial sum (``torch.distributed.nn.functional.all_reduce`` sums in
  its backward too, which is wrong here: every rank already holds the
  whole gradient of the replicated output);
* :func:`gather_from_model` — every rank's block concatenated along a
  dimension forward, this rank's block of the gradient backward (not a
  sum: every rank computes the same function of the gathered tensor, so
  each already holds its whole gradient): an MoE router's expert
  columns, gathered so that every rank routes alike;
* :func:`max_over_model` — the max over the axis, outside autograd (the
  softmax's shift over vocabulary shards).

Each takes ``mesh`` (None, or a mesh whose ``"model"`` axis is one
rank, is the identity, no copy made), so a one-rank model axis runs the
unsharded arithmetic bit for bit.

The compressed reductions are the reference's, arithmetic for
arithmetic:

* :func:`bf16_all_reduce` — cast to bf16 for the wire, sum, cast back;
* :func:`int8_all_reduce` — a per-rank scale ``max|x| / 127 + 1e-12``,
  ``x / scale`` rounded half to even and clipped to ±127, the int8
  payloads summed in int32, times the mean of the ranks' scales;
* :func:`compressed_grad_reduce` — either over every leaf of a gradient
  tree, divided by the axis size (a mean over the axis).
"""

from __future__ import annotations

import threading
import weakref

import torch
import torch.distributed as dist

#: calls, payload bytes and host-staged bytes since the last reset, and
#: the most bytes of gathered parameters (:func:`gather_param`, and their
#: gathers again in the backward) alive at once since then
STATS = {"calls": 0, "bytes": 0, "host_staged_bytes": 0,
         "gathered_peak_bytes": 0}
#: bytes of gathered parameters alive now
_live = {"bytes": 0}
_live_lock = threading.Lock()


def reset_stats() -> dict:
    """Zero :data:`STATS` (the gathered peak restarts at the bytes alive
    now); returns the counts it held."""
    old = dict(STATS)
    for k in STATS:
        STATS[k] = 0
    STATS["gathered_peak_bytes"] = _live["bytes"]
    return old


def backend_for(group, device_type: str) -> str:
    """The backend ``group`` uses for tensors on ``device_type``:
    ``"cpu:gloo,cuda:nccl"`` splits by device, a single name does not."""
    name = str(dist.get_backend(group))
    if ":" not in name:
        return name
    table = dict(part.split(":") for part in name.split(","))
    return table.get(device_type, name)


def _host_staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` goes through a host copy: a CUDA tensor over gloo,
    unless the group is one rank (the collective is then a copy on the
    device)."""
    return (x.device.type == "cuda" and backend_for(group, "cuda") == "gloo"
            and dist.get_world_size(group) > 1)


def _count(nbytes: int, staged: int = 0) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += nbytes
    STATS["host_staged_bytes"] += staged


#: the group a collective is running over, for a staged count
#: (``launch.hlo_cost``): its ``(size, stride)`` in the world's ranks
_running = threading.local()


def group_span(group) -> tuple[int, int]:
    """``(size, stride)`` of ``group``'s ranks in the world's order (the
    stride between its first two ranks; 1 for one rank): where a
    collective over it runs on a cluster (``launch.hillclimb``)."""
    ranks = dist.get_process_group_ranks(group) if group is not None \
        else list(range(dist.get_world_size()))
    return len(ranks), ranks[1] - ranks[0] if len(ranks) > 1 else 1


def running_span():
    """The ``(size, stride)`` of the group of the collective running on
    this thread now, or None."""
    return getattr(_running, "span", None)


class _over:
    """Marks the collective calls inside as running over ``group``."""

    def __init__(self, group):
        self.group = group

    def __enter__(self):
        _running.span = group_span(self.group)

    def __exit__(self, *exc):
        _running.span = None


def _to_host(x: torch.Tensor) -> torch.Tensor:
    return x.to("cpu", copy=True)


def group_of(mesh, axis: str):
    return mesh.groups[axis]


def all_reduce(x: torch.Tensor, mesh, axis: str, op=None) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over ``axis``'s ranks, in a new
    tensor on ``x``'s device."""
    return all_reduce_group(x, group_of(mesh, axis), op)


def all_reduce_group(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """:func:`all_reduce` over a process group."""
    op = dist.ReduceOp.SUM if op is None else op
    nbytes = x.numel() * x.element_size()
    if _host_staged(x, group):
        h = _to_host(x)
        with _over(group):
            dist.all_reduce(h, op=op, group=group)
        _count(nbytes, 2 * nbytes)
        return h.to(x.device)
    out = x.clone()
    with _over(group):
        dist.all_reduce(out, op=op, group=group)
    _count(nbytes)
    return out


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in the
    axis's order."""
    if x.dtype == torch.bool:       # gathered as bytes
        return all_gather(x.view(torch.uint8), mesh, axis, dim).view(
            torch.bool)
    return _gather_group(x, group_of(mesh, axis), mesh.shape[axis], dim)


def _gather_group(x: torch.Tensor, group, k: int, dim: int
                  ) -> torch.Tensor:
    """:func:`all_gather` over a process group of ``k`` ranks."""
    staged = _host_staged(x, group)
    src = _to_host(x) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(k)]
    with _over(group):
        dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    nbytes = out.numel() * out.element_size()
    _count(nbytes, (x.numel() * x.element_size() + nbytes) if staged else 0)
    return out.to(x.device) if staged else out


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's block, along ``dim``, of the sum of ``x`` over
    ``axis``'s ranks."""
    group = group_of(mesh, axis)
    k, j = mesh.shape[axis], mesh.coords[axis]
    n = x.shape[dim]
    if n % k:
        raise ValueError(f"reduce_scatter: dimension {dim} of "
                         f"{tuple(x.shape)} does not split over {k} ranks")
    b = n // k
    nbytes = x.numel() * x.element_size()
    if backend_for(group, x.device.type) == "gloo":
        staged = _host_staged(x, group)
        h = _to_host(x) if staged else x.clone()
        with _over(group):
            dist.all_reduce(h, group=group)
        out = h.narrow(dim, j * b, b).contiguous()
        _count(nbytes, (nbytes + out.numel() * out.element_size())
               if staged else 0)
        return out.to(x.device) if staged else out
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((b,) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with _over(group):
        dist.reduce_scatter_tensor(out, src, group=group)
    _count(nbytes)
    return out.movedim(0, dim).contiguous()


def send_recv(x, into: torch.Tensor, mesh, axis: str, *, to=None,
              frm=None) -> torch.Tensor:
    """Point to point along ``axis``: send ``x`` to the rank at index
    ``to`` and/or receive into ``into`` from the rank at index ``frm``
    (``isend``/``irecv`` batched, then waited on); returns ``into``."""
    group = group_of(mesh, axis)
    staged = _host_staged(into, group)
    recv = torch.empty_like(into, device="cpu") if staged else into
    ops = []
    if to is not None:
        src = (x.to("cpu") if staged else x).contiguous()
        ops.append(dist.P2POp(dist.isend, src,
                              dist.get_global_rank(group, to), group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, frm), group))
    with _over(group):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    nbytes = into.numel() * into.element_size()
    if to is not None:
        _count(nbytes, nbytes if staged else 0)
    if frm is not None:
        if staged:
            into.copy_(recv)
        _count(0, nbytes if staged else 0)
    return into


def broadcast(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """Rank ``src`` (its index along ``axis``) of ``x``, on every rank
    of the axis."""
    group = group_of(mesh, axis)
    nbytes = x.numel() * x.element_size()
    src_rank = dist.get_global_rank(group, src) if group is not None \
        else src
    if _host_staged(x, group):
        h = _to_host(x)
        with _over(group):
            dist.broadcast(h, src_rank, group=group)
        _count(nbytes, 2 * nbytes)
        return h.to(x.device)
    out = x.clone()
    with _over(group):
        dist.broadcast(out, src_rank, group=group)
    _count(nbytes)
    return out


# -- ZeRO-3: a parameter gathered where it is used ------------------------------


def _release(nbytes: int) -> None:
    with _live_lock:
        _live["bytes"] -= nbytes


def _track(t: torch.Tensor) -> torch.Tensor:
    """Count ``t``, a gathered parameter, in ``gathered_peak_bytes`` until
    it is freed."""
    n = t.numel() * t.element_size()
    with _live_lock:
        _live["bytes"] += n
        STATS["gathered_peak_bytes"] = max(STATS["gathered_peak_bytes"],
                                           _live["bytes"])
    weakref.finalize(t, _release, n)
    return t


class _Source:
    """What a gathered parameter was gathered from: the block (detached),
    the axis and the dimension, whether it stays alive through the
    backward anyway (``resident``), and the tensor gathered again for the
    backward (kept until the gather's own backward has run, so that every
    saved view of the parameter shares one)."""

    __slots__ = ("block", "mesh", "axis", "dim", "resident", "again")

    def __init__(self, block, mesh, axis, dim, resident):
        self.block, self.mesh, self.axis, self.dim = block, mesh, axis, dim
        self.resident, self.again = resident, None

    def gather_again(self) -> torch.Tensor:
        if self.again is None:
            self.again = _track(all_gather(self.block, self.mesh, self.axis,
                                           self.dim))
        return self.again


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, resident):
        out = _track(all_gather(x, mesh, axis, dim))
        ctx.source = out.gathered_from = _Source(x.detach(), mesh, axis, dim,
                                                 resident)
        return out

    @staticmethod
    def backward(ctx, g):
        src = ctx.source
        src.again = None       # every use of the parameter is done
        return (reduce_scatter(g.contiguous(), src.mesh, src.axis, src.dim),
                None, None, None, None)


def gather_param(x: torch.Tensor, mesh, axis: str, dim: int, *,
                 resident: bool = False) -> torch.Tensor:
    """Every rank's block ``x`` along ``axis``, concatenated on ``dim``
    (:func:`all_gather`); its gradient is reduce-scattered back to ``x``'s
    shape (:func:`reduce_scatter`: the sum over the axis's ranks, whose
    losses are each their rows' share of the global one).  Under
    :func:`reshard_after_forward` the saved views of the result are
    dropped and gathered again in the backward, unless ``resident`` (a
    parameter kept for the whole step)."""
    return _GatherParam.apply(x, mesh, axis, dim, resident)


class _Saved:
    """A saved view of a gathered parameter, without its storage."""

    __slots__ = ("source", "size", "stride", "offset")

    def __init__(self, source, t):
        self.source = source
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


def _pack(t: torch.Tensor):
    base = t if t._base is None else t._base
    source = getattr(base, "gathered_from", None)
    if source is None or source.resident:
        return t
    return _Saved(source, t)


def _unpack(x):
    if not isinstance(x, _Saved):
        return x
    return x.source.gather_again().as_strided(x.size, x.stride, x.offset)


def reshard_after_forward():
    """Saved-tensor hooks for a forward whose layers gather their
    parameters (:func:`gather_param`): a tensor autograd saves that is a
    gathered parameter, or a view of one (a transpose, a half of a fused
    ``w_in``), is kept as its block and the view's size, strides and
    offset, and rebuilt in the backward from the parameter gathered again
    — once a parameter, however many views of it were saved.  So a
    layer's gathered weights are freed when its forward ends.  The hooks
    of a rematerialized layer's checkpoint sit inside these and take its
    saved tensors first."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


# -- the model axis's operators -----------------------------------------------

#: the mesh axis of tensor-parallel compute
MODEL = "model"


def _model_group(mesh):
    """The ``"model"`` axis's group, or None where the axis is one rank
    (or there is no mesh)."""
    if mesh is None or mesh.shape.get(MODEL, 1) == 1:
        return None
    return mesh.groups[MODEL]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_group(g.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_group(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        k, j = dist.get_world_size(group), dist.get_rank(group)
        ctx.block, ctx.dim = (j * x.shape[dim], x.shape[dim]), dim
        return _gather_group(x, group, k, dim)

    @staticmethod
    def backward(ctx, g):
        start, n = ctx.block
        return g.narrow(ctx.dim, start, n).contiguous(), None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``"model"``."""
    group = _model_group(mesh)
    return x if group is None else _CopyToModel.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group`` (the ranks that
    hold one replicated block: each holds a share of its gradient).  The
    identity for no group."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over ``"model"``; its gradient passed as it is."""
    group = _model_group(mesh)
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1
                      ) -> torch.Tensor:
    """Every ``"model"`` rank's ``x`` concatenated on ``dim`` in rank
    order; its gradient is this rank's block of the whole one."""
    group = _model_group(mesh)
    if group is None:
        return x
    return _GatherFromModel.apply(x, group, dim % x.dim())


def max_over_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max of ``x`` over ``"model"`` (no gradient)."""
    group = _model_group(mesh)
    if group is None:
        return x
    return all_reduce_group(x.detach().contiguous(), group,
                            dist.ReduceOp.MAX)


# -- compressed reductions ----------------------------------------------------


def bf16_all_reduce(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    return all_reduce(x.to(torch.bfloat16), mesh, axis_name).to(x.dtype)


def int8_all_reduce(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    # sum int8 payloads in int32, then rescale; scales are averaged
    total = all_reduce(q.to(torch.int32), mesh, axis_name)
    s = all_reduce(scale.reshape(1), mesh, axis_name)[0] \
        / mesh.shape[axis_name]
    return (total.to(torch.float32) * s).to(x.dtype)


def compressed_grad_reduce(grads: dict, mesh, axis_name: str = "pod",
                           mode: str = "bf16") -> dict:
    """The mean over ``axis_name``'s ranks of a gradient tree, each leaf
    reduced with wire compression (``"bf16"`` or ``"int8"``)."""
    red = bf16_all_reduce if mode == "bf16" else int8_all_reduce
    k = mesh.shape[axis_name]

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(v) for key, v in node.items()}
        return red(node, mesh, axis_name) / k
    return walk(grads)
