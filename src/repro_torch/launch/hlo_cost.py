"""The planner's measured cost model: one step's operations, bytes and
collective bytes, counted op by op.

The counterpart of ``repro/launch/hlo_cost.py``, under its names
(``cost_model="hlo"``, ``CostEstimate.source == "hlo"``,
:func:`staged_cost`) so that plans and ``explain()`` line up with the
reference's.  The reference lowers and compiles the step and walks the
optimized HLO text.  An eager step has no HLO: :func:`staged_cost` runs
the step once on its real arguments under a ``TorchDispatchMode`` and
counts each aten op as it runs, which is one kernel:

* dot FLOPs ``2·|result|·|contracted|`` (the reference's ``_dot_flops``
  rule) for the matmul family;
* ``|result|`` for each elementwise or reduce op;
* bytes: each tensor operand and the result (an expanded dimension read
  once), the count the reference takes at a fusion boundary; views,
  allocations and ops without a tensor operand (constants, ``arange``)
  move nothing;
* collective bytes, the result's, in ``per_collective`` under the
  reference's names (``all-reduce``, ``all-gather``, …).

A hand-written kernel (B1, B2, B3) counts as one op with the operations
and bytes its bound reckons, whether its CUDA version or its plain
version ran (:mod:`repro_torch.kernels.costing`): the plain version's
own ops are not counted, so a CPU plan and a card plan price a kernel
alike.  The first call of the step builds what it caches (segment
plans, device copies of a kernel's geometry) and is not counted, as the
reference's compile is not.

The reference's HLO walker (``analyze``, ``parse_computations``, the
``while`` trip-count rule) has nothing to read here and is not ported;
the planner multiplies a step's count by its predicted trips, as the
reference's does.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import costing

#: the matmul family: ``2·|result|·|contracted|`` with the contracted
#: extent read off the first matrix operand's last dimension
_DOTS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "vdot": 0,
         "addmm": 1, "baddbmm": 1, "addmv": 1}

#: reduce-like ops beyond those tagged ``reduction`` (the reference
#: counts its sort and scatter ops as reduces)
_REDUCES = {"sort", "scatter", "scatter_add", "scatter_reduce",
            "index_add", "index_reduce", "cumsum", "cumprod", "cummax",
            "cummin", "logcumsumexp"}

#: elementwise ops beyond those tagged ``pointwise``: a dtype cast (the
#: reference's ``convert``) and a masked fill (its ``select``)
_ELEMENTWISE = {"_to_copy", "masked_fill"}

#: copies: bytes, no operations (tagged ``pointwise`` all the same)
_COPIES = {"clone", "copy"}

#: ops that move no data: allocations and shape-only rewrites that are
#: not tagged as views
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "resize"}

#: aten collective names → the reference's HLO opcode names
_COLLECTIVES = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                ("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                ("send", "collective-permute"),
                ("recv", "collective-permute"))


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    #: collective bytes by the group they ran over, ``"size×stride"`` of
    #: its ranks in the world's order (``collectives.group_span``;
    #: ``"?"`` for a collective not made by ``distributed.collectives``)
    collective_spans: dict = dataclasses.field(default_factory=dict)
    #: hand-written kernel calls by ``"name/path"``
    kernels: dict = dataclasses.field(default_factory=dict)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    """The bytes a kernel reads or writes of ``t``: an expanded (stride
    0) dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _collective(name: str) -> str | None:
    for key, hlo in _COLLECTIVES:
        if key in name:
            return hlo
    return None


class _CountMode(TorchDispatchMode):
    """Counts every aten op that runs outside a reported kernel."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.paused = False

    def kernel(self, name: str, path: str, ops: float, nbytes: float):
        self.cost.flops += ops
        self.cost.bytes += nbytes
        key = f"{name}/{path}"
        self.cost.kernels[key] = self.cost.kernels.get(key, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func._overloadpacket.__name__.rstrip("_")
        ins = _tensors((args, kwargs))
        res = _tensors(out)
        hlo = _collective(name)
        if hlo is not None:
            b = float(sum(_bytes(t) for t in res))
            c = self.cost
            c.collective_bytes += b
            c.per_collective[hlo] = c.per_collective.get(hlo, 0.0) + b
            c.collective_counts[hlo] = c.collective_counts.get(hlo, 0) + 1
            from repro_torch.distributed import collectives
            span = collectives.running_span()
            key = "?" if span is None else f"{span[0]}×{span[1]}"
            c.collective_spans[key] = c.collective_spans.get(key, 0.0) + b
            return
        if func.is_view or name in _FREE or not ins or not res:
            return
        elems = float(res[0].numel())
        if name in _DOTS:
            mat = ins[_DOTS[name]]
            self.cost.flops += 2.0 * elems * mat.shape[-1]
        elif name not in _COPIES and (
                torch.Tag.pointwise in func.tags
                or torch.Tag.reduction in func.tags
                or name in _ELEMENTWISE or name in _REDUCES):
            self.cost.flops += elems
        self.cost.bytes += float(sum(_bytes(t) for t in ins)
                                 + sum(_bytes(t) for t in res))


def staged_cost(fn, *args) -> Cost:
    """Run ``fn(*args)`` once to build what it caches, then once more
    under the count; returns that step's :class:`Cost`."""
    fn(*args)
    mode = _CountMode()
    with costing.open_count(mode), mode:
        fn(*args)
    return mode.cost
