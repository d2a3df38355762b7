"""B3: semiring segment ⊕-reduce over COO ids (``csrc/coo_segment.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/coo_segment.py:38``
(``_kernel`` via ``segment_reduce_pallas`` :64): the scatter half of
sparse contraction, ``out[s] = ⊕ vals[i]`` over ``ids[i] = s``, with
out-of-range ids (COO sentinels) dropped.  The reference routes only
``(m,)`` payloads to its kernel; here ``(m, B)`` payloads — the batched
SpMM rows of ``contract.spmm`` — take the same kernels.

Two paths (see the source note in the ``.cu`` file):

* ``runs`` — for ids that have a segment plan (:func:`plan_segment`,
  built once per ids tensor on its device and cached weakly): the
  in-range entries in a stable order by id, cut into work items of at
  most ``E_CHUNK`` entries of one row (B1's :class:`~repro_torch.
  kernels.coo_spmm.Items`: hub rows split, one empty item for a row no
  entry reaches).  The caller hands the payload in plan order (``vals[
  plan.order]``, as ``contract`` does from the relation's memoized
  columns); each output row is written once by its owner, with no
  atomics on it and no fill pass, and a split row's partials are folded
  in item order, so real sums repeat bit for bit.
* ``scatter`` — ids without a plan (one-shot keys): global atomics.

Bound on the card: bytes (the payload, the items, the written rows).

:func:`segment_reduce` dispatches on the tensor's device: CPU tensors
take the plain versions — :func:`segment_runs_plain` (items and folds
emulated) with a plan, the oracle :func:`segment_reduce_plain`
without — and CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.kernels import cuda_lib, ref
from repro_torch.kernels.coo_spmm import E_CHUNK, Geometry, Items, cut_items

#: the plain PyTorch version of this kernel (the oracle of both paths)
segment_reduce_plain = ref.segment_reduce_ref

_MODE = {"bool": 0, "trop": 1, "maxplus": 2, "nat": 3, "real": 3}
PATHS = ("runs", "scatter")
#: warps a block of the runs kernels (csrc: WARPS)
WARPS = 8
#: items a warp of the runs kernels (csrc: ITEMS)
ITEMS_PER_WARP = 4
#: csrc kernel ids: (m,) payloads, (m, B) rows
_SCALAR, _ROWS = 0, 1
#: grid.y limit
_GRID_Y = 65535


@dataclasses.dataclass
class SegmentPlan:
    """The sorted-run geometry of one ids column over ``n`` rows, on the
    ids' device.  ``order`` picks the entries whose id lies in ``[0,
    n)`` in a stable order by id (negative ids sort before them, the
    sentinel ``n`` and above after, and neither is kept); the items cut
    ``[0, m_live)`` of that order."""

    m: int                    # entries of the ids column
    n: int                    # output rows
    order: torch.Tensor       # (m_live,) int64 entry indices, sorted by id
    items: Items              # device tensors over the sorted entries
    slot_fold: torch.Tensor   # (n_part,) int32: each partial slot's split row
    n_part: int               # partial slots (items of split rows)
    _tickets: dict = dataclasses.field(default_factory=dict, repr=False)
    _launch: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def m_live(self) -> int:
        return int(self.order.shape[0])

    @property
    def device(self) -> torch.device:
        return self.order.device

    def tickets(self, slabs: int) -> torch.Tensor:
        """The split rows' tickets for ``slabs`` column slabs: int32
        zeros, which every launch leaves zero (allocated once).  They and
        the partials' scratch are the plan's, so its launches run on one
        stream at a time."""
        t = self._tickets.get(slabs)
        if t is None:
            t = self._tickets[slabs] = torch.zeros(
                max(1, self.items.n_split * slabs), dtype=torch.int32,
                device=self.device)
        return t


_PLANS: dict[tuple[int, int], tuple[weakref.ref, SegmentPlan]] = {}


def _cached(ids: torch.Tensor, n: int) -> SegmentPlan | None:
    ent = _PLANS.get((id(ids), int(n)))
    if ent is not None and ent[0]() is ids:
        return ent[1]
    return None


def plan_segment(ids: torch.Tensor, n: int) -> SegmentPlan:
    """The (cached) segment plan of an ids column over ``n`` rows: the
    ``runs`` path's geometry.  Built on the ids' device (a stable sort,
    a bincount and a cumsum) the first time a tensor is seen, kept while
    it lives; the ids must not change after."""
    plan = _cached(ids, n)
    if plan is not None:
        return plan
    plan = _build_plan(ids, int(n))
    key = (id(ids), int(n))

    def _evict(r, k=key):
        cur = _PLANS.get(k)
        if cur is not None and cur[0] is r:
            _PLANS.pop(k, None)

    _PLANS[key] = (weakref.ref(ids, _evict), plan)
    return plan


def _build_plan(ids: torch.Tensor, n: int) -> SegmentPlan:
    if ids.dim() != 1:
        raise ValueError(f"plan_segment: ids must be (m,), got "
                         f"{tuple(ids.shape)}")
    if ids.shape[0] >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("plan_segment: more than 2³¹ entries or rows")
    key = ids.long()
    srt, perm = torch.sort(key, stable=True)
    lo, hi = torch.stack([(key < 0).sum(), (key < n).sum()]).tolist()
    deg = torch.bincount(srt[lo:hi], minlength=n)
    items = cut_items(deg)
    pieces = torch.diff(items.fold_seg)
    slot_fold = torch.repeat_interleave(
        torch.arange(items.n_split, dtype=torch.int32, device=ids.device),
        pieces)
    return SegmentPlan(int(ids.shape[0]), n, perm[lo:hi], items, slot_fold,
                       int(slot_fold.shape[0]))


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def plan_runs(plan: SegmentPlan, sr_name: str, lanes: int | None
              ) -> tuple[int, int, Geometry]:
    """The ``runs`` launch over ``plan`` for a payload of ``lanes`` lanes
    (None for ``(m,)``): ``(kernel, elem_bytes, Geometry)``.  ``(m,)``
    and ``(m, 1)`` payloads take the scalar kernel; wider rows the rows
    kernel, f32 with 16-byte loads where the width allows, 𝔹 as words of
    four lanes where it divides by 4, else as bytes."""
    if sr_name not in _MODE:
        raise ValueError(f"coo_segment: unknown semiring {sr_name!r}")
    it = plan.items
    per_block = WARPS * ITEMS_PER_WARP
    grid_x = math.ceil(it.n_items / per_block)
    if lanes is None or lanes == 1:
        return _SCALAR, 1 if sr_name == "bool" else 4, Geometry(
            it, 1, 1, 1, (grid_x, 1), plan.n_part)
    if lanes < 0:
        raise ValueError(f"coo_segment: negative lane count {lanes}")
    if sr_name == "bool":
        elem = 4 if lanes % 4 == 0 else 1
        row_len, vec = lanes // elem, 1
    else:
        elem, row_len = 4, lanes
        vec = 4 if lanes % 4 == 0 else 1
    tpe = min(32, _pow2_at_least(-(-row_len // vec)))
    slabs = max(1, -(-row_len // (tpe * vec)))
    if slabs > _GRID_Y:
        raise ValueError(f"coo_segment: {lanes} lanes exceed the grid limit")
    return _ROWS, elem, Geometry(it, row_len, vec, tpe, (grid_x, slabs),
                                 plan.n_part * row_len)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def segment_runs_plain(sr, plan: SegmentPlan,
                       vals: torch.Tensor) -> torch.Tensor:
    """The ``runs`` path as the kernels run it, on a payload in plan
    order: each item ⊕-reduces its entries into its row, or into its
    partial slot for a split row (an empty item gives 0̄), and each split
    row folds its partials in item order.  Returns ``(n,) + vals.shape[
    1:]``; the CPU path of ``runs``."""
    it, dev = plan.items, vals.device
    tail = tuple(vals.shape[1:])
    item_of = torch.repeat_interleave(
        torch.arange(it.n_items, device=dev), torch.diff(it.edge.long()))
    acc = sr_mod.scatter_op(sr.name, sr.zeros((it.n_items,) + tail, dev),
                            item_of, vals)
    dst = it.dst.long()
    whole = dst >= 0
    out = torch.empty((plan.n,) + tail, dtype=sr.dtype, device=dev)
    out[dst[whole]] = acc[whole]
    if it.n_split:
        part = acc[~whole]                 # slot order is item order
        seg = it.fold_seg.long()
        pieces = torch.diff(seg)
        row = part[seg[:-1]]
        for j in range(1, int(pieces.max())):
            more = pieces > j
            row[more] = sr.add(row[more], part[seg[:-1][more] + j])
        out[it.fold_row.long()] = row
    return out


# --------------------------------------------------------------------------
# dispatch and launch
# --------------------------------------------------------------------------


def segment_reduce(sr_name: str, vals: torch.Tensor,
                   segment_ids: torch.Tensor, num_segments: int, *,
                   plan: SegmentPlan | None = None) -> torch.Tensor:
    """⊕-reduce ``vals`` ``(m,)`` / ``(m, B)`` by ``segment_ids`` into
    ``num_segments`` rows — or, with the ids' ``plan``, ``vals`` already
    in plan order (``plan.m_live`` rows)."""
    if vals.device.type == "cpu":
        sr = sr_mod.get(sr_name)
        if plan is None:
            return segment_reduce_plain(sr, vals, segment_ids, num_segments)
        _check_plan(plan, vals, segment_ids, num_segments)
        return segment_runs_plain(sr, plan, vals)
    return segment_reduce_cuda(sr_name, vals, segment_ids, num_segments,
                               plan)


def _check_plan(plan, vals, segment_ids, num_segments) -> None:
    if _cached(segment_ids, num_segments) is not plan:
        raise ValueError("segment_reduce: the plan was not built from these "
                         "ids over these rows")
    if vals.dim() not in (1, 2) or vals.shape[0] != plan.m_live:
        raise ValueError(f"segment_reduce: a payload of {plan.m_live} rows in "
                         f"plan order expected, got {tuple(vals.shape)}")
    if vals.device != plan.device:
        raise ValueError(f"segment_reduce: payload on {vals.device}, plan on "
                         f"{plan.device}")


def segment_reduce_cuda(sr_name: str, vals: torch.Tensor,
                        segment_ids: torch.Tensor, num_segments: int,
                        plan: SegmentPlan | None = None) -> torch.Tensor:
    """Launch the ``runs`` kernel (with a plan) or the ``scatter`` kernel
    (without); counts launches in ``.launches`` and by path in
    ``.by_path``."""
    sr = sr_mod.get(sr_name)
    if vals.dim() not in (1, 2):
        raise ValueError(f"segment_reduce: payload must be (m,) or (m, B), "
                         f"got {tuple(vals.shape)}")
    cuda_lib.require(vals, "vals", dtype=sr.dtype)
    if plan is None:
        m = int(vals.shape[0])
        cuda_lib.require(segment_ids, "segment_ids", dtype=torch.int32,
                         shape=(m,))
        if segment_ids.device != vals.device:
            raise ValueError("segment_reduce: vals and ids on different "
                             "devices")
    else:          # the kernel reads the plan, built from these very ids
        _check_plan(plan, vals, segment_ids, num_segments)
    out = torch.empty((num_segments,) + tuple(vals.shape[1:]),
                      dtype=sr.dtype, device=vals.device)
    lib, stream = cuda_lib.library(), cuda_lib.stream_of(vals)
    if plan is None:
        lanes = int(vals.shape[1]) if vals.dim() == 2 else 1
        err = lib.coo_segment_reduce(
            _MODE[sr_name], vals.data_ptr(), segment_ids.data_ptr(),
            out.data_ptr(), m, lanes, int(num_segments), stream)
        cuda_lib.check(err, "coo_segment_reduce (scatter)")
        path = "scatter"
    else:
        _launch_runs(sr_name, plan, vals, out, lib, stream)
        path = "runs"
    segment_reduce_cuda.launches += 1
    segment_reduce_cuda.by_path[path] += 1
    return out


def _launch_runs(sr_name, plan, vals, out, lib, stream) -> None:
    lanes = int(vals.shape[1]) if vals.dim() == 2 else None
    key = (sr_name, lanes)
    launch = plan._launch.get(key)
    if launch is None:   # the constant arguments, converted once, and the
        kernel, elem, geo = plan_runs(plan, sr_name, lanes)    # scratch
        it, tickets = geo.items, plan.tickets(geo.grid[1])
        words = sr_name == "bool" and elem == 4
        part = torch.empty(geo.scratch, device=plan.device,
                           dtype=torch.int32 if words else sr_mod.get(
                               sr_name).dtype)
        types = cuda_lib.SIGNATURES["coo_segment_runs"]
        head = (_MODE[sr_name], kernel, elem)
        arrays = tuple(t.data_ptr() for t in (it.edge, it.dst, plan.slot_fold,
                                              it.fold_row, it.fold_seg,
                                              tickets))
        tail = (plan.n, geo.row_len, geo.vec, geo.threads_per_edge, E_CHUNK,
                it.n_items, 0, plan.m_live, it.max_edges, it.n_split,
                plan.n_part, geo.scratch, tickets.numel(), *geo.grid)
        launch = plan._launch[key] = (
            elem, geo, words, part,
            tuple(t(v) for t, v in zip(types[:3], head)),
            tuple(t(v) for t, v in zip(types[4:10], arrays)),
            tuple(t(v) for t, v in zip(types[13:28], tail)))
    elem, geo, words, part, head, arrays, tail = launch
    if out.numel() == 0:
        return
    if vals.data_ptr() % (16 if geo.vec == 4 else elem):
        vals = vals.clone()               # vector loads want an aligned base
    src = vals.view(torch.int32) if words else vals
    dst = out.view(torch.int32) if words else out
    err = lib.coo_segment_runs(*head, src.data_ptr(), *arrays, dst.data_ptr(),
                               part.data_ptr(), vals.shape[0], *tail, stream)
    cuda_lib.check(err, "coo_segment_runs")


segment_reduce_cuda.launches = 0
segment_reduce_cuda.by_path = dict.fromkeys(PATHS, 0)
