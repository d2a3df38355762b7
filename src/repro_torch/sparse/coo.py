"""COO semiring tensors with fixed-capacity padded buffers.

The counterpart of ``repro/sparse/coo.py``.  A :class:`SparseRelation`
stores an S-relation as ``coords[(cap, r)]`` (int32, the reference's
layout) and ``values[(cap,)]`` (the semiring dtype) on one device, with
``nnz`` live rows at the front.  Padding rows are self-neutralizing
twice over, exactly as in the reference:

* padded coordinates hold the out-of-range sentinel ``shape[axis]``, so
  every ⊕-scatter drops them;
* padded values hold 0̄, so even a clamped gather contributes the ⊕
  identity.

Host-side constructors (``from_dense`` / ``from_coo``) run in numpy and
coalesce duplicate coordinates with ⊕, so buffers are bit-identical to
the reference's for the same input.  Torch indexing wants int64 while
the kernels take int32, so each relation memoizes its contiguous
per-axis index columns (converted once per relation, not per round),
and, for each contraction orientation, B3's segment plan with the
gathered column and the values in plan order (:meth:`runs`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import semiring as sr_mod

_NP_COMBINE = sr_mod.NP_COMBINE


class CooBuffers(NamedTuple):
    """Host numpy view of a relation's padded buffers (``as_np``)."""

    coords: np.ndarray   # (cap, arity) int32
    values: np.ndarray   # (cap,) semiring dtype
    nnz: np.ndarray      # () int32
    shape: tuple
    semiring: str


@dataclasses.dataclass(eq=False)
class SparseRelation:
    """A semiring S-relation in padded COO form on one device."""

    coords: torch.Tensor  # (capacity, arity) int32
    values: torch.Tensor  # (capacity,) semiring dtype
    nnz: int              # number of live (non-padding) rows
    shape: tuple[int, ...]
    semiring: str
    _cols: dict = dataclasses.field(default_factory=dict, repr=False)

    # -- basics ------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.coords.shape[0])

    @property
    def arity(self) -> int:
        return int(self.coords.shape[1])

    @property
    def device(self) -> torch.device:
        return self.values.device

    def sr(self) -> sr_mod.Semiring:
        return sr_mod.get(self.semiring)

    def density(self) -> float:
        """Live fraction of the dense key space (host-side)."""
        total = float(np.prod(self.shape)) or 1.0
        return float(self.nnz) / total

    def col(self, axis: int, dtype=torch.int64) -> torch.Tensor:
        """Contiguous index column ``coords[:, axis]`` in ``dtype``,
        memoized: int64 for torch indexing, int32 for the kernels."""
        key = (axis, dtype)
        c = self._cols.get(key)
        if c is None:
            c = self._cols[key] = self.coords[:, axis].to(dtype).contiguous()
        return c

    def runs(self, out_axis: int, gather_axis: int):
        """``(plan, gather, values)`` for a contraction that reduces onto
        axis ``out_axis``: the segment plan of that column (kernel B3's
        ``runs`` path), and the ``gather_axis`` index column (int64) and
        the values taken in plan order, memoized beside the columns, so
        every round of every query reuses them."""
        key = ("runs", out_axis, gather_axis)
        got = self._cols.get(key)
        if got is None:
            from repro_torch.kernels import coo_segment
            plan = coo_segment.plan_segment(self.col(out_axis, torch.int32),
                                            self.shape[out_axis])
            got = self._cols[key] = (
                plan, self.col(gather_axis).index_select(0, plan.order),
                self.values.index_select(0, plan.order))
        return got

    def __repr__(self) -> str:
        return (f"SparseRelation({self.semiring}{list(self.shape)}, "
                f"nnz={self.nnz}≤{self.capacity}, {self.device})")

    # -- conversions -------------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        """Materialize as a dense S-relation (⊕-combining duplicates):
        one segment ⊕-reduce over the row-major flattened keys."""
        from repro_torch.kernels import ops as kops
        total = int(np.prod(self.shape))
        if total >= 2 ** 31:
            raise ValueError(f"{self!r} is too large to densify")
        keys = torch.zeros(self.capacity, dtype=torch.int64,
                           device=self.device)
        out_of_range = torch.zeros(self.capacity, dtype=torch.bool,
                                   device=self.device)
        for ax, size in enumerate(self.shape):
            c = self.col(ax)
            keys = keys * size + c
            out_of_range |= (c < 0) | (c >= size)
        keys = torch.where(out_of_range, total, keys).to(torch.int32)
        flat = kops.semiring_segment_reduce(self.sr(), self.values, keys,
                                            total)
        return flat.reshape(self.shape)

    def as_np(self) -> CooBuffers:
        return CooBuffers(self.coords.cpu().numpy(),
                          self.values.cpu().numpy(),
                          np.asarray(self.nnz, np.int32), tuple(self.shape),
                          self.semiring)

    def to(self, device) -> "SparseRelation":
        device = torch.device(device)
        if device == self.device:
            return self
        return SparseRelation(self.coords.to(device),
                              self.values.to(device), self.nnz, self.shape,
                              self.semiring)

    def transpose(self, axes: tuple[int, ...] | None = None
                  ) -> "SparseRelation":
        axes = axes or tuple(reversed(range(self.arity)))
        coords = self.coords[:, list(axes)].contiguous()
        shape = tuple(self.shape[a] for a in axes)
        return SparseRelation(coords, self.values, self.nnz, shape,
                              self.semiring)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_buffers(cls, coords, values, nnz, shape, semiring: str, *,
                     device=None) -> "SparseRelation":
        """Adopt padded host buffers as they are (capacity, sentinels and
        value order kept) — e.g. the reference's ``as_np()`` output."""
        dev = device_mod.resolve(device)
        srn = sr_mod.get(semiring, lib="np")
        coords = np.asarray(coords, np.int32).reshape(-1, len(shape))
        values = np.asarray(values, srn.dtype).reshape(-1)
        if len(coords) != len(values):
            raise ValueError(f"coords {coords.shape} vs values "
                             f"{values.shape}")
        return cls(torch.from_numpy(np.array(coords, order="C")).to(dev),
                   torch.from_numpy(np.array(values, order="C")).to(dev),
                   int(nnz), tuple(int(s) for s in shape), semiring)

    @classmethod
    def from_coo(cls, coords, values, shape, semiring: str, *,
                 capacity: int | None = None,
                 device=None) -> "SparseRelation":
        """Build from host coordinate/value arrays (coalesces duplicates,
        drops explicit 0̄ entries, pads to ``capacity``)."""
        sr = sr_mod.get(semiring, lib="np")
        coords = np.asarray(coords, np.int64).reshape(-1, len(shape))
        values = np.asarray(values, sr.dtype).reshape(-1)
        if len(coords) != len(values):
            raise ValueError(f"coords {coords.shape} vs values "
                             f"{values.shape}")
        if len(coords):
            uniq, inv = np.unique(coords, axis=0, return_inverse=True)
            if len(uniq) != len(coords):
                merged = np.full(len(uniq), sr.zero, sr.dtype)
                _NP_COMBINE[semiring].at(merged, inv.reshape(-1), values)
                coords, values = uniq, merged
        if len(values):
            live = values != sr.zero if semiring != "bool" else values
            coords, values = coords[live], values[live]
        nnz = len(values)
        cap = capacity if capacity is not None else max(1, nnz)
        if nnz > cap:
            raise ValueError(f"nnz {nnz} exceeds capacity {cap}")
        pad = cap - nnz
        if pad:
            sentinel = np.tile(np.asarray(shape, np.int64), (pad, 1))
            coords = np.concatenate([coords, sentinel])
            values = np.concatenate(
                [values, np.full(pad, sr.zero, sr.dtype)])
        return cls.from_buffers(coords, values, nnz, shape, semiring,
                                device=device)

    @classmethod
    def from_dense(cls, arr, semiring: str, *,
                   capacity: int | None = None,
                   device=None) -> "SparseRelation":
        """Sparsify a dense array; a tensor keeps its device unless
        ``device`` says otherwise."""
        if isinstance(arr, torch.Tensor):
            device = arr.device if device is None else device
            host = arr.cpu().numpy()
        else:
            host = np.asarray(arr)
        sr = sr_mod.get(semiring, lib="np")
        coords = np.argwhere(host if semiring == "bool"
                             else host != sr.zero)
        values = host[tuple(coords.T)]
        return cls.from_coo(coords, values, host.shape, semiring,
                            capacity=capacity, device=device)
