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

Streaming updates (:meth:`apply_delta`, :meth:`delete_keys`,
:meth:`union`) run on the relation's device and give the same buffers
as the reference's host versions; ``apply_delta`` and ``delete_keys``
hand a binary child the parent's cached CSR index of the worklist
(:mod:`repro_torch.sparse.fixpoint`), extended or poisoned instead of
re-sorted.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import semiring as sr_mod

_NP_COMBINE = sr_mod.NP_COMBINE

#: entries from which :meth:`SparseRelation.to_dense` refuses (its flat
#: keys and the dense engine's indexing are int32-sized)
DENSIFY_LIMIT = 2 ** 31


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
        if total >= DENSIFY_LIMIT:
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

    # -- streaming updates -------------------------------------------------
    def _keys(self, coords) -> torch.Tensor:
        """Update coordinates as an ``(d, arity)`` int64 tensor on the
        relation's device (host arrays are copied up; only the delta
        moves)."""
        if isinstance(coords, torch.Tensor):
            t = coords.to(self.device, torch.int64)
        else:
            t = torch.from_numpy(np.asarray(coords, np.int64)).to(
                self.device)
        return t.reshape(-1, self.arity)

    def _shape_tensor(self) -> torch.Tensor:
        return torch.tensor(self.shape, dtype=torch.int64,
                            device=self.device)

    def _sentinel(self, pad: int) -> torch.Tensor:
        return self._shape_tensor().to(torch.int32).expand(
            pad, self.arity)

    def apply_delta(self, coords, values=None) -> "SparseRelation":
        """⊕-merge a batch of tuple updates, O(nnz(Δ)) on the device.

        The delta rows go into the padding slots when they fit (capacity
        unchanged); beyond capacity the buffers are re-padded at the next
        power of two ≥ the new live count (a prefix-preserving copy, no
        re-coalesce).  Appended duplicates of live keys are not
        coalesced: every consumer ⊕-combines, so an appended row is
        exactly ``E′ = E ⊕ Δ``.  ``values=None`` fills 1̄ per tuple;
        explicit 0̄ rows are dropped.
        """
        sr = self.sr()
        coords = self._keys(coords)
        if values is None:
            values = sr.ones((coords.shape[0],), self.device)
        elif isinstance(values, torch.Tensor):
            values = values.to(self.device, sr.dtype).reshape(-1)
        else:
            srn = sr_mod.get(self.semiring, lib="np")
            values = torch.from_numpy(np.asarray(values, srn.dtype).reshape(
                -1)).to(self.device)
        if coords.shape[0] != values.shape[0]:
            raise ValueError(f"coords {tuple(coords.shape)} vs values "
                             f"{tuple(values.shape)}")
        if bool(((coords < 0) | (coords >= self._shape_tensor())).any()):
            raise ValueError("delta coordinates out of range for shape "
                             f"{self.shape}")
        live = sr.live(values)
        coords, values = coords[live], values[live]
        k, d = self.nnz, int(values.shape[0])
        if d == 0:
            return self
        need = k + d
        if need <= self.capacity:
            new_coords = self.coords.clone()
            new_values = self.values.clone()
            new_coords[k:need] = coords.to(torch.int32)
            new_values[k:need] = values
        else:
            cap = max(1, self.capacity)
            while cap < need:
                cap <<= 1
            pad = cap - need
            new_coords = torch.cat([self.coords[:k], coords.to(torch.int32),
                                    self._sentinel(pad)])
            new_values = torch.cat([self.values[:k], values,
                                    sr.zeros((pad,), self.device)])
        out = SparseRelation(new_coords.contiguous(), new_values, need,
                             self.shape, self.semiring)
        if self.arity == 2:
            from repro_torch.sparse import fixpoint as fx
            fx.register_delta(self, out, coords, values)
        return out

    def _flat_keys(self, coords: torch.Tensor) -> torch.Tensor:
        """Row-major flattened int64 key per coordinate tuple, each axis
        clipped into range (numpy's ``ravel_multi_index(mode="clip")``)."""
        key = torch.zeros(coords.shape[0], dtype=torch.int64,
                          device=coords.device)
        for ax, size in enumerate(self.shape):
            key = key * size + coords[:, ax].long().clamp(0, size - 1)
        return key

    def delete_keys(self, coords) -> "SparseRelation":
        """Remove the given keys entirely (every live copy, duplicates
        appended by :meth:`apply_delta` included): a mask and a stable
        compaction at the same capacity, on the device.  Deletion is the
        non-monotone mutation: warm fixpoint state over the relation must
        be repaired or recomputed."""
        coords = self._keys(coords)
        k = self.nnz
        if k == 0 or coords.shape[0] == 0:
            return self
        gone = self._flat_keys(coords)
        keep = ~torch.isin(self._flat_keys(self.coords[:k]), gone)
        kept = int(keep.sum())
        if kept == k:
            return self
        pad = self.capacity - kept
        new_coords = torch.cat([self.coords[:k][keep], self._sentinel(pad)])
        new_values = torch.cat([self.values[:k][keep],
                                self.sr().zeros((pad,), self.device)])
        out = SparseRelation(new_coords.contiguous(), new_values, kept,
                             self.shape, self.semiring)
        if self.arity == 2:
            from repro_torch.sparse import fixpoint as fx
            fx.register_delete(self, out, coords)
        return out

    def union(self, other: "SparseRelation", *,
              capacity: int | None = None) -> "SparseRelation":
        """⊕-merge two sparse relations, coalescing duplicate keys (the
        reference's ``from_coo`` order: keys sorted when any repeat, the
        input order otherwise), on this relation's device."""
        if self.shape != other.shape or self.semiring != other.semiring:
            raise ValueError(f"union of {self!r} and {other!r}")
        sr = self.sr()
        coords = torch.cat([self.coords[:self.nnz],
                            other.coords[:other.nnz].to(self.device)]).long()
        values = torch.cat([self.values[:self.nnz],
                            other.values[:other.nnz].to(self.device)])
        if coords.shape[0]:
            flat = self._flat_keys(coords)
            uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
            if uniq.shape[0] != flat.shape[0]:
                values = sr_mod.scatter_op(
                    self.semiring, sr.zeros(uniq.shape, self.device), inv,
                    values)
                cols = []
                for size in reversed(self.shape):
                    cols.append(uniq % size)
                    uniq = uniq // size
                coords = torch.stack(cols[::-1], dim=1)
        live = sr.live(values)
        coords, values = coords[live], values[live]
        nnz = int(values.shape[0])
        cap = capacity if capacity is not None else max(1, nnz)
        if nnz > cap:
            raise ValueError(f"nnz {nnz} exceeds capacity {cap}")
        pad = cap - nnz
        return SparseRelation(
            torch.cat([coords.to(torch.int32), self._sentinel(pad)]
                      ).contiguous(),
            torch.cat([values, sr.zeros((pad,), self.device)]), nnz,
            self.shape, self.semiring)
