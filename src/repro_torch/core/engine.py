"""Dense tensor evaluation of Datalog° queries on one device.

The counterpart of ``repro/core/engine.py`` (its ``backend="jnp"``
path).  An S-relation over finite domains is a dense tensor of semiring
values; evaluating a sum-product term is a semiring tensor contraction,
planned greedily pair by pair:

* a plain binary join ``(i?,k) × (k,j?)`` is a semiring matmul — kernel
  B2 (:mod:`repro_torch.kernels.semiring_matmul`) — or, with a sparse
  operand, an SpMV/SpMM (:mod:`repro_torch.sparse.contract`, kernel B3);
* any other contraction is a chunked broadcast-⊗-then-⊕-reduce whose
  materialized intermediate stays under :data:`_CHUNK_ELEMS` elements;
* variables local to one factor are ⊕-reduced away eagerly.

The :class:`Database`'s device decides where every relation and every
intermediate lives.  Two backends share the code path, as in the
reference: ``backend="torch"`` (the default) evaluates with torch on
that device, and ``backend="np"`` evaluates eagerly with numpy — the
synthesizer's and verifier's tiny-database micro-evaluations, where
per-op dispatch would dominate.  The np backend reads a CPU database's
tensors as zero-copy ``.numpy()`` views, densifies sparse relations as
the reference's does, multiplies with :func:`_np_matmul`, and raises on
a CUDA database.  Under the torch backend a join of two sparse
relations on the CPU takes the host ``spmspm`` path of the reference's
host (np) relations; on the card it densifies the smaller side.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import ir
from repro_torch.core import semiring as sr_mod
from repro_torch.sparse.coo import SparseRelation

# max elements materialized by one broadcast contraction before chunking
_CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass
class Database:
    """EDB/IDB storage: name → S-relation (dense tensor or
    :class:`SparseRelation`), sort domain sizes, and the device.

    ``device=None`` resolves to ``cuda`` and raises when there is no GPU
    (:func:`repro_torch.device.resolve`); pass ``device="cpu"`` to run on
    the CPU.  Relations handed in are moved to the database's device.
    """

    schema: ir.Schema
    domains: dict[str, int]
    relations: dict[str, object]
    device: object = None

    def __post_init__(self):
        self.device = device_mod.resolve(self.device)
        self.relations = {k: _to_device(v, self.device)
                          for k, v in self.relations.items()}

    @classmethod
    def from_numpy(cls, schema: ir.Schema, domains: Mapping[str, int],
                   relations: Mapping[str, object], *,
                   device) -> "Database":
        """Build from host data: each relation is a dense numpy array or
        a dict ``{coords, values, nnz, shape, semiring}`` of padded COO
        buffers, adopted as they are (capacity, sentinels, value order)."""
        dev = device_mod.resolve(device)
        rels = {}
        for name, v in relations.items():
            if isinstance(v, Mapping):
                rels[name] = SparseRelation.from_buffers(
                    v["coords"], v["values"], v["nnz"], v["shape"],
                    v["semiring"], device=dev)
            else:
                rels[name] = torch.from_numpy(
                    np.array(v, order="C")).to(dev)
        return cls(schema, dict(domains), rels, dev)

    def dom(self, sort: str) -> int:
        return self.domains[sort]

    def with_relations(self, extra: Mapping) -> "Database":
        rels = dict(self.relations)
        rels.update(extra)
        return Database(self.schema, self.domains, rels, self.device)

    # -- storage backends ---------------------------------------------------
    def storage_of(self, name: str) -> str:
        if isinstance(self.relations.get(name), SparseRelation):
            return "sparse"
        return "dense"

    def with_storage(self, name: str, backend: str, *,
                     capacity: int | None = None) -> "Database":
        """Convert one relation to the requested representation."""
        arr = self.relations[name]
        if backend == "sparse" and not isinstance(arr, SparseRelation):
            arr = SparseRelation.from_dense(
                arr, self.schema[name].semiring, capacity=capacity)
        elif backend == "dense" and isinstance(arr, SparseRelation):
            arr = arr.to_dense()
        return self.with_relations({name: arr})

    # -- streaming updates --------------------------------------------------
    def apply_delta(self, delta) -> "Database":
        """Apply a :class:`repro_torch.incremental.DeltaLog` (or any
        iterable of entries with ``relation``/``coords``/``values``/``op``
        fields) and return the mutated database, on the same device.

        ``op="merge"`` is the ⊕-merge ``R′ = R ⊕ Δ``: a COO append for a
        sparse relation (:meth:`SparseRelation.apply_delta`, whose child
        extends the parent's cached CSR index) and a ⊕-combining scatter
        (``semiring.scatter_op``) for a dense one.  ``op="delete"`` removes keys (:meth:`SparseRelation.
        delete_keys`, whose child gets the parent's index 0̄-poisoned) and
        ``op="increase"`` replaces stored values with larger ones
        (delete-the-old ⊕ insert-the-new) — the non-monotone mutations,
        which the synthesized maintenance rule repairs or a full
        recompute redoes."""
        entries = getattr(delta, "entries", delta)
        rels = dict(self.relations)
        for ent in entries:
            arr = rels[ent.relation]
            if isinstance(arr, SparseRelation):
                if ent.op == "delete":
                    arr = arr.delete_keys(ent.coords)
                elif ent.op == "increase":
                    arr = arr.delete_keys(ent.coords).apply_delta(
                        ent.coords, ent.values)
                else:
                    arr = arr.apply_delta(ent.coords, ent.values)
                rels[ent.relation] = arr
                continue
            rels[ent.relation] = _dense_update(
                arr, ent, self.schema[ent.relation].semiring)
        return Database(self.schema, self.domains, rels, self.device)


def _dense_update(arr: torch.Tensor, ent, semiring: str) -> torch.Tensor:
    """One log entry against a dense relation on its device.  Keys index
    as the reference's ``.at[...]`` updates do: a negative coordinate
    counts from the end of its axis, and a key out of range on any axis
    is dropped."""
    sr = sr_mod.get(semiring)
    srn = sr_mod.get(semiring, lib="np")
    coords = torch.from_numpy(np.asarray(ent.coords, np.int64).reshape(
        -1, arr.dim())).to(arr.device)
    flat = torch.zeros(coords.shape[0], dtype=torch.int64,
                       device=arr.device)
    ok = torch.ones(coords.shape[0], dtype=torch.bool, device=arr.device)
    for ax, size in enumerate(arr.shape):
        c = torch.where(coords[:, ax] < 0, coords[:, ax] + size,
                        coords[:, ax])
        flat = flat * size + c
        ok &= (c >= 0) & (c < size)
    if ent.op == "delete":
        vals = sr.zeros((coords.shape[0],), arr.device)
    elif ent.values is None:
        vals = sr.ones((coords.shape[0],), arr.device)
    else:
        vals = torch.from_numpy(np.asarray(ent.values, srn.dtype).reshape(
            -1)).to(arr.device)
    if ent.op in ("delete", "increase"):
        out = arr.clone(memory_format=torch.contiguous_format)
        out.view(-1)[flat[ok]] = vals[ok]
        return out
    return sr_mod.scatter_op(semiring, arr.reshape(-1),
                             torch.where(ok, flat, -1), vals
                             ).reshape(arr.shape)


def _to_device(v, dev: torch.device):
    if isinstance(v, SparseRelation):
        return v.to(dev)
    if isinstance(v, torch.Tensor):
        return v if v.device == dev else v.to(dev)
    return torch.as_tensor(np.asarray(v), device=dev)


# --------------------------------------------------------------------------
# Sort inference
# --------------------------------------------------------------------------


def infer_var_sorts(e: ir.SSP, schema: ir.Schema,
                    hints: Mapping[str, str] | None = None) -> dict[str, str]:
    sorts: dict[str, str] = dict(hints or {})
    changed = True
    while changed:
        changed = False
        for t in e.terms:
            for a in t.atoms:
                if isinstance(a, ir.RelAtom):
                    rs = schema[a.name].sorts
                    for arg, s in zip(a.args, rs):
                        if not isinstance(arg, ir.C) and arg not in sorts:
                            sorts[arg] = s
                            changed = True
                elif isinstance(a, (ir.PredAtom, ir.ValFnAtom)):
                    # predicates equate the sorts of their arguments
                    known = [sorts[x] for x in a.args
                             if not isinstance(x, ir.C) and x in sorts]
                    if known:
                        for x in a.args:
                            if not isinstance(x, ir.C) and x not in sorts:
                                sorts[x] = known[0]
                                changed = True
    for t in e.terms:
        for v in t.vars():
            sorts.setdefault(v, _fallback_sort(v))
    for h in e.head:
        sorts.setdefault(h, _fallback_sort(h))
    return sorts


def _fallback_sort(v: str) -> str:
    # synthesizer-minted variables are sort-tagged ("pos$1"); default 'id'
    return v.split("$")[0] if "$" in v else "id"


# --------------------------------------------------------------------------
# Factors
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Factor:
    vars: tuple[str, ...]
    tensor: object

    @property
    def is_sparse(self) -> bool:
        return isinstance(self.tensor, SparseRelation)


def _densify(t):
    return t.to_dense() if isinstance(t, SparseRelation) else t


class _TorchOps:
    """The array operations of the torch backend, on the database's
    device (the np backend's are :class:`_NpOps`)."""

    is_np = False

    def __init__(self, dev: torch.device):
        self.dev = dev

    def relation(self, arr):
        return arr

    def arange(self, n: int, dtype: str):
        return torch.arange(n, dtype=getattr(torch, dtype), device=self.dev)

    def scalar(self, value, dtype: str):
        return torch.tensor(value, dtype=getattr(torch, dtype),
                            device=self.dev)

    @staticmethod
    def take(arr, index: int, axis: int):
        return arr.select(axis, index)

    @staticmethod
    def diagonal(arr, i: int, j: int):
        arr = torch.movedim(arr, (i, j), (0, 1))
        d = torch.diagonal(arr, dim1=0, dim2=1)  # diag axis goes last
        d = torch.movedim(d, -1, 0)
        return torch.movedim(d, 0, i)

    logical_not = staticmethod(torch.logical_not)
    broadcast_to = staticmethod(torch.broadcast_to)

    @staticmethod
    def permute(t, perm):
        return t.permute(perm)

    @staticmethod
    def transpose2(t):
        return t.t()

    @staticmethod
    def concat(pieces):
        return torch.cat(pieces, dim=0)

    @staticmethod
    def astype(t, dtype):
        return t.to(dtype)

    @staticmethod
    def at_least(t, floor: float):
        return torch.clamp(t, min=floor)

    @staticmethod
    def matmul(sr, a, b):
        from repro_torch.kernels import ops as kops
        return kops.semiring_matmul(sr, a, b)

    # semiring values (the torch Semiring's own helpers)
    @staticmethod
    def from_bool(sr, b):
        return sr.from_bool(b)

    @staticmethod
    def lift_value(sr, v):
        return sr.lift_value(v)

    def const(self, sr, c):
        return sr.const(c, self.dev)

    def full(self, sr, shape, value):
        return torch.full(tuple(shape), value, dtype=sr.dtype,
                          device=self.dev)

    def recast(self, arr, src, target):
        """Float→float semiring view: absent (0̄_src) stays absent."""
        return torch.where(arr == src.zero, self.const(target, target.zero),
                           arr.to(target.dtype))


class _NpOps:
    """The array operations of the np backend (host numpy)."""

    is_np = True

    @staticmethod
    def relation(arr):
        if isinstance(arr, SparseRelation):
            arr = arr.to_dense()
        if arr.device.type != "cpu":
            raise ValueError("backend='np' evaluates a CPU database only; "
                             f"this relation lives on {arr.device}")
        return arr.numpy()

    @staticmethod
    def arange(n: int, dtype: str):
        return np.arange(n, dtype=getattr(np, dtype))

    @staticmethod
    def scalar(value, dtype: str):
        return np.asarray(value, getattr(np, dtype))

    @staticmethod
    def take(arr, index: int, axis: int):
        return np.take(arr, index, axis=axis)

    @staticmethod
    def diagonal(arr, i: int, j: int):
        arr = np.moveaxis(arr, (i, j), (0, 1))
        d = np.diagonal(arr, axis1=0, axis2=1)  # diag axis goes last
        d = np.moveaxis(d, -1, 0)
        return np.moveaxis(d, 0, i)

    logical_not = staticmethod(np.logical_not)
    broadcast_to = staticmethod(np.broadcast_to)
    permute = staticmethod(np.transpose)

    @staticmethod
    def transpose2(t):
        return t.T

    @staticmethod
    def concat(pieces):
        return np.concatenate(pieces, axis=0)

    @staticmethod
    def astype(t, dtype):
        return t.astype(dtype)

    @staticmethod
    def at_least(t, floor: float):
        return np.maximum(t, floor)

    @staticmethod
    def matmul(sr, a, b):
        return _np_matmul(sr, a, b)

    @staticmethod
    def from_bool(sr, b):
        if sr.name == "bool":
            return b
        return np.where(b, np.asarray(sr.one, sr.dtype),
                        np.asarray(sr.zero, sr.dtype))

    @staticmethod
    def lift_value(sr, v):
        if sr.name == "bool":
            raise TypeError("𝔹 has no numeric value atoms")
        return v.astype(sr.dtype)

    @staticmethod
    def const(sr, c):
        return np.asarray(c, sr.dtype)

    @staticmethod
    def full(sr, shape, value):
        return np.full(tuple(shape), value, sr.dtype)

    @staticmethod
    def recast(arr, src, target):
        return np.where(arr == src.zero, np.asarray(target.zero,
                                                    target.dtype),
                        arr.astype(target.dtype))


_NP = _NpOps()


def _xp(backend: str, dev: torch.device):
    """The array operations of ``backend`` ("torch" or "np")."""
    if backend == "np":
        return _NP
    if backend == "torch":
        return _TorchOps(dev)
    raise ValueError(f"unknown engine backend {backend!r}; have 'torch' "
                     f"and 'np'")


def _rel_factor(a: ir.RelAtom, db: Database, target: sr_mod.Semiring,
                xp) -> _Factor:
    arr = db.relations[a.name]
    schema = db.schema[a.name]
    if isinstance(arr, SparseRelation) and not xp.is_np:
        vars_only = [x for x in a.args if not isinstance(x, ir.C)]
        plain = (len(set(vars_only)) == len(a.args) and not a.neg
                 and arr.semiring == target.name)
        if plain and arr.arity == 2:
            # stays sparse: consumed by the SpMV/SpMM contraction paths
            return _Factor(tuple(vars_only), arr)
        arr = arr.to_dense()  # constants/diagonals/negation/casts: dense
    arr = xp.relation(arr)
    # index out constant arguments (each collapses one axis)
    vars_out: list[str] = []
    axis = 0
    for arg in a.args:
        if isinstance(arg, ir.C):
            arr = xp.take(arr, arg.value, axis)
        else:
            vars_out.append(arg)
            axis += 1
    # diagonal for repeated variables R(x, x)
    while len(set(vars_out)) != len(vars_out):
        seen: dict[str, int] = {}
        for i, v in enumerate(vars_out):
            if v in seen:
                arr = xp.diagonal(arr, seen[v], i)
                vars_out = vars_out[:i] + vars_out[i + 1:]
                break
            seen[v] = i
    src_sr = sr_mod.get(schema.semiring, lib="np")
    if a.neg:
        if src_sr.name != "bool":
            raise TypeError(f"negation of non-boolean relation {a.name}")
        arr = xp.logical_not(arr)
    if a.cast or src_sr.name != target.name:
        if src_sr.name == "bool":
            arr = xp.from_bool(target, arr)
        elif src_sr.name != target.name:
            # float→float semiring view: absent (0̄_src) stays absent
            # (0̄_dst), finite values pass through
            arr = xp.recast(arr, src_sr, target)
    return _Factor(tuple(vars_out), arr)


def _grids(uniq, shape, dtype: str, xp):
    grids = {}
    for i, v in enumerate(uniq):
        g = xp.arange(shape[i], dtype)
        grids[v] = g.reshape([-1 if k == i else 1 for k in range(len(uniq))])
    return grids


def _pred_array(a: ir.PredAtom, db: Database, sorts: Mapping[str, str],
                xp) -> _Factor:
    vs = [x for x in a.args if not isinstance(x, ir.C)]
    uniq = list(dict.fromkeys(vs))
    shape = tuple(db.dom(sorts[v]) for v in uniq)
    grids = _grids(uniq, shape, "int32", xp)
    vals = [xp.scalar(x.value, "int32") if isinstance(x, ir.C)
            else grids[x] for x in a.args]
    p = a.pred
    if p == "eq":
        out = vals[0] == vals[1]
    elif p == "neq":
        out = vals[0] != vals[1]
    elif p == "lt":
        out = vals[0] < vals[1]
    elif p == "le":
        out = vals[0] <= vals[1]
    elif p == "sum3":
        out = vals[0] == vals[1] + vals[2]
    elif p == "succ":
        out = vals[0] == vals[1] + 1
    elif p == "winlt":
        out = (vals[0] >= 1) & (vals[0] < vals[1])
    else:  # pragma: no cover
        raise KeyError(p)
    return _Factor(tuple(uniq), xp.broadcast_to(out, shape))


def _valfn_array(a: ir.ValFnAtom, db: Database, sorts: Mapping[str, str],
                 xp) -> _Factor:
    """Interpreted value functions (IR.VALUE_FNS) as dense factors."""
    vs = [x for x in a.args if not isinstance(x, ir.C)]
    uniq = list(dict.fromkeys(vs))
    shape = tuple(db.dom(sorts[v]) for v in uniq)
    grids = _grids(uniq, shape, "float32", xp)
    vals = [xp.scalar(float(x.value), "float32") if isinstance(x, ir.C)
            else grids[x] for x in a.args]
    if a.fn == "mulratio":
        out = vals[0] * vals[1] / xp.at_least(vals[2], 1.0)
    elif a.fn == "plus1":
        out = vals[0] + 1.0
    else:  # pragma: no cover
        raise KeyError(a.fn)
    return _Factor(tuple(uniq), xp.broadcast_to(out, shape))


# --------------------------------------------------------------------------
# Pairwise contraction
# --------------------------------------------------------------------------


def _to_axes(f: _Factor, order: tuple[str, ...], xp):
    """Transpose + expand ``f.tensor`` so its axes follow ``order``."""
    perm = [f.vars.index(v) for v in order if v in f.vars]
    t = xp.permute(f.tensor, perm)
    shape = []
    k = 0
    for v in order:
        if v in f.vars:
            shape.append(t.shape[k])
            k += 1
        else:
            shape.append(1)
    return t.reshape(shape)


def _np_matmul(sr, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The np backend's semiring matmul (the reference's host product)."""
    if sr.name == "bool":
        return (a.astype(np.float32) @ b.astype(np.float32)) > 0.5
    if sr.name in ("nat", "real"):
        return a.astype(np.float32) @ b.astype(np.float32)
    red = np.min if sr.name == "trop" else np.max
    return red(a[:, :, None] + b[None, :, :], axis=1)


def _sparse_matmul_path(sr, f1: _Factor, f2: _Factor, k: str) -> _Factor:
    """Sparse×dense (or dense×sparse) contraction over the single shared
    variable ``k`` via SpMV/SpMM — O(nnz) instead of O(n²)."""
    from repro_torch.sparse import contract
    sp, dn = (f1, f2) if f1.is_sparse else (f2, f1)
    rel = sp.tensor
    k_ax = sp.vars.index(k)
    out_var = [v for v in sp.vars if v != k]
    dn_vars = [v for v in dn.vars if v != k]
    dense = dn.tensor
    if dense.dim() == 1:
        out = contract.spmv(rel, dense, transpose=(k_ax == 0))
        return _Factor(tuple(out_var), out)
    # dense matrix: contract k along its first axis
    if dn.vars[0] != k:
        dense = dense.t()
    out = contract.spmm(rel, dense, transpose=(k_ax == 0))
    return _Factor(tuple(out_var + dn_vars), out)


def _matmul_path(sr, f1: _Factor, f2: _Factor, elim: set[str],
                 xp) -> _Factor | None:
    """(i?,k) x (k,j?) -> (i?,j?) contraction via semiring matmul."""
    if len(elim) != 1:
        return None
    (k,) = elim
    if k not in f1.vars or k not in f2.vars:
        return None
    if len(f1.vars) > 2 or len(f2.vars) > 2:
        return None
    a, b = f1, f2
    avars = [v for v in a.vars if v != k]
    bvars = [v for v in b.vars if v != k]
    if set(avars) & set(bvars):
        return None  # shared non-contracted var: not a plain matmul
    if a.is_sparse or b.is_sparse:
        if a.is_sparse and b.is_sparse:
            if a.tensor.device.type == b.tensor.device.type == "cpu":
                from repro_torch.sparse import contract
                # align as (i,k) x (k,j): sparse join on k (host path)
                sa = a.tensor if a.vars[-1] == k else a.tensor.transpose()
                sb = b.tensor if b.vars[0] == k else b.tensor.transpose()
                merged = contract.spmspm(sa, sb)
                return _Factor(tuple(avars + bvars), merged.to_dense())
            # on the card the output nnz is data-dependent: densify the
            # operand with fewer stored tuples, keep the other's SpMM
            small, big = ((a, b) if a.tensor.capacity
                          <= b.tensor.capacity else (b, a))
            small = _Factor(small.vars, _densify(small.tensor))
            return _sparse_matmul_path(sr, big, small, k)
        return _sparse_matmul_path(sr, a, b, k)
    at = a.tensor if a.vars[-1] == k else xp.transpose2(a.tensor)
    bt = b.tensor if b.vars[0] == k else xp.transpose2(b.tensor)
    a2 = at.reshape(-1, at.shape[-1]) if at.ndim == 2 else at.reshape(1, -1)
    b2 = bt.reshape(bt.shape[0], -1) if bt.ndim == 2 else bt.reshape(-1, 1)
    out = xp.matmul(sr, a2, b2)
    out_vars = tuple(avars + bvars)
    shape = [at.shape[0]] if at.ndim == 2 else []
    shape += [bt.shape[1]] if bt.ndim == 2 else []
    return _Factor(out_vars, out.reshape(shape) if shape else out.reshape(()))


def _contract_pair(sr, f1: _Factor, f2: _Factor, elim: set[str],
                   xp) -> _Factor:
    mm = _matmul_path(sr, f1, f2, elim, xp)
    if mm is not None:
        return mm
    # general broadcast path needs dense operands
    if f1.is_sparse:
        f1 = _Factor(f1.vars, _densify(f1.tensor))
    if f2.is_sparse:
        f2 = _Factor(f2.vars, _densify(f2.tensor))
    out_vars = tuple([v for v in f1.vars if v not in elim] +
                     [v for v in f2.vars if v not in elim and v not in f1.vars])
    order = out_vars + tuple(sorted(elim))
    dims1 = dict(zip(f1.vars, f1.tensor.shape))
    dims2 = dict(zip(f2.vars, f2.tensor.shape))
    dims = {**dims2, **dims1}
    total = int(np.prod([dims[v] for v in order], dtype=np.int64)) if order else 1
    t1 = _to_axes(f1, order, xp)
    t2 = _to_axes(f2, order, xp)
    red_axes = tuple(range(len(out_vars), len(order)))
    if total <= _CHUNK_ELEMS or not out_vars:
        prod = sr.mul(t1, t2)
        if red_axes:
            prod = sr.add_reduce(prod, axis=red_axes)
        return _Factor(out_vars, xp.broadcast_to(
            prod, tuple(dims[v] for v in out_vars)))
    # chunk along the leading output axis to bound the intermediate
    n0 = dims[out_vars[0]]
    chunk = max(1, int(_CHUNK_ELEMS // max(1, total // n0)))
    pieces = []
    for s in range(0, n0, chunk):
        e = min(n0, s + chunk)
        s1 = t1[s:e] if t1.shape[0] != 1 else t1
        s2 = t2[s:e] if t2.shape[0] != 1 else t2
        prod = sr.mul(s1, s2)
        if red_axes:
            prod = sr.add_reduce(prod, axis=red_axes)
        pieces.append(xp.broadcast_to(
            prod, (e - s,) + tuple(dims[v] for v in out_vars[1:])))
    return _Factor(out_vars, xp.concat(pieces))


# --------------------------------------------------------------------------
# Term / SSP evaluation
# --------------------------------------------------------------------------


def eval_term(t: ir.Term, head: tuple[str, ...], db: Database,
              sr: sr_mod.Semiring, sorts: Mapping[str, str], xp=None):
    """One sum-product term over ``head``; ``sr`` is the semiring twin of
    the backend whose ops ``xp`` are (torch on the database's device by
    default)."""
    xp = _TorchOps(db.device) if xp is None else xp
    head_vars = list(head)
    factors: list[_Factor] = []
    scalar = xp.const(sr, sr.one)
    for a in t.atoms:
        if isinstance(a, ir.RelAtom):
            factors.append(_rel_factor(a, db, sr, xp))
        elif isinstance(a, ir.PredAtom):
            f = _pred_array(a, db, sorts, xp)
            factors.append(_Factor(f.vars, xp.from_bool(sr, f.tensor)))
        elif isinstance(a, ir.ValAtom):
            n = db.dom(sorts[a.var])
            factors.append(_Factor((a.var,), xp.lift_value(
                sr, xp.arange(n, "float32"))))
        elif isinstance(a, ir.ValFnAtom):
            f = _valfn_array(a, db, sorts, xp)
            factors.append(_Factor(f.vars, xp.lift_value(sr, f.tensor)))
        elif isinstance(a, ir.ConstAtom):
            scalar = sr.mul(scalar, xp.const(sr, a.value))
        else:  # pragma: no cover
            raise TypeError(a)

    keep = set(head_vars)

    def occurrences(v: str) -> int:
        return sum(1 for f in factors if v in f.vars)

    # eliminate single-factor bound vars eagerly
    def sweep_local():
        for i, f in enumerate(factors):
            local = [v for v in f.vars if v not in keep and occurrences(v) == 1]
            if local:
                if f.is_sparse:
                    # ⊕ over an axis = SpMV against the all-1̄ vector
                    from repro_torch.sparse import contract as sp_contract
                    ax = f.vars.index(local[0])
                    ones = xp.full(sr, (f.tensor.shape[ax],), sr.one)
                    nv = tuple(v for v in f.vars if v != local[0])
                    factors[i] = _Factor(nv, sp_contract.spmv(
                        f.tensor, ones, transpose=(ax == 0)))
                    return True
                axes = tuple(f.vars.index(v) for v in local)
                nv = tuple(v for v in f.vars if v not in local)
                factors[i] = _Factor(nv, sr.add_reduce(f.tensor, axis=axes))
                return True
        return False

    while sweep_local():
        pass

    while len(factors) > 1:
        # greedy: pick the pair with the most shared vars, tie-break on
        # smallest resulting broadcast size
        best = None
        for i in range(len(factors)):
            for j in range(i + 1, len(factors)):
                shared = set(factors[i].vars) & set(factors[j].vars)
                union = set(factors[i].vars) | set(factors[j].vars)
                dims = {**dict(zip(factors[j].vars, factors[j].tensor.shape)),
                        **dict(zip(factors[i].vars, factors[i].tensor.shape))}
                size = int(np.prod([dims[v] for v in union] or [1],
                                   dtype=np.int64))
                key = (-len(shared), size)
                if best is None or key < best[0]:
                    best = (key, i, j)
        _, i, j = best
        f1, f2 = factors[i], factors[j]
        others_vars = set()
        for k2, f in enumerate(factors):
            if k2 not in (i, j):
                others_vars.update(f.vars)
        elim = (set(f1.vars) | set(f2.vars)) - keep - others_vars
        merged = _contract_pair(sr, f1, f2, elim, xp)
        factors = [f for k2, f in enumerate(factors) if k2 not in (i, j)]
        factors.append(merged)
        while sweep_local():
            pass

    out_shape = tuple(db.dom(sorts[h]) for h in head_vars)
    if not factors:
        return xp.astype(xp.broadcast_to(scalar, out_shape), sr.dtype)
    f = factors[0]
    if f.is_sparse:  # single uncontracted sparse atom: materialize
        f = _Factor(f.vars, _densify(f.tensor))
    rem = tuple(v for v in f.vars if v not in keep)
    if rem:
        axes = tuple(f.vars.index(v) for v in rem)
        f = _Factor(tuple(v for v in f.vars if v in keep),
                    sr.add_reduce(f.tensor, axis=axes))
    # align to head order, broadcasting head vars absent from the factor
    t_out = _to_axes(f, tuple(head_vars), xp)
    t_out = xp.broadcast_to(t_out, out_shape)
    t_out = sr.mul(t_out, scalar)
    return xp.astype(t_out, sr.dtype)


def eval_ssp(e: ir.SSP, db: Database,
             sort_hints: Mapping[str, str] | None = None, *,
             backend: str = "torch"):
    """Evaluate a normalized SSP expression to a dense S-relation: a
    tensor on the database's device (``backend="torch"``) or a numpy
    array (``backend="np"``, a CPU database only)."""
    xp = _xp(backend, db.device)
    if xp.is_np and db.device.type != "cpu":
        raise ValueError("backend='np' evaluates a CPU database only; "
                         f"this one lives on {db.device}")
    sr = sr_mod.get(e.semiring, lib="np" if xp.is_np else "torch")
    sorts = infer_var_sorts(e, db.schema, sort_hints)
    out_shape = tuple(db.dom(sorts[h]) for h in e.head)
    acc = xp.full(sr, out_shape, sr.zero)
    for t in e.terms:
        acc = sr.add(acc, eval_term(t, e.head, db, sr, sorts, xp))
    return acc
