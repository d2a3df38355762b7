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
intermediate lives.  The numpy evaluation backend the reference's
synthesizer uses is not ported yet.
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


def _rel_factor(a: ir.RelAtom, db: Database,
                target: sr_mod.Semiring) -> _Factor:
    arr = db.relations[a.name]
    schema = db.schema[a.name]
    if isinstance(arr, SparseRelation):
        vars_only = [x for x in a.args if not isinstance(x, ir.C)]
        plain = (len(set(vars_only)) == len(a.args) and not a.neg
                 and arr.semiring == target.name)
        if plain and arr.arity == 2:
            # stays sparse: consumed by the SpMV/SpMM contraction paths
            return _Factor(tuple(vars_only), arr)
        arr = arr.to_dense()  # constants/diagonals/negation/casts: dense
    # index out constant arguments (each collapses one axis)
    vars_out: list[str] = []
    axis = 0
    for arg in a.args:
        if isinstance(arg, ir.C):
            arr = arr.select(axis, arg.value)
        else:
            vars_out.append(arg)
            axis += 1
    # diagonal for repeated variables R(x, x)
    while len(set(vars_out)) != len(vars_out):
        seen: dict[str, int] = {}
        for i, v in enumerate(vars_out):
            if v in seen:
                arr = _diagonal(arr, seen[v], i)
                vars_out = vars_out[:i] + vars_out[i + 1:]
                break
            seen[v] = i
    src_sr = sr_mod.get(schema.semiring)
    if a.neg:
        if src_sr.name != "bool":
            raise TypeError(f"negation of non-boolean relation {a.name}")
        arr = torch.logical_not(arr)
    if a.cast or src_sr.name != target.name:
        if src_sr.name == "bool":
            arr = target.from_bool(arr)
        elif src_sr.name != target.name:
            # float→float semiring view: absent (0̄_src) stays absent
            # (0̄_dst), finite values pass through
            arr = torch.where(arr == src_sr.zero,
                              target.const(target.zero, arr.device),
                              arr.to(target.dtype))
    return _Factor(tuple(vars_out), arr)


def _diagonal(arr: torch.Tensor, i: int, j: int) -> torch.Tensor:
    arr = torch.movedim(arr, (i, j), (0, 1))
    d = torch.diagonal(arr, dim1=0, dim2=1)  # diag axis goes last
    d = torch.movedim(d, -1, 0)
    return torch.movedim(d, 0, i)


def _grids(uniq, shape, dtype, dev):
    grids = {}
    for i, v in enumerate(uniq):
        g = torch.arange(shape[i], dtype=dtype, device=dev)
        grids[v] = g.reshape([-1 if k == i else 1 for k in range(len(uniq))])
    return grids


def _pred_array(a: ir.PredAtom, db: Database,
                sorts: Mapping[str, str]) -> _Factor:
    vs = [x for x in a.args if not isinstance(x, ir.C)]
    uniq = list(dict.fromkeys(vs))
    shape = tuple(db.dom(sorts[v]) for v in uniq)
    grids = _grids(uniq, shape, torch.int32, db.device)
    vals = [torch.tensor(x.value, dtype=torch.int32, device=db.device)
            if isinstance(x, ir.C) else grids[x] for x in a.args]
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
    return _Factor(tuple(uniq), torch.broadcast_to(out, shape))


def _valfn_array(a: ir.ValFnAtom, db: Database,
                 sorts: Mapping[str, str]) -> _Factor:
    """Interpreted value functions (IR.VALUE_FNS) as dense factors."""
    vs = [x for x in a.args if not isinstance(x, ir.C)]
    uniq = list(dict.fromkeys(vs))
    shape = tuple(db.dom(sorts[v]) for v in uniq)
    grids = _grids(uniq, shape, torch.float32, db.device)
    vals = [torch.tensor(float(x.value), dtype=torch.float32,
                         device=db.device)
            if isinstance(x, ir.C) else grids[x] for x in a.args]
    if a.fn == "mulratio":
        out = vals[0] * vals[1] / torch.clamp(vals[2], min=1.0)
    elif a.fn == "plus1":
        out = vals[0] + 1.0
    else:  # pragma: no cover
        raise KeyError(a.fn)
    return _Factor(tuple(uniq), torch.broadcast_to(out, shape))


# --------------------------------------------------------------------------
# Pairwise contraction
# --------------------------------------------------------------------------


def _to_axes(f: _Factor, order: tuple[str, ...]) -> torch.Tensor:
    """Transpose + expand ``f.tensor`` so its axes follow ``order``."""
    perm = [f.vars.index(v) for v in order if v in f.vars]
    t = f.tensor.permute(perm)
    shape = []
    k = 0
    for v in order:
        if v in f.vars:
            shape.append(t.shape[k])
            k += 1
        else:
            shape.append(1)
    return t.reshape(shape)


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


def _matmul_path(sr, f1: _Factor, f2: _Factor,
                 elim: set[str]) -> _Factor | None:
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
            # output nnz is data-dependent: densify the operand with
            # fewer stored tuples and keep the other side's SpMM
            small, big = ((a, b) if a.tensor.capacity
                          <= b.tensor.capacity else (b, a))
            small = _Factor(small.vars, _densify(small.tensor))
            return _sparse_matmul_path(sr, big, small, k)
        return _sparse_matmul_path(sr, a, b, k)
    at = a.tensor if a.vars[-1] == k else a.tensor.t()
    bt = b.tensor if b.vars[0] == k else b.tensor.t()
    a2 = at.reshape(-1, at.shape[-1]) if at.dim() == 2 else at.reshape(1, -1)
    b2 = bt.reshape(bt.shape[0], -1) if bt.dim() == 2 else bt.reshape(-1, 1)
    from repro_torch.kernels import ops as kops
    out = kops.semiring_matmul(sr, a2, b2)
    out_vars = tuple(avars + bvars)
    shape = [at.shape[0]] if at.dim() == 2 else []
    shape += [bt.shape[1]] if bt.dim() == 2 else []
    return _Factor(out_vars, out.reshape(shape) if shape else out.reshape(()))


def _contract_pair(sr, f1: _Factor, f2: _Factor,
                   elim: set[str]) -> _Factor:
    mm = _matmul_path(sr, f1, f2, elim)
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
    t1 = _to_axes(f1, order)
    t2 = _to_axes(f2, order)
    red_axes = tuple(range(len(out_vars), len(order)))
    if total <= _CHUNK_ELEMS or not out_vars:
        prod = sr.mul(t1, t2)
        if red_axes:
            prod = sr.add_reduce(prod, axis=red_axes)
        return _Factor(out_vars, torch.broadcast_to(
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
        pieces.append(torch.broadcast_to(
            prod, (e - s,) + tuple(dims[v] for v in out_vars[1:])))
    return _Factor(out_vars, torch.cat(pieces, dim=0))


# --------------------------------------------------------------------------
# Term / SSP evaluation
# --------------------------------------------------------------------------


def eval_term(t: ir.Term, head: tuple[str, ...], db: Database,
              sr: sr_mod.Semiring, sorts: Mapping[str, str]) -> torch.Tensor:
    head_vars = list(head)
    dev = db.device
    factors: list[_Factor] = []
    scalar = sr.const(sr.one, dev)
    for a in t.atoms:
        if isinstance(a, ir.RelAtom):
            factors.append(_rel_factor(a, db, sr))
        elif isinstance(a, ir.PredAtom):
            f = _pred_array(a, db, sorts)
            factors.append(_Factor(f.vars, sr.from_bool(f.tensor)))
        elif isinstance(a, ir.ValAtom):
            n = db.dom(sorts[a.var])
            factors.append(_Factor((a.var,), sr.lift_value(
                torch.arange(n, dtype=torch.float32, device=dev))))
        elif isinstance(a, ir.ValFnAtom):
            f = _valfn_array(a, db, sorts)
            factors.append(_Factor(f.vars, sr.lift_value(f.tensor)))
        elif isinstance(a, ir.ConstAtom):
            scalar = sr.mul(scalar, sr.const(a.value, dev))
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
                    ones = sr.ones((f.tensor.shape[ax],), dev)
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
        merged = _contract_pair(sr, f1, f2, elim)
        factors = [f for k2, f in enumerate(factors) if k2 not in (i, j)]
        factors.append(merged)
        while sweep_local():
            pass

    out_shape = tuple(db.dom(sorts[h]) for h in head_vars)
    if not factors:
        return torch.broadcast_to(scalar, out_shape).to(sr.dtype)
    f = factors[0]
    if f.is_sparse:  # single uncontracted sparse atom: materialize
        f = _Factor(f.vars, _densify(f.tensor))
    rem = tuple(v for v in f.vars if v not in keep)
    if rem:
        axes = tuple(f.vars.index(v) for v in rem)
        f = _Factor(tuple(v for v in f.vars if v in keep),
                    sr.add_reduce(f.tensor, axis=axes))
    # align to head order, broadcasting head vars absent from the factor
    t_out = _to_axes(f, tuple(head_vars))
    t_out = torch.broadcast_to(t_out, out_shape)
    t_out = sr.mul(t_out, scalar)
    return t_out.to(sr.dtype)


def eval_ssp(e: ir.SSP, db: Database,
             sort_hints: Mapping[str, str] | None = None) -> torch.Tensor:
    """Evaluate a normalized SSP expression to a dense S-relation on the
    database's device."""
    sr = sr_mod.get(e.semiring)
    sorts = infer_var_sorts(e, db.schema, sort_hints)
    out_shape = tuple(db.dom(sorts[h]) for h in e.head)
    acc = sr.zeros(out_shape, db.device)
    for t in e.terms:
        acc = sr.add(acc, eval_term(t, e.head, db, sr, sorts))
    return acc
