"""Ordered (pre-)semirings as PyTorch value spaces.

The counterpart of ``repro/core/semiring.py``.  Each semiring carries
elementwise ⊕/⊗, the ⊕-reduction over axes, the lattice order ``leq``,
the GSN difference ⊖ (idempotent lattices only) and the cast
``from_bool``.  Values are float32 tensors except 𝔹 (``torch.bool``) —
exactly the reference's dtypes, so the same numpy inputs give the same
bits in both packages.

``lib="np"`` twins keep the reference's numpy semantics for host-side
work (COO construction, ⊕-coalescing, the IR's constant folding).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor
INF = float("inf")


def _axes(axis, ndim: int) -> tuple[int, ...]:
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, int):
        return (axis,)
    return tuple(axis)


def _reduce(fn):
    def red(x: Tensor, axis=None, keepdims: bool = False) -> Tensor:
        # one axis at a time, highest first, so every torch version
        # (tuple dims are not universal for any/amin/amax) agrees
        for ax in sorted((a % max(x.dim(), 1) for a in _axes(axis, x.dim())),
                         reverse=True):
            x = fn(x, dim=ax, keepdim=keepdims)
        return x
    return red


_any_reduce = _reduce(torch.any)
_min_reduce = _reduce(torch.amin)
_max_reduce = _reduce(torch.amax)


def _sum_reduce(x: Tensor, axis=None, keepdims: bool = False) -> Tensor:
    return torch.sum(x, dim=_axes(axis, x.dim()), keepdim=keepdims)


def _full(value, like: Tensor, dtype) -> Tensor:
    return torch.tensor(value, dtype=dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A commutative ordered (pre-)semiring over a torch/numpy dtype."""

    name: str
    dtype: object
    zero: float
    one: float
    add: Callable
    mul: Callable
    add_reduce: Callable
    leq: Callable
    idempotent: bool
    minus: Callable | None = None  # b ⊖ a
    naturally_ordered: bool = True
    lib: str = "torch"

    # -- torch helpers (the numpy twins keep only the ops and constants)
    def from_bool(self, b: Tensor) -> Tensor:
        """The cast [-] : 𝔹 → S mapping 0 ↦ 0̄ and 1 ↦ 1̄."""
        if self.name == "bool":
            return b
        return torch.where(b, _full(self.one, b, self.dtype),
                           _full(self.zero, b, self.dtype))

    def lift_value(self, v: Tensor) -> Tensor:
        """Interpret a numeric key value as an element of S (ValAtom)."""
        if self.name == "bool":
            raise TypeError("𝔹 has no numeric value atoms")
        return v.to(self.dtype)

    def const(self, c: float, device=None) -> Tensor:
        return torch.tensor(c, dtype=self.dtype, device=device)

    def zeros(self, shape, device=None) -> Tensor:
        return torch.full(tuple(shape), self.zero, dtype=self.dtype,
                          device=device)

    def ones(self, shape, device=None) -> Tensor:
        return torch.full(tuple(shape), self.one, dtype=self.dtype,
                          device=device)

    def live(self, x: Tensor) -> Tensor:
        """Mask of non-0̄ entries."""
        return x if self.name == "bool" else x != self.zero

    def __repr__(self) -> str:
        return f"Semiring({self.name}/{self.lib})"


def _where_const(cond: Tensor, b: Tensor, value: float) -> Tensor:
    return torch.where(cond, b, _full(value, b, b.dtype))


#: Booleans 𝔹 = ({0,1}, ∨, ∧, 0, 1).
BOOL = Semiring(
    name="bool", dtype=torch.bool, zero=False, one=True,
    add=torch.logical_or, mul=torch.logical_and, add_reduce=_any_reduce,
    leq=lambda a, b: torch.logical_or(torch.logical_not(a), b),
    idempotent=True,
    minus=lambda b, a: torch.logical_and(b, torch.logical_not(a)),
)

#: Tropical Trop = (ℕ∪{∞}, min, +, ∞, 0); its order is reversed.
TROP = Semiring(
    name="trop", dtype=torch.float32, zero=INF, one=0.0,
    add=torch.minimum, mul=lambda a, b: a + b, add_reduce=_min_reduce,
    leq=lambda a, b: a >= b, idempotent=True,
    minus=lambda b, a: _where_const(b < a, b, INF),
)

#: Reversed tropical Tropʳ = (ℝ∪{-∞}, max, +, -∞, 0).
MAXPLUS = Semiring(
    name="maxplus", dtype=torch.float32, zero=-INF, one=0.0,
    add=torch.maximum, mul=lambda a, b: a + b, add_reduce=_max_reduce,
    leq=lambda a, b: a <= b, idempotent=True,
    minus=lambda b, a: _where_const(b > a, b, -INF),
)

#: Closed naturals ℕ∞ = (ℕ∪{∞}, +, ×, 0, 1).
NAT = Semiring(
    name="nat", dtype=torch.float32, zero=0.0, one=1.0,
    add=lambda a, b: a + b, mul=lambda a, b: a * b,
    add_reduce=_sum_reduce, leq=lambda a, b: a <= b, idempotent=False,
)

#: Lifted reals ℝ⊥ = (ℝ∪{⊥}, +, ×, 0, 1).
REAL = Semiring(
    name="real", dtype=torch.float32, zero=0.0, one=1.0,
    add=lambda a, b: a + b, mul=lambda a, b: a * b,
    add_reduce=_sum_reduce, leq=lambda a, b: a <= b, idempotent=False,
    naturally_ordered=False,
)

SEMIRINGS: dict[str, Semiring] = {
    s.name: s for s in (BOOL, TROP, MAXPLUS, NAT, REAL)
}


def _np_reduce(fn):
    def red(x, axis=None, keepdims=False):
        return fn(x, axis=axis, keepdims=keepdims)
    return red


def _numpy_twin(sr: Semiring) -> Semiring:
    table = {
        "bool": dict(add=np.logical_or, mul=np.logical_and,
                     add_reduce=_np_reduce(np.any),
                     leq=lambda a, b: np.logical_or(~np.asarray(a), b),
                     minus=lambda b, a: np.logical_and(b, ~np.asarray(a)),
                     dtype=np.bool_),
        "trop": dict(add=np.minimum, mul=lambda a, b: a + b,
                     add_reduce=_np_reduce(np.min),
                     leq=lambda a, b: a >= b,
                     minus=lambda b, a: np.where(b < a, b,
                                                 np.float32(INF)),
                     dtype=np.float32),
        "maxplus": dict(add=np.maximum, mul=lambda a, b: a + b,
                        add_reduce=_np_reduce(np.max),
                        leq=lambda a, b: a <= b,
                        minus=lambda b, a: np.where(b > a, b,
                                                    np.float32(-INF)),
                        dtype=np.float32),
        "nat": dict(add=lambda a, b: a + b, mul=lambda a, b: a * b,
                    add_reduce=_np_reduce(np.sum),
                    leq=lambda a, b: a <= b, minus=None, dtype=np.float32),
        "real": dict(add=lambda a, b: a + b, mul=lambda a, b: a * b,
                     add_reduce=_np_reduce(np.sum),
                     leq=lambda a, b: a <= b, minus=None, dtype=np.float32),
    }
    return dataclasses.replace(sr, lib="np", **table[sr.name])


_NP_SEMIRINGS: dict[str, Semiring] = {
    name: _numpy_twin(s) for name, s in SEMIRINGS.items()
}


def get(name: str | Semiring, lib: str = "torch") -> Semiring:
    if isinstance(name, Semiring):
        if name.lib == lib:
            return name
        name = name.name
    try:
        return _NP_SEMIRINGS[name] if lib == "np" else SEMIRINGS[name]
    except KeyError:
        raise KeyError(f"unknown semiring {name!r}; have {sorted(SEMIRINGS)}")


#: ``torch.Tensor.scatter_reduce_`` reduction per semiring — the ⊕ of
#: the plain segment reduce (bool runs as ``amax`` over uint8, since
#: scatter_reduce has no boolean or)
SCATTER_REDUCE = {"bool": "amax", "trop": "amin", "maxplus": "amax",
                  "nat": "sum", "real": "sum"}


def scatter_op(sr_name: str, base: Tensor, idx: Tensor,
               vals: Tensor) -> Tensor:
    """⊕-combining scatter ``base[idx] ⊕= vals`` with drop mode: ids
    outside ``[0, len(base))`` (the COO sentinels) contribute nothing.

    The plain counterpart of the reference's ``x.at[idx].max/min/add(
    mode="drop")``: torch's ``scatter_reduce_`` has neither a drop mode
    nor a boolean or, so the update runs into an ``(n + 1)`` buffer whose
    last slot absorbs every out-of-range id, with 𝔹 as uint8.
    """
    n = base.shape[0]
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    is_bool = base.dtype == torch.bool
    work_dtype = torch.uint8 if is_bool else base.dtype
    buf = torch.cat([base.to(work_dtype),
                     base.new_zeros((1,) + tuple(base.shape[1:]),
                                    dtype=work_dtype)])
    v = vals.to(work_dtype)
    index = idx.reshape((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
    buf.scatter_reduce_(0, index, v, SCATTER_REDUCE[sr_name],
                        include_self=True)
    out = buf[:n]
    return out.bool() if is_bool else out


#: numpy ufuncs whose ``.at`` performs the same ⊕-combining scatter
NP_COMBINE = {
    "bool": np.logical_or,
    "trop": np.minimum,
    "maxplus": np.maximum,
    "nat": np.add,
    "real": np.add,
}


def np_value_pool(sr: Semiring, *, small: bool = True) -> np.ndarray:
    """A small pool of semiring values for bounded-model verification."""
    if sr.name == "bool":
        return np.array([False, True])
    if sr.name == "trop":
        return np.array([0.0, 1.0, 2.0, INF], np.float32)
    if sr.name == "maxplus":
        return np.array([-INF, 0.0, 1.0, 2.0], np.float32)
    return np.array([0.0, 1.0, 2.0, 3.0], np.float32)
