"""Sparse semiring contraction: SpMV / SpMM / SpMSpM.

The counterpart of ``repro/sparse/contract.py``:

* ``spmv``/``vspm`` — sparse matrix × dense vector: per edge gather the
  vector at the contracted key, ⊗ with the edge value, and ⊕-reduce by
  the output key through kernel B3 (:mod:`repro_torch.kernels.
  coo_segment`).  O(nnz), independent of the key-space size.  The edges
  go in the plan order of the output column (``SparseRelation.runs``,
  memoized): B3's ``runs`` path then reads one contiguous payload.
* ``spmm``/``mspm`` — the same with row payloads (B3 on ``(cap, d)``
  rows), or with ``backend="kernel"`` the fused single-pass kernel B1.
* ``spmspm`` — sparse × sparse → sparse on the host (numpy), as in the
  reference.

Padding discipline: padded values are 0̄ and padded coordinates are the
out-of-range sentinel, which B3's segment plan drops.  torch has no
``take(mode="fill")``: where a relation has padding slots, the gather
clamps the index and masks the result with 1̄, so sentinel rows never
read out of bounds and contribute 0̄ ⊗ 1̄ = 0̄.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.sparse.coo import SparseRelation

BACKENDS = ("torch", "kernel")


def _gather(rel: SparseRelation, x: torch.Tensor, idx: torch.Tensor, fill):
    """``x[idx]`` with fill-mode semantics for sentinels."""
    if rel.capacity == rel.nnz:  # no padding: every index is in range
        return x.index_select(0, idx)
    n = x.shape[0]
    ok = (idx >= 0) & (idx < n)
    g = x.index_select(0, idx.clamp(0, max(n - 1, 0)))
    ok = ok.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(ok, g, torch.tensor(fill, dtype=x.dtype,
                                           device=x.device))


def _contract(rel: SparseRelation, x: torch.Tensor, transpose: bool):
    """Gather, ⊗ and B3's ⊕ in the plan order of the output column: the
    payload reaches B3 contiguous and sorted by output row."""
    from repro_torch.kernels import ops as kops
    sr = sr_mod.get(rel.semiring)
    contract_ax, out_ax = (0, 1) if transpose else (1, 0)
    plan, idx, vals = rel.runs(out_ax, contract_ax)
    rows = _gather(rel, x, idx, sr.one)
    vals = vals.reshape((-1,) + (1,) * (x.dim() - 1))
    return kops.semiring_segment_reduce(
        sr, sr.mul(vals, rows), rel.col(out_ax, torch.int32),
        rel.shape[out_ax], plan=plan)


def spmv(rel: SparseRelation, x: torch.Tensor, *, transpose: bool = False):
    """``out[i] = ⊕_j rel[i, j] ⊗ x[j]`` (or ``⊕_i rel[i,j] ⊗ x[i]`` with
    ``transpose``).  Returns a dense vector over the non-contracted sort."""
    if rel.arity != 2:
        raise ValueError(f"spmv needs a binary relation, got {rel!r}")
    return _contract(rel, x, transpose)


def vspm(x: torch.Tensor, rel: SparseRelation):
    """``out[j] = ⊕_i x[i] ⊗ rel[i, j]`` — vector × sparse matrix."""
    return spmv(rel, x, transpose=True)


def spmm(rel: SparseRelation, b: torch.Tensor, *, transpose: bool = False,
         backend: str = "torch"):
    """Sparse (n, k) × dense (k, d) → dense (n, d) over the semiring.

    ``backend="torch"`` is the gather/⊗/segment-⊕ composition (B3 does
    the ⊕); ``backend="kernel"`` routes through the fused single-pass
    kernel B1 over the operator's cached dst-sorted geometry.
    """
    if rel.arity != 2 or b.dim() != 2:
        raise ValueError(f"spmm needs a binary relation and a matrix, got "
                         f"{rel!r} × {tuple(b.shape)}")
    if backend == "kernel":
        from repro_torch.kernels import ops as kops
        return kops.coo_spmm(rel, b, transpose=transpose)
    if backend != "torch":
        raise ValueError(f"unknown SpMM backend {backend!r}")
    return _contract(rel, b, transpose)


def mspm(x: torch.Tensor, rel: SparseRelation, *, backend: str = "torch"):
    """Dense (B, n) × sparse (n, m) → dense (B, m): batched vspm, run in
    the (n, B) layout so gathers and scatters move contiguous rows."""
    if x.dim() != 2:
        raise ValueError(f"mspm needs a (B, n) matrix, got {tuple(x.shape)}")
    return spmm(rel, x.t().contiguous(), transpose=True,
                backend=backend).t()


def spmspm(a: SparseRelation, b: SparseRelation, *,
           capacity: int | None = None) -> SparseRelation:
    """Sparse × sparse → sparse: ``C[i,j] = ⊕_k A[i,k] ⊗ B[k,j]``.

    Host/numpy (the output's nnz is data-dependent): a sort-merge join on
    k with ⊕-coalescing of the (i, j) results; the result lands on
    ``a``'s device.
    """
    if a.arity != 2 or b.arity != 2 or a.shape[1] != b.shape[0] \
            or a.semiring != b.semiring:
        raise ValueError(f"spmspm: incompatible {a!r} × {b!r}")
    sr = sr_mod.get(a.semiring, lib="np")
    ah, bh = a.as_np(), b.as_np()
    ka, kb = int(ah.nnz), int(bh.nnz)
    ai, ak, av = (ah.coords[:ka, 0].astype(np.int64),
                  ah.coords[:ka, 1].astype(np.int64), ah.values[:ka])
    bk, bj, bv = (bh.coords[:kb, 0].astype(np.int64),
                  bh.coords[:kb, 1].astype(np.int64), bh.values[:kb])
    order = np.argsort(bk, kind="stable")
    bk, bj, bv = bk[order], bj[order], bv[order]
    counts = np.bincount(bk, minlength=a.shape[1])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    deg = counts[ak]
    rep = np.repeat(np.arange(ka), deg)
    if len(rep):
        run_off = np.arange(len(rep)) - np.repeat(
            np.concatenate([[0], np.cumsum(deg)[:-1]]), deg)
        bsel = starts[ak[rep]] + run_off
    else:
        bsel = np.zeros(0, np.int64)
    coords = np.stack([ai[rep], bj[bsel]], axis=1) if len(rep) else \
        np.zeros((0, 2), np.int64)
    values = sr.mul(av[rep], bv[bsel]) if len(rep) else \
        np.zeros(0, sr.dtype)
    return SparseRelation.from_coo(
        coords, values, (a.shape[0], b.shape[1]), a.semiring,
        capacity=capacity, device=a.device)
