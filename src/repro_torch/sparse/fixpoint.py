"""Staged semi-naive fixpoint over sparse S-relations.

The counterpart of ``repro/sparse/fixpoint.py``'s ``mode="jit"`` path.
It solves the linear vector equation (the GH-form of BM/CC/SSSP after
the FGH rewrite)

    x[y]  =  init[y] ⊕ ⊕_z x[z] ⊗ E[z, y]

by GSN rounds ``y ⊕= Δ; Δ = (Δ ⊗ E) ⊖ y`` for one source (``(n,)``
init) or a ``(B, n)`` pack of sources, each row with its own
convergence mask and iteration count.  ``lax.while_loop`` becomes a
Python loop: the carry, the per-row ``live`` mask and the per-row
counts stay on the device, and only the global "any row live" test
syncs with the host, once per round.

Two backends advance Δ: ``"torch"`` — the gather/⊗/segment-⊕
composition of :mod:`repro_torch.sparse.contract` whose ⊕ is kernel B3
(``vspm`` for one source, ``spmm`` in the (n, B) layout for a pack) —
and ``"kernel"`` — the fused SpMM kernel B1 over the operator's cached
dst-sorted geometry.  The host worklist ``mode="frontier"`` and its CSR
cache are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.sparse import contract
from repro_torch.sparse.coo import SparseRelation


@dataclasses.dataclass
class FrontierStats:
    """Frontier observations from one run or one bounded chunk: the
    carry at the chunk boundary (``nnz`` live Δ entries, their
    ``density`` over the ``(B, n)`` carry, at global ``iteration``)."""

    frontier_sizes: list[int]
    edges_expanded: list[int]
    nnz: int = 0
    density: float = 0.0
    iteration: int = 0


@dataclasses.dataclass
class FixpointState:
    """The resumable carry of a GSN fixpoint: ``y`` a pre-fixpoint,
    ``delta = F(y) ⊖ y`` its pending frontier, both ``(B, n)`` tensors
    (``B = 1`` for one source; ``batched`` remembers whether the
    caller's init had a batch axis), ``iters`` the per-row ``(B,)`` int32
    iteration counter carried across chunks."""

    y: torch.Tensor
    delta: torch.Tensor
    iters: torch.Tensor
    semiring: str = "bool"
    batched: bool = True

    @classmethod
    def cold(cls, edges: SparseRelation, init: torch.Tensor
             ) -> "FixpointState":
        """``y = 0̄``, ``delta = init ⊖ 0̄`` (``0̄ ⊗ E = 0̄``)."""
        sr = sr_mod.get(edges.semiring)
        i2 = init.to(sr.dtype)
        batched = i2.dim() == 2
        if not batched:
            i2 = i2[None]
        y0 = sr.zeros(i2.shape, i2.device)
        return cls(y0, sr.minus(i2, y0),
                   torch.zeros(i2.shape[0], dtype=torch.int32,
                               device=i2.device),
                   edges.semiring, batched)

    @classmethod
    def from_numpy(cls, y, delta, iters, semiring: str, batched: bool, *,
                   device) -> "FixpointState":
        """Adopt a warm host carry (``(B, n)`` y/delta, ``(B,)`` iters)."""
        srn = sr_mod.get(semiring, lib="np")

        def t(a, dtype):
            return torch.from_numpy(np.array(a, dtype, order="C")).to(device)
        return cls(t(y, srn.dtype), t(delta, srn.dtype),
                   t(np.reshape(iters, -1), np.int32), semiring, batched)

    @property
    def batch(self) -> int:
        return int(self.y.shape[0])

    @property
    def n(self) -> int:
        return int(self.y.shape[1])

    def frontier_nnz(self) -> int:
        return int(sr_mod.get(self.semiring).live(self.delta).sum())

    @property
    def converged(self) -> bool:
        return self.frontier_nnz() == 0

    def stats(self) -> FrontierStats:
        nnz = self.frontier_nnz()
        it = int(self.iters.max()) if self.iters.numel() else 0
        return FrontierStats([], [], nnz=nnz,
                             density=nnz / max(1, self.batch * self.n),
                             iteration=it)

    def solution(self):
        """``(x*, iters)`` in the caller's original shape."""
        if self.batched:
            return self.y, self.iters
        return self.y[0], int(self.iters[0])


def fixpoint(edges: SparseRelation, init=None, *, state=None,
             budget=None, max_iters: int = 10_000, mode: str = "jit",
             backend: str = "torch"):
    """Least fixpoint of ``x = init ⊕ vspm(x, edges)`` — cold, warm and
    chunked.

    Pass exactly one of ``init`` (cold start, ``(n,)`` or ``(B, n)``) or
    ``state`` (a :class:`FixpointState` to resume).  With ``budget=None``
    the run converges and returns ``(x*, iters)``: ``iters`` is an int
    for one source and a ``(B,)`` int32 tensor for a pack, and a resumed
    run's iters include the rounds already in the carry.  With
    ``budget=k`` at most k rounds run and the updated
    :class:`FixpointState` comes back.  ``backend`` is ``"torch"`` or
    ``"kernel"`` (module docstring).
    """
    if (init is None) == (state is None):
        raise ValueError("fixpoint() takes exactly one of init= or state=")
    if mode != "jit":
        raise ValueError(f"mode {mode!r} is not ported; the staged 'jit' "
                         f"loop is")
    sr = _check(edges, backend)
    if budget is None and state is None:
        batched = init.dim() == 2
        i2 = (init if batched else init[None]).to(sr.dtype)
        y = sr.zeros(i2.shape[::-1], i2.device)                 # (n, B)
        d = sr.minus(i2.t().contiguous(), y)
        live = torch.ones(i2.shape[0], dtype=torch.bool, device=i2.device)
        it_rows = torch.zeros(i2.shape[0], dtype=torch.int32,
                              device=i2.device)
        y, _, it_rows = _gsn_loop(_advance(edges, backend, batched), sr,
                                  y, d, it_rows, max_iters, live=live)
        if batched:
            return y.t(), it_rows
        return y[:, 0], int(it_rows[0])
    st = state if state is not None else FixpointState.cold(edges, init)
    rounds = max_iters if budget is None else int(min(budget, max_iters))
    y = st.y.t().contiguous()
    d = st.delta.t().contiguous()
    y, d, it_rows = _gsn_loop(_advance(edges, backend, st.batched), sr, y,
                              d, st.iters.clone(), rounds)
    out = FixpointState(y.t(), d.t(), it_rows, st.semiring, st.batched)
    return out.solution() if budget is None else out


def _check(edges: SparseRelation, backend: str) -> sr_mod.Semiring:
    if edges.arity != 2 or edges.shape[0] != edges.shape[1]:
        raise ValueError(f"recursive expansion needs a square binary edge "
                         f"relation, got shape {edges.shape}")
    sr = sr_mod.get(edges.semiring)
    if sr.minus is None:
        raise ValueError(f"semiring {sr.name} lacks ⊖; "
                         "GSN needs an idempotent complete lattice")
    if backend not in contract.BACKENDS:
        raise ValueError(f"unknown fixpoint backend {backend!r}")
    return sr


def _advance(edges: SparseRelation, backend: str, batched: bool):
    """The (n, B) → (n, B) frontier advance ``Δ ⊗ E`` of one round."""
    if backend == "kernel":
        from repro_torch.kernels import coo_spmm
        plan = coo_spmm.plan_geometry(edges, transpose=True)
        return lambda d: coo_spmm.spmm(plan, d)
    if batched:
        return lambda d: contract.spmm(edges, d, transpose=True)
    # one source: the SpMV over a length-n vector (B3 on scalar payloads)
    return lambda d: contract.vspm(d[:, 0], edges)[:, None]


def _gsn_loop(adv, sr, y, d, it_rows, max_rounds: int, *, live=None):
    """GSN rounds over an (n, B) carry until no row is live or
    ``max_rounds`` rounds ran.  A row's count advances in every round it
    enters live; a row whose Δ went all-0̄ re-derives 0̄ forever, so the
    loop masks only the counts, never the values.  ``live`` defaults to
    the rows whose Δ is non-0̄ (a warm carry); a cold start passes all
    rows live."""
    if live is None:
        live = sr.live(d).any(dim=0)
    rounds = 0
    while rounds < max_rounds and bool(live.any()):
        it_rows += live.to(torch.int32)
        y = sr.add(y, d)
        d = sr.minus(adv(d), y)
        live = sr.live(d).any(dim=0)
        rounds += 1
    return y, d, it_rows
