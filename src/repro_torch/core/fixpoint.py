"""Fixpoint runners: naive and generalized semi-naive (GSN) evaluation.

The counterpart of ``repro/core/fixpoint.py``.  GSN is the FGH rewrite
of the naive loop for idempotent lattices (paper Sec. 3.1):

    naive:  X ← F(X)
    GSN:    Y ← Y ⊕ Δ;  Δ ← δF(Δ) ⊖ (Y ⊕ Δ)

Each ``lax.while_loop`` of the reference is a Python loop here; the
state stays on the device and only the convergence test reads back one
boolean per round.  States are dicts name → tensor; iteration counts
come back as Python ints (``(B,)`` int32 tensors for the batched
runner).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import semiring as sr_mod

State = dict[str, torch.Tensor]


def _check_minus(semirings: dict[str, sr_mod.Semiring]) -> None:
    for name, sr in semirings.items():
        if sr.minus is None:
            raise ValueError(f"{name}: semiring {sr.name} lacks ⊖; "
                             "GSN needs an idempotent complete lattice")


def naive_fixpoint(ico: Callable[[State], State], x0: State, *,
                   max_iters: int = 10_000) -> tuple[State, int]:
    """Iterate X ← F(X) until X stops changing.  Returns (X*, iters)."""
    x, it, changed = x0, 0, True
    while changed and it < max_iters:
        nx = ico(x)
        changed = not all(bool(torch.equal(nx[k], x[k])) for k in x)
        x, it = nx, it + 1
    return x, it


def seminaive_fixpoint(ico: Callable[[State], State],
                       delta_ico: Callable[[State], State],
                       x0: State, semirings: dict[str, sr_mod.Semiring], *,
                       max_iters: int = 10_000) -> tuple[State, int]:
    """GSN evaluation.  ``delta_ico`` is δF: applies only the linear part
    to the Δ state.  Needs idempotent ⊕ with a ⊖ (lattice) per IDB."""
    _check_minus(semirings)
    fx0 = ico(x0)
    y = x0
    d = {k: semirings[k].minus(fx0[k], x0[k]) for k in fx0}
    it, changed = 0, True
    while changed and it < max_iters:
        y = {k: semirings[k].add(y[k], d[k]) for k in y}
        dd = delta_ico(d)
        d = {k: semirings[k].minus(dd[k], y[k]) for k in dd}
        changed = any(bool(semirings[k].live(d[k]).any()) for k in d)
        it += 1
    return y, it


def batched_seminaive_fixpoint(ico: Callable[[State], State],
                               delta_ico: Callable[[State], State],
                               x0: State,
                               semirings: dict[str, sr_mod.Semiring], *,
                               max_iters: int = 10_000,
                               ) -> tuple[State, torch.Tensor]:
    """GSN over a batch of independent instances: every leaf of ``x0``
    carries a leading batch axis B, all rows advance together with a
    per-row convergence mask, and each row's count matches its
    single-instance run.  Returns ``(Y*, iters)`` with ``iters`` a
    ``(B,)`` int32 tensor."""
    _check_minus(semirings)
    b = next(iter(x0.values())).shape[0]
    for k, v in x0.items():
        if v.shape[0] != b:
            raise ValueError(f"{k}: batch axis mismatch "
                             f"({v.shape[0]} vs {b})")

    def row_live(d: State) -> torch.Tensor:
        out = None
        for k in d:
            f = semirings[k].live(d[k]).reshape(b, -1).any(dim=1)
            out = f if out is None else out | f
        return out

    dev = next(iter(x0.values())).device
    fx0 = ico(x0)
    y = x0
    d = {k: semirings[k].minus(fx0[k], x0[k]) for k in fx0}
    live = torch.ones(b, dtype=torch.bool, device=dev)
    it_rows = torch.zeros(b, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iters and bool(live.any()):
        it_rows += live.to(torch.int32)
        y = {k: semirings[k].add(y[k], d[k]) for k in y}
        dd = delta_ico(d)
        d = {k: semirings[k].minus(dd[k], y[k]) for k in dd}
        live = row_live(d)
        it += 1
    return y, it_rows


def host_fixpoint(ico: Callable[[State], State], x0: State, *,
                  max_iters: int = 10_000) -> tuple[State, int]:
    """The host loop of the ``dense_host`` runner: X ← F(X) with a host
    test of every key each round.  Returns ``(X*, iters)``, the round at
    which X stopped changing counted, or ``max_iters`` when it did not
    stop."""
    x = dict(x0)
    for it in range(max_iters):
        nx = ico(x)
        same = all(bool(torch.equal(nx[k], x[k])) for k in nx)
        x = nx
        if same:
            return x, it + 1
    return x, max_iters


def sparse_seminaive_fixpoint(edges, init, *, max_iters: int = 10_000,
                              mode: str = "auto"):
    """Frontier-based GSN over a sparse edge relation, forwarded from
    :mod:`repro_torch.sparse.fixpoint` (deprecated there: use its
    ``fixpoint``).  A round costs O(nnz) in the staged loop, or the
    frontier's out-degrees in the worklist, instead of the dense
    runners' O(n²)."""
    from repro_torch.sparse.fixpoint import sparse_seminaive_fixpoint as impl
    return impl(edges, init, max_iters=max_iters, mode=mode)
