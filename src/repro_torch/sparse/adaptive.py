"""Adaptive storage density switch (the counterpart of the first half of
``repro/sparse/adaptive.py``).

Below :data:`SPARSIFY_BELOW` live fraction a relation is stored as COO
(O(nnz) kernels), above :data:`DENSIFY_ABOVE` as a dense tensor; in
between it keeps its current representation (hysteresis).
:func:`decide` is the one threshold table shared by ``Database.adapt``
and the planner's storage folding.  Mid-fixpoint re-planning
(``ReplanPolicy``/``AdaptiveCostModel``) is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.sparse.coo import SparseRelation

SPARSIFY_BELOW = 0.05
DENSIFY_ABOVE = 0.25

#: spare capacity factor when sparsifying, so a growing relation does not
#: immediately overflow its padded buffer
CAPACITY_SLACK = 1.5


def density(arr, semiring: str) -> float:
    """Live (non-0̄) fraction of a dense tensor or SparseRelation."""
    if isinstance(arr, SparseRelation):
        return arr.density()
    sr = sr_mod.get(semiring)
    live = int(sr.live(arr).sum())
    return float(live) / (arr.numel() or 1)


def decide(density_value: float, current: str, *,
           sparsify_below: float = SPARSIFY_BELOW,
           densify_above: float = DENSIFY_ABOVE) -> str:
    """Target storage ("sparse" | "dense") with hysteresis."""
    if density_value < sparsify_below:
        return "sparse"
    if density_value > densify_above:
        return "dense"
    return current


def adapt_value(arr, semiring: str, *,
                sparsify_below: float = SPARSIFY_BELOW,
                densify_above: float = DENSIFY_ABOVE):
    """Return ``arr`` in the representation its density warrants (on
    the same device)."""
    d = density(arr, semiring)
    current = "sparse" if isinstance(arr, SparseRelation) else "dense"
    target = decide(d, current, sparsify_below=sparsify_below,
                    densify_above=densify_above)
    if target == current:
        return arr
    if target == "dense":
        return arr.to_dense()
    if not isinstance(arr, torch.Tensor) or arr.dim() < 1:
        return arr
    cap = max(1, int(d * arr.numel() * CAPACITY_SLACK) + 1)
    return SparseRelation.from_dense(arr, semiring, capacity=cap)
