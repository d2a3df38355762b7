"""Adaptive switching policies: storage density and mid-fixpoint runner
re-planning (the counterpart of ``repro/sparse/adaptive.py``).

Below :data:`SPARSIFY_BELOW` live fraction a relation is stored as COO
(O(nnz) kernels), above :data:`DENSIFY_ABOVE` as a dense tensor; in
between it keeps its current representation (hysteresis).
:func:`decide` is the one threshold table shared by ``Database.adapt``
and the planner's storage folding.

:class:`ReplanPolicy` (when a runner switch is allowed) and
:class:`AdaptiveCostModel` (what each runner's next round costs) drive
:func:`repro_torch.core.runners.adaptive_fixpoint`, which flips the
*runner* between chunks of one fixpoint.
"""

from __future__ import annotations

import dataclasses

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


# --------------------------------------------------------------------------
# Mid-fixpoint re-planning
# --------------------------------------------------------------------------
#
# The storage hysteresis above flips a *representation* between strata;
# the pieces below flip the *runner* between chunks of one fixpoint: a
# frozen policy (when a switch is allowed) and a patchable model of what
# each runner's next round costs, so tests and calibration sweeps can
# pin either side.


@dataclasses.dataclass(frozen=True)
class ReplanPolicy:
    """When the adaptive executor may switch runners mid-fixpoint.

    A switch fires only when the challenger prices at least
    ``hysteresis``× cheaper per round, at most once per
    ``min_chunks_between`` chunks, never before ``warmup_chunks`` chunks
    have been observed, and never more than ``max_switches`` times in
    one fixpoint — so the hand-off overhead is at most ``max_switches``
    chunk boundaries and the time spent in a mispriced runner at most
    one chunk a switch.
    """

    #: rounds per chunk — the re-planning granularity
    chunk_iters: int = 8
    #: challenger must price this many × under the incumbent's next-round
    #: estimate before a switch fires
    hysteresis: float = 2.0
    #: chunks that must elapse after a switch before the next one
    min_chunks_between: int = 2
    #: hard cap on switches per fixpoint
    max_switches: int = 4
    #: chunks to observe before the first switch is allowed
    warmup_chunks: int = 1

    def should_switch(self, incumbent_cost: float, challenger_cost: float,
                      *, chunk_index: int, chunks_since_switch: int,
                      switches: int) -> bool:
        if switches >= self.max_switches:
            return False
        if chunk_index + 1 <= self.warmup_chunks:
            return False
        if chunks_since_switch < self.min_chunks_between:
            return False
        return challenger_cost * self.hysteresis <= incumbent_cost


@dataclasses.dataclass
class AdaptiveCostModel:
    """Per-round ns estimates for re-pricing the *remaining* fixpoint at
    a chunk boundary, from the carry observed there.

    These price one *round*, not a whole run: the remaining trip count
    is the same for every candidate (they share the GSN round), so it
    cancels.  The worklist's round tracks the live frontier; the staged
    runners pay O(nnz(E)·B) whatever the density.

    The constants are the reference's, fitted to its CPU host, and are
    **uncalibrated on the card**: ROADMAP's main-path work queues their
    calibration on CUDA from ``chip_smoke.py``'s ``replan`` phase, whose
    per-round table records the measured ms beside these predictions.
    The ``sparse_sharded`` branch prices the sharded runner on a mesh
    of ``mesh_d`` ranks (``Runner.estimate`` passes the context's); one
    card cannot calibrate it for D > 1.  Module-level instance
    :data:`ADAPTIVE_COST` is patchable in place.
    """

    #: worklist: per expanded edge (gather + ⊗ + combine-at)
    host_edge_ns: float = 60.0
    #: worklist: per vertex per live row per round (the O(n) scans)
    host_vertex_ns: float = 4.0
    #: worklist: fixed per-round overhead per live row
    host_round_ns: float = 5_000.0
    #: staged loop: per stored edge per lane per round
    staged_edge_ns: float = 1.5
    #: staged loop: per vertex per lane per round (⊕/⊖/mask sweeps)
    staged_vertex_ns: float = 1.0
    #: staged loop: fixed per-round dispatch/loop overhead
    staged_round_ns: float = 20_000.0
    #: dense matmul runner: per n² cell per lane per round
    dense_cell_ns: float = 0.6
    #: sharded loop: per-round synchronizing-collective toll per device
    sharded_sync_ns: float = 50_000.0

    def round_ns(self, runner: str, *, n: int, e_nnz: int, batch: int,
                 frontier_nnz: int, live_rows: int, semiring: str,
                 fused_speedup: float = 1.0, mesh_d: int = 1) -> float:
        """Estimated cost of the *next* round for ``runner`` given the
        chunk-boundary frontier observation."""
        if runner == "sparse_frontier":
            deg = e_nnz / max(1, n)
            return (frontier_nnz * deg * self.host_edge_ns
                    + live_rows * (n * self.host_vertex_ns
                                   + self.host_round_ns))
        if runner == "sparse_jit":
            return (e_nnz * batch * self.staged_edge_ns
                    + n * batch * self.staged_vertex_ns
                    + self.staged_round_ns)
        if runner == "sparse_frontier_pallas":
            base = self.round_ns("sparse_jit", n=n, e_nnz=e_nnz,
                                 batch=batch, frontier_nnz=frontier_nnz,
                                 live_rows=live_rows, semiring=semiring)
            return base / max(fused_speedup, 1.0)
        if runner == "vector_dense":
            return (n * n * batch * self.dense_cell_ns
                    + n * batch * self.staged_vertex_ns
                    + self.staged_round_ns)
        if runner == "sparse_sharded":
            work = (e_nnz * batch * self.staged_edge_ns
                    + n * batch * self.staged_vertex_ns)
            return (work / max(1, mesh_d)
                    + mesh_d * self.sharded_sync_ns
                    + self.staged_round_ns)
        raise ValueError(f"no adaptive cost model for runner {runner!r}")


#: module-level so tests and calibration sweeps can patch it in place
ADAPTIVE_COST = AdaptiveCostModel()
