"""Incremental fixpoint maintenance on the relation's device.

The counterpart of ``repro/incremental/``.  Keeps fixpoint solutions
warm across database mutations instead of recomputing from ⊥:

* :class:`DeltaLog` — a typed log of streaming relation updates:
  ⊕-merge edge insertions (and monotone weight decreases for trop,
  where ⊕ = min absorbs them) plus the non-monotone mutations —
  explicit deletions and weight increases.
* :func:`delta_restart_fixpoint` — re-converge ``x = init ⊕ x ⊗ E′``
  from the previous solution ``y*``, seeding the GSN frontier with only
  the rows reachable from touched edges (``d₀ = (y* ⊗ ΔE) ⊖ y*``,
  O(nnz(Δ))).  A ``(B, n)`` previous solution repairs a batch of warm
  answers in one contraction a round.
* :func:`maintain_nonmonotone` / :func:`synthesize_maintenance` — the
  non-monotone repair: a CEGIS loop over a small ⊕/⊗/⊖/recount rule
  grammar synthesizes, and a probe-based verifier certifies, the
  maintenance program; the winner is cached per (program signature,
  semiring, update op) and executed as a warm-start carry — reset the
  support cone, recount its in-edges, resume GSN.
* :func:`refresh_program` — the policy layer: applies a
  :class:`DeltaLog` through :meth:`repro_torch.core.engine.Database.
  apply_delta`, asks the planner (``objective="incremental"``) whether
  delta-restart (monotone logs) or the synthesized maintenance rule
  (deletes / weight increases) beats a full recompute, and falls back
  to a full recompute, with the reason, whenever synthesis fails, the
  previous solution is missing, or the delta is large enough that
  repairing loses.
"""

from repro_torch.incremental.delta import DeltaEntry, DeltaLog
from repro_torch.incremental.maintenance import (MaintenanceRule,
                                                 cached_rule, ensure_rule,
                                                 maintain_nonmonotone,
                                                 synthesize_maintenance)
from repro_torch.incremental.restart import (RefreshReport,
                                             delta_restart_fixpoint,
                                             delta_seed, refresh_program)

__all__ = [
    "DeltaEntry", "DeltaLog", "MaintenanceRule", "RefreshReport",
    "cached_rule", "delta_seed", "delta_restart_fixpoint", "ensure_rule",
    "maintain_nonmonotone", "refresh_program", "synthesize_maintenance",
]
