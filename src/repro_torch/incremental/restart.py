"""Delta-restart semi-naive maintenance and the refresh policy layer.

The counterpart of ``repro/incremental/restart.py``.  The vector
fixpoint ``x = init ⊕ x ⊗ E`` was solved once; then the graph mutated
monotonically: ``E′ = E ⊕ ΔE``.  Because ⊗ distributes over ⊕ and the
old solution ``y*`` satisfies ``y* = init ⊕ y* ⊗ E``,

    F′(y*) = init ⊕ y* ⊗ E′ = y* ⊕ (y* ⊗ ΔE)

so ``y*`` is a *pre-fixpoint* of the new ICO and its pending delta
restricted to the touched edges,

    d₀ = F′(y*) ⊖ y* = (y* ⊗ ΔE) ⊖ y*,

costs O(nnz(Δ)) to derive.  GSN iteration from ``(y*, d₀)`` under
``E′`` converges to the least fixpoint above ``y*``, which by
monotonicity is exactly ``lfp F′`` — the from-scratch answer.
Non-monotone updates (deletions, weight increases) void the
pre-fixpoint property; :func:`refresh_program` routes them through a
CEGIS-verified ⊖/recount maintenance rule
(:mod:`repro_torch.incremental.maintenance`) when synthesis succeeds
and the planner prices it under a full recompute, and falls back to the
full recompute with an explicit reason otherwise.

Everything runs on the relation's device.  On the card the seed is one
contraction over Δ (``contract.vspm``/``mspm``: kernel B3's ``runs``
path over Δ's own segment plan) and the resume is the staged loop, whose
rounds over ``E′`` are B3 ``runs`` launches too; the worklist
(``mode="frontier"``) resumes over the CSR index that
``SparseRelation.apply_delta`` extended with an overlay.  A previous
solution handed in as a numpy array is moved to the device once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import planner, vectorize
from repro_torch.core import semiring as sr_mod
from repro_torch.incremental.delta import DeltaLog
from repro_torch.sparse import contract
from repro_torch.sparse.coo import SparseRelation
from repro_torch.sparse.fixpoint import FixpointState, fixpoint


def _on(x, device: torch.device, dtype) -> torch.Tensor:
    """``x`` (host data: numpy, or a CPU tensor) as a ``dtype`` tensor on
    the relation's ``device``, moved once.  A tensor on another
    accelerator is refused: the work would leave the relation's
    device."""
    if isinstance(x, torch.Tensor):
        if x.device != device and x.device.type != "cpu":
            raise ValueError(f"a tensor on {x.device} for a relation on "
                             f"{device}")
        return x.to(device, dtype)
    return torch.from_numpy(np.array(x, order="C")).to(device, dtype)


def delta_seed(delta: SparseRelation, prev, *, backend: str = "torch"):
    """``d₀ = (y* ⊗ ΔE) ⊖ y*`` — the pending delta of the old solution
    under the mutated operator, derived from the touched edges alone.

    ``prev`` may be ``(n,)`` or a ``(B, n)`` pack of warm solutions (one
    contraction over Δ seeds every row at once).  ``backend="torch"``
    runs on Δ's device (``contract.vspm``/``mspm``, whose ⊕ is B3's
    ``runs`` path); ``backend="np"`` is the reference's host
    ``NP_COMBINE.at`` on a CPU relation — the CEGIS probes' path.
    Returns a tensor on Δ's device.
    """
    sr = sr_mod.get(delta.semiring)
    prev = _on(prev, delta.device, sr.dtype)
    if backend == "np":
        if delta.device.type != "cpu":
            raise ValueError("delta_seed(backend='np') runs on the host; "
                             f"Δ lives on {delta.device}")
        srn = sr_mod.get(delta.semiring, lib="np")
        h = delta.as_np()
        k = int(h.nnz)
        src = h.coords[:k, 0].astype(np.int64)
        dst = h.coords[:k, 1].astype(np.int64)
        w = h.values[:k]
        p = prev.numpy()
        derived = np.full(p.shape, srn.zero, srn.dtype)
        if p.ndim == 1:
            sr_mod.NP_COMBINE[srn.name].at(derived, dst,
                                           srn.mul(p[src], w))
        else:
            b = p.shape[0]
            sr_mod.NP_COMBINE[srn.name].at(
                derived, (np.arange(b)[:, None], dst[None, :]),
                srn.mul(p[:, src], w[None, :]))
        return torch.from_numpy(srn.minus(derived, p))
    if backend != "torch":
        raise ValueError(f"unknown delta_seed backend {backend!r}")
    derived = (contract.vspm(prev, delta) if prev.dim() == 1
               else contract.mspm(prev, delta))
    return sr.minus(derived, prev)


def delta_restart_fixpoint(edges: SparseRelation, delta: SparseRelation,
                           prev, *, max_iters: int = 10_000,
                           mode: str = "auto"):
    """Repair ``y* = lfp(x ↦ init ⊕ x ⊗ E)`` after the monotone update
    ``E′ = E ⊕ ΔE``: seed ``d₀`` from ``delta`` (O(nnz(Δ))), then
    re-converge with the ordinary GSN loop under ``edges`` (= E′,
    post-update).  Exact for monotone updates on idempotent-lattice
    semirings; :func:`refresh_program` routes non-monotone mutations
    elsewhere.

    ``mode="auto"`` is the worklist on a CPU relation and the staged
    loop on a CUDA one; a ``(B, n)`` ``prev`` always takes the staged
    loop (the worklist is per row).  Returns ``(y′*, iters)`` on the
    relation's device, where ``iters`` counts only resumed rounds (0 when
    the update does not change the solution at all): an int for one
    source, a ``(B,)`` int32 tensor for a pack.
    """
    assert edges.semiring == delta.semiring, (edges, delta)
    assert edges.shape == delta.shape, (edges.shape, delta.shape)
    if mode == "auto":
        mode = "frontier" if edges.device.type == "cpu" else "jit"
    sr = sr_mod.get(edges.semiring)
    prev = _on(prev, edges.device, sr.dtype)
    batched = prev.dim() == 2
    if mode == "frontier" and batched:
        # worklists are per row; the batched repair is the staged loop
        mode = "jit"
    backend = "np" if mode == "frontier" and edges.device.type == "cpu" \
        else "torch"
    d0 = delta_seed(delta, prev, backend=backend)
    y0, d0 = (prev, d0) if batched else (prev[None], d0[None])
    st = FixpointState(y0, d0,
                       torch.zeros(y0.shape[0], dtype=torch.int32,
                                   device=edges.device),
                       edges.semiring, batched)
    return fixpoint(edges, state=st, max_iters=max_iters, mode=mode)


# --------------------------------------------------------------------------
# Policy layer: plan → (delta-restart | synth_maintenance | full)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RefreshReport:
    """How one refresh was executed and why."""

    strategy: str        # "delta_restart" | "synth_maintenance" | "full"
    reason: str
    iters: int = 0
    delta_nnz: int = 0
    plan: object | None = None    # the consulted ExecutionPlan, if any
    rule: object | None = None    # the MaintenanceRule executed, if any


def refresh_program(prog, db, prev, log: DeltaLog, *, hints=None,
                    max_iters: int = 10_000, mode: str = "auto",
                    synth_budget_s: float = 5.0):
    """Apply ``log`` to ``db`` and return the fresh answer, repairing
    ``prev`` in place when the planner prices that cheaper.

    Returns ``(answer, updated_db, RefreshReport)``; the answer lies on
    the database's device.  ``prev`` is the program's previous answer on
    ``db`` (numpy or tensor; ``None`` → full recompute).  The decision is
    the planner's (``objective="incremental"``): a monotone log
    considers delta-restart at O(nnz(Δ) · affected-trip-count) against
    every full-recompute candidate; a non-monotone log (deletes / weight
    increases) first ensures a CEGIS-verified maintenance rule for
    (program signature, semiring, op) — synthesized once within
    ``synth_budget_s``, then cached — and considers the
    ``synth_maintenance`` repair instead.  Whenever synthesis fails, the
    planner prices the repair out, or the log touches relations outside
    the linear operator, the refresh falls back to a full recompute with
    the recorded reason — semantics never change.
    """
    ph = planner.PlanHints.of(hints, defaults=prog.sort_hints)
    hints = dict(ph.sorts)

    nm_op = log.nonmonotone_op()
    if nm_op is not None:
        return _refresh_nonmonotone(prog, db, prev, log, nm_op, ph,
                                    hints, max_iters, mode,
                                    synth_budget_s)
    db2 = db.apply_delta(log)
    if prev is None:
        return _full(prog, db2, log, "no previous solution to restart "
                     "from", max_iters)

    plan = planner.plan_program(prog, db2, ph,
                                objective="incremental",
                                delta_nnz=log.nnz(), max_iters=max_iters)
    sp = plan.strata[0] if plan.strata else None
    if sp is None or sp.runner != "delta_restart":
        reason = "planner: full recompute priced cheaper" if sp is None \
            or "delta_restart" in sp.considered else \
            f"planner: {sp.rejected.get('delta_restart', 'infeasible')}"
        return _full(prog, db2, log, reason, max_iters, plan=plan)

    bail = _outside_operator(sp.vf, log)
    if bail is not None:
        return _full(prog, db2, log, bail, max_iters, plan=plan)

    a = vectorize.edge_atom(sp.vf)
    delta = _oriented(log.merged(a.name, *_rel_frame(db2, a.name),
                                 device=db2.device), a, sp.vf)
    edges = planner.materialize_edges(plan, db2, hints)
    y, iters = delta_restart_fixpoint(edges, delta, prev,
                                      max_iters=max_iters, mode=mode)
    rep = RefreshReport("delta_restart", sp.reason, int(iters),
                        log.nnz(), plan)
    return y, db2, rep


def _refresh_nonmonotone(prog, db, prev, log, nm_op, ph, hints,
                         max_iters, mode, synth_budget_s):
    """The delete/increase path: synthesize-or-recall the maintenance
    rule, let the planner price it, gather the *old* stored values of
    the removed keys before mutating, and execute the verified repair."""
    from repro_torch.incremental import maintenance

    if prev is None:
        return _full(prog, db.apply_delta(log),
                     log, "no previous solution to restart from",
                     max_iters)
    try:
        vf = vectorize.vector_form(prog)
    except ValueError as e:
        return _full(prog, db.apply_delta(log), log,
                     f"{nm_op} maintenance needs the vector form: {e}",
                     max_iters)
    bail = _outside_operator(vf, log)
    if bail is not None:
        return _full(prog, db.apply_delta(log), log, bail, max_iters)

    rule_op = "delete" if nm_op == "mixed" else nm_op
    rule = maintenance.ensure_rule(vf.signature, vf.semiring, rule_op,
                                   budget_s=synth_budget_s)

    # the removed keys' *old* stored values decide which deletions were
    # support-carrying — gather them before apply_delta drops them
    a = vectorize.edge_atom(vf)
    rcoords = log.removed_coords(a.name)
    removed = _oriented(_removed_rel(db, a.name, rcoords), a, vf)

    db2 = db.apply_delta(log)
    plan = planner.plan_program(prog, db2, ph,
                                objective="incremental",
                                delta_nnz=log.nnz(), delta_op=rule_op,
                                max_iters=max_iters)
    sp = plan.strata[0] if plan.strata else None
    if sp is None or sp.runner != "synth_maintenance":
        reason = "planner: full recompute priced cheaper" if sp is None \
            or "synth_maintenance" in sp.considered else \
            f"planner: {sp.rejected.get('synth_maintenance', 'infeasible')}"
        return _full(prog, db2, log, reason, max_iters, plan=plan)

    merged = log.merged(a.name, *_rel_frame(db2, a.name),
                        device=db2.device)
    merged = _oriented(merged, a, vf) if merged.nnz else None
    edges = planner.materialize_edges(plan, db2, hints)
    init = vectorize.init_vector(vf, db2, hints)
    k = removed.nnz
    y, iters = maintenance.maintain_nonmonotone(
        edges, removed.coords[:k], removed.values[:k], prev, init, rule,
        merge_delta=merged, max_iters=max_iters, mode=mode)
    rep = RefreshReport("synth_maintenance", sp.reason, int(iters),
                        log.nnz(), plan, rule)
    return y, db2, rep


def _outside_operator(vf, log: DeltaLog) -> str | None:
    """The shared feasibility guards of both maintenance strategies."""
    a = vectorize.edge_atom(vf)
    touched = log.touched()
    if a is None or touched - {a.name}:
        extra = sorted(touched - ({a.name} if a else set()))
        return (f"delta touches relations outside the linear operator "
                f"({extra}) — the init term may have changed")
    if vectorize.init_reads(vf, a.name):
        return (f"edge relation {a.name} also feeds the init term — a "
                f"delta seed from y* ⊗ ΔE alone would miss its "
                f"contribution")
    return None


def _rel_frame(db, name: str) -> tuple:
    rel = db.relations[name]
    return tuple(rel.shape), (rel.semiring
                              if isinstance(rel, SparseRelation)
                              else db.schema[name].semiring)


def _oriented(delta: SparseRelation, a, vf) -> SparseRelation:
    if tuple(a.args) != vf.edge.head:
        delta = delta.transpose()
    return vectorize._sparse_into_semiring(delta, vf.semiring)


def _removed_rel(db, name: str, coords) -> SparseRelation:
    """The removed keys with their old stored values, as a sparse Δ in
    the relation's own frame on the database's device (keys absent from
    the relation carry 0̄ and coalesce away — deleting a non-edge
    repairs nothing)."""
    from repro_torch.incremental.maintenance import _gather_values
    rel = db.relations[name]
    shape, semiring = _rel_frame(db, name)
    coords = np.asarray(coords, np.int64).reshape(-1, len(shape))
    if isinstance(rel, SparseRelation):
        vals = _gather_values(rel, coords)
    else:
        vals = rel[tuple(torch.from_numpy(coords).to(rel.device).t())]
    return SparseRelation.from_coo(coords, vals.cpu().numpy(), shape,
                                   semiring, device=db.device)


def _full(prog, db2, log, reason, max_iters, *, plan=None):
    from repro_torch.core.program import run_program

    out, stats = run_program(prog, db2, max_iters=max_iters)
    return out, db2, RefreshReport("full", reason,
                                   int(sum(stats.iterations)), log.nnz(),
                                   plan)
