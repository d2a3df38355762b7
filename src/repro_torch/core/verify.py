"""Verification of the FGH identity G(F(X)) = H(G(X))  (paper Sec. 5).

The paper verifies with z3 over normalized expressions; offline we use a
*bounded-model / orbit* check (DESIGN.md §4):

* sample small databases D (Γ-constrained when the task has a constraint);
* walk the F-orbit X₀, X₁ = F(X₀), … (⊆ 8 steps) — every loop invariant Φ
  of F holds on the orbit *by construction*, so checking the commutation on
  orbit states is exactly the premise of Theorem 3.1's diagram (invariants
  are a proof device; the diagram only ever visits orbit states);
* at each state, compare G(F(Xₜ)) with H(G(Xₜ)) numerically.

Refutation is sound (a mismatch is a real counterexample — returned to the
synthesizer as CEGIS feedback).  Acceptance is exhaustive over tiny boolean
domains plus randomized over larger ones; the final program additionally
passes a full Π₁-vs-Π₂ answer comparison.

Also here: :class:`UpdateProbe` / :func:`sample_update_probes`, the probe
generator for the *maintenance*-rule CEGIS loop (DESIGN.md §11) — small
adversarial graphs (chains, diamonds, slack paths, cycles feeding tails)
plus randomized digraphs, each with a deletion/increase batch, on which
``maintain(y*, ΔE) ≡ fixpoint(E ⊖ ΔE)`` is checked numerically.

The counterpart of ``repro/core/verify.py``.  Probe databases live on
the CPU and every evaluation here uses the engine's np backend, so the
orbits, targets and counterexamples are the reference's numpy arrays;
probe relations are the port's ``SparseRelation`` on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import constraints as gamma
from repro_torch.core import engine, ir
from repro_torch.core import semiring as sr_mod
from repro_torch.core.program import (Program, Rule, Stratum, make_ico,
                                      zero_state)


@dataclasses.dataclass
class FGHTask:
    """One stratum Π₁ = (F, G) to optimize, plus its verification context."""

    name: str
    schema: ir.Schema
    stratum: Stratum                 # F: the recursive IDBs X
    outputs: list[Rule]              # G chain; last head is the answer Y
    edbs: list[str]
    constraint: str | None = None
    small_domains: dict[str, int] = dataclasses.field(default_factory=dict)
    sampler: Callable | None = None  # custom Γ/shape-aware DB sampler
    sort_hints: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def y_name(self) -> str:
        return self.outputs[-1].head

    def y_semiring(self) -> sr_mod.Semiring:
        """The answer's semiring, as its numpy twin: the synthesizer
        combines np-backend evaluations with its ⊕."""
        return sr_mod.get(self.schema[self.y_name].semiring, lib="np")


_DEFAULT_SORT_SIZES = {"id": 3, "w": 3, "d": 12, "pos": 5, "cnt": 6}


def task_from_program(prog: Program, edbs: list[str],
                      constraint: str | None = None,
                      small_domains: dict[str, int] | None = None,
                      sampler: Callable | None = None) -> FGHTask:
    if len(prog.strata) != 1:
        raise ValueError("FGH optimizes one stratum at a time")
    sorts: set[str] = set()
    for rs in prog.schema.values():
        sorts.update(rs.sorts)
    doms = {s: _DEFAULT_SORT_SIZES.get(s, 4) for s in sorts}
    doms.update(small_domains or {})
    return FGHTask(prog.name, prog.schema, prog.strata[0], prog.outputs,
                   edbs, constraint, doms, sampler, prog.sort_hints)


@dataclasses.dataclass
class OrbitPoint:
    """One CEGIS counterexample: Y_in = G(Xₜ) and target = G(F(Xₜ))."""

    db: engine.Database
    y_in: np.ndarray
    target: np.ndarray


def eval_g(task: FGHTask, db: engine.Database,
           state: dict[str, np.ndarray]) -> np.ndarray:
    cur = db.with_relations(state)
    out = None
    for rule in task.outputs:
        out = engine.eval_ssp(rule.body, cur, task.sort_hints, backend="np")
        cur = cur.with_relations({rule.head: out})
    return out


def orbit_points(task: FGHTask, db: engine.Database, *,
                 max_steps: int = 8) -> list[OrbitPoint]:
    """G-images and G∘F-targets along the F-orbit from X₀ = 0̄."""
    ico = make_ico(task.stratum, db, task.sort_hints, backend="np")
    x = zero_state(task.stratum, db, backend="np")
    pts = []
    for _ in range(max_steps):
        nx = ico(x)
        pts.append(OrbitPoint(db, eval_g(task, db, x),
                              np.asarray(eval_g(task, db, nx))))
        if all(bool(np.all(nx[k] == x[k])) for k in nx):
            break
        x = nx
    return pts


def eval_h(task: FGHTask, h_body: ir.SSP, pt: OrbitPoint) -> np.ndarray:
    db = pt.db.with_relations({task.y_name: pt.y_in})
    return np.asarray(engine.eval_ssp(h_body, db, task.sort_hints,
                                      backend="np"))


def values_equal(a: np.ndarray, b: np.ndarray, atol: float = 1e-4) -> bool:
    if a.dtype == bool:
        return bool((a == b).all())
    return bool(np.allclose(a, b, atol=atol, rtol=1e-4, equal_nan=True))


def constant_floors(task: FGHTask) -> dict[str, int]:
    """Smallest domain size per sort that contains every constant the
    program mentions — a query-source constant C(a) in an id position
    forces id ≥ a + 1, or the probe databases cannot even index it (the
    serve loop optimizes source-parameterized programs at arbitrary
    vertices, not just 0)."""
    floors: dict[str, int] = {}

    def bump(sort: str, value: int) -> None:
        floors[sort] = max(floors.get(sort, 0), int(value) + 1)

    def visit(e: ir.SSP) -> None:
        sorts = engine.infer_var_sorts(e, task.schema, task.sort_hints)
        for t in e.terms:
            for a in t.atoms:
                if isinstance(a, ir.RelAtom):
                    for arg, s in zip(a.args, task.schema[a.name].sorts):
                        if isinstance(arg, ir.C):
                            bump(s, arg.value)
                elif isinstance(a, (ir.PredAtom, ir.ValFnAtom)):
                    var_sorts = [sorts[x] for x in a.args
                                 if not isinstance(x, ir.C) and x in sorts]
                    for arg in a.args:
                        if isinstance(arg, ir.C):
                            for s in var_sorts:
                                bump(s, arg.value)

    for rule in list(task.stratum.rules.values()) + list(task.outputs):
        visit(rule.body)
    if task.stratum.init:
        for e in task.stratum.init.values():
            visit(e)
    return floors


#: largest probe-domain size the bounded-model check will materialize —
#: dense probe relations are O(size²); beyond this a program constant
#: (e.g. a 50k-vertex query source) must be substituted into an already
#: verified template instead of re-verified from scratch
_MAX_PROBE_DOMAIN = 512


def sample_dbs(task: FGHTask, rng: np.random.Generator, count: int,
               ) -> list[engine.Database]:
    floors = constant_floors(task)
    too_big = {s: v for s, v in floors.items() if v > _MAX_PROBE_DOMAIN}
    if too_big:
        raise ValueError(
            f"{task.name}: constants force probe domains {too_big} past "
            f"the bounded-model capacity ({_MAX_PROBE_DOMAIN}); verify a "
            f"small-constant template and substitute instead")

    def floored(d: dict) -> dict:
        out = {s: max(v, floors.get(s, 0)) for s, v in d.items()}
        for s, v in floors.items():
            out.setdefault(s, v)
        return out

    doms = floored({"id": 3, **task.small_domains})
    dbs: list[engine.Database] = []
    if task.sampler is not None:
        for _ in range(count):
            dbs.append(task.sampler(rng, doms))
        return dbs
    # a slice of the exhaustive n=2 space plus random n∈{3,4} instances.
    # Γ-constrained tasks skip the exhaustive slice: its instances ignore
    # the V-covers-all-nodes aspect of the tree/dag constraints.
    if task.constraint is None:
        doms2 = floored({**doms, "id": 2})
        dbs.extend(gamma.exhaustive_databases(
            task.schema, task.edbs, doms2, constraint=task.constraint,
            limit=8))
    for i in range(count):
        d = dict(doms)
        d["id"] = max(3 + (i % 2), floors.get("id", 0))
        dbs.append(gamma.sample_database(task.schema, task.edbs, d, rng,
                                         constraint=task.constraint))
    return dbs


@dataclasses.dataclass
class VerifyResult:
    ok: bool
    counterexample: OrbitPoint | None = None
    points_checked: int = 0


def verify_h(task: FGHTask, h_body: ir.SSP, *, rng: np.random.Generator,
             n_dbs: int = 10, max_steps: int = 8) -> VerifyResult:
    """Check G(F(X)) = H(G(X)) on sampled orbits; CEGIS's verifier."""
    checked = 0
    for db in sample_dbs(task, rng, n_dbs):
        for pt in orbit_points(task, db, max_steps=max_steps):
            checked += 1
            got = eval_h(task, h_body, pt)
            if not values_equal(got, pt.target):
                return VerifyResult(False, pt, checked)
    return VerifyResult(True, None, checked)


# --------------------------------------------------------------------------
# Update-maintenance probes (DESIGN.md §11)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class UpdateProbe:
    """One bounded-model instance for maintenance-rule verification: a
    small vector fixpoint ``x = init ⊕ x ⊗ E`` plus a non-monotone
    update against ``E``.  The maintenance CEGIS loop
    (:func:`repro_torch.incremental.maintenance.synthesize_maintenance`)
    replays each candidate rule on these and compares against a
    from-scratch solve — the maintenance analogue of :func:`sample_dbs`
    + :func:`orbit_points`."""

    name: str
    edges: object          # SparseRelation over the probe semiring
    init: np.ndarray       # (n,) init vector (a query source)
    coords: np.ndarray     # (k, 2) updated edge keys
    new_values: np.ndarray | None = None  # increase op: the heavier values


def _probe_rel(coords, values, n, semiring):
    from repro_torch.sparse.coo import SparseRelation
    return SparseRelation.from_coo(coords, values, (n, n), semiring,
                                   capacity=max(1, 2 * len(coords)),
                                   device="cpu")


def sample_update_probes(semiring: str, rng: np.random.Generator,
                         count: int = 8, *, op: str = "delete"
                         ) -> list[UpdateProbe]:
    """Adversarial + randomized probes for non-monotone maintenance.

    The deterministic set is chosen to *refute* every unsound candidate
    in the rule grammar (DESIGN.md §11): chains kill no-closure and
    one-hop cones, cyclic support kills DRed-style support counting
    (a cycle keeps itself "supported" after its external feed is
    deleted).  ``maxplus`` probes are DAGs only — a positive cycle has
    no finite longest path, so cyclic instances would not even have a
    from-scratch ground truth to compare against.
    """
    sr = sr_mod.get(semiring, lib="np")
    cyclic_ok = semiring != "maxplus"

    def mk(name, coords, dels, *, n=None, w=None, inc=None):
        coords = np.asarray(coords, np.int64)
        n = n or int(coords.max()) + 1
        if semiring == "bool":
            vals = np.ones(len(coords), bool)
        else:
            vals = np.asarray(w if w is not None
                              else np.ones(len(coords)), sr.dtype)
        init = np.full(n, sr.zero, sr.dtype)
        init[0] = sr.one
        return UpdateProbe(name, _probe_rel(coords, vals, n, semiring),
                           init, np.asarray(dels, np.int64),
                           None if inc is None
                           else np.asarray(inc, sr.dtype))

    probes = [
        # chain: effects propagate ≥ 3 hops past the deleted edge
        mk("chain", [(0, 1), (1, 2), (2, 3), (3, 4)], [(0, 1)]),
        # diamond: surviving alternate support must be kept, not dropped
        mk("diamond", [(0, 1), (0, 2), (1, 3), (2, 3)], [(0, 1)],
           w=[1, 5, 1, 1]),
        # slack: deleting a non-tight edge must be a no-op
        mk("slack", [(0, 1), (1, 2), (0, 2)], [(0, 2)], w=[1, 1, 9]),
        # batch: two deletes in one update
        mk("batch", [(0, 1), (1, 2), (2, 3), (3, 4)],
           [(0, 1), (2, 3)]),
    ]
    if cyclic_ok:
        probes += [
            # cyclic support: 1⇄2 keep each other "supported" after the
            # external feed (0,1) is deleted — the DRed counterexample
            mk("cycle-feed", [(0, 1), (1, 2), (2, 1)], [(0, 1)]),
            # self-loop support (the 1-cycle variant)
            mk("self-loop", [(0, 1), (1, 1)], [(0, 1)],
               w=[1, 0] if semiring != "bool" else None),
            # a cycle with a tail hanging off it
            mk("cycle-tail", [(0, 1), (1, 2), (2, 3), (3, 1), (1, 4)],
               [(0, 1)]),
        ]
    for i in range(count):
        n = int(rng.integers(6, 10))
        mask = rng.random((n, n)) < 0.3
        np.fill_diagonal(mask, False)
        if not cyclic_ok:
            mask = np.triu(mask)  # DAG
        coords = np.argwhere(mask)
        if len(coords) == 0:
            coords = np.asarray([(0, 1)])
        w = rng.integers(1, 6, len(coords))
        k = int(rng.integers(1, min(4, len(coords)) + 1))
        dels = coords[rng.choice(len(coords), size=k, replace=False)]
        probes.append(mk(f"rand{i}", coords, dels, n=n, w=w))
    if op == "increase":
        for p in probes:
            k = len(p.coords)
            bump = rng.integers(1, 5, k)
            if semiring == "bool":
                p.new_values = np.ones(k, bool)
            else:
                p.new_values = np.asarray(bump * 3 + 1, sr.dtype)
    return probes


def verify_programs_equal(p1: Program, p2: Program, dbs, *,
                          atol: float = 1e-4) -> bool:
    """End-to-end Π₁ ≡ Π₂ answer check on concrete databases (the
    answers are brought to the host to compare)."""
    from repro_torch.core.program import run_program
    for db in dbs:
        # ground-truth naive evaluation: CEGIS candidates may be
        # non-monotone mid-search, where fancier runners can diverge
        a, _ = run_program(p1, db, mode="naive")
        b, _ = run_program(p2, db, mode="naive")
        if not values_equal(_host(a), _host(b), atol):
            return False
    return True


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
