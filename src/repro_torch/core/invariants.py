"""Loop-invariant inference (paper Sec. 3.2 + Sec. 7, green boxes).

The paper symbolically executes F for 5 iterations, mines identities
satisfied by every iterate with an e-graph, and checks candidates with the
SMT solver.  We follow the same shape:

* symbolic execution — Xₜ₊₁ = normalize(F[X := Xₜ]) as SSP expressions over
  the EDBs (X₀ = the empty SSP);
* candidate mining — *probe* identities L(X) = R(X) instantiated from a
  template family (join-commutation probes ⊕_z E(x,z)X(z,y) =
  ⊕_z X(x,z)E(z,y) for each binary EDB, identity/containment probes);
  a candidate survives if L(Xₜ) ≅ R(Xₜ) (normal-form isomorphism, the
  e-graph's role) for every executed iterate;
* checking — surviving candidates are confirmed numerically on sampled
  orbits (the verifier's role; orbit states satisfy every invariant of F
  by construction, so this checks conditions (9)+(10) on those instances).

Verified invariants feed the rule-based synthesizer as term-rewrite rules
(the *beyond magic* optimization, Example 3.8).

The counterpart of ``repro/core/invariants.py`` (host-side: the IR and
the engine's np backend).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import ir, verify
from repro_torch.core.ir import RelAtom, Term


@dataclasses.dataclass(frozen=True)
class Invariant:
    """An identity  ⊕_{lhs.bound} Π lhs.atoms = ⊕_{rhs.bound} Π rhs.atoms
    that holds for every reachable X (free vars are shared)."""

    lhs: Term
    rhs: Term
    head: tuple[str, ...]

    def __str__(self) -> str:
        return f"{ir.term_str(self.lhs)}  ⇔  {ir.term_str(self.rhs)}"


def symbolic_orbit(task: verify.FGHTask, steps: int = 5) -> dict[str, list[ir.SSP]]:
    """Xₜ as SSP expressions over the EDBs, t = 0..steps."""
    orbits: dict[str, list[ir.SSP]] = {
        n: [ir.SSP(r.body.head, (), r.body.semiring)]
        for n, r in task.stratum.rules.items()}
    for _ in range(steps):
        defs = {n: orbits[n][-1] for n in orbits}
        for n, rule in task.stratum.rules.items():
            orbits[n].append(ir.substitute_defs(rule.body, defs))
    return orbits


def _commutation_probes(task: verify.FGHTask, idb: str):
    """⊕_z E(x,z)⊗X(z,y)  vs  ⊕_z X(x,z)⊗E(z,y), per binary bool EDB."""
    schema = task.schema
    if len(schema[idb].sorts) != 2:
        return
    s0, s1 = schema[idb].sorts
    for e in task.edbs:
        if schema[e].sorts == (s0, s1) and \
                schema[e].semiring == schema[idb].semiring:
            lhs = Term((RelAtom(e, ("x", "z")), RelAtom(idb, ("z", "y"))),
                       ("z",))
            rhs = Term((RelAtom(idb, ("x", "z")), RelAtom(e, ("z", "y"))),
                       ("z",))
            yield Invariant(lhs, rhs, ("x", "y"))


def infer_invariants(task: verify.FGHTask, *, steps: int = 5,
                     rng: np.random.Generator | None = None,
                     n_confirm_dbs: int = 6) -> tuple[list[Invariant], dict]:
    rng = rng or np.random.default_rng(1)
    t0 = time.perf_counter()
    try:
        orbits = symbolic_orbit(task, steps)
    except ir.NonIdempotentCast:
        return [], {"time_s": time.perf_counter() - t0, "candidates": 0}

    found: list[Invariant] = []
    n_cand = 0
    for idb in task.stratum.rules:
        for inv in _commutation_probes(task, idb):
            n_cand += 1
            symbolic_ok = True
            for xt in orbits[idb][1:]:
                l = ir.substitute_defs(
                    ir.SSP(inv.head, (inv.lhs,), xt.semiring), {idb: xt})
                r = ir.substitute_defs(
                    ir.SSP(inv.head, (inv.rhs,), xt.semiring), {idb: xt})
                if not ir.isomorphic(l, r):
                    symbolic_ok = False
                    break
            # symbolic isomorphism is a fast certificate; when it fails
            # (e.g. V-guards make the forms differ off-support) we still
            # accept numerically-confirmed candidates — the synthesized H
            # is independently verified afterwards, so a spurious rewrite
            # rule can enlarge the search space but not unsoundify it.
            n_dbs = n_confirm_dbs if symbolic_ok else 2 * n_confirm_dbs
            if _confirm_numeric(task, idb, inv, rng, n_dbs):
                found.append(inv)
    return found, {"time_s": time.perf_counter() - t0, "candidates": n_cand}


def _confirm_numeric(task: verify.FGHTask, idb: str, inv: Invariant,
                     rng: np.random.Generator, n_dbs: int) -> bool:
    from repro_torch.core import engine
    from repro_torch.core.program import make_ico, zero_state

    sr_name = task.schema[idb].semiring
    for db in verify.sample_dbs(task, rng, n_dbs):
        ico = make_ico(task.stratum, db, task.sort_hints, backend="np")
        x = zero_state(task.stratum, db, backend="np")
        for _ in range(6):
            cur = db.with_relations(x)
            l = engine.eval_ssp(ir.SSP(inv.head, (inv.lhs,), sr_name), cur,
                                task.sort_hints, backend="np")
            r = engine.eval_ssp(ir.SSP(inv.head, (inv.rhs,), sr_name), cur,
                                task.sort_hints, backend="np")
            if not verify.values_equal(np.asarray(l), np.asarray(r)):
                return False
            nx = ico(x)
            if all(bool((nx[k] == x[k]).all()) for k in nx):
                break
            x = nx
    return True
