"""The FGH optimizer (paper Fig. 6): Π₁(F, G) + Γ  →  Π₂(H).

Pipeline, mirroring the paper's architecture:

1. **Invariant inference** (invariants.py) — symbolic execution + probe
   identities; verified invariants become term-rewrite rules.
2. **Rule-based synthesis** (Sec. 6.1) — compute P₁ = normalize(G(F(X)))
   symbolically, then *denormalize*: rewrite P₁ using the view V = G(X) by
   sub-multiset matching of G's sum-product into each P₁ term (query
   rewriting using views).  Invariant rewrites extend the reachable forms
   (beyond magic).  Fails over to —
3. **CEGIS** (synthesis.py, Sec. 6.2) — counterexample-guided enumeration
   of the grammar Σ.
4. **Verification** — orbit/bounded-model check of the candidate H, plus a
   final whole-program Π₁ ≡ Π₂ answer comparison.
5. **GSN** — the optimized program runs under generalized semi-naive
   evaluation when its semiring is an idempotent lattice (Sec. 3.1; applied
   by the fixpoint runner, pattern-style, exactly as the paper does).

The counterpart of ``repro/core/fgh.py``: the whole optimizer runs on
the host (the IR and the engine's np backend), and the Π₂ it returns is
an ordinary port :class:`~repro_torch.core.program.Program`, planned and
run on the card like any other.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np

from repro_torch.core import invariants as inv_mod
from repro_torch.core import ir, synthesis, verify
from repro_torch.core.ir import C, RelAtom, Term
from repro_torch.core.program import Program, Rule, Stratum


@dataclasses.dataclass
class OptimizationReport:
    ok: bool
    method: str | None                 # 'rule' | 'cegis'
    h_body: ir.SSP | None
    program: Program | None            # Π₂
    invariants: list
    stats: dict


# --------------------------------------------------------------------------
# Sub-multiset pattern matching (shared by denormalization + inv rewrites)
# --------------------------------------------------------------------------


def _unify_args(p_args, t_args, sigma, pattern_bound):
    """Extend sigma mapping pattern args -> term args; None on clash."""
    sigma = dict(sigma)
    for pa, ta in zip(p_args, t_args):
        if isinstance(pa, C):
            if not (isinstance(ta, C) and ta.value == pa.value):
                return None
        else:
            if pa in sigma:
                if sigma[pa] != ta:
                    return None
            else:
                sigma[pa] = ta
    return sigma


def _atoms_match(pa, ta) -> bool:
    if type(pa) is not type(ta):
        return False
    if isinstance(pa, RelAtom):
        return (pa.name == ta.name and pa.cast == ta.cast and pa.neg == ta.neg)
    if isinstance(pa, ir.PredAtom):
        return pa.pred == ta.pred
    if isinstance(pa, ir.ValAtom):
        return True
    if isinstance(pa, ir.ConstAtom):
        return pa.value == ta.value
    return False


def match_pattern(pattern_atoms, pattern_bound, term: Term):
    """Yield (sigma, used_indices) for injective sub-multiset matches of the
    pattern into ``term``.  Pattern-bound vars must map (injectively) onto
    term-bound vars that occur *only* inside the matched atoms."""
    t_atoms = list(term.atoms)

    def rec(pi, sigma, used):
        if pi == len(pattern_atoms):
            # bound-var containment checks
            img = {}
            for pv in pattern_bound:
                if pv in sigma:
                    tv = sigma[pv]
                    if isinstance(tv, C) or tv not in term.bound:
                        return
                    img[pv] = tv
            if len(set(img.values())) != len(img):
                return
            outside = set()
            for k, a in enumerate(t_atoms):
                if k not in used:
                    outside.update(ir.atom_vars(a))
            if any(tv in outside for tv in img.values()):
                return
            yield dict(sigma), frozenset(used)
            return
        pa = pattern_atoms[pi]
        p_args = (pa.args if hasattr(pa, "args")
                  else ((pa.var,) if isinstance(pa, ir.ValAtom) else ()))
        for k, ta in enumerate(t_atoms):
            if k in used or not _atoms_match(pa, ta):
                continue
            t_args = (ta.args if hasattr(ta, "args")
                      else ((ta.var,) if isinstance(ta, ir.ValAtom) else ()))
            s2 = _unify_args(p_args, t_args, sigma, pattern_bound)
            if s2 is not None:
                yield from rec(pi + 1, s2, used | {k})

    yield from rec(0, {}, set())


def rewrite_with_invariant(term: Term, inv, sr_name: str):
    """Apply L→R (and R→L) of an invariant to ``term``; yields new terms."""
    for lhs, rhs in ((inv.lhs, inv.rhs), (inv.rhs, inv.lhs)):
        for sigma, used in match_pattern(lhs.atoms, lhs.bound, term):
            remaining = tuple(a for k, a in enumerate(term.atoms)
                              if k not in used)
            consumed = {sigma[v] for v in lhs.bound if v in sigma}
            # fresh names for rhs bound vars
            sub = dict(sigma)
            new_bound = []
            for bv in rhs.bound:
                if bv not in sub:
                    fv = ir.fresh_var(bv)
                    sub[bv] = fv
                    new_bound.append(fv)
            new_atoms = tuple(a.rename(sub) for a in rhs.atoms)
            bound = tuple(b for b in term.bound if b not in consumed) \
                + tuple(new_bound)
            nt = ir.normalize_term(Term(remaining + new_atoms, bound), sr_name)
            if nt is not None:
                yield nt


# --------------------------------------------------------------------------
# Rule-based synthesis: denormalization via view matching (Sec. 6.1)
# --------------------------------------------------------------------------


def _term_variants(term: Term, invs, sr_name: str, depth: int = 2):
    seen = {ir.canonical_term(term, ()): term}
    frontier = [term]
    for _ in range(depth):
        nxt = []
        for t in frontier:
            for inv in invs:
                for nt in rewrite_with_invariant(t, inv, sr_name):
                    k = ir.canonical_term(nt, ())
                    if k not in seen:
                        seen[k] = nt
                        nxt.append(nt)
        frontier = nxt
        if not frontier:
            break
    return list(seen.values())


def rule_based_synthesis(task: verify.FGHTask, invs,
                         ) -> tuple[ir.SSP | None, dict]:
    t0 = time.perf_counter()
    stats = {"variants_explored": 0}
    if len(task.outputs) != 1:
        return None, {**stats, "why": "chained G", "time_s": 0.0}
    g = task.outputs[0].body
    if len(g.terms) != 1:
        return None, {**stats, "why": "multi-term G", "time_s": 0.0}
    defs = {n: r.body for n, r in task.stratum.rules.items()}
    try:
        p1 = ir.substitute_defs(g, defs)
    except ir.NonIdempotentCast:
        return None, {**stats, "why": "non-idempotent cast",
                      "time_s": time.perf_counter() - t0}

    g_term = g.terms[0]
    idbs = set(task.stratum.rules)
    y = task.y_name

    def has_x(t: Term) -> bool:
        return any(isinstance(a, RelAtom) and a.name in idbs for a in t.atoms)

    h_terms = []
    for t in p1.terms:
        if not has_x(t):
            h_terms.append(t)
            continue
        matched = None
        variants = _term_variants(t, invs, p1.semiring)
        stats["variants_explored"] += len(variants)
        for tv in variants:
            for sigma, used in match_pattern(g_term.atoms, g_term.bound, tv):
                rest = tuple(a for k, a in enumerate(tv.atoms) if k not in used)
                if any(isinstance(a, RelAtom) and a.name in idbs for a in rest):
                    continue  # leftover X outside the view: not total
                consumed = {sigma[v] for v in g_term.bound if v in sigma}
                y_args = tuple(sigma.get(hv, hv) for hv in g.head)
                bound = tuple(b for b in tv.bound if b not in consumed)
                matched = Term((RelAtom(y, y_args),) + rest, bound)
                break
            if matched is not None:
                break
        if matched is None:
            return None, {**stats, "why": f"unmatched term: {ir.term_str(t)}",
                          "time_s": time.perf_counter() - t0}
        h_terms.append(matched)

    h = ir.normalize(ir.SSP(g.head, tuple(h_terms), g.semiring))
    stats["time_s"] = time.perf_counter() - t0
    return h, stats


# --------------------------------------------------------------------------
# Π₂ assembly + the full optimizer
# --------------------------------------------------------------------------


def make_gh_program(task: verify.FGHTask, h_body: ir.SSP,
                    post=None) -> Program:
    y = task.y_name
    idbs = set(task.stratum.rules)
    init = None
    if len(task.outputs) == 1:
        g = task.outputs[0].body
        init_terms = tuple(
            t for t in g.terms
            if not any(isinstance(a, RelAtom) and a.name in idbs
                       for a in t.atoms))
        if init_terms:
            init = {y: ir.SSP(g.head, init_terms, g.semiring)}
    stratum = Stratum({y: Rule(y, h_body)}, init=init)
    out = Rule(f"{y}__ans", ir.SSP(
        h_body.head, (Term((RelAtom(y, h_body.head),), ()),),
        h_body.semiring))
    hints = dict(task.sort_hints)
    hints.update(zip(h_body.head, task.schema[y].sorts))
    return Program(f"{task.name}_fgh", task.schema, [stratum], [out],
                   post=post, sort_hints=hints)


def optimize(task: verify.FGHTask, *, rng: np.random.Generator | None = None,
             infer_invs: bool = True, cegis_kwargs: dict | None = None,
             post=None) -> OptimizationReport:
    rng = rng or np.random.default_rng(0)
    t_start = time.perf_counter()
    invs: list = []
    inv_stats: dict = {"time_s": 0.0, "candidates": 0}
    if infer_invs:
        invs, inv_stats = inv_mod.infer_invariants(task, rng=rng)

    stats: dict = {"invariant_inference": inv_stats}

    h, rb_stats = rule_based_synthesis(task, invs)
    stats["rule_based"] = rb_stats
    method = None
    if h is not None:
        res = verify.verify_h(task, h, rng=rng)
        if res.ok:
            method = "rule"
        else:
            stats["rule_based"]["why"] = "verification failed"
            h = None
    if h is None:
        cres = synthesis.synthesize(task, rng=rng, **(cegis_kwargs or {}))
        stats["cegis"] = cres.stats
        if cres.ok:
            h, method = cres.h_body, "cegis"

    if h is None:
        stats["total_time_s"] = time.perf_counter() - t_start
        return OptimizationReport(False, None, None, None, invs, stats)

    prog = make_gh_program(task, h, post=post)
    stats["total_time_s"] = time.perf_counter() - t_start
    return OptimizationReport(True, method, h, prog, invs, stats)
