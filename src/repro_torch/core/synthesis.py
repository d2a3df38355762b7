"""CEGIS query synthesis: find H with G(F(X)) = H(G(X))  (paper Sec. 6).

Grammar Σ (paper Fig. 8, k_max = 1 — linear programs): candidates are
normalized SSPs ``H = H⁰ ⊕ H¹(Y)`` where H⁰-terms use only EDB atoms and
each H¹-term contains exactly one Y atom.  As in the paper's refinements
(Appendix A) the atom vocabulary is mined from the original program: EDB
atom patterns, interpreted predicates, value atoms and constants appearing
in F and G, instantiated over a typed variable pool (head vars + per-sort
fresh bound vars).

The CEGIS loop (paper Sec. 6.2.1), adapted to the ⊕-of-terms structure:

* generator — enumerate candidate *terms*, keep those *admissible* on all
  counterexamples so far (a term t is admissible iff target ⊕ t = target
  pointwise for idempotent ⊕, iff t ≤ target for (+)-semirings with
  non-negative values: adding terms can then only overshoot);
* search ⊕-combinations of admissible terms (DFS, ≤ max_terms) whose ⊕
  matches the target exactly on every counterexample — term evaluations are
  cached per counterexample so a combination test is a couple of numpy
  reductions;
* verifier — the orbit/bounded-model check (verify.py); failures return a
  fresh counterexample database and the loop repeats.

This mirrors Rosette's generate/verify duel; we replace the SMT-encoded
choice variables with the admissibility filter + cached-evaluation DFS
(DESIGN.md §4), which keeps the explored space in the paper's 10–150 range.

The same sketch/verify/refine shape is reused a second time by
:mod:`repro_torch.incremental.maintenance` (DESIGN.md §11), where the
grammar ranges over ⊖/recount *maintenance* rules instead of query
rewrites and the counterexamples are update probes
(:func:`verify.sample_update_probes`) rather than orbit databases.

The counterpart of ``repro/core/synthesis.py``: the same grammar, pool
order and DFS, evaluated with the engine's np backend on CPU probe
databases, so one seed explores the same candidates as the reference.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Sequence

import numpy as np

from repro_torch.core import ir, verify
from repro_torch.core import semiring as sr_mod
from repro_torch.core.ir import (C, ConstAtom, PredAtom, RelAtom, Term,
                                 ValAtom, canonical_term)


@dataclasses.dataclass
class SynthesisResult:
    ok: bool
    h_body: ir.SSP | None
    stats: dict


# --------------------------------------------------------------------------
# Vocabulary mining (paper Appendix A: types + program subexpressions)
# --------------------------------------------------------------------------


def _program_atoms(task: verify.FGHTask):
    for rule in list(task.stratum.rules.values()) + list(task.outputs):
        for t in rule.body.terms:
            yield from t.atoms


def _collect_consts(task: verify.FGHTask) -> tuple[list[C], list[float]]:
    key_consts: dict[tuple, C] = {}
    val_consts: set[float] = set()
    uses_succ = False
    for a in _program_atoms(task):
        if isinstance(a, (RelAtom, PredAtom)):
            for arg in a.args:
                if isinstance(arg, C):
                    key_consts.setdefault(("c", arg.value), arg)
            if isinstance(a, PredAtom) and a.pred in ("succ", "sum3"):
                uses_succ = True
        elif isinstance(a, ConstAtom):
            val_consts.add(a.value)
    sr = task.y_semiring()
    if uses_succ and sr.name in ("trop", "maxplus"):
        val_consts.add(1.0)  # x = y+1 in a (min/max,+) ring ⇒ the const 1̄⊗1
    return list(key_consts.values()), sorted(val_consts)


def build_term_pool(task: verify.FGHTask, *, max_atoms: int = 3,
                    max_bound: int = 2) -> list[Term]:
    """Instantiate the grammar's sum-product terms (one pool for H⁰ ∪ H¹)."""
    schema = task.schema
    sr = task.y_semiring()
    y = task.y_name
    y_sorts = schema[y].sorts
    head = task.outputs[-1].body.head  # answer head vars

    # typed variable pool: head vars + per-sort bound variables
    var_sort: dict[str, str] = dict(zip(head, y_sorts))
    bound_pool: dict[str, list[str]] = {}
    sorts_in_play = set(y_sorts)
    # H's vocabulary: the EDBs plus the view Y — never the IDBs X (total
    # rewrite) nor G-chain intermediates (they exist only inside G).
    rel_names = {a.name for a in _program_atoms(task) if isinstance(a, RelAtom)}
    rel_names &= set(task.edbs)
    rel_names |= {y}
    for rn in rel_names:
        sorts_in_play.update(schema[rn].sorts)
    for s in sorts_in_play:
        bound_pool[s] = [f"{s}$1", f"{s}$2"][:max_bound]
        for v in bound_pool[s]:
            var_sort[v] = s

    key_consts, val_consts = _collect_consts(task)

    def args_for(sorts: Sequence[str]):
        pools = []
        for s in sorts:
            p = [v for v in head if var_sort[v] == s] + bound_pool.get(s, [])
            p = p + [c for c in key_consts]
            pools.append(p)
        return itertools.product(*pools)

    # key-level arithmetic predicates (sum3/winlt) encode what value atoms
    # already express under (min/max,+)/(+,×) — dropping them from Σ keeps
    # the space in the paper's range without losing the published rewrites.
    preds_used = {a.pred for a in _program_atoms(task)
                  if isinstance(a, PredAtom)} - {"sum3", "winlt"}

    atoms: list = []
    for rn in sorted(rel_names):
        rs = schema[rn]
        need_cast = rs.semiring != sr.name and rs.semiring == "bool"
        for args in args_for(rs.sorts):
            vs_only = [a2 for a2 in args if not isinstance(a2, C)]
            if len(set(vs_only)) != len(vs_only):
                continue  # repeated-variable (diagonal) atoms: not in Σ
            atoms.append(RelAtom(rn, tuple(args), cast=need_cast))
    for pred in sorted(preds_used):
        arity = ir.PREDICATES[pred]
        # predicates on any same-sort variable pairs/triples
        for s in sorted(sorts_in_play):
            vs = [v for v in head if var_sort[v] == s] + bound_pool.get(s, [])
            vs = vs + [c for c in key_consts]
            for args in itertools.product(vs, repeat=arity):
                if all(isinstance(a2, C) for a2 in args):
                    continue
                atoms.append(PredAtom(pred, tuple(args)))
    if sr.name != "bool":
        for v in list(var_sort):
            atoms.append(ValAtom(v))
        for c in val_consts:
            atoms.append(ConstAtom(c))

    # assemble connected terms with ≤ max_atoms atoms and ≤ 1 Y-occurrence
    head_set = set(head)
    pool: dict[tuple, Term] = {}

    def add_term(selected: tuple):
        n_y = sum(1 for a in selected
                  if isinstance(a, RelAtom) and a.name == y)
        if n_y > 1:
            return
        vs: set[str] = set()
        for a in selected:
            vs.update(ir.atom_vars(a))
        bound = tuple(sorted(vs - head_set))
        if len(bound) > max_bound:
            return
        # connectivity: bound vars must link to the head/other atoms
        if len(selected) > 1:
            # every atom shares a variable with some other atom, or uses a
            # head var (keeps products from being arbitrary cartesians)
            for a in selected:
                av = set(ir.atom_vars(a))
                if not av:
                    continue
                if av & head_set:
                    continue
                others = set()
                for b in selected:
                    if b is not a:
                        others.update(ir.atom_vars(b))
                if not av & others:
                    return
        # every bound var must appear in a relational/value atom (safety-ish)
        try:
            t = ir.normalize_term(Term(tuple(selected), bound), sr.name)
        except ValueError:  # dangling bound var under a non-idempotent ⊕
            return
        if t is None:
            return
        key = canonical_term(t, tuple(head))
        pool.setdefault(key, t)

    for k in range(1, max_atoms + 1):
        for combo in itertools.combinations(range(len(atoms)), k):
            add_term(tuple(atoms[i] for i in combo))
    return list(pool.values())


# --------------------------------------------------------------------------
# The CEGIS loop
# --------------------------------------------------------------------------


def _admissible(sr: sr_mod.Semiring, tv: np.ndarray, target: np.ndarray,
                atol: float = 1e-4) -> bool:
    if sr.idempotent:
        joined = np.asarray(sr.add(tv, target))
        return verify.values_equal(joined, target, atol)
    return bool(np.all(tv <= target + atol))


def synthesize(task: verify.FGHTask, *, rng: np.random.Generator | None = None,
               max_terms: int = 3, max_atoms: int = 3,
               max_rounds: int = 12, n_verify_dbs: int = 10,
               require_recursive: bool = True) -> SynthesisResult:
    rng = rng or np.random.default_rng(0)
    t0 = time.perf_counter()
    sr = task.y_semiring()
    head = task.outputs[-1].body.head
    # the answer head vars are sort-hinted so pure-predicate terms evaluate
    # at the right domain shapes
    hints = dict(task.sort_hints)
    hints.update(zip(head, task.schema[task.y_name].sorts))
    task = dataclasses.replace(task, sort_hints=hints)
    pool = build_term_pool(task, max_atoms=max_atoms)

    # initial counterexamples: random orbits (exhaustive tiny instances are
    # left to the verifier — as CEGIS seeds they are too degenerate and
    # collapse the signature space)
    from repro_torch.core import constraints as gamma

    def fresh_ces(n_id: int) -> list[verify.OrbitPoint]:
        doms = dict(task.small_domains)
        doms["id"] = n_id
        if task.sampler is not None:
            db = task.sampler(rng, doms)
        else:
            db = gamma.sample_database(task.schema, task.edbs, doms, rng,
                                       constraint=task.constraint)
        return verify.orbit_points(task, db)[:5]

    ces: list[verify.OrbitPoint] = fresh_ces(3) + fresh_ces(4)

    term_cache: list[dict[int, np.ndarray]] = []  # per-ce: idx -> eval

    def ce_evals(ce_idx: int) -> dict[int, np.ndarray]:
        while len(term_cache) <= ce_idx:
            term_cache.append({})
        return term_cache[ce_idx]

    def eval_term_on(ti: int, ce_idx: int) -> np.ndarray:
        cache = ce_evals(ce_idx)
        if ti not in cache:
            body = ir.SSP(tuple(head), (pool[ti],), sr.name)
            cache[ti] = verify.eval_h(task, body, ces[ce_idx])
        return cache[ti]

    tested = 0
    rounds = 0
    y = task.y_name

    def is_recursive(idxs) -> bool:
        return any(any(isinstance(a, RelAtom) and a.name == y
                       for a in pool[i].atoms) for i in idxs)

    while rounds < max_rounds:
        rounds += 1
        # 1. admissibility filter against all current counterexamples
        admissible = []
        for ti in range(len(pool)):
            ok = True
            for ci in range(len(ces)):
                if not _admissible(sr, eval_term_on(ti, ci), ces[ci].target):
                    ok = False
                    break
            if ok:
                admissible.append(ti)

        # 1b. usefulness: a term that never *attains* the target anywhere
        # (idempotent ⊕) / is identically 0̄ (additive ⊕) cannot matter.
        def useful(ti: int) -> bool:
            for ci in range(len(ces)):
                tv = eval_term_on(ti, ci)
                tgt = ces[ci].target
                if sr.idempotent:
                    hit = (tv == tgt) & (tgt != np.asarray(sr.zero))
                    if tgt.dtype == bool:
                        hit = tv & tgt
                    if np.any(hit):
                        return True
                elif np.any(tv != np.asarray(sr.zero)):
                    return True
            return False

        admissible = [ti for ti in admissible if useful(ti)]

        # 1c. dedup by evaluation signature across counterexamples — terms
        # indistinguishable on every counterexample collapse to the
        # syntactically smallest representative (Rosette's symbolic choice
        # variables play this role in the paper).
        admissible.sort(key=lambda ti: (len(pool[ti].atoms),
                                        len(pool[ti].bound)))
        sig_seen: dict[bytes, int] = {}
        deduped = []
        for ti in admissible:
            sig = b"".join(np.ascontiguousarray(eval_term_on(ti, ci)).tobytes()
                           for ci in range(len(ces)))
            if sig not in sig_seen:
                sig_seen[sig] = ti
                deduped.append(ti)
        admissible = deduped
        if len(admissible) > 64:
            admissible = admissible[:64]

        # 2. DFS over ⊕-combinations (smallest first)
        candidate = None
        for k in range(1, max_terms + 1):
            for combo in itertools.combinations(admissible, k):
                if require_recursive and not is_recursive(combo):
                    continue
                tested += 1
                ok = True
                for ci in range(len(ces)):
                    acc = None
                    for ti in combo:
                        tv = eval_term_on(ti, ci)
                        acc = tv if acc is None else np.asarray(sr.add(acc, tv))
                    if not verify.values_equal(acc, ces[ci].target):
                        ok = False
                        break
                if ok:
                    candidate = combo
                    break
            if candidate:
                break
        if candidate is None:
            # no exact ⊕-combination on the current counterexample set:
            # richer instances may separate collapsed signatures — widen
            # the set before giving up
            if rounds < max_rounds:
                ces.extend(fresh_ces(3 + rounds % 3))
                continue
            return SynthesisResult(False, None, _stats(t0, pool, tested,
                                                       rounds, len(ces)))

        h_body = ir.normalize(ir.SSP(tuple(head),
                                     tuple(pool[i] for i in candidate),
                                     sr.name))
        res = verify.verify_h(task, h_body, rng=rng, n_dbs=n_verify_dbs)
        if res.ok:
            stats = _stats(t0, pool, tested, rounds, len(ces))
            stats["points_checked"] = res.points_checked
            return SynthesisResult(True, h_body, stats)
        ces.append(res.counterexample)

    return SynthesisResult(False, None, _stats(t0, pool, tested, rounds,
                                               len(ces)))


def _stats(t0, pool, tested, rounds, n_ces) -> dict:
    return {
        "time_s": time.perf_counter() - t0,
        "pool_terms": len(pool),
        "candidates_tested": tested,
        "cegis_rounds": rounds,
        "counterexamples": n_ces,
    }
