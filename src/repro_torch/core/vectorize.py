"""Lower FGH-optimized Π₂ programs to vector fixpoint equations.

The FGH rewrite turns all-pairs programs (BM/CC/SSSP/MLM, paper Sec. 3.1)
into *vector-shaped* GH-programs: a single linear stratum over a unary IDB
``x`` whose merged rule splits as

    x[y]  =  init[y]  ⊕  ⊕_z x[z] ⊗ E[z, y]

with ``init`` the non-recursive terms (they carry the query source
constant) and ``E`` the source-*independent* linear operator.  This module
performs that split symbolically so the serve loop (DESIGN.md §3) can

* reuse one compiled batched fixpoint and one edge operator across every
  source that shares the linear part (``VectorForm.signature`` is the
  compile-cache key component), and
* evaluate only the cheap O(n) ``init`` per request.

``edge_operator`` keeps a sparse EDB sparse (the COO relation feeds the
SpMM batched runner directly); anything more exotic — multiple linear
terms, interpreted predicates in the remainder — falls back to a dense
``engine.eval_ssp`` materialization of E.

The split is consumed by the cost-based planner (DESIGN.md §4): the
vector runners of :mod:`repro.core.planner` and the serve loop's batched
fixpoints are all built from a :class:`VectorForm`.

The counterpart of ``repro/core/vectorize.py``; ``VectorForm.signature``
hashes the IR exactly as the reference does, so both packages key the
same operator identically.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from repro_torch.core import engine, ir
from repro_torch.core import semiring as sr_mod
from repro_torch.core.program import Program
from repro_torch.sparse.coo import SparseRelation

#: canonical name of the contracted (source-side) variable in ``edge``
Z = "__z"


@dataclasses.dataclass(frozen=True)
class VectorForm:
    """The split ``x = init ⊕ x ⊗ E`` of a vector-shaped Π₂ program."""

    idb: str
    semiring: str
    out_sort: str
    init: ir.SSP       # head (y,), no IDB atoms; carries source constants
    edge: ir.SSP       # head (Z, y): E[z, y] as an SSP over EDBs only
    signature: str     # stable source-independent hash of (edge, semiring)


def vector_form(prog: Program) -> VectorForm:
    """Split a Π₂ :class:`Program` into :class:`VectorForm`.

    Raises ``ValueError`` when the program is not vector-shaped (more than
    one stratum/rule, non-unary IDB, non-linear recursion, or a negated /
    cast recursive atom).
    """
    if len(prog.strata) != 1:
        raise ValueError(f"{prog.name}: need exactly one stratum, "
                         f"got {len(prog.strata)}")
    if prog.post is not None:
        raise ValueError(f"{prog.name}: host post-epilogues are not part "
                         f"of the vector equation — the fixpoint x* would "
                         f"be served unpostprocessed")
    stratum = prog.strata[0]
    if len(stratum.rules) != 1:
        raise ValueError(f"{prog.name}: need a single recursive IDB, "
                         f"got {tuple(stratum.rules)}")
    (idb,) = stratum.rules
    _check_identity_outputs(prog, idb)
    rule = stratum.rules[idb]
    body = rule.body
    if len(body.head) != 1:
        raise ValueError(f"{idb}: vector equations need a unary IDB head, "
                         f"got arity {len(body.head)}")
    (yvar,) = body.head
    sorts = prog.schema[idb].sorts
    if len(sorts) != 1:
        raise ValueError(f"{idb}: schema arity {len(sorts)} != 1")

    init_terms: list[ir.Term] = []
    edge_terms: list[ir.Term] = []
    for t in body.terms:
        rec = [a for a in t.atoms
               if isinstance(a, ir.RelAtom) and a.name == idb]
        if not rec:
            init_terms.append(t)
            continue
        if len(rec) > 1:
            raise ValueError(f"{idb}: non-linear term {ir.term_str(t)}")
        (a,) = rec
        if a.neg or a.cast:
            raise ValueError(f"{idb}: recursive atom must be plain, "
                             f"got {a}")
        if len(a.args) != 1 or isinstance(a.args[0], ir.C):
            raise ValueError(f"{idb}: recursive atom must bind one "
                             f"variable, got {a}")
        z = a.args[0]
        # The engine contracts every non-head variable, whether or not it
        # is annotated in ``t.bound`` (synthesized terms often carry an
        # empty annotation) — so "summed out" means "not the head var".
        if z == yvar:
            raise ValueError(f"{idb}: recursive variable {z} must be "
                             f"summed out in {ir.term_str(t)}")
        if Z in t.vars():
            raise ValueError(f"reserved variable {Z} already in use")
        rest = tuple(x for x in t.atoms if x is not a)
        renamed = tuple(x.rename({z: Z}) for x in rest)
        bound = tuple(v for v in t.bound if v != z)
        edge_terms.append(ir.Term(renamed, bound))

    if not edge_terms:
        raise ValueError(f"{idb}: no recursive term — nothing to iterate")

    # Y₀ terms from the GH-program's stratum init (make_gh_program) are
    # usually the same non-recursive terms again; ⊕ them in, deduplicating
    # so non-idempotent semirings don't double-count.
    if stratum.init and idb in stratum.init:
        seen = {ir.canonical_term(t, body.head) for t in init_terms}
        for t in stratum.init[idb].rename_head(body.head).terms:
            if ir.canonical_term(t, body.head) not in seen:
                init_terms.append(t)

    init = ir.SSP((yvar,), tuple(init_terms), body.semiring)
    edge = ir.SSP((Z, yvar), tuple(edge_terms), body.semiring)
    signature = _signature(edge, yvar, body.semiring, sorts[0])
    return VectorForm(idb, body.semiring, sorts[0], init, edge, signature)


def _check_identity_outputs(prog: Program, idb: str) -> None:
    """The served answer is the fixpoint x* itself, so the program's
    output chain must be a pure renaming chain ``ans(y) := x(y)`` —
    anything else (a join, a cast, a projection) would make the serve
    loop's answer diverge from ``run_program``."""
    prev = idb
    for r in prog.outputs:
        b = r.body
        atom = b.terms[0].atoms[0] if (
            len(b.terms) == 1 and len(b.terms[0].atoms) == 1) else None
        if not (isinstance(atom, ir.RelAtom) and atom.name == prev
                and not atom.neg and not atom.cast
                and tuple(atom.args) == tuple(b.head)
                and b.semiring == prog.schema[prev].semiring):
            raise ValueError(
                f"{prog.name}: output rule {r.head} is not the identity "
                f"on {prev} — the batched runner serves x* directly")
        prev = r.head


def _signature(edge: ir.SSP, yvar: str, semiring: str, sort: str) -> str:
    """Variable-renaming-invariant hash of the linear operator.

    Synthesized terms carry empty ``bound`` annotations and fresh-counter
    variable names that drift between fgh runs, and ``ir.canonical_term``
    canonicalizes only annotated bound vars — so every non-head variable
    is re-annotated as bound (making the canonical key permutation-
    invariant) and the head is renamed to fixed markers first.
    """
    head = (Z, "__y")
    keys = []
    for t in edge.terms:
        t2 = t.rename({yvar: "__y"})
        extra = tuple(sorted(v for v in t2.vars() if v not in head))
        keys.append(ir.canonical_term(ir.Term(t2.atoms, extra), head))
    payload = repr((sorted(keys), semiring, sort))
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def init_vector(vf: VectorForm, db: engine.Database, hints=None):
    """Evaluate the per-source constant term — a dense ``(n,)`` vector."""
    return engine.eval_ssp(vf.init, db, hints)


def edge_atom(vf: VectorForm) -> ir.RelAtom | None:
    """The single plain binary atom behind E's sparse fast path, if the
    linear operator is exactly one relation lookup — the one syntactic
    predicate shared by :func:`edge_operator` and the planner's sparsity
    costing (``repro.core.planner``), so plan and execution can never
    disagree about whether E stays sparse."""
    if len(vf.edge.terms) != 1:
        return None
    t = vf.edge.terms[0]
    if len(t.atoms) != 1 or not isinstance(t.atoms[0], ir.RelAtom):
        return None
    a = t.atoms[0]
    if a.neg or tuple(a.args) not in (vf.edge.head, vf.edge.head[::-1]):
        return None
    return a


def init_reads(vf: VectorForm, name: str) -> bool:
    """Whether the init term references relation ``name``.  A ⊕-merge
    into the linear operator's own relation then *also* changes the init
    vector, so a delta-restart seeded from ``y* ⊗ ΔE`` alone would miss
    the init contribution — the maintenance layers must fall back
    (DESIGN.md §5)."""
    return any(isinstance(a, ir.RelAtom) and a.name == name
               for t in vf.init.terms for a in t.atoms)


def edge_operator(vf: VectorForm, db: engine.Database, hints=None, *,
                  prefer_sparse: bool = True):
    """Materialize E[z, y] — sparse-preserving when the linear remainder
    is a single plain binary EDB atom stored as a SparseRelation.

    Returns either a :class:`~repro_torch.sparse.coo.SparseRelation`
    (values cast into ``vf.semiring``) ready for the SpMM batched runner,
    or a dense ``(n, n)`` S-relation from ``engine.eval_ssp``.
    """
    a = edge_atom(vf) if prefer_sparse else None
    if a is not None:
        arr = db.relations.get(a.name)
        if isinstance(arr, SparseRelation) and arr.arity == 2:
            rel = arr if tuple(a.args) == vf.edge.head \
                else arr.transpose()
            return _sparse_into_semiring(rel, vf.semiring)
    return engine.eval_ssp(vf.edge, db, hints)


def _sparse_into_semiring(rel, target: str):
    """Value-space view of a sparse relation in another semiring —
    the COO analogue of the engine's ``_rel_factor`` cast handling:
    𝔹 sources lift stored tuples to 1̄, float→float views pass finite
    values through (absent tuples are 0̄ in either space).  Stays on the
    relation's device."""
    if rel.semiring == target:
        return rel
    src = sr_mod.get(rel.semiring)
    dst = sr_mod.get(target)
    live = torch.arange(rel.capacity, device=rel.device) < rel.nnz
    if src.name == "bool":
        vals = dst.from_bool(rel.values & live)
    else:
        vals = torch.where(live, rel.values.to(dst.dtype),
                           dst.const(dst.zero, rel.device))
    return SparseRelation(rel.coords, vals, rel.nnz, rel.shape, target)
