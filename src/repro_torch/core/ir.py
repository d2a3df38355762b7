"""Symbolic IR for Datalog° queries: sum-sum-product normal forms.

A query body is a *sum-sum-product* (SSP) expression (paper Eq. (2)):

    Q(x₁..x_k) := T₁ ⊕ T₂ ⊕ ... ⊕ T_q          (q terms)
    T_i        := ⊕_{bound vars} A₁ ⊗ ... ⊗ A_m  (sum-product, Eq. (1))

where each atom A is a (possibly cast) relational atom, an interpreted
predicate ``[p(x,..)]``, a numeric value atom, or a semiring constant.

This module implements the pieces of the paper's Sec. 5.1 rule-based layer:

* substitution of IDB definitions into a query — computing ``G(F(X))``
  symbolically (exact for same-semiring substitution by distributivity, and
  for 𝔹→S casts when S has idempotent ⊕; otherwise raises and the numeric
  CEGIS path takes over, mirroring the paper's Fig. 10 split),
* normalization via the axioms (23)–(25): flattening of ⊕, pushing ⊗ over ⊕,
  and equality-predicate elimination ``⊕_x A(x)⊗[x=y] = A(y)``,
* canonicalization + isomorphism checking of normal forms (the paper's
  "Rule-based Test", Eq. (22)).

Variables are strings; constants in argument positions use :class:`C`.

The port keeps this module as a logic-for-logic copy of
``repro/core/ir.py`` (host-side Python), so IR keys, canonical forms and
``VectorForm.signature`` hashes come out identical in both packages.
Semiring constants fold through the numpy twins.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

from repro_torch.core import semiring as sr_mod

# --------------------------------------------------------------------------
# Arguments, schemas
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, order=True)
class C:
    """A constant in an argument position, e.g. TC(a, y) with a = C(0)."""

    value: int

    def __repr__(self) -> str:
        return f"C({self.value})"


Arg = "str | C"


@dataclasses.dataclass(frozen=True)
class RelSchema:
    """Declared sorts + value semiring of a relation symbol."""

    sorts: tuple[str, ...]
    semiring: str  # value space of the relation


class Schema(dict):
    """name -> RelSchema; shared by EDBs and IDBs."""

    def declare(self, name: str, sorts: Sequence[str], semiring: str) -> None:
        self[name] = RelSchema(tuple(sorts), semiring)

    def arity(self, name: str) -> int:
        return len(self[name].sorts)


# --------------------------------------------------------------------------
# Atoms
# --------------------------------------------------------------------------

# Interpreted predicates are named, closed over constant parameters, and are
# evaluated densely by the engine over index grids (engine.py).  Keeping them
# as (name, params) pairs makes atoms hashable/serializable for e-graphs and
# canonical forms.
PREDICATES = {
    "eq": 2,      # x = y
    "neq": 2,     # x ≠ y
    "lt": 2,      # x < y
    "le": 2,      # x ≤ y
    "sum3": 3,    # x = y + z         (value sorts)
    "succ": 2,    # x = y + 1
    "winlt": 2,   # 1 ≤ x < y       (paper's WS window guard)
}


@dataclasses.dataclass(frozen=True)
class RelAtom:
    """R(args); ``cast`` marks the 𝔹→S cast [R(args)] (paper's [-]₀̄¹̄);
    ``neg`` marks stratified negation [¬R(args)] (legal only on relations
    from earlier strata / EDBs, enforced by the program builder)."""

    name: str
    args: tuple
    cast: bool = False
    neg: bool = False

    def rename(self, sub: Mapping) -> "RelAtom":
        return RelAtom(self.name, _map_args(self.args, sub), self.cast,
                       self.neg)

    def key(self) -> tuple:
        return ("R", self.name, self.cast, self.neg, _arg_keys(self.args))


@dataclasses.dataclass(frozen=True)
class PredAtom:
    """[p(args)] — boolean interpreted predicate cast into the semiring."""

    pred: str
    args: tuple

    def __post_init__(self):
        assert self.pred in PREDICATES, self.pred
        assert len(self.args) == PREDICATES[self.pred], (self.pred, self.args)

    def rename(self, sub: Mapping) -> "PredAtom":
        return PredAtom(self.pred, _map_args(self.args, sub))

    def key(self) -> tuple:
        return ("P", self.pred, _arg_keys(self.args))


@dataclasses.dataclass(frozen=True)
class ValAtom:
    """The numeric value of a key variable, as a semiring element.

    E.g. ``⊕_v v ⊗ [L(x,v)]`` (paper Example 2.1) uses ValAtom("v").
    """

    var: str

    def rename(self, sub: Mapping) -> "ValAtom":
        v = sub.get(self.var, self.var)
        if isinstance(v, C):
            return ConstAtom(float(v.value))  # type: ignore[return-value]
        return ValAtom(v)

    def key(self) -> tuple:
        return ("V", self.var)


@dataclasses.dataclass(frozen=True)
class ConstAtom:
    """A semiring constant, e.g. the 100 in APSP100 (Example 5.1)."""

    value: float

    def rename(self, sub: Mapping) -> "ConstAtom":
        return self

    def key(self) -> tuple:
        return ("C", self.value)


#: Interpreted *value* functions over key variables (paper Appendix A's
#: user-defined helper functions); used e.g. by BC's σ·σ/σ term.
VALUE_FNS = {
    "mulratio": 3,  # (a, b, c) -> a*b / max(c, 1)
    "plus1": 1,     # (a,) -> a + 1
}


@dataclasses.dataclass(frozen=True)
class ValFnAtom:
    """fn(args) as a semiring element (interpreted function atom)."""

    fn: str
    args: tuple

    def __post_init__(self):
        assert self.fn in VALUE_FNS, self.fn
        assert len(self.args) == VALUE_FNS[self.fn]

    def rename(self, sub: Mapping) -> "ValFnAtom":
        return ValFnAtom(self.fn, _map_args(self.args, sub))

    def key(self) -> tuple:
        return ("F", self.fn, _arg_keys(self.args))


Atom = "RelAtom | PredAtom | ValAtom | ConstAtom"


def _map_args(args: tuple, sub: Mapping) -> tuple:
    out = []
    for a in args:
        if isinstance(a, C):
            out.append(a)
        else:
            out.append(sub.get(a, a))
    return tuple(out)


def _arg_keys(args: tuple) -> tuple:
    return tuple(("c", a.value) if isinstance(a, C) else ("v", a) for a in args)


def atom_vars(atom) -> tuple[str, ...]:
    if isinstance(atom, (RelAtom, PredAtom, ValFnAtom)):
        return tuple(a for a in atom.args if not isinstance(a, C))
    if isinstance(atom, ValAtom):
        return (atom.var,)
    return ()


# --------------------------------------------------------------------------
# Terms and SSP expressions
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Term:
    """⊕_{bound} A₁ ⊗ ... ⊗ A_m  (a sum-product, paper Eq. (1))."""

    atoms: tuple
    bound: tuple[str, ...]  # summed-out variables

    def vars(self) -> set[str]:
        vs: set[str] = set()
        for a in self.atoms:
            vs.update(atom_vars(a))
        return vs

    def free_vars(self) -> set[str]:
        return self.vars() - set(self.bound)

    def rename(self, sub: Mapping) -> "Term":
        # bound vars must not be captured: callers rename bound vars fresh
        # *before* applying head substitutions.
        return Term(tuple(a.rename(sub) for a in self.atoms),
                    tuple(sub.get(b, b) for b in self.bound))


@dataclasses.dataclass(frozen=True)
class SSP:
    """A sum-sum-product expression with a distinguished head var tuple."""

    head: tuple[str, ...]
    terms: tuple[Term, ...]
    semiring: str

    def rename_head(self, new_head: Sequence) -> "SSP":
        """Substitute head vars by ``new_head`` args (vars or constants)."""
        assert len(new_head) == len(self.head)
        sub = dict(zip(self.head, new_head))
        out_terms = []
        for t in self.terms:
            t = _freshen_bound(t, avoid=set(map(str, new_head)) | t.free_vars())
            out_terms.append(t.rename(sub))
        new_head_vars = tuple(h for h in new_head if not isinstance(h, C))
        return SSP(tuple(new_head_vars), tuple(out_terms), self.semiring)

    def map_terms(self, fn) -> "SSP":
        return SSP(self.head, tuple(fn(t) for t in self.terms), self.semiring)


_FRESH_COUNTER = itertools.count()


def fresh_var(prefix: str = "z") -> str:
    return f"{prefix}%{next(_FRESH_COUNTER)}"


def _freshen_bound(t: Term, avoid: set[str]) -> Term:
    sub = {}
    for b in t.bound:
        if b in avoid:
            sub[b] = fresh_var(b.split("%")[0])
    if not sub:
        return t
    return t.rename(sub)


# --------------------------------------------------------------------------
# Normalization (axioms (23)-(25) of Sec. 5.1)
# --------------------------------------------------------------------------


def normalize_term(t: Term, sr_name: str) -> Term | None:
    """Equality elimination + constant folding inside one sum-product.

    Returns None if the term is identically 0̄ (e.g. contains [c≠c] or 0̄).
    """
    sr = sr_mod.get(sr_name, lib="np")
    atoms = list(t.atoms)
    bound = list(t.bound)

    changed = True
    while changed:
        changed = False
        for i, a in enumerate(atoms):
            if isinstance(a, PredAtom) and a.pred == "eq":
                x, y = a.args
                if x == y and not isinstance(x, C):
                    atoms.pop(i); changed = True; break
                if isinstance(x, C) and isinstance(y, C):
                    if x.value == y.value:
                        atoms.pop(i)
                    else:
                        return None
                    changed = True; break
                # axiom (25): eliminate a bound variable via [x = y]
                tgt = src = None
                if not isinstance(x, C) and x in bound:
                    src, tgt = x, y
                elif not isinstance(y, C) and y in bound:
                    src, tgt = y, x
                if src is not None:
                    atoms.pop(i)
                    bound.remove(src)
                    sub = {src: tgt}
                    atoms = [a2.rename(sub) for a2 in atoms]
                    changed = True
                    break
            elif isinstance(a, PredAtom) and a.pred == "neq":
                x, y = a.args
                if x == y:
                    return None
                if isinstance(x, C) and isinstance(y, C):
                    if x.value == y.value:
                        return None
                    atoms.pop(i); changed = True; break

    # value-arithmetic folds (exact when ⊗ is numeric +, i.e. Trop/Tropʳ):
    #   ⊕_d val(d)⊗[d = d1+d2]⊗R  =  val(d1)⊗val(d2)⊗R    (single witness)
    #   ⊕_t val(t)⊗[t = s+1]⊗R    =  val(s)⊗1⊗R
    if sr.name in ("trop", "maxplus"):
        changed = True
        while changed:
            changed = False
            for i, a in enumerate(atoms):
                if not (isinstance(a, PredAtom) and a.pred in ("sum3", "succ")):
                    continue
                d = a.args[0]
                if isinstance(d, C) or d not in bound:
                    continue
                occurrences = [j for j, b2 in enumerate(atoms)
                               if j != i and d in atom_vars(b2)]
                if len(occurrences) != 1:
                    continue
                j = occurrences[0]
                if not isinstance(atoms[j], ValAtom):
                    continue
                repl: list = []
                for arg in a.args[1:]:
                    repl.append(ConstAtom(float(arg.value))
                                if isinstance(arg, C) else ValAtom(arg))
                if a.pred == "succ":
                    repl.append(ConstAtom(1.0))
                atoms = [b2 for k2, b2 in enumerate(atoms)
                         if k2 not in (i, j)] + repl
                bound.remove(d)
                changed = True
                break

    # constant folding
    const = sr.one
    kept = []
    for a in atoms:
        if isinstance(a, ConstAtom):
            if a.value == sr.zero:
                return None
            if a.value == sr.one:
                continue
            const = _sr_mul_scalar(sr, const, a.value)
        else:
            kept.append(a)
    if const != sr.one or not kept:
        kept.append(ConstAtom(const))

    # dedup idempotent atoms: predicates & casts are {0̄,1̄}-valued, hence
    # ⊗-idempotent in every semiring; plain relational atoms only in 𝔹.
    seen = set()
    dedup = []
    for a in kept:
        idem = isinstance(a, PredAtom) or (
            isinstance(a, RelAtom) and (a.cast or sr_name == "bool"))
        k = a.key()
        if idem and k in seen:
            continue
        seen.add(k)
        dedup.append(a)

    # drop bound vars that no longer occur (their sum contributes a domain
    # factor only in non-idempotent semirings — keep a guard there).
    used = set()
    for a in dedup:
        used.update(atom_vars(a))
    new_bound = tuple(b for b in bound if b in used)
    if len(new_bound) != len(bound) and not sr.idempotent:
        # ⊕_x 1̄ = |domain| ≠ 1̄ in e.g. ℕ; mark with an explicit free sum.
        # Our programs never produce this; fail loudly rather than silently.
        raise ValueError("dangling bound var in non-idempotent semiring")
    return Term(tuple(dedup), new_bound)


def _sr_mul_scalar(sr, a: float, b: float) -> float:
    import numpy as np
    return float(np.asarray(sr.mul(np.asarray(a, np.float64), np.asarray(b, np.float64))))


def normalize(e: SSP) -> SSP:
    terms = []
    for t in e.terms:
        nt = normalize_term(t, e.semiring)
        if nt is not None:
            terms.append(nt)
    sr = sr_mod.get(e.semiring, lib="np")
    if sr.idempotent:
        # ⊕-dedup of isomorphic terms
        seen = {}
        for t in terms:
            seen.setdefault(canonical_term(t, e.head), t)
        terms = list(seen.values())
    return SSP(e.head, tuple(terms), e.semiring)


# --------------------------------------------------------------------------
# Substitution: computing G(F(X)) symbolically
# --------------------------------------------------------------------------


class NonIdempotentCast(Exception):
    """Raised when a 𝔹-definition is substituted under a non-idempotent ⊕.

    The paper handles those cases (MLM, R) via CEGIS + constraints rather
    than by symbolic normalization; we mirror that split.
    """


def substitute_defs(e: SSP, defs: Mapping[str, SSP]) -> SSP:
    """Replace every atom whose name is in ``defs`` by its definition.

    Exact by distributivity for same-semiring substitution; exact for 𝔹→S
    casts when S.⊕ is idempotent (min/max/∨): [A ∨ B] = [A] ⊕ [B] and
    [∃z A] = ⊕_z [A] hold on {0̄,1̄}-valued casts.
    """
    target = sr_mod.get(e.semiring, lib="np")
    out_terms: list[Term] = []
    for t in e.terms:
        # Substitute each *original* occurrence exactly once: atoms inserted
        # from a definition are frozen (the definition of a recursive IDB
        # mentions the IDB itself — that is the "X" of G(F(X))).
        expansions: list[tuple[tuple, tuple, tuple]] = [
            ((), t.atoms, t.bound)]  # (done_atoms, todo_atoms, bound)
        final: list[Term] = []
        while expansions:
            done, todo, bound = expansions.pop()
            if not todo:
                final.append(Term(done, bound))
                continue
            atom, rest = todo[0], todo[1:]
            if not (isinstance(atom, RelAtom) and atom.name in defs
                    and not atom.neg):
                expansions.append((done + (atom,), rest, bound))
                continue
            body = defs[atom.name]
            is_cast = body.semiring != e.semiring
            if is_cast:
                if not (body.semiring == "bool" and target.idempotent):
                    raise NonIdempotentCast(
                        f"cannot substitute {atom.name}:{body.semiring} "
                        f"under {e.semiring}")
            inst = body.rename_head(list(atom.args))
            avoid = set(bound)
            for a in done + rest:
                avoid.update(atom_vars(a))
            for bt in inst.terms:
                bt = _freshen_bound(bt, avoid=avoid)
                new_atoms = []
                for a in bt.atoms:
                    if is_cast and isinstance(a, RelAtom):
                        a = RelAtom(a.name, a.args, cast=True, neg=a.neg)
                    new_atoms.append(a)
                expansions.append((done + tuple(new_atoms), rest,
                                   bound + bt.bound))
        out_terms.extend(final)
    return normalize(SSP(e.head, tuple(out_terms), e.semiring))


# --------------------------------------------------------------------------
# Canonicalization & isomorphism (the Rule-based Test, Eq. (22))
# --------------------------------------------------------------------------

_MAX_BOUND_PERm = 7


def canonical_term(t: Term, head: tuple[str, ...]) -> tuple:
    """A canonical, bound-variable-renaming-invariant key for a term."""
    bound = [b for b in t.bound if b in t.vars()]
    if len(bound) > _MAX_BOUND_PERm:
        # fall back to a refinement-only key (sound for equality grouping,
        # may distinguish some isomorphic terms — never merges distinct ones)
        sub = {b: f"b{i}" for i, b in enumerate(sorted(bound))}
        return _term_key(t.rename(sub))
    best = None
    for perm in itertools.permutations(range(len(bound))):
        sub = {b: f"b{perm[i]}" for i, b in enumerate(bound)}
        key = _term_key(Term(tuple(a.rename(sub) for a in t.atoms),
                             tuple(sorted(sub.values()))))
        if best is None or key < best:
            best = key
    return best if best is not None else _term_key(t)


def _term_key(t: Term) -> tuple:
    return (tuple(sorted(a.key() for a in t.atoms)), tuple(sorted(t.bound)))


def canonical_ssp(e: SSP) -> tuple:
    e = normalize(e)
    keys = sorted(canonical_term(t, e.head) for t in e.terms)
    return (e.head, tuple(keys), e.semiring)


def isomorphic(a: SSP, b: SSP) -> bool:
    """Sound syntactic equality of normal forms up to bound-var renaming."""
    if a.semiring != b.semiring or len(a.head) != len(b.head):
        return False
    # align head variable names
    sub = dict(zip(b.head, a.head))
    b2 = SSP(a.head, tuple(
        _freshen_bound(t, avoid=set(a.head) | set(b.head)).rename(sub)
        for t in b.terms), b.semiring)
    return canonical_ssp(a) == canonical_ssp(b2)


# --------------------------------------------------------------------------
# Pretty-printing
# --------------------------------------------------------------------------


def atom_str(a) -> str:
    if isinstance(a, RelAtom):
        s = f"{a.name}({', '.join(map(_arg_str, a.args))})"
        return f"[{s}]" if a.cast else s
    if isinstance(a, PredAtom):
        return f"[{a.pred}({', '.join(map(_arg_str, a.args))})]"
    if isinstance(a, ValAtom):
        return f"val({a.var})"
    if isinstance(a, ValFnAtom):
        return f"{a.fn}({', '.join(map(_arg_str, a.args))})"
    return f"{a.value:g}"


def _arg_str(a) -> str:
    return f"'{a.value}'" if isinstance(a, C) else str(a)


def term_str(t: Term) -> str:
    body = " ⊗ ".join(atom_str(a) for a in t.atoms) or "1̄"
    if t.bound:
        return f"⊕_{{{','.join(t.bound)}}} {body}"
    return body


def ssp_str(e: SSP) -> str:
    head = f"({', '.join(e.head)})"
    return f"{head} := " + "  ⊕  ".join(term_str(t) for t in e.terms) + f"   [{e.semiring}]"
