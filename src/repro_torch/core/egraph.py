"""Equality saturation (paper Sec. 7): a compact egg-style e-graph.

The counterpart of ``repro/core/egraph.py``, pure Python and the same
logic, so saturation, extraction and maintenance-rule normal forms
agree between the packages.

E-nodes are (op, child-eclass-ids) with leaves (vars/consts/symbols);
e-classes live in a union-find with hashcons-based congruence closure.
Rewrite rules are pattern pairs; saturation applies all matches until a
fixpoint or a node budget.  Used for the paper's three EQSAT roles:

* **equivalence under constraints** — a constraint Δ ⇒ Θ is inserted as
  the equation Δ∧Θ = Δ (Sec. 7), then equivalence is an e-class check;
* **denormalization** (query rewriting using views, Sec. 6.1) — insert the
  normalized body and the view V = G(X), merge V's e-class with a fresh
  symbol Y, extract the smallest expression containing no X;
* **invariant mining support** — identities over symbolic iterates.

Terms here are generic s-expressions ``("op", child, child, ...)`` with
string leaves; the Datalog°-specific bridge lives in the callers (the SSP
IR canonicalizes AC operators itself, so the e-graph handles the
*structural* rules: distributivity, factoring, cast algebra, constraint
equations).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable

Term = "tuple | str"


@dataclasses.dataclass(frozen=True)
class ENode:
    op: str
    children: tuple[int, ...]


class EGraph:
    def __init__(self):
        self.parent: list[int] = []
        self.classes: dict[int, set[ENode]] = {}
        self.hashcons: dict[ENode, int] = {}
        self.worklist: list[int] = []

    # -- union-find --------------------------------------------------------
    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def _new_class(self, node: ENode) -> int:
        cid = len(self.parent)
        self.parent.append(cid)
        self.classes[cid] = {node}
        self.hashcons[node] = cid
        return cid

    def canonicalize(self, node: ENode) -> ENode:
        return ENode(node.op, tuple(self.find(c) for c in node.children))

    def add_node(self, node: ENode) -> int:
        node = self.canonicalize(node)
        if node in self.hashcons:
            return self.find(self.hashcons[node])
        return self._new_class(node)

    def add_term(self, t: Term) -> int:
        if isinstance(t, str):
            return self.add_node(ENode(t, ()))
        op, *children = t
        return self.add_node(ENode(op, tuple(self.add_term(c)
                                             for c in children)))

    def merge(self, a: int, b: int) -> int:
        a, b = self.find(a), self.find(b)
        if a == b:
            return a
        if len(self.classes[a]) < len(self.classes[b]):
            a, b = b, a
        self.parent[b] = a
        self.classes[a] |= self.classes.pop(b)
        self.worklist.append(a)
        return a

    def rebuild(self):
        """Restore congruence closure after merges."""
        while self.worklist:
            todo, self.worklist = self.worklist, []
            seen: dict[ENode, int] = {}
            for cid in list(self.classes):
                if cid not in self.classes:
                    continue
                for node in list(self.classes[cid]):
                    if cid not in self.classes:
                        break  # a merge below absorbed cid into another class
                    canon = self.canonicalize(node)
                    self.classes[cid].discard(node)
                    self.classes[cid].add(canon)
                    self.hashcons[canon] = cid
                    if canon in seen and self.find(seen[canon]) != \
                            self.find(cid):
                        self.merge(seen[canon], cid)
                    seen[canon] = self.find(cid)
            del todo

    def eq(self, a: int, b: int) -> bool:
        return self.find(a) == self.find(b)

    # -- e-matching ----------------------------------------------------------
    def ematch(self, pattern: Term) -> Iterable[tuple[int, dict]]:
        """Yield (eclass, substitution) for every match of ``pattern``.
        Pattern variables are strings starting with '?'."""
        for cid in list(self.classes):
            yield from ((cid, s) for s in self._match_class(pattern, cid, {}))

    def _match_class(self, pattern, cid, subst):
        cid = self.find(cid)
        if isinstance(pattern, str):
            if pattern.startswith("?"):
                if pattern in subst:
                    if self.find(subst[pattern]) == cid:
                        yield subst
                    return
                s2 = dict(subst)
                s2[pattern] = cid
                yield s2
                return
            if ENode(pattern, ()) in self.hashcons and \
                    self.find(self.hashcons[ENode(pattern, ())]) == cid:
                yield subst
            return
        op, *children = pattern
        for node in list(self.classes.get(cid, ())):
            if node.op != op or len(node.children) != len(children):
                continue
            substs = [subst]
            for pat_c, node_c in zip(children, node.children):
                substs = [s2 for s in substs
                          for s2 in self._match_class(pat_c, node_c, s)]
                if not substs:
                    break
            yield from substs

    def instantiate(self, pattern: Term, subst: dict) -> int:
        if isinstance(pattern, str):
            if pattern.startswith("?"):
                return subst[pattern]
            return self.add_node(ENode(pattern, ()))
        op, *children = pattern
        return self.add_node(ENode(op, tuple(
            self.instantiate(c, subst) for c in children)))

    # -- saturation -----------------------------------------------------------
    def run_rules(self, rules: list[tuple[Term, Term]], *, iters: int = 8,
                  node_limit: int = 20_000) -> int:
        applied = 0
        for _ in range(iters):
            matches = []
            for lhs, rhs in rules:
                for cid, subst in self.ematch(lhs):
                    matches.append((cid, rhs, subst))
            changed = False
            for cid, rhs, subst in matches:
                new_id = self.instantiate(rhs, subst)
                if self.find(new_id) != self.find(cid):
                    self.merge(cid, new_id)
                    changed = True
                    applied += 1
            self.rebuild()
            if not changed or len(self.parent) > node_limit:
                break
        return applied

    # -- extraction -----------------------------------------------------------
    def extract(self, cid: int, *, forbid_ops: set[str] = frozenset(),
                max_iters: int = 50) -> Term | None:
        """Smallest term for e-class ``cid`` avoiding ``forbid_ops``."""
        INF = float("inf")
        cost: dict[int, float] = {}
        best: dict[int, ENode] = {}
        for _ in range(max_iters):
            changed = False
            for c, nodes in self.classes.items():
                for n in nodes:
                    if n.op in forbid_ops:
                        continue
                    child_cost = 0.0
                    ok = True
                    for ch in n.children:
                        ch = self.find(ch)
                        if ch not in cost:
                            ok = False
                            break
                        child_cost += cost[ch]
                    if not ok:
                        continue
                    total = 1.0 + child_cost
                    c_root = self.find(c)
                    if total < cost.get(c_root, INF):
                        cost[c_root] = total
                        best[c_root] = n
                        changed = True
            if not changed:
                break
        root = self.find(cid)
        if root not in best:
            return None

        def build(c: int) -> Term:
            n = best[self.find(c)]
            if not n.children:
                return n.op
            return (n.op,) + tuple(build(ch) for ch in n.children)

        return build(root)


# -- convenience -------------------------------------------------------------


def equivalent_under(rules: list[tuple[Term, Term]], a: Term, b: Term,
                     constraints: list[tuple[Term, Term]] = (),
                     iters: int = 8) -> bool:
    """Check a ≡ b under rewrite rules + constraint equations (Δ∧Θ = Δ)."""
    g = EGraph()
    ia, ib = g.add_term(a), g.add_term(b)
    for lhs, rhs in constraints:
        g.merge(g.add_term(lhs), g.add_term(rhs))
    g.rebuild()
    g.run_rules(list(rules), iters=iters)
    return g.eq(ia, ib)


#: structural semiring rules (AC is canonicalized by the SSP IR; these are
#: the directional rules the paper's Sec. 5.1/7 uses the e-graph for)
SEMIRING_RULES: list[tuple[Term, Term]] = [
    (("mul", "?a", ("add", "?b", "?c")),
     ("add", ("mul", "?a", "?b"), ("mul", "?a", "?c"))),   # distribute
    (("add", ("mul", "?a", "?b"), ("mul", "?a", "?c")),
     ("mul", "?a", ("add", "?b", "?c"))),                   # factor
    (("mul", "?a", "one"), "?a"),
    (("mul", "?a", "zero"), "zero"),
    (("add", "?a", "zero"), "?a"),
    (("mul", "?a", "?b"), ("mul", "?b", "?a")),
    (("add", "?a", "?b"), ("add", "?b", "?a")),
    (("mul", ("mul", "?a", "?b"), "?c"), ("mul", "?a", ("mul", "?b", "?c"))),
    (("add", ("add", "?a", "?b"), "?c"), ("add", "?a", ("add", "?b", "?c"))),
    # cast algebra: [P]⊗[P] = [P]
    (("mul", ("cast", "?p"), ("cast", "?p")), ("cast", "?p")),
]


#: structural rules over maintenance-rule terms (DESIGN.md §11).  A
#: candidate is an s-expression ``("recount", cone(seed("delta")))``;
#: these rewrites canonicalize it — closure operators are idempotent,
#: the forward closure absorbs the tight closure it contains, a
#: seed-only "cone" is the identity on its seed set, and the full cone
#: is the whole vertex universe no matter what seeded it, at which point
#: the recount *is* a cold fixpoint.  The synthesizer uses the last fact
#: to reject the degenerate candidate by proof instead of by pricing.
MAINTENANCE_RULES: list[tuple[Term, Term]] = [
    (("cone_tight", ("cone_tight", "?x")), ("cone_tight", "?x")),
    (("cone_forward", ("cone_forward", "?x")), ("cone_forward", "?x")),
    (("cone_forward", ("cone_tight", "?x")), ("cone_forward", "?x")),
    (("cone_one_hop", ("cone_seeds", "?x")), ("cone_one_hop", "?x")),
    (("cone_seeds", "?x"), "?x"),
    (("cone_all", "?x"), "univ"),
    (("cone_tight", "univ"), "univ"),
    (("cone_forward", "univ"), "univ"),
    (("recount", "univ"), "cold_fixpoint"),
]


def normalize(term: Term, rules: list[tuple[Term, Term]] | None = None,
              *, iters: int = 8) -> Term:
    """Saturate ``term`` under ``rules`` (default
    :data:`MAINTENANCE_RULES`) and extract the smallest equivalent —
    the canonical form cached and surfaced by ``explain()``."""
    g = EGraph()
    cid = g.add_term(term)
    g.run_rules(list(rules if rules is not None else MAINTENANCE_RULES),
                iters=iters)
    out = g.extract(cid)
    return term if out is None else out
