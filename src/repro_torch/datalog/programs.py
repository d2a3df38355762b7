"""The paper's benchmark programs (Fig. 10, Appendix B, Figs. 14–20).

Each benchmark bundles the *original* program Π₁, the *known optimized*
program Π₂ (the paper's published FGH rewrite — used as ground truth for
the synthesizer tests and as the executable optimized form), and a database
builder.  The FGH optimizer (:mod:`repro_torch.core.fgh`) re-derives
Π₂'s recursive rule H from Π₁; running Π₁ against Π₂
measures original-vs-optimized runtime like the paper's Figs. 11–12.

Dense-domain note: programs that key on numeric values (SSSP's D(x,d),
R's TC(x,y,w), WS's W(t,j,w)) materialize the value domain densely — this
faithfully reproduces the asymptotic waste the FGH rewrite removes.

The counterpart of ``repro/datalog/programs.py``: the same IR, so the
same programs (and ``VectorForm`` signatures) in both packages.  Each
``make_db`` takes the database's ``device`` (``cuda`` unless asked
otherwise).  BC's optimized form is no Datalog° program but Brandes'
algorithm over dense f32 products (:func:`bc`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import engine, ir
from repro_torch.core.ir import C, ConstAtom, PredAtom, RelAtom, Term, ValAtom
from repro_torch.core.program import Program, Rule, Stratum
from repro_torch.datalog import datasets


@dataclasses.dataclass
class Bench:
    name: str
    original: Program
    optimized: Program
    make_db: Callable[..., engine.Database]
    constraint: str | None = None      # 'tree' → Γ-constrained verification
    needs_invariant: bool = False      # paper Fig. 10 column
    synthesis: str = "rule"            # 'rule' | 'cegis' (paper Fig. 10)
    optimized_fn: Callable | None = None  # Π₂ as a function of the db (BC)


def _ssp(head, terms, sr):
    return ir.normalize(ir.SSP(tuple(head), tuple(terms), sr))


def _t(atoms, bound=()):
    return Term(tuple(atoms), tuple(bound))


# --------------------------------------------------------------------------
# BM — Beyond Magic (Example 3.8 / Fig. 14): right-recursive reachability
# --------------------------------------------------------------------------


def bm(a: int = 0) -> Bench:
    schema = ir.Schema()
    schema.declare("E", ("id", "id"), "bool")
    schema.declare("V", ("id",), "bool")
    schema.declare("TC", ("id", "id"), "bool")
    schema.declare("Q", ("id",), "bool")

    f_tc = Rule("TC", _ssp(("x", "y"), [
        _t([RelAtom("V", ("x",)), PredAtom("eq", ("x", "y"))]),
        _t([RelAtom("E", ("x", "z")), RelAtom("TC", ("z", "y"))], ["z"]),
    ], "bool"))
    g = Rule("Q", _ssp(("y",), [_t([RelAtom("TC", (C(a), "y"))])], "bool"))
    original = Program("BM", schema, [Stratum({"TC": f_tc})], [g])

    h = Rule("Q", _ssp(("y",), [
        _t([PredAtom("eq", ("y", C(a))), RelAtom("V", (C(a),))]),
        _t([RelAtom("Q", ("z",)), RelAtom("E", ("z", "y"))], ["z"]),
    ], "bool"))
    out = Rule("Qans", _ssp(("y",), [_t([RelAtom("Q", ("y",))])], "bool"))
    optimized = Program("BM_opt", schema, [Stratum({"Q": h})], [out])

    def make_db(g_: datasets.Graph, device=None) -> engine.Database:
        return engine.Database(schema, {"id": g_.n}, {
            "E": g_.adjacency(device=device),
            "V": g_.vertex_set(device=device)}, device)

    return Bench("BM", original, optimized, make_db,
                 needs_invariant=True, synthesis="rule")


# --------------------------------------------------------------------------
# CC — Connected Components (Fig. 1 / Fig. 15)
# --------------------------------------------------------------------------


def cc() -> Bench:
    schema = ir.Schema()
    schema.declare("E", ("id", "id"), "bool")
    schema.declare("V", ("id",), "bool")
    schema.declare("TC", ("id", "id"), "bool")
    schema.declare("CC", ("id",), "trop")

    f_tc = Rule("TC", _ssp(("x", "y"), [
        _t([RelAtom("V", ("x",)), PredAtom("eq", ("x", "y"))]),
        _t([RelAtom("E", ("x", "z")), RelAtom("TC", ("z", "y"))], ["z"]),
    ], "bool"))
    # SCC[x] = min_v { v | TC(x, v) }   (vertex id is its own label)
    g = Rule("CC", _ssp(("x",), [
        _t([ValAtom("v"), RelAtom("TC", ("x", "v"), cast=True)], ["v"]),
    ], "trop"))
    original = Program("CC", schema, [Stratum({"TC": f_tc})], [g])

    h = Rule("CC", _ssp(("x",), [
        _t([ValAtom("x"), RelAtom("V", ("x",), cast=True)]),
        _t([RelAtom("CC", ("y",)), RelAtom("E", ("x", "y"), cast=True)], ["y"]),
    ], "trop"))
    out = Rule("CCans", _ssp(("x",), [_t([RelAtom("CC", ("x",))])], "trop"))
    optimized = Program("CC_opt", schema, [Stratum({"CC": h})], [out])

    def make_db(g_: datasets.Graph, device=None) -> engine.Database:
        return engine.Database(schema, {"id": g_.n}, {
            "E": g_.adjacency(symmetric=True, device=device),
            "V": g_.vertex_set(device=device)}, device)

    return Bench("CC", original, optimized, make_db, synthesis="rule")


# --------------------------------------------------------------------------
# SSSP — Single-Source Shortest Paths (Fig. 16)
# --------------------------------------------------------------------------


def sssp(a: int = 0, wmax: int = 8, dmax: int = 64) -> Bench:
    schema = ir.Schema()
    schema.declare("E3", ("id", "id", "w"), "bool")   # E(y, x, d2)
    schema.declare("D", ("id", "d"), "bool")
    schema.declare("SP", ("id",), "trop")

    f_d = Rule("D", _ssp(("x", "d"), [
        _t([PredAtom("eq", ("x", C(a))), PredAtom("eq", ("d", C(0)))]),
        _t([RelAtom("D", ("y", "d1")), RelAtom("E3", ("y", "x", "d2")),
            PredAtom("sum3", ("d", "d1", "d2"))], ["y", "d1", "d2"]),
    ], "bool"))
    g = Rule("SP", _ssp(("x",), [
        _t([ValAtom("d"), RelAtom("D", ("x", "d"), cast=True)], ["d"]),
    ], "trop"))
    original = Program("SSSP", schema, [Stratum({"D": f_d})], [g])

    h = Rule("SP", _ssp(("x",), [
        _t([PredAtom("eq", ("x", C(a)))]),
        _t([RelAtom("SP", ("y",)), RelAtom("E3", ("y", "x", "d2"), cast=True),
            ValAtom("d2")], ["y", "d2"]),
    ], "trop"))
    out = Rule("SPans", _ssp(("x",), [_t([RelAtom("SP", ("x",))])], "trop"))
    optimized = Program("SSSP_opt", schema, [Stratum({"SP": h})], [out])

    def make_db(g_: datasets.Graph, device=None) -> engine.Database:
        return engine.Database(schema, {"id": g_.n, "w": wmax, "d": dmax}, {
            "E3": g_.weighted_adjacency(wmax, device=device)}, device)

    return Bench("SSSP", original, optimized, make_db, synthesis="rule")


# --------------------------------------------------------------------------
# WS — Window Sum (Fig. 17)
# --------------------------------------------------------------------------


def ws(window: int = 10, vmax: int = 8) -> Bench:
    schema = ir.Schema()
    schema.declare("A2", ("pos", "w"), "bool")      # A(j, w)
    schema.declare("W", ("pos", "pos", "w"), "bool")
    schema.declare("P", ("pos",), "nat")

    f_w = Rule("W", _ssp(("t", "j", "w"), [
        _t([RelAtom("A2", ("j", "w")), PredAtom("eq", ("t", "j"))]),
        _t([PredAtom("succ", ("t", "s")), RelAtom("W", ("s", "j", "w")),
            PredAtom("lt", ("j", "t"))], ["s"]),
    ], "bool"))
    g = Rule("P", _ssp(("t",), [
        _t([ValAtom("w"), RelAtom("W", ("t", "j", "w"), cast=True)],
           ["j", "w"]),
    ], "nat"))

    def post(p, db):  # S[t] = P[t] - P[t-window]
        shifted = torch.cat([torch.zeros(window, dtype=p.dtype,
                                         device=p.device), p[:-window]])
        return p - shifted

    original = Program("WS", schema, [Stratum({"W": f_w})], [g], post=post)

    h = Rule("P", _ssp(("t",), [
        _t([ValAtom("w"), RelAtom("A2", ("t", "w"), cast=True)], ["w"]),
        _t([PredAtom("succ", ("t", "s")), RelAtom("P", ("s",))], ["s"]),
    ], "nat"))
    out = Rule("Pans", _ssp(("t",), [_t([RelAtom("P", ("t",))])], "nat"))
    optimized = Program("WS_opt", schema, [Stratum({"P": h})], [out],
                        post=post)

    def make_db(values: np.ndarray, device=None) -> engine.Database:
        n = len(values)
        a2 = np.zeros((n, vmax), bool)
        a2[np.arange(n), np.minimum(values, vmax - 1)] = True
        return engine.Database(schema, {"pos": n, "w": vmax},
                               {"A2": torch.from_numpy(a2)}, device)

    return Bench("WS", original, optimized, make_db,
                 needs_invariant=True, synthesis="cegis")


# --------------------------------------------------------------------------
# R — Graph Radius (Fig. 19); semantic optimization on trees
# --------------------------------------------------------------------------


def radius(dmax: int = 64) -> Bench:
    schema = ir.Schema()
    schema.declare("E", ("id", "id"), "bool")
    schema.declare("V", ("id",), "bool")
    schema.declare("TC3", ("id", "id", "d"), "bool")
    schema.declare("SP2", ("id", "id"), "trop")
    schema.declare("R", ("id",), "maxplus")

    f_tc = Rule("TC3", _ssp(("x", "y", "w"), [
        _t([RelAtom("V", ("x",)), PredAtom("eq", ("x", "y")),
            PredAtom("eq", ("w", C(0)))]),
        _t([RelAtom("TC3", ("x", "z", "w1")), RelAtom("E", ("z", "y")),
            PredAtom("succ", ("w", "w1"))], ["z", "w1"]),
    ], "bool"))
    g_sp = Rule("SP2", _ssp(("x", "y"), [
        _t([ValAtom("w"), RelAtom("TC3", ("x", "y", "w"), cast=True)], ["w"]),
    ], "trop"))
    g_r = Rule("R", _ssp(("x",), [
        _t([RelAtom("SP2", ("x", "y"), cast=True)], ["y"]),
    ], "maxplus"))
    original = Program("R", schema, [Stratum({"TC3": f_tc})], [g_sp, g_r])

    h = Rule("R", _ssp(("x",), [
        _t([RelAtom("V", ("x",), cast=True)]),
        _t([RelAtom("R", ("y",)), RelAtom("E", ("x", "y"), cast=True),
            ConstAtom(1.0)], ["y"]),
    ], "maxplus"))
    out = Rule("Rans", _ssp(("x",), [_t([RelAtom("R", ("x",))])], "maxplus"))
    optimized = Program("R_opt", schema, [Stratum({"R": h})], [out])

    def make_db(g_: datasets.Graph, device=None) -> engine.Database:
        return engine.Database(schema, {"id": g_.n, "d": dmax}, {
            "E": g_.adjacency(device=device),
            "V": g_.vertex_set(device=device)}, device)

    return Bench("R", original, optimized, make_db,
                 constraint="tree", needs_invariant=True, synthesis="cegis")


# --------------------------------------------------------------------------
# MLM — Multi-Level Marketing (Example 3.9 / Fig. 20); trees
# --------------------------------------------------------------------------


def mlm() -> Bench:
    schema = ir.Schema()
    schema.declare("E", ("id", "id"), "bool")
    schema.declare("V", ("id",), "bool")
    schema.declare("TC", ("id", "id"), "bool")
    schema.declare("M", ("id",), "nat")

    f_tc = Rule("TC", _ssp(("x", "y"), [
        _t([RelAtom("V", ("x",)), PredAtom("eq", ("x", "y"))]),
        _t([RelAtom("TC", ("x", "z")), RelAtom("E", ("z", "y"))], ["z"]),
    ], "bool"))
    g = Rule("M", _ssp(("x",), [
        _t([ValAtom("v"), RelAtom("TC", ("x", "v"), cast=True)], ["v"]),
    ], "nat"))
    original = Program("MLM", schema, [Stratum({"TC": f_tc})], [g])

    h = Rule("M", _ssp(("x",), [
        _t([ValAtom("x"), RelAtom("V", ("x",), cast=True)]),
        _t([RelAtom("M", ("z",)), RelAtom("E", ("x", "z"), cast=True)], ["z"]),
    ], "nat"))
    out = Rule("Mans", _ssp(("x",), [_t([RelAtom("M", ("x",))])], "nat"))
    optimized = Program("MLM_opt", schema, [Stratum({"M": h})], [out])

    def make_db(g_: datasets.Graph, device=None) -> engine.Database:
        return engine.Database(schema, {"id": g_.n}, {
            "E": g_.adjacency(device=device),
            "V": g_.vertex_set(device=device)}, device)

    return Bench("MLM", original, optimized, make_db,
                 constraint="tree", needs_invariant=True, synthesis="cegis")


# --------------------------------------------------------------------------
# APSP100 — Example 5.1 (verifier showcase: factorized constant)
# --------------------------------------------------------------------------


def apsp100(cap: float = 100.0) -> Bench:
    schema = ir.Schema()
    schema.declare("Ew", ("id", "id"), "trop")
    schema.declare("Dap", ("id", "id"), "trop")
    schema.declare("Qap", ("id", "id"), "trop")

    f_d = Rule("Dap", _ssp(("x", "y"), [
        _t([PredAtom("eq", ("x", "y"))]),
        _t([RelAtom("Dap", ("x", "z")), RelAtom("Ew", ("z", "y")),
            PredAtom("neq", ("x", "y"))], ["z"]),
    ], "trop"))
    g = Rule("Qap", _ssp(("x", "y"), [
        _t([RelAtom("Dap", ("x", "y"))]),
        _t([ConstAtom(cap)]),
    ], "trop"))
    original = Program("APSP100", schema, [Stratum({"Dap": f_d})], [g])

    h = Rule("Qap", _ssp(("x", "y"), [
        _t([PredAtom("eq", ("x", "y"))]),
        _t([RelAtom("Qap", ("x", "z")), RelAtom("Ew", ("z", "y")),
            PredAtom("neq", ("x", "y"))], ["z"]),
        _t([ConstAtom(cap)]),
    ], "trop"))
    out = Rule("Qans", _ssp(("x", "y"),
                            [_t([RelAtom("Qap", ("x", "y"))])], "trop"))
    optimized = Program("APSP100_opt", schema, [Stratum({"Qap": h})], [out])

    def make_db(g_: datasets.Graph, wmax: int = 8,
                device=None) -> engine.Database:
        rng = np.random.default_rng(7)
        w = np.full((g_.n, g_.n), np.inf, np.float32)
        costs = (g_.weights if g_.weights is not None
                 else rng.integers(1, wmax, len(g_.edges)))
        w[g_.edges[:, 0], g_.edges[:, 1]] = costs
        return engine.Database(schema, {"id": g_.n}, {
            "Ew": torch.from_numpy(w)}, device)

    return Bench("APSP100", original, optimized, make_db, synthesis="cegis")


ALL = {b.__name__: b for b in (bm, cc, sssp, ws, radius, mlm, apsp100)}


# --------------------------------------------------------------------------
# BC — Betweenness Centrality (Fig. 18); FGH-optimizes to Brandes
# --------------------------------------------------------------------------

#: BC's post batches the vertices v so that one block's (v, s, t)
#: temporaries hold at most this many entries
BC_BLOCK_ENTRIES = 1 << 26


@contextlib.contextmanager
def _f32_products():
    """f32 products without TF32 whatever the global flag says: Brandes'
    path counts are integers carried in f32 and must stay exact."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def bc_brandes(db: engine.Database) -> torch.Tensor:
    """Brandes' algorithm, level-synchronous and dense (all sources at
    once): the forward pass moves the frontier one level a round (reach
    ``fr @ E``, path counts ``where(fr, σ, 0) @ E``); the backward pass
    accumulates δ(s, v) = Σ_w σ_sv/σ_sw (1 + δ(s, w)) over the
    shortest-path DAG from the deepest level ``lmax`` down to 1.
    Returns B[v] = Σ_{s≠v} δ(s, v)."""
    e = db.relations["E"].to(torch.float32)
    n = e.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=e.device)
    inf = float("inf")
    dist = torch.full((n, n), inf, device=e.device).masked_fill_(eye, 0.0)
    sig = eye.to(torch.float32)
    lvl = 0.0
    with _f32_products():
        while True:
            fr = dist == lvl
            if not bool(fr.any()):
                break
            reach = (fr.to(torch.float32) @ e) > 0
            newly = reach & (dist == inf)
            cnt = torch.where(fr, sig, 0.0) @ e
            dist = torch.where(newly, lvl + 1.0, dist)
            sig = torch.where(newly, cnt, sig)
            lvl += 1.0
        lmax = int(lvl)
        delta = torch.zeros((n, n), device=e.device)
        den = sig.clamp(min=1.0)
        for level in range(lmax, 0, -1):
            t = torch.where(dist == level, (1.0 + delta) / den, 0.0)
            delta = delta + sig * (t @ e.t()) * (dist == level - 1)
    return (delta * ~eye).sum(dim=0)


def bc(dmax: int = 32) -> Bench:
    """Original: materialize levels R3/Lv (bounded-depth reachability with
    stratified negation), shortest-path counts σ over ℕ, then the triple
    join B[v] = Σ σ_sv·σ_vt/σ_st in the post (the value ratio acts on
    relation values, which the IR's value functions do not).  Optimized:
    :func:`bc_brandes`."""
    schema = ir.Schema()
    schema.declare("E", ("id", "id"), "bool")
    schema.declare("V", ("id",), "bool")
    schema.declare("R3", ("id", "id", "d"), "bool")
    schema.declare("Lv", ("id", "id", "d"), "bool")
    schema.declare("sig", ("id", "id"), "nat")

    f_r3 = Rule("R3", _ssp(("s", "t", "k"), [
        _t([RelAtom("V", ("s",)), PredAtom("eq", ("s", "t"))]),
        _t([RelAtom("R3", ("s", "v", "l")), RelAtom("E", ("v", "t")),
            PredAtom("succ", ("k", "l"))], ["v", "l"]),
        _t([RelAtom("R3", ("s", "t", "l")), PredAtom("succ", ("k", "l"))],
           ["l"]),
    ], "bool"))
    f_lv = Rule("Lv", _ssp(("s", "t", "k"), [
        _t([RelAtom("R3", ("s", "t", "k")), PredAtom("eq", ("k", C(0)))]),
        _t([RelAtom("R3", ("s", "t", "k")),
            RelAtom("R3", ("s", "t", "l"), neg=True),
            PredAtom("succ", ("k", "l"))], ["l"]),
    ], "bool"))
    f_sig = Rule("sig", _ssp(("s", "t"), [
        _t([PredAtom("eq", ("s", "t"))]),
        _t([RelAtom("sig", ("s", "v")), RelAtom("E", ("v", "t"), cast=True),
            RelAtom("Lv", ("s", "t", "k"), cast=True),
            RelAtom("Lv", ("s", "v", "l"), cast=True),
            PredAtom("succ", ("k", "l"))], ["v", "k", "l"]),
    ], "nat"))

    def post(_, db):
        sig = db.relations["sig"]
        lv = db.relations["Lv"]
        kk = torch.arange(lv.shape[-1], dtype=torch.float32,
                          device=lv.device)
        dist = torch.where(lv.any(-1), (lv * kk).sum(-1),
                           float("inf"))
        n = sig.shape[0]
        ids = torch.arange(n, device=sig.device)
        base = (ids[:, None] != ids[None, :]) & (dist != float("inf"))
        den = sig.clamp(min=1.0)
        block = max(1, BC_BLOCK_ENTRIES // max(n * n, 1))
        out = []
        for v0 in range(0, n, block):
            v = ids[v0:v0 + block]                       # (b,)
            d_sv = dist[:, v].t()[:, :, None]            # (b, s, 1)
            d_vt = dist[v][:, None, :]                   # (b, 1, t)
            ok = (dist[None] == d_sv + d_vt) & base[None]
            ok &= (ids[None, None, :] != v[:, None, None])
            ok &= (ids[None, :, None] != v[:, None, None])
            contrib = sig[:, v].t()[:, :, None] * sig[v][:, None, :] / den
            out.append(torch.where(ok, contrib, 0.0).sum(dim=(1, 2)))
        return torch.cat(out)

    original = Program("BC", schema,
                       [Stratum({"R3": f_r3}), Stratum({"Lv": f_lv}),
                        Stratum({"sig": f_sig})],
                       [], post=post)
    optimized = Program("BC_opt", schema, [], [],
                        post=lambda _, db: bc_brandes(db))

    def make_db(g_: datasets.Graph, device=None) -> engine.Database:
        return engine.Database(schema, {"id": g_.n, "d": dmax}, {
            "E": g_.adjacency(device=device),
            "V": g_.vertex_set(device=device)}, device)

    return Bench("BC", original, optimized, make_db, synthesis="cegis",
                 optimized_fn=bc_brandes)


ALL["bc"] = bc


# --------------------------------------------------------------------------
# SM — Simple Magic (Example 3.5): left-recursive TC → reachability
# --------------------------------------------------------------------------


def simple_magic(a: int = 0) -> Bench:
    """Example 3.5: TC(x,y) := [x=y] ∨ ∃z(TC(x,z) ∧ E(z,y)); Q(y)=TC(a,y)
    → Q(y) := [y=a] ∨ ∃z(Q(z) ∧ E(z,y)).  Unlike BM (Example 3.8), here
    G(F(TC)) = H(G(TC)) holds for *every* TC — no loop invariant needed:
    the magic-set rewrite falls out of plain rule-based denormalization."""
    schema = ir.Schema()
    schema.declare("E", ("id", "id"), "bool")
    schema.declare("V", ("id",), "bool")
    schema.declare("TC", ("id", "id"), "bool")
    schema.declare("Q", ("id",), "bool")

    f_tc = Rule("TC", _ssp(("x", "y"), [
        _t([RelAtom("V", ("x",)), PredAtom("eq", ("x", "y"))]),
        _t([RelAtom("TC", ("x", "z")), RelAtom("E", ("z", "y"))], ["z"]),
    ], "bool"))
    g = Rule("Q", _ssp(("y",), [_t([RelAtom("TC", (C(a), "y"))])], "bool"))
    original = Program("SM", schema, [Stratum({"TC": f_tc})], [g])

    h = Rule("Q", _ssp(("y",), [
        _t([PredAtom("eq", ("y", C(a))), RelAtom("V", (C(a),))]),
        _t([RelAtom("Q", ("z",)), RelAtom("E", ("z", "y"))], ["z"]),
    ], "bool"))
    out = Rule("Qans", _ssp(("y",), [_t([RelAtom("Q", ("y",))])], "bool"))
    optimized = Program("SM_opt", schema, [Stratum({"Q": h})], [out])

    def make_db(g_: datasets.Graph, device=None) -> engine.Database:
        return engine.Database(schema, {"id": g_.n}, {
            "E": g_.adjacency(device=device),
            "V": g_.vertex_set(device=device)}, device)

    return Bench("SM", original, optimized, make_db, synthesis="rule")


ALL["simple_magic"] = simple_magic
