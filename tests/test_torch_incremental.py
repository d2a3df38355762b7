"""Port parity: the incremental slice — DeltaLog, Database.apply_delta,
delta-restart, refresh_program and the planner's incremental branch.

``repro_torch.incremental`` on CPU tensors against ``repro.incremental``
on the same host buffers (the reference's own way of running on the
CPU).  For bool, trop and maxplus, values and iteration counts must
match bit for bit; nat (no ⊖) goes to the full recompute in both, and
its answers match exactly too (small integers).

The non-monotone executor and CEGIS are in
``tests/test_torch_maintenance.py``; ``refresh_program``'s delete path
is checked here end to end.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import ir as jir
from repro.core import planner as jplanner
from repro.core.program import run_program as jrun
from repro.datalog import datasets as jdata
from repro.datalog import programs as jprograms
from repro.incremental import DeltaLog as JLog
from repro.incremental import delta_restart_fixpoint as jrestart
from repro.incremental import delta_seed as jseed
from repro.incremental import refresh_program as jrefresh
from repro.incremental import maintenance as jmaint
from repro.sparse import fixpoint as jfx
from repro.sparse.coo import SparseRelation as JRel
from repro_torch.core import engine, planner
from repro_torch.core import ir as pir
from repro_torch.core import semiring as sr_mod
from repro_torch.core.program import run_program
from repro_torch.datalog import datasets as pdata
from repro_torch.datalog import programs
from repro_torch.incremental import (DeltaLog, delta_restart_fixpoint,
                                     delta_seed, refresh_program)
from repro_torch.incremental import maintenance, restart
from repro_torch.sparse import fixpoint as fx
from repro_torch.sparse.coo import SparseRelation

LATTICES = ("bool", "trop", "maxplus")
N = 120


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def _port(jrel) -> SparseRelation:
    h = jrel.as_np()
    return SparseRelation.from_buffers(h.coords, h.values, h.nnz, h.shape,
                                       jrel.semiring, device="cpu")


def _graph(sr_name, seed, *, n=N, deg=2.0, pad=0):
    """A random digraph in both packages (host lib for the reference, so
    its CSR hooks run); maxplus keeps the acyclic half."""
    rng = np.random.default_rng(seed)
    g = jdata.erdos_renyi(n, deg, seed=seed, weighted=True, wmax=6)
    e = g.edges
    if sr_name == "maxplus":
        e = e[e[:, 0] < e[:, 1]]
    w = np.ones(len(e), bool) if sr_name == "bool" else \
        rng.integers(1, 6, len(e)).astype(np.float32)
    jrel = JRel.from_coo(e, w, (n, n), sr_name,
                         capacity=len(e) + pad if pad else None, lib="np")
    return jrel, _port(jrel)


def _delta(rng, k, sr_name, *, n=N):
    coords = np.stack([rng.integers(0, n, k), rng.integers(0, n, k)], 1)
    if sr_name == "maxplus":       # stay acyclic
        coords = np.sort(coords, axis=1)
        coords = coords[coords[:, 0] < coords[:, 1]]
    values = (np.ones(len(coords), bool) if sr_name == "bool"
              else rng.integers(1, 6, len(coords)).astype(np.float32))
    return coords, values


def _inits(sr_name, sources, *, n=N):
    sr = sr_mod.get(sr_name, lib="np")
    init = np.full((len(sources), n), sr.zero, sr.dtype)
    init[np.arange(len(sources)), sources] = sr.one
    return init


# --------------------------------------------------------------------------
# DeltaLog
# --------------------------------------------------------------------------


def _logs(L):
    return {
        "empty": L(),
        "merge": L().insert("E", [[0, 1], [2, 3]]).insert("E", [4, 5]),
        "delete": L().delete("E", [[0, 1]]).insert("E", [[7, 8]]),
        "increase": L().increase("E", [[0, 1]], [5.0]),
        "mixed": L().delete("E", [[0, 1]]).increase("E", [[2, 3]], [4.0])
                    .insert("V", [[3]]),
    }


@pytest.mark.parametrize("which", list(_logs(DeltaLog)))
def test_deltalog_classification_matches_reference(which):
    got, want = _logs(DeltaLog)[which], _logs(JLog)[which]
    assert got.monotone() == want.monotone()
    assert got.nonmonotone_op() == want.nonmonotone_op()
    assert got.touched() == want.touched()
    assert got.nnz() == want.nnz() and got.nnz("E") == want.nnz("E")
    assert len(got) == len(want) and repr(got) == repr(want)
    assert_same(got.removed_coords("E"), want.removed_coords("E"))
    for e, je in zip(got.entries, want.entries):
        assert (e.relation, e.op, e.size) == (je.relation, je.op, je.size)
        assert_same(e.coords, je.coords)


@pytest.mark.parametrize("sr_name", LATTICES + ("nat",))
def test_deltalog_merged_matches_reference(sr_name):
    """merge entries plus the new values of increases, duplicates
    ⊕-coalesced: the same buffers, built on the requested device."""
    def mk(L):
        return (L().insert("E", [[0, 1], [2, 3]], [3, 4])
                .insert("E", [[0, 1]], [2]).increase("E", [[5, 6]], [7])
                .delete("E", [[2, 3]]).insert("E", [[9, 9]]))
    if sr_name == "bool":
        def mk(L):  # noqa: F811 — 𝔹 has no weights
            return (L().insert("E", [[0, 1], [2, 3]])
                    .insert("E", [[0, 1]]).delete("E", [[2, 3]]))
    got = mk(DeltaLog).merged("E", (10, 10), sr_name, device="cpu")
    want = mk(JLog).merged("E", (10, 10), sr_name).as_np()
    assert got.device.type == "cpu" and got.nnz == int(want.nnz)
    assert_same(got.coords, want.coords)
    assert_same(got.values, want.values)
    empty = DeltaLog().merged("E", (10, 10), sr_name, device="cpu")
    assert empty.nnz == int(JLog().merged("E", (10, 10), sr_name).nnz)


# --------------------------------------------------------------------------
# Database.apply_delta
# --------------------------------------------------------------------------


def _bm_dbs(n=30, seed=0, *, storage="sparse"):
    g = jdata.erdos_renyi(n, 1.5, seed=seed)
    schema = jprograms.bm(a=0).original.schema
    jrel = JRel.from_coo(g.edges, np.ones(len(g.edges), bool), (n, n),
                         "bool", capacity=len(g.edges) + 8, lib="np")
    jdb = jengine.Database(schema, {"id": n},
                           {"E": jrel, "V": jnp.ones((n,), bool)})
    db = engine.Database(programs.bm(a=0).original.schema, {"id": n},
                         {"E": _port(jrel),
                          "V": torch.ones(n, dtype=torch.bool)}, "cpu")
    if storage == "dense":
        jdb, db = jdb.with_storage("E", "dense"), db.with_storage("E",
                                                                  "dense")
    return jdb, db, g


@pytest.mark.parametrize("storage", ["sparse", "dense"])
@pytest.mark.parametrize("op", ["merge", "delete", "increase", "chain"])
def test_database_apply_delta_buffers_match_reference(storage, op):
    """Sparse children have the reference's padded buffers (capacity,
    sentinels, order); dense ones its values; both on the database's
    device, and a sparse child keeps the parent's CSR index."""
    jdb, db, g = _bm_dbs(storage=storage)
    live = g.edges[:3]

    def mk(L):
        if op == "merge":
            return L().insert("E", [[2, 7], [7, 11], [2, 7]])
        if op == "delete":
            return L().delete("E", live)
        if op == "increase":
            return L().increase("E", live[:2], [True, True])
        return (L().insert("E", np.stack([np.arange(12),
                                          np.arange(12)[::-1]], 1))
                .delete("E", live).insert("E", [[29, 0]]))
    if storage == "sparse":
        fx.csr_index(db.relations["E"])
    out, jout = db.apply_delta(mk(DeltaLog)), jdb.apply_delta(mk(JLog))
    assert out.device.type == "cpu"
    got, want = out.relations["E"], jout.relations["E"]
    if storage == "sparse":
        h = want.as_np()
        assert got.nnz == int(h.nnz) and got.capacity == len(h.coords)
        assert_same(got.coords, h.coords)
        assert_same(got.values, h.values)
        assert fx._csr_lookup(got) is not None
    else:
        assert got.device.type == "cpu"
        assert_same(got, want)
    assert out.relations["V"] is db.relations["V"]


@pytest.mark.parametrize("op", ["merge", "delete", "increase"])
def test_database_apply_delta_dense_trop_matches_reference(op):
    """A dense trop relation: ⊕ = min on merge, 0̄ on delete, the new
    value on increase; keys index as the reference's ``.at[...]``."""
    n = 6
    rng = np.random.default_rng(3)
    arr = np.where(rng.random((n, n)) < 0.5, rng.integers(1, 9, (n, n)),
                   np.inf).astype(np.float32)
    jschema, schema = jir.Schema(), pir.Schema()
    jschema.declare("X", ("id", "id"), "trop")
    schema.declare("X", ("id", "id"), "trop")
    jdb = jengine.Database(jschema, {"id": n}, {"X": jnp.asarray(arr)})
    db = engine.Database(schema, {"id": n}, {"X": torch.from_numpy(arr)},
                         "cpu")
    # a repeated key, a negative coordinate (counts from the end) and a
    # key out of range (dropped)
    coords = np.asarray([[0, 1], [2, 2], [0, 1], [5, 3], [-1, 2], [6, 0]])
    vals = np.asarray([4.0, 0.5, 2.0, 7.0, 3.0, 1.0], np.float32)

    def mk(L):
        if op == "merge":
            return L().insert("X", coords, vals)
        if op == "delete":
            return L().delete("X", coords)
        return L().increase("X", coords[1:], vals[1:] + 10)
    assert_same(db.apply_delta(mk(DeltaLog)).relations["X"],
                jdb.apply_delta(mk(JLog)).relations["X"])


# --------------------------------------------------------------------------
# delta_seed and delta_restart_fixpoint
# --------------------------------------------------------------------------


def _warm(sr_name, seed, *, b=None, pad=0, k=6):
    """A graph, its solved warm answer(s) in both packages, and a merge
    delta: ``(jrel, rel, init, prev, jdelta, delta, coords, values)``."""
    jrel, rel = _graph(sr_name, seed, pad=pad)
    rng = np.random.default_rng(seed + 100)
    inits = _inits(sr_name, rng.integers(0, N, b or 1))
    init = inits if b else inits[0]
    prev, _ = jfx.fixpoint(jrel, init, mode="frontier" if not b else "jit")
    prev = np.array(prev)
    coords, values = _delta(rng, k, sr_name)
    # half of the new edges leave a reached vertex, so the seed is live
    live = sr_mod.get(sr_name, lib="np").live(prev.reshape(-1, N)).any(0)
    reached = np.flatnonzero(live)
    coords[:len(coords) // 2, 0] = rng.choice(reached, len(coords) // 2)
    if sr_name == "maxplus":
        coords = coords[coords[:, 0] < coords[:, 1]]
        values = values[:len(coords)]
    jdelta = JRel.from_coo(coords, values, (N, N), sr_name, lib="np")
    return (jrel, rel, init, prev, jdelta, _port(jdelta),
            coords, values)


@pytest.mark.parametrize("sr_name", LATTICES)
@pytest.mark.parametrize("backend", ["np", "torch"])
@pytest.mark.parametrize("b", [None, 4])
def test_delta_seed_matches_reference(sr_name, backend, b):
    """``(y* ⊗ ΔE) ⊖ y*`` on the host (``np``, the reference's
    ``NP_COMBINE.at``) and on the relation's device (``torch``: a
    contraction over Δ, B3's runs path), ``(n,)`` and ``(B, n)``."""
    *_, prev, jdelta, delta, _, _ = _warm(sr_name, 1, b=b, k=12)
    want = jseed(jdelta, prev, backend="np")
    got = delta_seed(delta, torch.from_numpy(prev), backend=backend)
    assert got.device.type == "cpu"
    assert_same(got, want)
    assert bool(sr_mod.get(sr_name).live(got).any())   # not a 0̄ seed
    assert_same(delta_seed(delta, prev, backend=backend), want)


@pytest.mark.parametrize("sr_name", LATTICES)
@pytest.mark.parametrize("mode", ["frontier", "jit"])
@pytest.mark.parametrize("seed", [1, 2])
def test_delta_restart_matches_reference(sr_name, mode, seed):
    """One warm answer repaired after ``apply_delta``: values and resumed
    rounds equal the reference's, and the cold run on E′."""
    jrel, rel, init, prev, jdelta, delta, coords, values = _warm(
        sr_name, seed, pad=4)
    jrel2, rel2 = jrel.apply_delta(coords, values), \
        rel.apply_delta(coords, values)
    want, wit = jrestart(jrel2, jdelta, prev, mode=mode)
    got, it = delta_restart_fixpoint(rel2, delta, prev, mode=mode)
    assert_same(got, want)
    assert isinstance(it, int) and it == int(np.asarray(wit))
    cold, _ = fx.fixpoint(rel2, torch.from_numpy(init), mode=mode)
    assert_same(got, cold)
    got_t, it_t = delta_restart_fixpoint(rel2, delta, torch.from_numpy(prev),
                                         mode=mode)
    assert_same(got_t, want)
    assert it_t == it


@pytest.mark.parametrize("sr_name", LATTICES)
@pytest.mark.parametrize("mode", ["frontier", "jit", "auto"])
def test_delta_restart_batched_matches_reference(sr_name, mode):
    """A ``(B, n)`` warm pack takes the staged loop in every mode (the
    worklist is per row): values and per-row rounds as the reference."""
    jrel, rel, init, prev, jdelta, delta, coords, values = _warm(
        sr_name, 3, b=5)
    jrel2, rel2 = jrel.apply_delta(coords, values), \
        rel.apply_delta(coords, values)
    want, wit = jrestart(jrel2, jdelta, prev, mode=mode)
    got, it = delta_restart_fixpoint(rel2, delta, prev, mode=mode)
    assert_same(got, want)
    assert_same(it, np.asarray(wit, np.int32))
    cold, _ = fx.fixpoint(rel2, torch.from_numpy(init))
    assert_same(got, cold)


@pytest.mark.parametrize("sr_name", LATTICES)
def test_capacity_doubling_repad_matches_reference(sr_name):
    """A delta larger than the padded slack re-pads at the doubled
    capacity: the same buffers as the reference, and the same repair."""
    jrel, rel, init, prev, *_ = _warm(sr_name, 4)
    assert rel.capacity == rel.nnz
    rng = np.random.default_rng(9)
    coords, values = _delta(rng, rel.capacity + 7, sr_name)
    jrel2, rel2 = jrel.apply_delta(coords, values), \
        rel.apply_delta(coords, values)
    assert rel2.capacity > rel.capacity
    assert_same(rel2.coords, jrel2.as_np().coords)
    jdelta = JRel.from_coo(coords, values, (N, N), sr_name, lib="np")
    for mode in ("frontier", "jit"):
        want, wit = jrestart(jrel2, jdelta, prev, mode=mode)
        got, it = delta_restart_fixpoint(rel2, _port(jdelta), prev,
                                         mode=mode)
        assert_same(got, want)
        assert it == int(np.asarray(wit))


@pytest.mark.parametrize("sr_name", LATTICES)
@pytest.mark.parametrize("mode", ["frontier", "jit"])
@pytest.mark.parametrize("b", [None, 3])
def test_update_that_changes_nothing_takes_zero_rounds(sr_name, mode, b):
    """Re-inserting edges the answer already accounts for leaves no live
    row: 0 resumed rounds in both modes (no cold-start count leaks into
    a warm carry), the answer unchanged, as in the reference."""
    jrel, rel, init, prev, *_ = _warm(sr_name, 5, b=b)
    h = jrel.as_np()
    coords, values = h.coords[:5], h.values[:5]
    jdelta = JRel.from_coo(coords, values, (N, N), sr_name, lib="np")
    want, wit = jrestart(jrel.apply_delta(coords, values), jdelta, prev,
                         mode=mode)
    got, it = delta_restart_fixpoint(rel.apply_delta(coords, values),
                                     _port(jdelta), prev, mode=mode)
    assert_same(got, prev)
    assert_same(got, want)
    assert np.all(_np(it) == 0) and np.array_equal(_np(it), np.asarray(wit))


def test_auto_mode_is_the_worklist_on_the_cpu(monkeypatch):
    """``mode="auto"`` resolves by the relation's device: the worklist
    on a CPU relation for one source, the staged loop for a pack."""
    seen = []
    real = restart.fixpoint

    def spy(edges, **kw):
        seen.append(kw["mode"])
        return real(edges, **kw)
    monkeypatch.setattr(restart, "fixpoint", spy)
    jrel, rel, init, prev, jdelta, delta, coords, values = _warm("bool", 6)
    delta_restart_fixpoint(rel.apply_delta(coords), delta, prev)
    *_, prev_b, _, delta_b, coords_b, _ = _warm("bool", 6, b=2)
    delta_restart_fixpoint(rel.apply_delta(coords_b), delta_b, prev_b)
    assert seen == ["frontier", "jit"]


# --------------------------------------------------------------------------
# refresh_program: the planner-routed policy layer
# --------------------------------------------------------------------------


def _bench_dbs(kind, n=40, seed=None):
    """BM, CC or SSSP Π₂ with its database in both packages (E sparse;
    SSSP's E3 is the weighted adjacency, as the reference's make_db).
    The default graphs have a mixed answer: BM from 0 reaches 22 of 40
    vertices, CC has several components."""
    if seed is None:
        seed = 2 if kind == "cc" else 6
    if kind == "sssp":
        jb, b = jprograms.sssp(a=0, wmax=4, dmax=16), \
            programs.sssp(a=0, wmax=4, dmax=16)
        g = jdata.erdos_renyi(n, 2.0, seed=seed, weighted=True, wmax=4)
        pg = pdata.Graph(g.n, g.edges, g.weights)
        return jb.optimized, jb.make_db(g), b.optimized, \
            b.make_db(pg, device="cpu"), g
    jb, b = (jprograms.bm(a=0), programs.bm(a=0)) if kind == "bm" else \
        (jprograms.cc(), programs.cc())
    g = jdata.erdos_renyi(n, 2.0, seed=seed)
    sym = kind == "cc"
    jrel = g.sparse_adjacency(symmetric=sym)
    jdb = jengine.Database(jb.original.schema, {"id": n},
                           {"E": jrel, "V": jnp.ones((n,), bool)})
    db = engine.Database(b.original.schema, {"id": n},
                         {"E": _port(jrel),
                          "V": torch.ones(n, dtype=torch.bool)}, "cpu")
    return jb.optimized, jdb, b.optimized, db, g


def _log_for(kind, which, g, prev, L):
    """Updates that move the answer: BM inserts a path from a reached
    vertex into unreached ones and deletes every in-edge of a reached
    vertex; CC joins its two least-labelled components and cuts a
    vertex of the first out of it (both directions of its edges)."""
    e, p = g.edges, _np(prev)
    if kind == "bm":
        out, hit = np.flatnonzero(~p), np.flatnonzero(p)
        ins = [[hit[-1], out[0]], [out[0], out[1]], [out[1], out[2]]]
        dels = e[e[:, 1] == hit[-1]]
    else:
        labs = np.unique(p)
        a, b = np.flatnonzero(p == labs[0])[-1], \
            np.flatnonzero(p == labs[1])[-1]
        ins = [[a, b], [b, a], [b, b]]
        dels = e[(e[:, 0] == a) | (e[:, 1] == a)]
    if which == "insert":
        return L().insert("E", ins)
    if which == "delete":
        return L().delete("E", dels)
    return L().delete("E", dels).insert("E", ins[1:])


def _same_refresh(jprog, jdb, prog, db, jlog, log, **kw):
    jprev, _ = jrun(jprog, jdb)
    prev, _ = run_program(prog, db)
    assert_same(prev, jprev)
    jy, jdb2, jrep = jrefresh(jprog, jdb, np.asarray(jprev), jlog, **kw)
    y, db2, rep = refresh_program(prog, db, prev, log, **kw)
    assert y.device.type == "cpu" and db2.device.type == "cpu"
    assert_same(y, jy)
    assert (rep.strategy, rep.reason, rep.iters, rep.delta_nnz) == \
        (jrep.strategy, jrep.reason, jrep.iters, jrep.delta_nnz)
    scratch, _ = run_program(prog, db2)
    assert_same(y, scratch)
    return rep, _np(y), _np(prev)


@pytest.mark.parametrize("kind", ["bm", "cc", "sssp"])
@pytest.mark.parametrize("which", ["insert", "delete", "mixed"])
def test_refresh_program_matches_reference(kind, which):
    """Strategy, reason, resumed rounds and answer as the reference's,
    and the answer equals a from-scratch run on the mutated database.
    SSSP's operator is a dense E3(x, y, w) join, so both packages fall
    back to the full recompute with the same reason."""
    maintenance.clear_rule_cache()
    jmaint.clear_rule_cache()
    jprog, jdb, prog, db, g = _bench_dbs(kind)
    if kind == "sssp":
        name = "E3"
        w = np.asarray([[1, 37, 2], [37, 3, 1]])
        jlog = JLog().insert(name, w) if which == "insert" else \
            JLog().delete(name, [[g.edges[0][0], g.edges[0][1],
                                  g.weights[0]]])
        log = DeltaLog().insert(name, w) if which == "insert" else \
            DeltaLog().delete(name, [[g.edges[0][0], g.edges[0][1],
                                      g.weights[0]]])
    else:
        prev, _ = run_program(prog, db)
        jlog, log = _log_for(kind, which, g, prev, JLog), \
            _log_for(kind, which, g, prev, DeltaLog)
    rep, y, prev = _same_refresh(jprog, jdb, prog, db, jlog, log)
    if kind != "sssp":
        assert rep.strategy == ("delta_restart" if which == "insert"
                                else "synth_maintenance")
        assert not np.array_equal(y, prev)
        assert rep.iters > 0 or which != "insert"
    else:
        assert rep.strategy == "full"
    maintenance.clear_rule_cache()
    jmaint.clear_rule_cache()


def _edge_init_prog(mod, ir, a=0):
    """Q(y) := E(a, y) ⊕ ⊕_z Q(z) ⊗ E(z, y): the init term reads E."""
    body = ir.SSP(("y",), (
        ir.Term((ir.RelAtom("E", (ir.C(a), "y")),), ()),
        ir.Term((ir.RelAtom("Q", ("z",)), ir.RelAtom("E", ("z", "y"))),
                ("z",))), "bool")
    return mod.Program("edge_init", mod_programs(mod).bm(a=0)
                       .original.schema,
                       [mod.Stratum({"Q": mod.Rule("Q", body)})],
                       [mod.Rule("Qans", ir.SSP(("y",), (ir.Term(
                           (ir.RelAtom("Q", ("y",)),), ()),), "bool"))])


def mod_programs(mod):
    return jprograms if mod.__name__.startswith("repro.") else programs


@pytest.mark.parametrize("case", ["no_prev", "nat", "edge_init", "outside",
                                  "synthesis_budget"])
def test_refresh_fallbacks_match_reference(case):
    """Every full-recompute fallback gives the reference's reason and an
    exact answer: no previous solution, a semiring without ⊖ (MLM on
    nat), an edge relation that also feeds the init term, a log that
    touches a relation outside the operator, a synthesis budget of 0."""
    from repro.core import ir as jir_, program as jprog_mod
    from repro_torch.core import ir as pir_, program as prog_mod
    kw = {}
    if case == "nat":
        jb, b = jprograms.mlm(), programs.mlm()
        g = jdata.random_recursive_tree(14, seed=3)
        jdb = jb.make_db(g)
        jdb = jdb.with_relations({"E": JRel.from_dense(
            np.asarray(jdb.relations["E"]), "bool", capacity=64,
            lib="np")})
        db = b.make_db(pdata.Graph(g.n, g.edges), device="cpu"
                       ).with_relations(
            {"E": _port(jdb.relations["E"])})
        jprog, prog = jb.optimized, b.optimized
        jlog, log = JLog().insert("E", [[0, 9]]), DeltaLog().insert(
            "E", [[0, 9]])
    elif case == "edge_init":
        n = 4
        jrel = JRel.from_coo([[1, 2]], [True], (n, n), "bool", capacity=8,
                             lib="np")
        jdb = jengine.Database(jprograms.bm(a=0).original.schema,
                               {"id": n}, {"E": jrel,
                                           "V": jnp.ones((n,), bool)})
        db = engine.Database(programs.bm(a=0).original.schema, {"id": n},
                             {"E": _port(jrel),
                              "V": torch.ones(n, dtype=torch.bool)}, "cpu")
        jprog = _edge_init_prog(jprog_mod, jir_)
        prog = _edge_init_prog(prog_mod, pir_)
        jlog, log = JLog().insert("E", [[0, 1]]), DeltaLog().insert(
            "E", [[0, 1]])
    else:
        jprog, jdb, prog, db, g = _bench_dbs("bm")
        if case == "outside":
            jlog = JLog().insert("E", [[0, 1]]).insert("V", [[2]])
            log = DeltaLog().insert("E", [[0, 1]]).insert("V", [[2]])
        else:
            jlog, log = JLog().delete("E", [[0, 1]]), DeltaLog().delete(
                "E", [[0, 1]])
        if case == "synthesis_budget":
            kw = dict(synth_budget_s=0.0)
            maintenance.clear_rule_cache()
            jmaint.clear_rule_cache()
    if case == "no_prev":
        jy, _, jrep = jrefresh(jprog, jdb, None, jlog)
        y, db2, rep = refresh_program(prog, db, None, log)
        assert_same(y, jy)
    else:
        rep = _same_refresh(jprog, jdb, prog, db, jlog, log, **kw)[0]
        jrep = rep
    assert rep.strategy == "full" and rep.reason == jrep.reason
    assert {"no_prev": "no previous solution", "nat": "planner:",
            "edge_init": "feeds the init term",
            "outside": "outside the linear",
            "synthesis_budget": "synthesis"}[case] in rep.reason
    maintenance.clear_rule_cache()
    jmaint.clear_rule_cache()


def test_refresh_program_takes_a_numpy_or_tensor_prev():
    """``prev`` may be the reference's kind (numpy) or a tensor; the
    answer lies on the database's device either way."""
    _, _, prog, db, g = _bench_dbs("bm", seed=4)
    prev, _ = run_program(prog, db)
    log = DeltaLog().insert("E", [[0, 5], [5, 9]])
    y1, _, r1 = refresh_program(prog, db, prev.numpy(), log)
    y2, _, r2 = refresh_program(prog, db, prev, log)
    assert y1.device == db.device and isinstance(y1, torch.Tensor)
    assert_same(y1, y2)
    assert r1.strategy == r2.strategy == "delta_restart"


# --------------------------------------------------------------------------
# Planner: the objective="incremental" candidates
# --------------------------------------------------------------------------


def _plans(jprog, jdb, prog, db, **kw):
    jsp = jplanner.plan_program(jprog, jdb, **kw).strata[0]
    sp = planner.plan_program(prog, db, **kw).strata[0]
    return jsp, sp


@pytest.mark.parametrize("kw", [
    dict(objective="incremental", delta_nnz=2),
    dict(objective="incremental"),
    dict(objective="incremental", delta_nnz=2, delta_op="delete"),
    dict(objective="incremental", delta_nnz=2, delta_op="increase"),
    dict(delta_nnz=3),
], ids=["merge", "no_delta", "delete", "increase", "latency"])
def test_planner_incremental_candidates_match_reference(kw):
    """The incremental candidates, their estimates and the rejection
    reasons as the reference's; a latency plan offers neither."""
    maintenance.clear_rule_cache()
    jmaint.clear_rule_cache()
    jprog, jdb, prog, db, _ = _bench_dbs("bm", n=200, seed=5)
    jsp, sp = _plans(jprog, jdb, prog, db, **kw)
    assert sp.runner == jsp.runner
    for r in ("delta_restart", "synth_maintenance"):
        assert sp.rejected.get(r, "").replace("repro_torch.", "repro.") \
            == jsp.rejected.get(r, "")
        assert (r in sp.considered) == (r in jsp.considered)
        if r in sp.considered:
            assert sp.considered[r] .total == jsp.considered[r].total
    if kw.get("delta_nnz") == 2 and "delta_op" not in kw:
        assert sp.runner == "delta_restart"
        assert "warm restart: nnz(Δ)=2" in sp.reason
        assert sp.reason == jsp.reason
        assert "warm restart" in planner.explain(
            planner.plan_program(prog, db, **kw))
    if kw.get("objective") != "incremental":
        assert "delta_restart" not in sp.considered
        assert "delta_restart" not in sp.rejected


@pytest.mark.parametrize("sr_name", ["bool", "trop"])
def test_planner_prices_a_cached_rule_only(sr_name):
    """Planning never synthesizes: no cached rule → the reference's
    rejection; after ``ensure_rule`` the synthesized repair wins, named
    in ``explain()``; a monotone merge keeps delta-restart."""
    maintenance.clear_rule_cache()
    jmaint.clear_rule_cache()
    kind = "bm" if sr_name == "bool" else "cc"
    jprog, jdb, prog, db, _ = _bench_dbs(kind, n=200, seed=5)
    kw = dict(objective="incremental", delta_nnz=2, delta_op="delete")
    jsp, sp = _plans(jprog, jdb, prog, db, **kw)
    assert sp.runner == jsp.runner != "synth_maintenance"
    assert "no maintenance rule cached" in sp.rejected["synth_maintenance"]
    assert "non-monotone" in sp.rejected["delta_restart"]
    maintenance.ensure_rule(sp.vf.signature, sp.vf.semiring, "delete")
    jmaint.ensure_rule(jsp.vf.signature, jsp.vf.semiring, "delete")
    jsp, sp = _plans(jprog, jdb, prog, db, **kw)
    assert sp.runner == jsp.runner == "synth_maintenance"
    assert sp.reason == jsp.reason
    assert "⊖-recount[seed=supported, cone=tight]" in planner.explain(
        planner.plan_program(prog, db, **kw))
    jsp, sp = _plans(jprog, jdb, prog, db, objective="incremental",
                     delta_nnz=2, delta_op="merge")
    assert sp.runner == jsp.runner == "delta_restart"
    assert "synth_maintenance" in sp.rejected
    maintenance.clear_rule_cache()
    jmaint.clear_rule_cache()


@pytest.mark.parametrize("runner", ["delta_restart", "synth_maintenance"])
def test_incremental_runners_cannot_be_forced_or_executed_cold(runner):
    _, _, prog, db, _ = _bench_dbs("bm")
    with pytest.raises(ValueError, match="cannot be forced"):
        planner.plan_program(prog, db, mode=runner)
    maintenance.clear_rule_cache()
    if runner == "synth_maintenance":
        vf = planner.plan_program(prog, db).strata[0].vf
        maintenance.ensure_rule(vf.signature, vf.semiring, "delete")
    plan = planner.plan_program(
        prog, db, objective="incremental", delta_nnz=1,
        delta_op="merge" if runner == "delta_restart" else "delete")
    assert plan.strata[0].runner == runner
    with pytest.raises(ValueError, match="refresh_program"):
        planner.execute_plan(plan, prog, db)
    maintenance.clear_rule_cache()
