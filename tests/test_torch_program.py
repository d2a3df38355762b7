"""Port parity: whole programs through planner, runners and engine.

``repro_torch.core.program.run_program`` against
``repro.core.program.run_program`` on the same graph, fed to both
packages from the same numpy buffers:

* BM and CC, Π₁ (original) and Π₂ (FGH-optimized), on a sparse
  ``powerlaw(300, 3)`` (E stays sparse: B3 through the contraction
  paths) and on a dense ``erdos_renyi(64, 0.4·64)`` (E stays dense:
  the engine's joins reach B2's plain version);
* the other ported benchmarks at small sizes;
* ``compile_batched`` for a ``(B, n)`` pack under
  ``objective="throughput"`` (the fused B1 runner, picked in both
  packages once ``SPMM_COST.min_nnz`` is lowered);
* ``VectorForm.signature`` and the seeded graph generators.

Answers and iteration counts are compared; runner picks and
``explain`` on CPU databases are held against the reference's in
``tests/test_torch_frontier.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import planner as jplanner
from repro.core import program as jprogram
from repro.core import vectorize as jvectorize
from repro.datalog import datasets as jdata
from repro.datalog import programs as jprograms
from repro.sparse.coo import SparseRelation as JRel
from repro_torch.core import engine, planner, program, vectorize
from repro_torch.datalog import datasets, programs
from repro_torch.sparse.coo import SparseRelation


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_match(got, want, sr_name: str) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if sr_name == "real":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        assert np.array_equal(got, want), sr_name


def port_db(jdb: jengine.Database, schema) -> engine.Database:
    """The reference database's relations as host buffers, adopted by
    the port as they are (``Database.from_numpy``)."""
    rels = {}
    for name, v in jdb.relations.items():
        if isinstance(v, JRel):
            h = v.as_np()
            rels[name] = dict(coords=h.coords, values=h.values, nnz=h.nnz,
                              shape=h.shape, semiring=h.semiring)
        else:
            rels[name] = np.asarray(v)
    return engine.Database.from_numpy(schema, jdb.domains, rels,
                                      device="cpu")


def _bm_cc_dbs(kind: str, graph: str):
    jb = jprograms.bm(a=0) if kind == "bm" else jprograms.cc()
    tb = programs.bm(a=0) if kind == "bm" else programs.cc()
    if graph == "sparse":
        g = jdata.powerlaw(300, 3, seed=0)
        e = g.sparse_adjacency(symmetric=kind == "cc")
        jdb = jengine.Database(jb.original.schema, {"id": g.n},
                               {"E": e, "V": g.vertex_set()})
    else:
        jdb = jb.make_db(jdata.erdos_renyi(64, 0.4 * 64, seed=1))
    return jb, tb, jdb, port_db(jdb, tb.original.schema)


@pytest.mark.parametrize("kind", ["bm", "cc"])
@pytest.mark.parametrize("which", ["original", "optimized"])
@pytest.mark.parametrize("graph", ["sparse", "dense"])
def test_run_program_matches_reference(kind, which, graph):
    jb, tb, jdb, db = _bm_cc_dbs(kind, graph)
    want, wst = jprogram.run_program(getattr(jb, which), jdb)
    got, st = program.run_program(getattr(tb, which), db)
    assert_match(got, want, getattr(tb, which).outputs[-1].body.semiring)
    assert st.iterations == wst.iterations


def test_dense_graph_reaches_the_matmul_path(monkeypatch):
    """On the dense graph both Π₁'s joins and Π₂'s vector rounds go
    through B2 (its plain version on CPU)."""
    from repro_torch.kernels import semiring_matmul
    calls = []
    real = semiring_matmul.semiring_matmul_plain
    monkeypatch.setattr(semiring_matmul, "semiring_matmul_plain",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    _, tb, _, db = _bm_cc_dbs("bm", "dense")
    for prog in (tb.original, tb.optimized):
        calls.clear()
        _, st = program.run_program(prog, db)
        assert calls, prog.name
    assert st.plan.strata[0].runner == "vector_dense"


def test_sparse_graph_keeps_e_sparse_and_uses_segment_reduce(monkeypatch):
    """On a CPU database the latency plan is the worklist (as on the
    reference's CPU host), whose ⊕ is B3 without a plan; the staged
    runner, forced, reaches B3's runs path."""
    from repro_torch.kernels import coo_segment
    calls = {"runs": 0, "scatter": 0}
    runs, scatter = coo_segment.segment_runs_plain, \
        coo_segment.segment_reduce_plain
    monkeypatch.setattr(coo_segment, "segment_runs_plain", lambda *a: (
        calls.__setitem__("runs", calls["runs"] + 1) or runs(*a)))
    monkeypatch.setattr(coo_segment, "segment_reduce_plain", lambda *a: (
        calls.__setitem__("scatter", calls["scatter"] + 1) or scatter(*a)))
    _, tb, _, db = _bm_cc_dbs("bm", "sparse")
    assert isinstance(db.relations["E"], SparseRelation)
    _, st = program.run_program(tb.optimized, db)
    assert st.plan.strata[0].runner == "sparse_frontier"
    assert calls["scatter"] == st.iterations[0] and calls["runs"] == 0
    _, st = program.run_program(tb.optimized, db, mode="sparse_jit")
    assert calls["runs"] == st.iterations[0]


def _small_bench(name):
    if name == "sssp":
        g = jdata.erdos_renyi(14, 3.0, seed=2, weighted=True, wmax=4)
        return (jprograms.sssp(a=0, wmax=4, dmax=24),
                programs.sssp(a=0, wmax=4, dmax=24), g)
    if name == "ws":
        return jprograms.ws(), programs.ws(), jdata.vector_data(20, seed=1)
    if name in ("radius", "mlm"):
        return (getattr(jprograms, name)(), getattr(programs, name)(),
                jdata.random_recursive_tree(16, seed=3))
    if name == "apsp100":
        return (jprograms.apsp100(), programs.apsp100(),
                jdata.erdos_renyi(12, 3.0, seed=4))
    return (jprograms.simple_magic(a=1), programs.simple_magic(a=1),
            jdata.erdos_renyi(20, 2.5, seed=5))


@pytest.mark.parametrize("name", ["sssp", "ws", "radius", "mlm", "apsp100",
                                  "simple_magic"])
@pytest.mark.parametrize("which", ["original", "optimized"])
def test_other_benchmarks_match_reference(name, which):
    jb, tb, data = _small_bench(name)
    jdb = jb.make_db(data)
    db = port_db(jdb, tb.original.schema)
    want, wst = jprogram.run_program(getattr(jb, which), jdb)
    got, st = program.run_program(getattr(tb, which), db)
    assert_match(got, want, getattr(tb, which).outputs[-1].body.semiring)
    assert st.iterations == wst.iterations


@pytest.mark.parametrize("mode", ["naive", "seminaive"])
def test_forced_modes_match_reference(mode):
    jb, tb, jdb, db = _bm_cc_dbs("bm", "sparse")
    want, wst = jprogram.run_program(jb.original, jdb, mode=mode)
    got, st = program.run_program(tb.original, db, mode=mode)
    assert_match(got, want, "bool")
    assert st.iterations == wst.iterations


@pytest.mark.parametrize("kind", ["bm", "cc"])
def test_compile_batched_throughput_matches_reference(kind, monkeypatch):
    monkeypatch.setattr(jplanner.SPMM_COST, "min_nnz", 512.0)
    monkeypatch.setattr(planner.SPMM_COST, "min_nnz", 512.0)
    if kind == "cc":  # the reference offers the fused runner for 𝔹 only
        monkeypatch.setitem(jplanner.SPMM_COST.host_speedup, "trop", 5.0)
        monkeypatch.setitem(planner.SPMM_COST.speedups["cpu"], "trop", 5.0)
    jb, tb, jdb, db = _bm_cc_dbs(kind, "sparse")
    jplan = jplanner.plan_program(jb.optimized, jdb, objective="throughput")
    plan = planner.plan_program(tb.optimized, db, objective="throughput")
    assert plan.strata[0].runner == "sparse_frontier_pallas"
    assert jplan.strata[0].runner == "sparse_frontier_pallas"
    n, b = 300, 8
    rng = np.random.default_rng(7)
    if kind == "bm":
        init = np.zeros((b, n), bool)
        init[np.arange(b), rng.integers(0, n, b)] = True
    else:
        init = np.full((b, n), np.inf, np.float32)
        seeds = rng.random((b, n)) < 0.05
        init[seeds] = np.nonzero(seeds)[1].astype(np.float32)
    jedges = jplanner.materialize_edges(jplan, jdb)
    edges = planner.materialize_edges(plan, db)
    want, wit = jplanner.compile_batched(jplan)(jedges, jnp.asarray(init))
    got, it = planner.compile_batched(plan)(edges, torch.from_numpy(init))
    assert_match(got, want, "bool" if kind == "bm" else "trop")
    assert np.array_equal(_np(it), np.asarray(wit))


def test_source_init_and_explain():
    _, tb, _, db = _bm_cc_dbs("bm", "sparse")
    plan = planner.plan_program(tb.optimized, db, objective="throughput")
    init = planner.source_init(plan, programs.bm(a=5).optimized, db)
    assert init.shape == (300,) and bool(init[5]) and int(init.sum()) == 1
    text = planner.explain(plan)
    assert "runner=" in text and "objective=throughput" in text
    with pytest.raises(ValueError, match="linear operator"):
        planner.source_init(plan, programs.cc().optimized, db)


@pytest.mark.parametrize("name", ["bm", "cc", "sssp", "radius", "mlm",
                                  "apsp100", "simple_magic"])
def test_vector_form_signature_identical(name):
    jprog = getattr(jprograms, name)().optimized
    tprog = getattr(programs, name)().optimized
    try:
        want = jvectorize.vector_form(jprog)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            vectorize.vector_form(tprog)
        return
    got = vectorize.vector_form(tprog)
    assert got.signature == want.signature
    assert (got.idb, got.semiring, got.out_sort) == (want.idb, want.semiring,
                                                     want.out_sort)


@pytest.mark.parametrize("gen,args", [
    ("powerlaw", (300, 3, 0)), ("powerlaw", (500, 11, 2)),
    ("erdos_renyi", (64, 25.6, 1)), ("erdos_renyi_sparse", (400, 3.0, 3)),
    ("random_recursive_tree", (50, 1)), ("decay_tree", (30, 1.5, 2)),
    ("path_graph", (12,)),
])
def test_same_seed_same_graph(gen, args):
    jg = getattr(jdata, gen)(*args)
    tg = getattr(datasets, gen)(*args)
    assert tg.n == jg.n
    assert np.array_equal(tg.edges, jg.edges)
    jrel = jg.sparse_adjacency()
    rel = tg.sparse_adjacency(device="cpu")
    assert np.array_equal(rel.as_np().coords, np.asarray(jrel.coords))
    if jg.n <= 500:
        assert np.array_equal(tg.adjacency(device="cpu").numpy(),
                              np.asarray(jg.adjacency()))


def test_plan_is_cached_per_database_and_device():
    _, tb, _, db = _bm_cc_dbs("cc", "sparse")
    p1 = planner.plan_for(tb.optimized, db)
    assert planner.plan_for(tb.optimized, db) is p1
    assert p1.device == "cpu"
    db2 = db.with_relations({"V": torch.ones(300, dtype=torch.bool)})
    assert planner.plan_for(tb.optimized, db2) is not p1


@pytest.mark.parametrize("kind", ["bm", "cc"])
def test_latency_plan_keeps_large_sparse_operator_sparse(kind):
    """At a size where the dense engine would have to densify E (CC's
    cast atom), the latency plan picks a sparse runner — on a CPU
    database the worklist — and the staged one ranks next; on BM the
    dense-GSN and staged costs tie and the preference order (not float
    noise) decides."""
    g = datasets.powerlaw(6000, 11, seed=0)
    bench = programs.bm(a=0) if kind == "bm" else programs.cc()
    db = engine.Database(bench.original.schema, {"id": g.n},
                         {"E": g.sparse_adjacency(device="cpu"),
                          "V": g.vertex_set(device="cpu")}, "cpu")
    sp = planner.plan_program(bench.optimized, db).strata[0]
    assert sp.runner == "sparse_frontier", sp.considered
    pref = list(planner.RUNNERS)
    rest = sorted((r for r in sp.considered if r != sp.runner),
                  key=lambda k: (float(f"{sp.considered[k].total:.12g}"),
                                 pref.index(k)))
    assert rest[0] == "sparse_jit", sp.considered
    if kind == "cc":  # the cast E(x, y) join is priced at its dense size
        assert sp.considered["dense_gsn"].flops_per_iter > 6000.0 ** 2
