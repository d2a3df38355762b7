"""Port parity: the packed-FIFO server, the family machinery and the
pieces of the planner, runners and fixpoint they call.

``repro_torch.launch.datalog_serve.DatalogServer`` on CPU databases
against ``repro.launch.datalog_serve.DatalogServer`` on the same host
buffers, fed the same request streams: answers bit for bit (bool, trop,
maxplus), per-request ``iters``, delivery order and the ``stats``
counters must be equal, over the cases ``tests/test_serve.py`` covers
(buckets and compile-cache reuse, padding rows, mixed families, the COO
override, FGH Π₂, bad sources, update fences, merge/delete/increase
repairs, edge-fed inits).  The query-batch mesh is held in
``tests/test_torch_mesh.py``, graph-sharded serving in
``tests/test_torch_sharded.py``.
Also here: the planner's
``source_init(backend=)`` / ``spmm_exec_backend``, the CPU ``"fused"``
fixpoint backend and ``bool_round_packed``, and the runners'
``serve_chunk_fn``, each against the reference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import planner as jplanner
from repro.core import runners as jrunners
from repro.datalog import datasets as jdata
from repro.datalog import programs as jprograms
from repro.kernels import coo_spmm as jspmm
from repro.launch.datalog_serve import DatalogServer as JServer
from repro.serve import family as jfam
from repro.sparse import fixpoint as jfx
from repro.sparse.coo import SparseRelation as JRel
from repro_torch.core import planner, runners, vectorize
from repro_torch.core.program import run_program
from repro_torch.datalog import programs
from repro_torch.kernels import coo_spmm
from repro_torch.launch.datalog_serve import (DatalogServer,
                                              _subst_sources, _bucket,
                                              fgh_make_program)
from repro_torch.serve import family as fam_mod
from repro_torch.sparse import fixpoint as fx

from torch_serve_pairs import (LongestPath, Pair, Sssp, bm_dbs,
                               bridge_edges, jmk_bm, np_of, pmk_bm,
                               port_rel)

LATTICES = ("bool", "trop", "maxplus")


def _pair(**kw):
    return Pair(JServer(**kw), DatalogServer(**kw))


def test_bucket():
    assert [_bucket(b, 64) for b in (1, 2, 3, 5, 8, 33, 64, 200)] == \
        [1, 2, 4, 8, 8, 64, 64, 64]


@pytest.mark.parametrize("sparse", [True, False])
def test_served_answers_match_reference(sparse):
    """Π₂ on a sparse and a dense operator: every answer, count and
    counter equal the reference server's, and the engine's."""
    jdb, db = bm_dbs(sparse=sparse)
    pr = _pair(max_batch=8)
    _, pf = pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    assert pf.backend == ("sparse" if sparse else "dense")
    for s in (0, 7, 31, 99, 5, 5):
        pr.submit("reach", s)
    assert pr.run_until_idle() == 6
    pr.check()
    want, _ = run_program(pmk_bm(31), db.with_storage("E", "dense"),
                          mode="seminaive")
    assert torch.equal(pr.reqs[2][1].result, want)


def test_compile_cache_reuse_and_buckets():
    """Same bucket → cache hit, new bucket → one miss, a lone query takes
    the latency route: the counters move together in both packages."""
    jdb, db = bm_dbs()
    pr = _pair(max_batch=8, warm_answers=0)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    for s in range(8):
        pr.submit("reach", s)
    pr.run_until_idle()
    assert pr.p.stats["cache_misses"] == 1
    for s in range(16):
        pr.submit("reach", s)
    pr.run_until_idle()
    assert (pr.p.stats["cache_misses"], pr.p.stats["cache_hits"]) == (1, 2)
    pr.submit("reach", 3)
    pr.run_until_idle()
    assert pr.p.stats["latency_routed"] == 1
    pr.submit("reach", 3)
    pr.submit("reach", 5)
    pr.run_until_idle()
    assert pr.p.stats["cache_misses"] == 2
    pr.check()


def test_padding_rows_do_not_leak():
    jdb, db = bm_dbs()
    pr = _pair(max_batch=8)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    for s in (11, 22, 33):
        pr.submit("reach", s)
    pr.run_until_idle()
    assert pr.p.stats["padded_rows"] == 1
    pr.check()


def test_mixed_families_interleaved():
    """BM on a CPU bool operator and SSSP on the trop tensor E3 (no
    override): the packer groups per family in arrival order."""
    jdb, db = bm_dbs()
    ss = Sssp(n=60, deg=2.5, seed=4, dmax=40)
    pr = _pair(max_batch=4)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    pr.register("sssp", ss.jmk, ss.jdb, ss.pmk, ss.db)
    for i in range(6):
        pr.submit("reach", 2 * i)
        pr.submit("sssp", 3 * i)
    pr.run_until_idle()
    pr.check()


def test_sparse_edges_override():
    """SSSP with the weighted COO override: the family's operator is the
    given relation, served batched."""
    ss = Sssp(n=80, wmax=6, seed=5, deg=2.5, dmax=48)
    pr = _pair(max_batch=4)
    _, pf = pr.register("sssp", ss.jmk, ss.jdb, ss.pmk, ss.db,
                        jedges=ss.jrel, pedges=ss.rel)
    assert pf.backend == "sparse"
    for s in (0, 13, 42):
        pr.submit("sssp", s)
    pr.run_until_idle()
    pr.check()
    want, _ = run_program(ss.pmk(42), ss.db, mode="seminaive")
    assert torch.equal(pr.reqs[2][1].result, want)


def _lattice_family(sr_name):
    """(jmk, jdb, pmk, db, register kwargs, a stored edge, a merge
    weight) for a family of each lattice: BM (bool), SSSP over its COO
    override (trop), longest paths over a stored W (maxplus)."""
    if sr_name == "bool":
        jdb, db = bm_dbs(n=90, seed=8)
        e = db.relations["E"].as_np().coords[0]
        return jmk_bm, jdb, pmk_bm, db, {}, [int(x) for x in e], None
    if sr_name == "trop":
        ss = Sssp(n=90, seed=6)
        return (ss.jmk, ss.jdb, ss.pmk, ss.db,
                {"jedges": ss.jrel, "pedges": ss.rel},
                [int(x) for x in ss.g.edges[0]], 1.0)
    lp = LongestPath()
    return lp.jmk, lp.jdb, lp.pmk, lp.db, {}, \
        [int(x) for x in lp.edges[0]], 9.0


@pytest.mark.parametrize("op", [None, "merge", "delete"])
@pytest.mark.parametrize("sr_name", LATTICES)
def test_lattice_families(sr_name, op):
    """A family of each lattice served batched, then (``op``) updated and
    served again: answers, counts and counters equal the reference's,
    warm repairs included."""
    jmk, jdb, pmk, db, kw, e0, w = _lattice_family(sr_name)
    pr = _pair(max_batch=4)
    pr.register("f", jmk, jdb, pmk, db, **kw)
    sources = (0, e0[0], 9, 33, 50)
    for s in sources:
        pr.submit("f", s)
    pr.run_until_idle()
    if op is not None:
        coords = [e0] if op == "delete" else [[e0[0], e0[1] + 1]]
        pr.submit_update("f", coords, None if op == "delete" or w is None
                         else [w], op=op)
        for s in sources:
            pr.submit("f", s)
        pr.run_until_idle()
    pr.check()
    assert all(p.error is None for _, p in pr.reqs)


def test_fgh_route_serves_every_source():
    """Π₂ synthesized by the port's FGH at two placeholder sources serves
    arbitrary sources through constant substitution; the answers equal
    the reference server's on the published Π₂."""
    jdb, db = bm_dbs(n=60)
    make_program = fgh_make_program(lambda a: programs.bm(a=a),
                                    ["E", "V"])
    want, _ = run_program(programs.bm(a=7).optimized,
                          db.with_storage("E", "dense"), mode="seminaive")
    got, _ = run_program(make_program(7), db.with_storage("E", "dense"))
    assert torch.equal(got, want)
    pr = _pair(max_batch=4)
    pr.j.register("reach", jmk_bm, jdb)
    pr.p.register("reach", make_program, db)
    for s in (0, 1, 7, 29, 53):
        pr.submit("reach", s)
    pr.run_until_idle()
    pr.check()


def test_subst_sources_refuses_a_structural_mismatch():
    p0 = programs.bm(a=0).optimized
    with pytest.raises(ValueError):
        _subst_sources(p0, programs.cc().optimized, (0, 1), 5)
    p5 = _subst_sources(p0, programs.bm(a=1).optimized, (0, 1), 5)
    assert fam_mod._source_equiv(p0, p5, 0, 5)


def test_bad_source_fails_alone():
    """A source whose program changes the linear operator fails its own
    request; the rest of its batch is served (same counters)."""
    jdb, db = bm_dbs(n=60)

    def jmk(a):
        return jprograms.cc().optimized if a == 13 else jmk_bm(a)

    def pmk(a):
        return programs.cc().optimized if a == 13 else pmk_bm(a)

    pr = _pair(max_batch=8)
    pr.register("reach", jmk, jdb, pmk, db)
    for s in (2, 13, 41):
        pr.submit("reach", s)
    pr.run_until_idle()
    pr.check()
    bad = pr.reqs[1][1]
    assert bad.result is None and "linear operator" in bad.error
    assert (pr.p.stats["failed"], pr.p.stats["served"]) == (1, 2)


def test_non_lattice_family_rejected():
    b = programs.mlm()
    from repro_torch.datalog import datasets
    db = b.make_db(datasets.random_recursive_tree(20, seed=1), device="cpu")
    with pytest.raises(ValueError, match="lacks"):
        DatalogServer().register("mlm", lambda a: b.optimized, db)


def test_unknown_family_or_op_rejected():
    server = DatalogServer()
    with pytest.raises(KeyError, match="unknown family"):
        server.submit("nope", 0)
    with pytest.raises(KeyError, match="unknown family"):
        server.submit_update("nope", [[0, 1]])
    _, db = bm_dbs(n=20)
    server.register("reach", pmk_bm, db)
    with pytest.raises(ValueError, match="unknown update op"):
        server.submit_update("reach", [[0, 1]], op="upsert")
    with pytest.raises(ValueError, match="larger"):
        server.submit_update("reach", [[0, 1]], op="increase")


def test_mesh_raises():
    """A mesh is a GraphMesh or a ShardMesh with a data axis, and a
    graph-sharded family needs a GraphMesh: both entries refuse anything
    else instead of serving on one device quietly."""
    with pytest.raises(TypeError, match="ShardMesh"):
        DatalogServer(mesh=object())
    _, db = bm_dbs(n=20)
    with pytest.raises(TypeError, match="GraphMesh"):
        fam_mod.build_family("reach", pmk_bm, db, graph_mesh=object())


# --------------------------------------------------------------------------
# streaming updates
# --------------------------------------------------------------------------


def _bridge_pair(**kw):
    edges, h = bridge_edges()
    jdb, db = bm_dbs(n=80, edges=edges)
    pr = _pair(**kw)
    fams = pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    return pr, fams, db, h


def test_update_acknowledged_before_later_queries():
    """FIFO through the shared queue: q1 predates the merge, q2 follows
    it and warm-hits the repaired answer."""
    pr, _, db, h = _bridge_pair(max_batch=8)
    pr.submit("reach", 0)
    pr.submit_update("reach", [[10, h]])
    pr.submit("reach", 0)
    pr.run_until_idle()
    pr.check()
    q1, u, q2 = (p for _, p in pr.reqs)
    assert not q1.result[h:].any() and q2.result[h:].all()
    assert u.applied and u.latency_s >= 0
    assert (pr.p.stats["warm_hits"], pr.p.stats["answers_repaired"]) == \
        (1, 1)
    want, _ = run_program(pmk_bm(0), db.with_relations(
        {"E": db.relations["E"].apply_delta([[10, h]])}))
    assert torch.equal(q2.result, want)


def test_update_compile_cache_survives_mutations():
    """Updates — one past the COO capacity — re-plan nothing: no new
    compile-cache misses, the same signature."""
    pr, (_, pf), db, h = _bridge_pair(max_batch=4, warm_answers=0)
    sig0 = pf.plan.signature
    for s in (0, 1, 2, 3):
        pr.submit("reach", s)
    pr.run_until_idle()
    misses0 = pr.p.stats["cache_misses"]
    cap = pf.edges.capacity
    pr.submit_update("reach", [[10, h]])
    rng = np.random.default_rng(0)
    big = np.stack([rng.integers(0, 80, cap + 8),
                    rng.integers(0, 80, cap + 8)], 1)
    pr.submit_update("reach", big)
    for s in (0, 1, 2, 3):
        pr.submit("reach", s)
    pr.run_until_idle()
    assert pf.edges.capacity > cap and pf.plan.signature == sig0
    assert pr.p.stats["cache_misses"] == misses0
    assert pr.p.stats["updates"] == 2
    pr.check()


def test_warm_answers_repaired_in_one_pass():
    pr, _, _, h = _bridge_pair(max_batch=8)
    sources = (0, 3, 9, 11)
    for s in sources:
        pr.submit("reach", s)
    pr.run_until_idle()
    pr.submit_update("reach", [[10, h], [h + 3, 2]])
    pr.run_until_idle()
    assert pr.p.stats["answers_repaired"] == len(sources)
    for s in sources:
        pr.submit("reach", s)
    pr.run_until_idle()
    assert pr.p.stats["warm_hits"] == len(sources)
    pr.check()


def test_delete_update_repairs_warm_answers_and_serves_fresh():
    """A delete repairs the cached answer through the synthesized
    ⊖/recount rule; the post-delete query warm-hits the repair."""
    pr, _, db, h = _bridge_pair(max_batch=4)
    pr.submit("reach", 0)
    pr.submit_update("reach", [[10, h]])
    pr.run_until_idle()
    pr.submit_update("reach", [[10, h]], op="delete")
    pr.submit("reach", 0)
    pr.run_until_idle()
    pr.check()
    assert pr.p.stats["answers_dropped"] == 0
    assert pr.p.stats["answers_repaired"] == 2
    q = pr.reqs[-1][1]
    want, _ = run_program(pmk_bm(0), db)
    assert not q.result[h:].any() and torch.equal(q.result, want)


@pytest.mark.parametrize("op", ["merge", "increase", "delete"])
def test_update_weighted_override_family(op):
    """Updates against the weighted SSSP override: a monotone weight
    decrease (merge), a weight increase and a delete each repair the
    warm distances, equal to the reference's and to a cold run on the
    mutated operator."""
    ss = Sssp(n=60, wmax=6, seed=11, deg=2.5, dmax=48)
    pr = _pair(max_batch=4)
    pr.register("sssp", ss.jmk, ss.jdb, ss.pmk, ss.db, jedges=ss.jrel,
                pedges=ss.rel)
    e0 = [int(x) for x in ss.g.edges[0]]
    for s in (0, e0[0], 7):
        pr.submit("sssp", s)
    pr.run_until_idle()
    coords, vals = {"merge": ([[0, 42]], [1.0]),
                    "increase": ([e0], [9.0]),
                    "delete": ([e0], None)}[op]
    pr.submit_update("sssp", coords, vals, op=op)
    for s in (0, e0[0], 7):
        pr.submit("sssp", s)
    pr.run_until_idle()
    pr.check()
    assert pr.p.stats["answers_repaired"] == len({0, e0[0], 7})
    assert pr.p.stats["warm_hits"] == 3
    rel = ss.rel.delete_keys(coords) if op != "merge" else ss.rel
    if op != "delete":
        rel = rel.apply_delta(coords, vals)
    init = torch.full((60,), float("inf"))
    init[e0[0]] = 0.0
    want, _ = fx.fixpoint(rel, init, mode="frontier")
    assert torch.equal(pr.reqs[-2][1].result, want)


def test_update_edge_fed_init_family_recomputes_cold():
    """An init term that reads the edge relation: updates drop the warm
    answers and the memoized inits, later queries recompute cold."""
    from repro.core import engine as jengine
    from repro.core import ir as jir
    from repro.core.program import Program as JProgram
    from repro.core.program import Rule as JRule
    from repro.core.program import Stratum as JStratum
    from repro_torch.core import engine, ir
    from repro_torch.core.program import Program, Rule, Stratum

    n = 6

    def make(irm, P, R, S, schema):
        def mk(a):
            body = irm.SSP(("y",), (
                irm.Term((irm.RelAtom("E", (irm.C(a), "y")),), ()),
                irm.Term((irm.RelAtom("Q", ("z",)),
                          irm.RelAtom("E", ("z", "y"))), ("z",))), "bool")
            return P("edge_init", schema, [S({"Q": R("Q", body)})],
                     [R("Qans", irm.SSP(("y",), (irm.Term(
                         (irm.RelAtom("Q", ("y",)),), ()),), "bool"))])
        return mk

    jschema = jprograms.bm(a=0).original.schema
    pschema = programs.bm(a=0).original.schema
    jrel = JRel.from_coo([[1, 2]], [True], (n, n), "bool", capacity=8)
    jdb = jengine.Database(jschema, {"id": n},
                           {"E": jrel, "V": jnp.ones((n,), bool)})
    db = engine.Database(pschema, {"id": n},
                         {"E": port_rel(jrel),
                          "V": torch.ones(n, dtype=torch.bool)}, "cpu")
    pr = _pair(max_batch=4)
    _, pf = pr.register("ei", make(jir, JProgram, JRule, JStratum, jschema),
                        jdb, make(ir, Program, Rule, Stratum, pschema), db)
    assert pf.init_reads_edges and pf.fast_init is None
    pr.submit("ei", 0)
    pr.run_until_idle()
    pr.submit_update("ei", [[0, 1]])
    pr.submit("ei", 0)
    pr.run_until_idle()
    pr.check()
    assert pr.p.stats["answers_dropped"] == 1
    assert pr.reqs[-1][1].result.any()


# --------------------------------------------------------------------------
# the planner, runner and fixpoint pieces the family calls
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bm", "sssp"])
def test_source_init_backend_matches_reference(kind):
    """``planner.source_init(..., backend=)`` / ``vectorize.init_vector``
    on a CPU database: the np backend returns the reference's numpy
    array (dtype included), the torch backend the same values."""
    if kind == "bm":
        jdb, db = bm_dbs(n=50)
        jmk, pmk = jmk_bm, pmk_bm
    else:
        ss = Sssp(n=50)
        jdb, db, jmk, pmk = ss.jdb, ss.db, ss.jmk, ss.pmk
    jplan = jplanner.plan_program(jmk(0), jdb, objective="throughput")
    plan = planner.plan_program(pmk(0), db, objective="throughput")
    for s in (0, 17, 49):
        want = jplanner.source_init(jplan, jmk(s), jdb, backend="np")
        got = planner.source_init(plan, pmk(s), db, backend="np")
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert np.array_equal(got, want)
        t = planner.source_init(plan, pmk(s), db)
        assert isinstance(t, torch.Tensor)
        assert np.array_equal(t.numpy(), want)
        vf = vectorize.vector_form(pmk(s))
        assert np.array_equal(vectorize.init_vector(vf, db, backend="np"),
                              want)


def test_spmm_exec_backend_follows_the_device():
    for dev in ("cuda", torch.device("cuda", 0)):
        assert planner.spmm_exec_backend("sparse_frontier_pallas",
                                         dev) == "kernel"
    assert planner.spmm_exec_backend("sparse_frontier_pallas",
                                     "cpu") == "fused"
    assert jplanner.spmm_exec_backend("sparse_frontier_pallas") == "fused"
    for r in ("sparse_jit", "sparse_frontier", "vector_dense"):
        assert planner.spmm_exec_backend(r, "cuda") == "torch"
        assert planner.spmm_exec_backend(r, "cpu") == "torch"
    assert runners.get("sparse_frontier_pallas").backend(
        port_rel(JRel.from_coo([[0, 1]], [True], (4, 4), "bool"))) == "fused"
    # the rule lives with the runners; the planner's entry point forwards
    for r in ("sparse_frontier_pallas", "sparse_jit", "sparse_frontier"):
        for dev in ("cpu", "cuda"):
            assert runners.spmm_exec_backend(r, dev) == \
                planner.spmm_exec_backend(r, dev)


def _lattice(sr_name, n=150, seed=3):
    g = jdata.erdos_renyi(n, 2.5, seed=seed, weighted=True, wmax=6)
    e = g.edges
    if sr_name == "maxplus":
        e = e[e[:, 0] < e[:, 1]]
    rng = np.random.default_rng(seed)
    w = np.ones(len(e), bool) if sr_name == "bool" else \
        rng.integers(1, 6, len(e)).astype(np.float32)
    jrel = JRel.from_coo(e, w, (n, n), sr_name, lib="np")
    srn = {"bool": (False, True), "trop": (np.inf, 0.0),
           "maxplus": (-np.inf, 0.0)}[sr_name]
    init = np.full((6, n), srn[0], bool if sr_name == "bool"
                   else np.float32)
    for b, s in enumerate(rng.choice(n, 5, replace=False)):
        init[b, s] = srn[1]     # row 5 stays inert 0̄ padding
    return jrel, port_rel(jrel), init


@pytest.mark.parametrize("sr_name", LATTICES)
def test_fused_backend_matches_reference(sr_name):
    """The CPU ``"fused"`` backend: cold runs and chained chunks equal
    the reference's ``_fused_host_fixpoint`` / ``_fused_resume_chunk`` —
    values, per-row counts, live masks — and the torch backend's."""
    jrel, rel, init = _lattice(sr_name)
    want, wit = jfx.fixpoint(jrel, init, mode="jit", backend="fused")
    got, it = fx.fixpoint(rel, torch.from_numpy(init), backend="fused")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(it.numpy(), np.asarray(wit))
    tor, tit = fx.fixpoint(rel, torch.from_numpy(init), backend="torch")
    assert torch.equal(got, tor) and torch.equal(it, tit)
    one, one_it = fx.fixpoint(rel, torch.from_numpy(init[0]),
                              backend="fused")
    assert torch.equal(one, got[0]) and one_it == int(it[0])
    jst = jfx.FixpointState.cold(jrel, init)
    st = fx.FixpointState.cold(rel, torch.from_numpy(init))
    for _ in range(4):
        jst = jfx.fixpoint(jrel, state=jst, budget=2, backend="fused")
        st = fx.fixpoint(rel, state=st, budget=2, backend="fused")
        assert np.array_equal(st.y.numpy(), np.asarray(jst.y))
        assert np.array_equal(st.delta.numpy(), np.asarray(jst.delta))
        assert np.array_equal(st.iters.numpy(), np.asarray(jst.iters))


def test_fused_backend_refuses_other_devices():
    """``"fused"`` is a CPU backend, never a way around B1: a relation
    or carry elsewhere raises (the meta device stands in for the card
    here; ``tests/test_torch_gpu.py`` checks CUDA)."""
    _, rel, init = _lattice("bool", n=30)
    meta = rel.to("meta")
    with pytest.raises(ValueError, match="fused"):
        fx.fixpoint(meta, torch.from_numpy(init).to("meta"),
                    backend="fused")
    with pytest.raises(ValueError, match="fused"):
        fx.fixpoint(rel, torch.from_numpy(init).to("meta"),
                    backend="fused")


def test_bool_round_packed_matches_reference():
    rng = np.random.default_rng(4)
    jrel, rel, _ = _lattice("bool", n=130)
    jplan = jspmm.plan_geometry(jrel.as_np(), transpose=True)
    plan = coo_spmm.plan_geometry(rel, transpose=True)
    for b in (1, 64, 100):
        x = rng.random((b, 130)) < 0.1
        wj = jspmm.pack_lanes(x)
        w = coo_spmm.pack_lanes(torch.from_numpy(x))
        assert np.array_equal(w.numpy(), wj)
        got = coo_spmm.bool_round_packed(plan, w)
        assert got.dtype == torch.uint64
        assert np.array_equal(got.numpy(), jspmm.bool_round_packed(jplan,
                                                                   wj))
        live = coo_spmm.packed_live(got, b).numpy()
        assert np.array_equal(live, jfx._packed_live(
            jspmm.bool_round_packed(jplan, wj), b))
    with pytest.raises(ValueError, match="host"):
        coo_spmm.bool_round_packed(plan, w.view(torch.int64).to("meta"))


@pytest.mark.parametrize("runner", ["sparse_jit",
                                    "sparse_frontier_pallas"])
@pytest.mark.parametrize("sr_name", LATTICES)
def test_serve_chunk_fn_matches_reference(runner, sr_name):
    """``Runner.serve_chunk_fn(k)``: chained chunks over a (B, n) carry
    equal the reference runner's chunk function, carry for carry."""
    jrel, rel, init = _lattice(sr_name, n=90)
    jchunk = jrunners.get(runner).serve_chunk_fn(3)
    chunk = runners.get(runner).serve_chunk_fn(3)
    jst = jfx.FixpointState.cold(jrel, init)
    jy, jd, jit = jst.y, jst.delta, jst.iters
    st = fx.FixpointState.cold(rel, torch.from_numpy(init))
    y, d, it = st.y, st.delta, st.iters
    for _ in range(5):
        jy, jd, jit = jchunk(jrel.as_jnp(), jy, jd, jit)
        y, d, it = chunk(rel, y, d, it)
        assert np.array_equal(y.numpy(), np.asarray(jy))
        assert np.array_equal(d.numpy(), np.asarray(jd))
        assert np.array_equal(it.numpy(), np.asarray(jit))


def test_family_device_and_warm_answers_are_tensors():
    """A CPU family: operator, warm answers and the packed run's answers
    are tensors on its device; inits stay numpy on the host."""
    ss = Sssp(n=40)
    server = DatalogServer(max_batch=4)
    fam = server.register("sssp", ss.pmk, ss.db, edges=ss.rel)
    assert fam.device == torch.device("cpu")
    assert fam.host_db.device == torch.device("cpu")
    assert isinstance(fam_mod.family_init(fam, 3), np.ndarray)
    jfam_ = jfam.build_family("sssp", ss.jmk, ss.jdb, edges=ss.jrel)
    assert np.array_equal(fam_mod.family_init(fam, 3),
                          jfam.family_init(jfam_, 3))
    for s in (1, 2, 3):
        server.submit("sssp", s)
    server.run_until_idle()
    assert all(isinstance(v, torch.Tensor) and v.device == fam.device
               for _, v in fam.answers.items())
    assert np_of(fam.answers.peek(3)).dtype == np.float32
