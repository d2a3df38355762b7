"""Port parity: the FGH synthesis stack and the engine's numpy backend.

``repro_torch.core.{constraints, egraph, verify, invariants, synthesis,
fgh}`` against their ``repro.core`` twins, and the np backend of
``eval_ssp`` / ``make_ico`` against the reference's, on the same numpy
inputs:

* the np backend on every ported benchmark's rule bodies, bit for bit
  (real: ``atol = rtol = 1e-4``);
* ``sample_database`` / ``sample_dbs`` draw the same databases from one
  seed;
* the ``tests/test_egraph.py`` cases on the port's e-graph, and the
  same extractions as the reference's;
* ``verify_h`` accepts the published H and rejects the wrong H of
  ``tests/test_fgh.py``; ``infer_invariants`` mines the same
  invariants;
* ``fgh.optimize(task, rng=default_rng(0))`` over the seven cases of
  ``tests/test_fgh.py``: the same ``ok``, ``method`` and printed H
  (``ir.ssp_str``), and the port's Π₂ gives the reference Π₂'s answers
  on ``tests/test_fgh.py``'s graphs.
"""

import functools

import numpy as np
import pytest
import torch

from repro.core import constraints as jgamma
from repro.core import egraph as jegraph
from repro.core import engine as jengine
from repro.core import fgh as jfgh
from repro.core import invariants as jinv
from repro.core import ir as jir
from repro.core import program as jprogram
from repro.core import verify as jverify
from repro.datalog import datasets as jdata
from repro.datalog import programs as jprograms
from repro.sparse.coo import SparseRelation as JRel
from repro_torch.core import constraints as gamma
from repro_torch.core import egraph, engine, fgh, invariants, ir, program
from repro_torch.core import verify
from repro_torch.core.egraph import (EGraph, SEMIRING_RULES,
                                     equivalent_under)
from repro_torch.datalog import programs

#: tests/test_fgh.py's cases: (benchmark, EDBs, expected method)
CASES = {
    "CC": ("cc", ["E", "V"], "rule"),
    "BM": ("bm", ["E", "V"], "rule"),
    "SSSP": ("sssp", ["E3"], "rule"),
    "WS": ("ws", ["A2"], "cegis"),
    "MLM": ("mlm", ["E", "V"], "cegis"),
    "R": ("radius", ["E", "V"], "cegis"),
    "APSP100": ("apsp100", ["Ew"], "cegis"),
}


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


def _port_db(jdb) -> engine.Database:
    rels = {}
    for name, v in jdb.relations.items():
        if isinstance(v, JRel):
            h = v.as_np()
            rels[name] = dict(coords=h.coords, values=h.values, nnz=h.nnz,
                              shape=h.shape, semiring=h.semiring)
        else:
            rels[name] = np.asarray(v)
    return engine.Database.from_numpy(jdb.schema, jdb.domains, rels,
                                      device="cpu")


def _dataset_for(name):
    """tests/test_fgh.py's graphs."""
    if name in ("MLM", "R"):
        return jdata.random_recursive_tree(25, seed=3)
    if name == "WS":
        return jdata.vector_data(20, seed=0, vmax=6)
    if name in ("SSSP", "APSP100"):
        return jdata.erdos_renyi(20, 2.0, seed=4, weighted=True, wmax=4)
    return jdata.erdos_renyi(20, 2.0, seed=4)


def _task(pkg_programs, pkg_verify, name):
    mk, edbs, _ = CASES[name]
    b = getattr(pkg_programs, mk)()
    return b, pkg_verify.task_from_program(b.original, edbs,
                                           constraint=b.constraint)


@functools.lru_cache(maxsize=None)
def _optimized(name):
    """Both packages' optimizer reports for one case (seed 0)."""
    jb, jtask = _task(jprograms, jverify, name)
    tb, task = _task(programs, verify, name)
    jrep = jfgh.optimize(jtask, rng=np.random.default_rng(0))
    rep = fgh.optimize(task, rng=np.random.default_rng(0))
    return jb, jrep, tb, rep


# --------------------------------------------------------------------------
# the engine's numpy backend
# --------------------------------------------------------------------------


BENCHES = ("bm", "cc", "sssp", "ws", "radius", "mlm", "apsp100",
           "simple_magic")


@pytest.mark.parametrize("name", BENCHES)
def test_np_backend_matches_reference(name):
    """Every rule body, init and output of Π₁ and Π₂, evaluated with
    ``backend="np"`` in both packages, over the reference's state after
    two ICO rounds; ``zero_state``/``init_state``/``make_ico`` too."""
    jb, tb = getattr(jprograms, name)(), getattr(programs, name)()
    data = _dataset_for({"ws": "WS", "radius": "R", "mlm": "MLM",
                         "sssp": "SSSP", "apsp100": "APSP100"}.get(name,
                                                                   "BM"))
    jdb = jb.make_db(data)
    jdb = jengine.Database(jdb.schema, jdb.domains,
                           {k: np.asarray(v) for k, v in
                            jdb.relations.items()})
    db = _port_db(jdb)
    for which in ("original", "optimized"):
        jp, tp = getattr(jb, which), getattr(tb, which)
        hints = dict(jp.sort_hints)
        for js, ts in zip(jp.strata, tp.strata):
            jx = jprogram.init_state(js, jdb, hints, backend="np")
            tx = program.init_state(ts, db, hints, backend="np")
            for k in jx:
                assert isinstance(tx[k], np.ndarray)
                assert_match(tx[k], jx[k], jp.schema[k].semiring)
            z = program.zero_state(ts, db, backend="np")
            assert all(isinstance(v, np.ndarray) for v in z.values())
            jico = jprogram.make_ico(js, jdb, hints, backend="np")
            tico = program.make_ico(ts, db, hints, backend="np")
            for _ in range(2):
                jn, tn = jico(jx), tico(tx)
                for k in jn:
                    assert_match(tn[k], jn[k], jp.schema[k].semiring)
                jx, tx = jn, {k: np.asarray(v) for k, v in jn.items()}
            jcur = jdb.with_relations(jx)
            cur = db.with_relations(tx)
            for jr, tr in zip(list(js.rules.values()) + list(jp.outputs),
                              list(ts.rules.values()) + list(tp.outputs)):
                want = jengine.eval_ssp(jr.body, jcur, hints, backend="np")
                got = engine.eval_ssp(tr.body, cur, hints, backend="np")
                assert isinstance(got, np.ndarray)
                assert_match(got, want, tr.body.semiring)
                # and the torch backend on the same CPU database
                assert_match(engine.eval_ssp(tr.body, cur, hints), want,
                             tr.body.semiring)
                jcur = jcur.with_relations({jr.head: want})
                cur = cur.with_relations({tr.head: got})


def test_np_backend_densifies_sparse_relations():
    """The np backend reads a sparse relation densified, as the
    reference's does; the torch backend keeps it sparse."""
    jb, tb = jprograms.bm(a=0), programs.bm(a=0)
    g = jdata.erdos_renyi(30, 2.0, seed=2)
    jdb = jengine.Database(jb.original.schema, {"id": g.n},
                           {"E": g.sparse_adjacency(),
                            "V": g.vertex_set()})
    db = _port_db(jdb)
    body = tb.optimized.strata[0].rules["Q"].body
    state = {"Q": np.random.default_rng(0).random(30) < 0.3}
    want = jengine.eval_ssp(jb.optimized.strata[0].rules["Q"].body,
                            jdb.with_relations(state), {}, backend="np")
    got = engine.eval_ssp(body, db.with_relations(state), {}, backend="np")
    assert_match(got, want, "bool")
    assert_match(engine.eval_ssp(body, db.with_relations(state), {}),
                 want, "bool")
    with pytest.raises(ValueError, match="unknown engine backend"):
        engine.eval_ssp(body, db, {}, backend="jnp")


@pytest.mark.parametrize("sr_name", ["bool", "trop", "maxplus", "nat",
                                     "real"])
def test_np_matmul_matches_reference(sr_name):
    from repro.core import semiring as jsr
    rng = np.random.default_rng(3)
    sr = jsr.get(sr_name, lib="np")
    a = rng.integers(0, 3, (7, 5)).astype(sr.dtype)
    b = rng.integers(0, 3, (5, 4)).astype(sr.dtype)
    if sr_name == "bool":
        a, b = rng.random((7, 5)) < 0.3, rng.random((5, 4)) < 0.3
    want = jengine._np_matmul(sr, a, b)
    from repro_torch.core import semiring as tsr
    got = engine._np_matmul(tsr.get(sr_name, lib="np"), a, b)
    assert_match(got, want, sr_name)


# --------------------------------------------------------------------------
# Γ-constrained sampling
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES) + ["dag", "exhaustive"])
def test_sampled_databases_are_the_references(name):
    """One seed, the same draws: ``sample_database`` (with each
    constraint), ``exhaustive_databases`` and ``sample_dbs``."""
    case = "BM" if name in ("dag", "exhaustive") else name
    jb, jtask = _task(jprograms, jverify, case)
    tb, task = _task(programs, verify, case)
    if name == "exhaustive":
        doms = {**task.small_domains, "id": 2}
        want = list(jgamma.exhaustive_databases(jtask.schema, jtask.edbs,
                                                doms, limit=8))
        got = list(gamma.exhaustive_databases(task.schema, task.edbs,
                                              doms, limit=8))
    elif name == "dag":
        doms = {**task.small_domains, "id": 5}
        want = [jgamma.sample_database(jtask.schema, jtask.edbs, doms,
                                       np.random.default_rng(s),
                                       constraint="dag")
                for s in range(4)]
        got = [gamma.sample_database(task.schema, task.edbs, doms,
                                     np.random.default_rng(s),
                                     constraint="dag") for s in range(4)]
    else:
        want = jverify.sample_dbs(jtask, np.random.default_rng(5), 6)
        got = verify.sample_dbs(task, np.random.default_rng(5), 6)
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.domains == w.domains
        assert sorted(g.relations) == sorted(w.relations)
        for k, v in w.relations.items():
            assert_match(g.relations[k], v, task.schema[k].semiring)


# --------------------------------------------------------------------------
# the e-graph (tests/test_egraph.py's cases)
# --------------------------------------------------------------------------


def test_egraph_congruence_closure():
    g = EGraph()
    a, b = g.add_term("a"), g.add_term("b")
    fa, fb = g.add_term(("f", "a")), g.add_term(("f", "b"))
    assert not g.eq(fa, fb)
    g.merge(a, b)
    g.rebuild()
    assert g.eq(fa, fb)


@pytest.mark.parametrize("lhs, rhs, equal", [
    (("mul", "a", ("add", "b", "c")),
     ("add", ("mul", "a", "b"), ("mul", "a", "c")), True),
    (("mul", "a", "one"), "a", True),
    (("mul", "a", "b"), ("mul", "b", "a"), True),
    (("mul", "a", "b"), ("mul", "a", "c"), False),
])
def test_egraph_semiring_rules(lhs, rhs, equal):
    assert equivalent_under(SEMIRING_RULES, lhs, rhs) is equal
    assert jegraph.equivalent_under(jegraph.SEMIRING_RULES, lhs,
                                    rhs) is equal


def test_egraph_equivalence_under_constraint():
    constraint = [(("mul", "E", "T"), "E")]
    a, b = ("mul", ("mul", "E", "T"), "x"), ("mul", "E", "x")
    assert equivalent_under(SEMIRING_RULES, a, b, constraints=constraint)
    assert not equivalent_under(SEMIRING_RULES, a, b)


def test_egraph_denormalization_extraction():
    outs = []
    for mod in (egraph, jegraph):
        g = mod.EGraph()
        p1 = g.add_term(("add", ("mul", "X", "E"), "B"))
        view = g.add_term(("mul", "X", "E"))
        g.merge(view, g.add_term("Y"))
        g.rebuild()
        g.run_rules(mod.SEMIRING_RULES, iters=4)
        outs.append(g.extract(p1, forbid_ops={"X"}))
    assert outs[0] is not None and "X" not in str(outs[0]) \
        and "Y" in str(outs[0])
    assert outs[0] == outs[1]


def test_egraph_extraction_respects_cost_and_normalizes():
    g = EGraph()
    big = g.add_term(("mul", ("mul", "a", "one"), "one"))
    g.run_rules(SEMIRING_RULES, iters=4)
    assert g.extract(big) == "a"
    term = ("recount", ("cone_forward", ("cone_tight", ("cone_all", "d"))))
    assert egraph.normalize(term) == jegraph.normalize(term) \
        == "cold_fixpoint"


# --------------------------------------------------------------------------
# the verifier and invariant inference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_verify_h_accepts_the_published_h(name):
    tb, task = _task(programs, verify, name)
    jb, jtask = _task(jprograms, jverify, name)
    h = next(iter(tb.optimized.strata[0].rules.values())).body
    jh = next(iter(jb.optimized.strata[0].rules.values())).body
    res = verify.verify_h(task, h, rng=np.random.default_rng(1))
    want = jverify.verify_h(jtask, jh, rng=np.random.default_rng(1))
    assert res.ok and want.ok
    assert res.points_checked == want.points_checked


def test_verify_h_rejects_the_wrong_h():
    """tests/test_fgh.py's wrong CC H (no min with the node's own label)
    gives the same counterexample in both packages."""
    def wrong_h(m):
        return m.SSP(("x",), (
            m.Term((m.RelAtom("CC", ("y",)),
                    m.RelAtom("E", ("x", "y"), cast=True)), ("y",)),
        ), "trop")

    _, task = _task(programs, verify, "CC")
    _, jtask = _task(jprograms, jverify, "CC")
    res = verify.verify_h(task, wrong_h(ir), rng=np.random.default_rng(0))
    want = jverify.verify_h(jtask, wrong_h(jir),
                            rng=np.random.default_rng(0))
    assert not res.ok and res.counterexample is not None
    assert res.points_checked == want.points_checked
    assert_match(res.counterexample.target, want.counterexample.target,
                 "trop")
    assert_match(res.counterexample.y_in, want.counterexample.y_in, "trop")


@pytest.mark.parametrize("name", list(CASES))
def test_infer_invariants_matches_reference(name):
    _, task = _task(programs, verify, name)
    _, jtask = _task(jprograms, jverify, name)
    got, st = invariants.infer_invariants(task,
                                          rng=np.random.default_rng(0))
    want, wst = jinv.infer_invariants(jtask, rng=np.random.default_rng(0))
    assert [str(i) for i in got] == [str(i) for i in want]
    assert st["candidates"] == wst["candidates"]
    if name == "BM":   # the commutation invariant of Example 3.8
        assert got and fgh.rule_based_synthesis(task, [])[0] is None
        assert fgh.rule_based_synthesis(task, got)[0] is not None


# --------------------------------------------------------------------------
# the optimizer end to end
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_optimize_gives_the_references_h(name):
    """Same ``ok``, ``method`` and printed H as the reference (seed 0),
    and the port's Π₂ gives the reference Π₂'s answers and Π₁'s."""
    jb, jrep, tb, rep = _optimized(name)
    assert rep.ok and jrep.ok, rep.stats
    assert rep.method == jrep.method == CASES[name][2]
    assert ir.ssp_str(rep.h_body) == jir.ssp_str(jrep.h_body)
    jdb = jb.make_db(_dataset_for(name))
    db = _port_db(jdb)
    if jb.original.post is not None:
        jrep.program.post = jb.original.post
        rep.program.post = tb.original.post
    want, wst = jprogram.run_program(jrep.program, jdb)
    got, st = program.run_program(rep.program, db)
    sr_name = rep.program.outputs[-1].body.semiring
    assert_match(got, want, sr_name)
    assert st.iterations == wst.iterations
    orig, _ = program.run_program(tb.original, db)
    assert_match(got, orig, sr_name)
    assert verify.verify_programs_equal(tb.original, rep.program, [db])


def test_synthesized_cc_is_the_published_h():
    """tests/test_fgh.py:49 on the port: CC's H is isomorphic to the
    paper's Fig. 1(b)."""
    _, _, tb, rep = _optimized("CC")
    assert ir.isomorphic(rep.h_body,
                         tb.optimized.strata[0].rules["CC"].body)


def test_update_probes_match_reference():
    """``sample_update_probes`` builds the same probe relations (the
    port's SparseRelation on the CPU) from one seed."""
    for sr_name in ("bool", "trop", "maxplus"):
        got = verify.sample_update_probes(sr_name,
                                          np.random.default_rng(2), 3,
                                          op="increase")
        want = jverify.sample_update_probes(sr_name,
                                            np.random.default_rng(2), 3,
                                            op="increase")
        assert [p.name for p in got] == [p.name for p in want]
        for p, q in zip(got, want):
            assert p.edges.device.type == "cpu"
            h = q.edges.as_np()
            assert np.array_equal(p.edges.coords.numpy(), h.coords)
            assert_match(p.edges.values, h.values, sr_name)
            assert np.array_equal(p.coords, q.coords)
            assert_match(p.init, q.init, sr_name)
            assert_match(p.new_values, q.new_values, sr_name)
