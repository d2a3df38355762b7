"""The planner's measured cost model (``cost_model="hlo"``,
``launch/hlo_cost.py``) against the JAX package.

The reference walks a compiled step's HLO; the port counts an eager
step op by op (``staged_cost``).  Held here on the CPU:

* ``staged_cost`` of one ``a @ b`` and one elementwise add gives the
  reference's FLOPs on the same shapes;
* a hand-written kernel (B1, B2, B3) counts once, as its bound reckons
  it, on every path its plan can take, and none of the ops of its plain
  version count (``tests/test_torch_gpu.py`` holds the CUDA versions to
  the same counts);
* the twin of the reference's ``test_hlo_cost_model_prices_candidates``;
* the runner picked under ``"hlo"`` on BM, CC and SSSP Π₂ is the
  reference's (``HLO_PICKS_DIFFER`` would list a case whose pick
  differs, with both counts; none does);
* an error while staging raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import planner as jplanner
from repro.datalog import datasets as jdata
from repro.datalog import programs as jprograms
from repro.launch import hlo_cost as jhlo
from repro_torch.core import planner, program
from repro_torch.core import semiring as sr_mod
from repro_torch.datalog import datasets, programs
from repro_torch.kernels import coo_segment, coo_spmm, ops, semiring_matmul
from repro_torch.launch import hlo_cost

from test_torch_program import port_db


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape", [(8, 12, 5), (1, 64, 64), (33, 7, 19)])
def test_staged_matmul_flops_equal_the_reference(shape):
    m, k, n = shape
    a = _rng(0).random((m, k), np.float32)
    b = _rng(1).random((k, n), np.float32)
    want = jhlo.staged_cost(lambda x, y: x @ y, jnp.asarray(a),
                            jnp.asarray(b))
    got = hlo_cost.staged_cost(lambda x, y: x @ y, torch.from_numpy(a),
                               torch.from_numpy(b))
    assert got.flops == want.flops == 2.0 * m * k * n
    assert got.bytes == 4.0 * (m * k + k * n + m * n)
    assert got.kernels == {}


@pytest.mark.parametrize("shape", [(8, 12), (1000,)])
def test_staged_add_flops_equal_the_reference(shape):
    a = _rng(0).random(shape, np.float32)
    b = _rng(1).random(shape, np.float32)
    want = jhlo.staged_cost(lambda x, y: x + y, jnp.asarray(a),
                            jnp.asarray(b))
    got = hlo_cost.staged_cost(lambda x, y: x + y, torch.from_numpy(a),
                               torch.from_numpy(b))
    assert got.flops == want.flops == float(a.size)
    assert got.bytes == 3.0 * 4 * a.size


def test_an_expanded_operand_is_read_once():
    x = torch.ones(64, 64)
    row = torch.ones(64)
    got = hlo_cost.staged_cost(lambda a, b: a * b.expand(64, 64), x, row)
    assert got.flops == 64 * 64
    assert got.bytes == 4.0 * (64 * 64 + 64 + 64 * 64)


# -- the kernels --------------------------------------------------------------


def _b2(name, m, k=48, n=40):
    sr = sr_mod.get(name)
    if name == "bool":
        a = torch.from_numpy(_rng(0).random((m, k)) < 0.2)
        b = torch.from_numpy(_rng(1).random((k, n)) < 0.2)
    else:
        a = torch.from_numpy(_rng(0).integers(0, 4, (m, k)).astype(
            np.float32))
        b = torch.from_numpy(_rng(1).integers(0, 4, (k, n)).astype(
            np.float32))
    return (lambda: ops.semiring_matmul(sr, a, b)), \
        semiring_matmul.matmul_cost(name, a, b)


def _operator(name, n=96, deg=5.0):
    g = datasets.erdos_renyi(n, deg, seed=2)
    return g.sparse_adjacency(semiring=name, device="cpu")


def _b1(name, lanes):
    rel = _operator(name)
    plan = coo_spmm.plan_geometry(rel, transpose=True)
    sr = sr_mod.get(name)
    if name == "bool":
        x = torch.from_numpy(_rng(3).random((rel.shape[0], lanes)) < 0.3)
    else:
        x = torch.from_numpy(_rng(3).integers(0, 5, (rel.shape[0], lanes))
                             .astype(np.float32))
        x = torch.where(x == 0, torch.tensor(sr.zero), x)
    return (lambda: ops.coo_spmm(rel, x, transpose=True)), \
        coo_spmm.spmm_cost(plan, x)


def _b3(path, lanes):
    sr = sr_mod.get("trop")
    m, n = 500, 70
    ids = torch.from_numpy(_rng(4).integers(0, n, m).astype(np.int32))
    vals = torch.from_numpy(_rng(5).random((m, lanes) if lanes else (m,))
                            .astype(np.float32))
    if path == "scatter":
        return (lambda: ops.semiring_segment_reduce(sr, vals, ids, n)), \
            coo_segment.segment_cost("trop", vals, ids, n)
    plan = coo_segment.plan_segment(ids, n)
    vals = vals[plan.order]
    return (lambda: ops.semiring_segment_reduce(sr, vals, ids, n,
                                                plan=plan)), \
        coo_segment.segment_cost("trop", vals, ids, n, plan=plan)


#: one call down each path a kernel's plan can take on the card
KERNEL_CASES = {
    "b2_stream_bool": (lambda: _b2("bool", 4), "semiring_matmul/stream"),
    "b2_stream_trop": (lambda: _b2("trop", 16), "semiring_matmul/stream"),
    "b2_tc_bool": (lambda: _b2("bool", 40), "semiring_matmul/tc_bool"),
    "b2_tile_nat": (lambda: _b2("nat", 40), "semiring_matmul/tile_f32"),
    "b2_tile_trop": (lambda: _b2("trop", 17), "semiring_matmul/tile_f32"),
    "b1_words_bool": (lambda: _b1("bool", 64), "coo_spmm/words_bool"),
    "b1_lanes_trop": (lambda: _b1("trop", 8), "coo_spmm/lanes_f32"),
    "b1_lanes_nat": (lambda: _b1("nat", 1), "coo_spmm/lanes_f32"),
    "b3_runs_rows": (lambda: _b3("runs", 8), "coo_segment/runs"),
    "b3_runs_vector": (lambda: _b3("runs", 0), "coo_segment/runs"),
    "b3_scatter": (lambda: _b3("scatter", 4), "coo_segment/scatter"),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_a_kernel_counts_once_as_its_bound_reckons_it(case):
    """One call is one op with its bound's operations and bytes; the
    plain version's own ops (it is what runs on the CPU) count
    nothing."""
    make, key = KERNEL_CASES[case]
    call, (path, ops_, nbytes) = make()
    assert key.endswith("/" + path)
    got = hlo_cost.staged_cost(call)
    assert got.kernels == {key: 1}
    assert (got.flops, got.bytes) == (ops_, nbytes)


def test_kernel_cost_formulas():
    """B2: 2·m·k·n and A, B, C once (bool one byte, f32 four); B3: one ⊕
    an entry a lane; B1: a ⊗ and a ⊕ an edge a lane."""
    a, b = torch.zeros((3, 5)), torch.zeros((5, 7))
    assert semiring_matmul.matmul_cost("trop", a, b) == (
        "stream", 2.0 * 3 * 5 * 7, 4.0 * (15 + 35 + 21))
    assert semiring_matmul.matmul_cost("bool", a.bool(), b.bool())[2] == \
        15 + 35 + 21
    ids = torch.tensor([0, 2, 2, 1], dtype=torch.int32)
    vals = torch.zeros((4, 3))
    assert coo_segment.segment_cost("nat", vals, ids, 3) == (
        "scatter", 12.0, 4 * (12 + 4) + 3 * 12.0)
    rel = _operator("trop")
    plan = coo_spmm.plan_geometry(rel, transpose=True)
    x = torch.zeros((rel.shape[0], 4))
    path, ops_, _ = coo_spmm.spmm_cost(plan, x)
    assert (path, ops_) == ("lanes_f32", 2.0 * plan.nnz * 4)


# -- the planner --------------------------------------------------------------


def _bm_db(n=24, avg_deg=3.0, seed=3):
    """The reference's ``tests/test_planner.py::_bm_db`` and its port."""
    g = jdata.erdos_renyi(n, avg_deg, seed=seed)
    schema = jprograms.bm(a=0).original.schema
    jdb = jengine.Database(schema, {"id": n}, {"E": g.adjacency(),
                                               "V": jnp.ones((n,), bool)})
    return jdb, port_db(jdb, programs.bm(a=0).original.schema)


def test_hlo_cost_model_prices_candidates():
    _, db = _bm_db()
    plan = planner.plan_program(programs.bm(a=0).optimized, db,
                                cost_model="hlo")
    sp = plan.strata[0]
    priced = [c for c in sp.considered.values() if c.source == "hlo"]
    assert priced, sp.considered
    assert all(c.flops_per_iter > 0 for c in priced)
    assert "[hlo]" in planner.explain(plan)
    got, _ = program.run_program(programs.bm(a=0).optimized, db, plan=plan)
    ref, _ = program.run_program(programs.bm(a=0).optimized, db,
                                 mode="naive")
    assert torch.equal(got, ref)


def _pick_cases():
    g = jdata.powerlaw(300, 3, seed=0)
    for kind in ("bm", "cc"):
        jb = jprograms.bm(a=0) if kind == "bm" else jprograms.cc()
        tb = programs.bm(a=0) if kind == "bm" else programs.cc()
        jdb = jengine.Database(jb.original.schema, {"id": g.n}, {
            "E": g.sparse_adjacency(symmetric=kind == "cc"),
            "V": g.vertex_set()})
        yield f"{kind}-sparse", jb, tb, jdb
        yield f"{kind}-dense", jb, tb, jb.make_db(
            jdata.erdos_renyi(64, 0.4 * 64, seed=1))
    jb = jprograms.sssp(a=0, wmax=4, dmax=24)
    yield "sssp", jb, programs.sssp(a=0, wmax=4, dmax=24), jb.make_db(
        jdata.erdos_renyi(14, 3.0, seed=2, weighted=True, wmax=4))


PICK_CASES = {name: (jb, tb, jdb) for name, jb, tb, jdb in _pick_cases()}
#: cases whose "hlo" pick differs from the reference's because an eager
#: step counts what XLA fuses: case → (reference's, port's) staged
#: (flops, bytes) by candidate.  None does (ROADMAP C: the counts differ,
#: the picks agree).
HLO_PICKS_DIFFER: dict = {}


@pytest.mark.parametrize("objective", ["latency", "throughput"])
@pytest.mark.parametrize("case", list(PICK_CASES))
def test_hlo_picks_match_the_reference(case, objective):
    jb, tb, jdb = PICK_CASES[case]
    db = port_db(jdb, tb.original.schema)
    jsp = jplanner.plan_program(jb.optimized, jdb, cost_model="hlo",
                                objective=objective).strata[0]
    plan = planner.plan_program(tb.optimized, db, cost_model="hlo",
                                objective=objective)
    sp = plan.strata[0]
    assert sorted(sp.considered) == sorted(jsp.considered)
    assert all(c.source == "hlo" for c in sp.considered.values())
    if (case, objective) in HLO_PICKS_DIFFER:
        assert sp.runner != jsp.runner
    else:
        assert sp.runner == jsp.runner, (sp.considered, jsp.considered)
    got, _ = program.run_program(tb.optimized, db, plan=plan)
    want, _ = program.run_program(tb.optimized, db)
    assert torch.equal(got, want)


def test_the_fused_kernel_is_priced_from_the_staged_loop(monkeypatch):
    """Under ``"throughput"`` the fused B1 candidate is ``sparse_jit``'s
    staged count over ``SPMM_COST``'s speedup, as in the reference."""
    monkeypatch.setattr(planner.SPMM_COST, "min_nnz", 16.0)
    jb, tb, jdb = PICK_CASES["bm-sparse"]
    db = port_db(jdb, tb.original.schema)
    sp = planner.plan_program(tb.optimized, db, cost_model="hlo",
                              objective="throughput").strata[0]
    fused, base = sp.considered["sparse_frontier_pallas"], \
        sp.considered["sparse_jit"]
    s = planner.SPMM_COST.speedup("bool", "cpu")
    assert fused.source == "hlo"
    assert fused.flops_per_iter == pytest.approx(base.flops_per_iter / s)
    assert fused.bytes_per_iter == pytest.approx(base.bytes_per_iter / s)


def test_a_staging_error_raises(monkeypatch):
    """A kernel that fails while a candidate is staged fails the plan;
    the analytic price does not stand in for it."""
    def broken(*a, **k):
        raise RuntimeError("B2 failed")
    monkeypatch.setattr(semiring_matmul, "semiring_matmul_plain", broken)
    _, db = _bm_db()
    with pytest.raises(RuntimeError, match="B2 failed"):
        planner.plan_program(programs.bm(a=0).optimized, db,
                             cost_model="hlo")


def test_a_dense_candidate_that_cannot_run_is_rejected(monkeypatch):
    """Under ``"hlo"`` a dense engine candidate whose step would densify
    a relation past ``DENSIFY_LIMIT`` (CC Π₂'s cast E on a large graph)
    is rejected with the reason, not staged; the analytic model still
    prices it."""
    jb, tb, jdb = PICK_CASES["cc-sparse"]
    db = port_db(jdb, tb.original.schema)
    monkeypatch.setattr(planner, "DENSIFY_LIMIT", 300 * 300)
    sp = planner.plan_program(tb.optimized, db, cost_model="hlo").strata[0]
    for r in ("dense_naive", "dense_gsn"):
        assert r not in sp.considered
        assert "densifies E[300, 300]" in sp.rejected[r]
    assert sp.runner == "sparse_frontier"
    analytic = planner.plan_program(tb.optimized, db).strata[0]
    assert {"dense_naive", "dense_gsn"} <= set(analytic.considered)


def test_an_unknown_cost_model_raises():
    _, db = _bm_db()
    with pytest.raises(ValueError, match="unknown cost_model 'hlo2'"):
        planner.plan_program(programs.bm(a=0).optimized, db,
                             cost_model="hlo2")
