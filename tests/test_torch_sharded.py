"""Port parity: graph-axis sharded fixpoints.

``repro_torch.distributed.datalog`` (with ``launch/mesh.py``, the
``sparse_sharded`` runner, the planner's mesh branch and graph-sharded
serving) against ``repro``, on the CPU, at the sizes of
``tests/test_sharded.py``:

* host side, no process group: every :class:`ShardedRelation` field
  (relabeling and exchange geometry included) equals the reference's
  for the same input and D ∈ {1, 2, 3, 8}; the shard round trip,
  ragged capacity, the balance permutation, ``apply_delta``,
  ``default_exchange_caps``, ``payload_row_bytes`` and
  ``exchange_byte_report``;
* the planner on int-D meshes: ``explain`` byte for byte, the partition
  line, the rejections;
* D = 1 in this process (a one-rank gloo world): cold, batched, warm,
  chunked runs and the ℕ∞ contraction against the reference's own
  sharded run on its one-device mesh, ``rounds`` included;
* D ∈ {2, 4} in spawned gloo worlds (one per D, a module fixture that
  runs every case in one go; the ranks import no JAX,
  ``tests/torch_sharded_worker.py``): answers and per-row ``iters`` bit
  for bit against the reference's single-device
  ``sparse_seminaive_fixpoint`` / ``resume_fixpoint`` — the reference's
  own sharded run fails at D ≥ 2 on this JAX (ROADMAP C) — and every
  rank's result equal to rank 0's.
"""

import re
import warnings

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from helpers import given, settings, strategies as st

import jax.numpy as jnp

from repro.core import engine as jengine
from repro.core import planner as jplanner
from repro.core.program import run_program as jrun_program
from repro.datalog import datasets as jdata
from repro.datalog import programs as jprograms
from repro.distributed import datalog as jdd
from repro.incremental import delta_seed as jdelta_seed
from repro.launch.datalog_serve import DatalogServer as JServer
from repro.launch.mesh import make_graph_mesh as jmake_graph_mesh
from repro.sparse import contract as jcontract
from repro.sparse.coo import SparseRelation as JRel
from repro.sparse.fixpoint import resume_fixpoint as jresume
from repro.sparse.fixpoint import sparse_seminaive_fixpoint as jfixpoint
from repro_torch.core import engine, planner
from repro_torch.datalog import programs
from repro_torch.distributed import datalog as dd
from repro_torch.launch.mesh import make_graph_mesh, spawn_graph_world
from repro_torch.sparse.coo import SparseRelation

import torch_sharded_worker as worker

SEMIRINGS = ("bool", "trop", "maxplus", "nat")
FIELDS = ("coords", "values", "nnz", "perm", "inv", "ssrc", "sdst", "sval",
          "usrc", "ustart")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _buf(jrel: JRel):
    h = jrel.as_np()
    return (np.asarray(h.coords), np.asarray(h.values), int(h.nnz),
            tuple(h.shape), h.semiring)


def _port(jrel: JRel) -> SparseRelation:
    return worker.rel_of(_buf(jrel))


def _single(jrel, init):
    """The reference's single-device staged fixpoint."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        y, it = jfixpoint(jrel, init, mode="jit")
    return np.asarray(y), np.asarray(it)


def _random_rel(rng, n: int, semiring: str, nnz: int,
                capacity: int | None = None) -> JRel:
    coords = np.stack([rng.integers(0, n, nnz), rng.integers(0, n, nnz)],
                      axis=1)
    if semiring == "bool":
        values = np.ones(nnz, bool)
    else:
        values = rng.integers(1, 6, nnz).astype(np.float32)
    return JRel.from_coo(coords, values, (n, n), semiring,
                         capacity=capacity, lib="np")


def _init_for(semiring, n, source=0):
    sr_zero = {"bool": False, "trop": np.inf, "maxplus": -np.inf}
    init = np.full(n, sr_zero[semiring],
                   bool if semiring == "bool" else np.float32)
    init[source] = True if semiring == "bool" else 0.0
    return init


def _graph_rel(semiring, n=90, seed=7) -> JRel:
    rng = np.random.default_rng(seed)
    if semiring == "maxplus":
        # longest path needs a DAG to converge: only edges i → j, i < j
        src = rng.integers(0, n - 1, 3 * n)
        off = rng.integers(1, 5, 3 * n)
        dst = np.minimum(src + off, n - 1)
        coords = np.stack([src, dst], axis=1)
        vals = rng.integers(1, 4, 3 * n).astype(np.float32)
        return JRel.from_coo(coords, vals, (n, n), "maxplus", lib="np")
    g = jdata.powerlaw(n, 3, seed=seed)
    g.weights = rng.integers(1, 6, len(g.edges))
    return g.sparse_adjacency(semiring=semiring)


def _dense(rel) -> np.ndarray:
    return _np(rel.to_dense())


def assert_fields(got: dd.ShardedRelation, want) -> None:
    g, w = got.as_np(), want.as_np()
    assert g.shape == tuple(w.shape) and g.semiring == w.semiring
    for f in FIELDS:
        a, b = getattr(g, f), getattr(w, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        assert np.array_equal(a, b), f


def assert_same(got, want) -> None:
    """Nested results equal, arrays bit for bit."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            assert_same(got[k], want[k])
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b)
    elif isinstance(got, (np.ndarray, torch.Tensor)) or \
            isinstance(want, (np.ndarray, torch.Tensor)):
        a, b = _np(got), _np(want)
        assert a.shape == b.shape and np.array_equal(a, b)
    else:
        assert got == want


# --------------------------------------------------------------------------
# host side: shard/unshard, apply_delta, the exchange accounting
# --------------------------------------------------------------------------


@settings(max_examples=30)
@given(data=st.data())
def test_shard_roundtrip_property(data):
    """Every field equals the reference's, and unshard(shard(rel)) ==
    rel, across semirings, sizes, ragged nnz and D not dividing n."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31 - 1)))
    semiring = data.draw(st.sampled_from(SEMIRINGS))
    n = data.draw(st.integers(1, 40))
    nnz = data.draw(st.integers(0, 80))
    d = data.draw(st.integers(1, 9))
    jrel = _random_rel(rng, n, semiring, nnz)
    sh = dd.shard_relation(_port(jrel), d)
    assert_fields(sh, jdd.shard_relation(jrel, d))
    assert sh.d == d and sh.row_block * d >= n
    host = sh.as_np()
    for s in range(d):
        k = int(host.nnz[s])
        assert (host.coords[s, :k, 1] < sh.row_block).all()
        src = host.coords[s, :k, 0]
        assert (src < sh.n_pad).all()
        if host.inv is not None:
            src = host.inv[src]
        assert (src < n).all()
    assert sh.total_nnz() == int(np.asarray(jrel.as_np().nnz))
    assert np.array_equal(_dense(dd.unshard(sh)), _dense(jrel))


@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("semiring", ["bool", "trop", "maxplus", "nat"])
def test_shard_fields_equal_reference(d, semiring):
    """The relabeling, the shards and the exchange geometry of a graph
    relation, bit for bit — balanced and not."""
    jrel = _graph_rel(semiring) if semiring != "nat" else \
        _random_rel(np.random.default_rng(11), 50, "nat", 180)
    rel = _port(jrel)
    for balance in (True, False):
        sh = dd.shard_relation(rel, d, balance=balance)
        assert_fields(sh, jdd.shard_relation(jrel, d, balance=balance))
        assert sh.as_torch("cpu") is sh
        moved = sh.as_torch("meta")
        assert moved.device.type == "meta" and moved.nnz == sh.nnz
        for f in FIELDS[:2] + FIELDS[3:]:
            a, b = getattr(moved, f), getattr(sh, f)
            assert (a is None) == (b is None)
            assert a is None or (a.device.type == "meta"
                                 and a.shape == b.shape
                                 and a.dtype == b.dtype)


def test_shard_ragged_capacity_is_worst_shard():
    n, d = 24, 4
    coords = np.stack([np.arange(12) % n, np.full(12, 1)], axis=1)
    jrel = JRel.from_coo(coords, np.ones(12, bool), (n, n), "bool",
                         lib="np")
    sh = dd.shard_relation(_port(jrel), d, balance=False)
    assert list(sh.nnz) == [12, 0, 0, 0]
    assert sh.capacity == 12 and sh.perm is None
    assert np.array_equal(_dense(dd.unshard(sh)), _dense(jrel))
    bal = dd.shard_relation(_port(jrel), d)
    assert bal.capacity == 12  # one vertex owns every edge: no split
    assert np.array_equal(_dense(dd.unshard(bal)), _dense(jrel))
    assert_fields(bal, jdd.shard_relation(jrel, d))


def test_balance_permutation_evens_edge_counts():
    rng = np.random.default_rng(0)
    n, d = 1024, 8
    dst = (rng.pareto(1.0, 6000) * 8).astype(np.int64) % n
    src = rng.integers(0, n, 6000)
    jrel = JRel.from_coo(np.stack([src, dst], axis=1), np.ones(6000, bool),
                         (n, n), "bool", lib="np")
    rel = _port(jrel)
    plain = dd.shard_relation(rel, d, balance=False)
    bal = dd.shard_relation(rel, d)
    assert bal.total_nnz() == plain.total_nnz()
    assert bal.capacity <= 1.25 * bal.total_nnz() / d
    assert bal.capacity < plain.capacity
    assert np.array_equal(_dense(dd.unshard(bal)), _dense(jrel))
    assert_fields(bal, jdd.shard_relation(jrel, d))


def test_shard_requires_binary():
    rel = SparseRelation.from_coo(np.zeros((1, 3), np.int64), [1.0],
                                  (4, 4, 4), "trop", device="cpu")
    with pytest.raises(ValueError, match="binary"):
        dd.shard_relation(rel, 2)
    with pytest.raises(TypeError):
        dd.mesh_size("nope")
    with pytest.raises(ValueError, match="≥ 1"):
        dd.mesh_size(0)


@settings(max_examples=20)
@given(data=st.data())
def test_apply_delta_matches_unsharded(data):
    """Routed deltas equal the reference's shards field for field and
    the unsharded relation's own ``apply_delta``."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31 - 1)))
    semiring = data.draw(st.sampled_from(("bool", "trop", "nat")))
    n = data.draw(st.integers(2, 30))
    d = data.draw(st.integers(1, 5))
    jrel = _random_rel(rng, n, semiring, data.draw(st.integers(1, 40)),
                       capacity=128)
    rel = _port(jrel)
    k = data.draw(st.integers(1, 20))
    coords = np.stack([rng.integers(0, n, k), rng.integers(0, n, k)],
                      axis=1)
    values = None if semiring == "bool" else \
        rng.integers(1, 6, k).astype(np.float32)
    got = dd.shard_relation(rel, d).apply_delta(coords, values)
    assert_fields(got, jdd.shard_relation(jrel, d).apply_delta(coords,
                                                               values))
    assert np.array_equal(_dense(dd.unshard(got)),
                          _dense(rel.apply_delta(coords, values)))


def test_apply_delta_keeps_capacity_within_padding():
    rng = np.random.default_rng(0)
    n = 24
    coords = np.stack([np.arange(12) % n, np.full(12, 1)], axis=1)
    jrel = JRel.from_coo(coords, np.ones(12, np.float32), (n, n), "trop",
                         lib="np")
    sh = dd.shard_relation(_port(jrel), 4)
    cap = sh.capacity
    small = sh.apply_delta([[0, 13]], [2.0])
    assert small.capacity == cap
    rows = np.stack([rng.integers(0, n, 4 * cap),
                     np.ones(4 * cap, np.int64)], axis=1)
    big = small.apply_delta(rows, np.ones(4 * cap, np.float32))
    assert big.capacity > cap and big.capacity % cap == 0
    assert (big.capacity // cap) & (big.capacity // cap - 1) == 0
    jbig = jdd.shard_relation(jrel, 4).apply_delta([[0, 13]], [2.0]) \
        .apply_delta(rows, np.ones(4 * cap, np.float32))
    assert_fields(big, jbig)


def test_apply_delta_rejects_out_of_range():
    jrel = _random_rel(np.random.default_rng(0), 8, "bool", 4)
    sh = dd.shard_relation(_port(jrel), 2)
    with pytest.raises(ValueError, match="out of range"):
        sh.apply_delta([[0, 9]])


@pytest.mark.parametrize("nb", [1, 45, 64, 100, 5_000, 2_000_000])
@pytest.mark.parametrize("cap", [1, 200, 4_096, 39_968, 15_999_968])
def test_default_exchange_caps_equal_reference(nb, cap):
    assert dd.default_exchange_caps(nb, cap) == \
        jdd.default_exchange_caps(nb, cap)


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("batch", [1, 3, 8, 9, 64])
def test_payload_row_bytes_equal_reference(semiring, batch):
    assert dd.payload_row_bytes(semiring, batch) == \
        jdd.payload_row_bytes(semiring, batch)


@pytest.mark.parametrize("semiring,batch", [("bool", 1), ("bool", 8),
                                            ("trop", 8), ("maxplus", 1)])
@pytest.mark.parametrize("d", [1, 2, 8])
def test_exchange_byte_report_equal_reference(semiring, batch, d):
    jrel = _graph_rel(semiring)
    sh, jsh = dd.shard_relation(_port(jrel), d), jdd.shard_relation(jrel, d)
    n_tiers = len(dd.default_exchange_caps(sh.row_block, sh.capacity))
    for rounds in ([3, 2, 2][:n_tiers] + [1], [0] * n_tiers + [5]):
        assert dd.exchange_byte_report(sh, rounds, batch=batch) == \
            jdd.exchange_byte_report(jsh, rounds, batch=batch)
    caps = ((4, 16), (sh.row_block, sh.capacity))
    assert dd.exchange_byte_report(sh, [1, 2, 3], batch=batch,
                                   exchange_caps=caps) == \
        jdd.exchange_byte_report(jsh, [1, 2, 3], batch=batch,
                                 exchange_caps=caps)


@pytest.mark.parametrize("b", [1, 2, 7, 8, 9, 16, 17, 64])
def test_bool_payload_codec_round_trip(b):
    """𝔹 lanes packed 8 to a byte as ``np.packbits`` packs them, exact
    round trip, ``payload_row_bytes`` bytes a row."""
    from repro_torch.core import semiring as sr_mod
    sr = sr_mod.get("bool")
    x = np.random.default_rng(b).random((33, b)) < 0.5
    packed = dd._pack(sr, torch.from_numpy(x))
    assert packed.dtype == torch.uint8
    assert packed.shape == (33, -(-b // 8))
    assert packed.shape[1] == dd.payload_row_bytes("bool", b)
    assert np.array_equal(packed.numpy(), np.packbits(x, axis=1))
    assert np.array_equal(dd._unpack(sr, packed, b).numpy(), x)


# --------------------------------------------------------------------------
# the planner's mesh branch on int-D meshes
# --------------------------------------------------------------------------


GOLDEN_SSSP = """\
plan SSSP_opt  mode=auto  objective=latency  signature=<sig>
  stratum 0  runner=sparse_frontier  idbs=SP
    reason      min est. total flops among 2 feasible candidates (cpu host ⇒ frontier worklist)
    cost        90.4 flops/iter × 5 iters  [analytic]
    considered  sparse_frontier=452  sparse_jit=1.06e+03
    rejected    dense_gsn: edges override requires a vector runner (the engine paths read the stored relations, not the override)
    rejected    dense_naive: edges override requires a vector runner (the engine paths read the stored relations, not the override)
    rejected    sparse_frontier_pallas: fused-kernel SpMM is a batched-serving backend (objective='throughput') — single-shot latency keeps the worklist/staged runners
    rejected    sparse_sharded: below the sharding crossover: ≈26.5 work/device/iter < 20000 measured minimum (BENCH_sharded.json) — one device wins
    rejected    vector_dense: linear operator is sparse — the SpMV/SpMM runners cover it
  outputs    SPans"""


def _sssp_plans(mesh, n=60, seed=4, objective="latency"):
    """Both packages' SSSP plans over the same weighted COO override."""
    g = jdata.erdos_renyi(n, 2.5, seed=seed, weighted=True, wmax=4)
    jrel = g.sparse_adjacency(semiring="trop")
    jb = jprograms.sssp(a=0, wmax=4, dmax=40)
    tb = programs.sssp(a=0, wmax=4, dmax=40)
    doms = {"id": n, "w": 4, "d": 40}
    jplan = jplanner.plan_program(
        jb.optimized, jengine.Database(jb.original.schema, doms, {}),
        edges=jrel, mesh=mesh, objective=objective)
    plan = planner.plan_program(
        tb.optimized, engine.Database(tb.original.schema, doms, {}, "cpu"),
        edges=_port(jrel), mesh=mesh, objective=objective)
    return plan, jplan


def _text(plan, explain):
    return re.sub(r"signature=[0-9a-f]{16}", "signature=<sig>",
                  explain(plan))


def test_explain_golden_sharded_sssp():
    """A mesh-priced SSSP plan below the sharding crossover renders as
    the reference's golden, byte for byte."""
    plan, jplan = _sssp_plans(mesh=8)
    assert _text(plan, planner.explain) == GOLDEN_SSSP
    assert _text(plan, planner.explain) == _text(jplan, jplanner.explain)
    assert plan.signature == jplan.signature


def test_explain_partition_line_above_crossover(monkeypatch):
    for cost in (planner.SHARDED_COST, jplanner.SHARDED_COST):
        monkeypatch.setattr(cost, "min_work_per_device", 0.0)
        monkeypatch.setattr(cost, "sync_flops_per_device", 0.0)
    plan, jplan = _sssp_plans(mesh=8)
    sp = plan.strata[0]
    assert sp.runner == "sparse_sharded"
    assert sp.partition == ("graph axis D=8 × 8 dst rows/shard; "
                            "nnz(E)=152 (≈19/shard); "
                            "Δ-exchange ≈672 B/iter "
                            "(dense all-gather 1680 B)")
    assert sp.partition == jplan.strata[0].partition
    assert f"    partition   {sp.partition}" in planner.explain(plan)
    assert _text(plan, planner.explain) == _text(jplan, jplanner.explain)


@pytest.mark.parametrize("objective", ["latency", "throughput"])
@pytest.mark.parametrize("d", [2, 8, 64])
def test_sharded_pricing_matches_reference(monkeypatch, objective, d):
    """Above the crossover the sharded candidate is priced as the
    reference prices it on its CPU host, and the fused kernel steps
    aside for it."""
    for cost in (planner.SHARDED_COST, jplanner.SHARDED_COST):
        monkeypatch.setattr(cost, "min_work_per_device", 0.0)
    plan, jplan = _sssp_plans(mesh=d, objective=objective)
    sp, jsp = plan.strata[0], jplan.strata[0]
    assert sp.considered["sparse_sharded"].total == pytest.approx(
        jsp.considered["sparse_sharded"].total, rel=1e-12)
    assert sp.runner == jsp.runner and sp.partition == jsp.partition
    assert sp.rejected.get("sparse_frontier_pallas") == \
        jsp.rejected.get("sparse_frontier_pallas")


def test_planner_rejects_single_device_mesh():
    plan, jplan = _sssp_plans(mesh=1)
    sp = plan.strata[0]
    assert sp.runner != "sparse_sharded"
    assert "single device" in sp.rejected["sparse_sharded"]
    assert sp.rejected["sparse_sharded"] == \
        jplan.strata[0].rejected["sparse_sharded"]


def test_planner_no_mesh_keeps_plans_unchanged():
    plan, jplan = _sssp_plans(mesh=None)
    sp = plan.strata[0]
    assert "sparse_sharded" not in sp.considered
    assert "sparse_sharded" not in sp.rejected
    assert sp.partition is None and plan.mesh is None
    assert _text(plan, planner.explain) == _text(jplan, jplanner.explain)


def test_planner_dense_operator_rejects_sharded():
    g = jdata.erdos_renyi(40, 14.0, seed=1)
    jb, tb = jprograms.cc(), programs.cc()
    plan = planner.plan_program(tb.optimized, engine.Database(
        tb.original.schema, {"id": 40},
        {"E": torch.from_numpy(np.array(g.adjacency())),
         "V": torch.ones(40, dtype=torch.bool)}, "cpu"), mesh=8)
    jplan = jplanner.plan_program(jb.optimized, jb.make_db(g), mesh=8)
    sp = plan.strata[0]
    assert "dense" in sp.rejected["sparse_sharded"]
    assert sp.rejected["sparse_sharded"] == \
        jplan.strata[0].rejected["sparse_sharded"]


def test_forced_sharded_requires_mesh():
    b = programs.bm(a=0)
    jrel = jdata.erdos_renyi(30, 3.0, seed=0).sparse_adjacency()
    db = engine.Database(b.original.schema, {"id": 30},
                         {"E": _port(jrel),
                          "V": torch.ones(30, dtype=torch.bool)}, "cpu")
    with pytest.raises(ValueError, match="mesh"):
        planner.plan_program(b.optimized, db, mode="sparse_sharded")
    plan = planner.plan_program(b.optimized, db, mode="sparse_sharded",
                                mesh=4)
    assert plan.strata[0].partition == "graph axis D=4 (forced)"
    assert "partition   graph axis D=4 (forced)" in planner.explain(plan)


# --------------------------------------------------------------------------
# D = 1 in this process: the reference's own sharded run is the oracle
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    return make_graph_mesh(1, device="cpu")


@pytest.fixture(scope="module")
def jmesh1():
    return jmake_graph_mesh(1)


def test_make_graph_mesh_one_rank(mesh1):
    assert (mesh1.d, mesh1.rank, mesh1.device.type) == (1, 0, "cpu")
    assert dd.mesh_size(mesh1) == 1
    with pytest.raises(ValueError, match="2 ranks"):
        make_graph_mesh(2, device="cpu")
    with pytest.raises(TypeError, match="GraphMesh"):
        dd.sharded_seminaive_fixpoint(_port(_graph_rel("bool")),
                                      _init_for("bool", 90), mesh=1)


@pytest.mark.parametrize("semiring,batched", [
    ("bool", False), ("trop", False), ("maxplus", False), ("bool", True),
    ("trop", True)])
def test_d1_cold_matches_reference_sharded(mesh1, jmesh1, semiring,
                                           batched):
    jrel = _graph_rel(semiring)
    n = jrel.shape[0]
    init = np.stack([_init_for(semiring, n, s) for s in (0, 3, 7, 11)]) \
        if batched else _init_for(semiring, n)
    y, it, rounds = dd.sharded_seminaive_fixpoint_stats(_port(jrel), init,
                                                        mesh=mesh1)
    jy, jit, jrounds = jdd.sharded_seminaive_fixpoint_stats(jrel, init,
                                                            mesh=jmesh1)
    assert_same(y, np.asarray(jy))
    assert_same(np.asarray(_np(it)), np.asarray(jit))
    assert rounds.tolist() == np.asarray(jrounds).tolist()
    sy, sit = _single(jrel, init)
    assert_same(y, sy)
    assert_same(np.asarray(_np(it)), sit)


def test_d1_caps_rounds_match_reference(mesh1, jmesh1):
    """Shrunk ladders (every round dense; every round sparse) count the
    same rounds per tier as the reference's one-device run."""
    jrel = _graph_rel("bool")
    init = _init_for("bool", jrel.shape[0])
    jsh = jdd.shard_relation(jrel, 1)
    for caps in (((1, 1),), ((4, 64), (16, jsh.capacity))):
        y, it, rounds = dd.sharded_seminaive_fixpoint_stats(
            _port(jrel), init, mesh=mesh1, exchange_caps=caps)
        jy, jit, jrounds = jdd.sharded_seminaive_fixpoint_stats(
            jrel, init, mesh=jmesh1, exchange_caps=caps)
        assert_same(y, np.asarray(jy))
        assert it == int(jit)
        assert rounds.tolist() == np.asarray(jrounds).tolist()


def test_d1_warm_resume_matches_reference(mesh1, jmesh1):
    jrel = _graph_rel("trop")
    n = jrel.shape[0]
    init = np.stack([_init_for("trop", n, s) for s in (0, 5)])
    y_star, _ = _single(jrel, init)
    coords = np.array([[2, 40], [40, 60], [60, 2]])
    values = np.ones(3, np.float32)
    delta = JRel.from_coo(coords, values, jrel.shape, "trop", lib="np")
    jrel2 = jrel.apply_delta(coords, values)
    d0 = np.asarray(jdelta_seed(delta, y_star, backend="np"))
    y, it = dd.sharded_resume_fixpoint(_port(jrel2), y_star, d0,
                                       mesh=mesh1)
    jy, jit = jdd.sharded_resume_fixpoint(jrel2, y_star, d0, mesh=jmesh1)
    assert_same(y, np.asarray(jy))
    assert_same(it, np.asarray(jit))
    assert_same(y, _single(jrel2, init)[0])


def test_d1_chunks_match_reference(mesh1, jmesh1):
    """``sharded_resume_chunk`` from the cold carry in chunks of 2: every
    chunk's carry equals the reference's."""
    jrel = _graph_rel("bool")
    n = jrel.shape[0]
    init = np.stack([_init_for("bool", n, s) for s in (0, 9)])
    rel = _port(jrel)
    y = np.zeros_like(init)
    d, it = init.copy(), np.zeros(2, np.int32)
    jy, jd, jit = y, d, it
    while d.any():
        y, d, it = (_np(v) for v in dd.sharded_resume_chunk(
            rel, y, d, it, mesh=mesh1, max_iters=2))
        jy, jd, jit = (np.asarray(v) for v in jdd.sharded_resume_chunk(
            jrel, jy, jd, jit, mesh=jmesh1, max_iters=2))
        for a, b in ((y, jy), (d, jd), (it, jit)):
            assert_same(a, b)
    assert_same(y, _single(jrel, init)[0])
    assert_same(it, _single(jrel, init)[1])


@pytest.mark.parametrize("balance_graph", [False, True])
def test_d1_contract_nat_matches_reference(mesh1, jmesh1, balance_graph):
    rng = np.random.default_rng(3)
    if balance_graph:
        jrel = _random_rel(np.random.default_rng(11), 50, "nat", 180)
    else:
        h = _graph_rel("bool").as_np()
        k = int(h.nnz)
        jrel = JRel.from_coo(h.coords[:k], np.ones(k, np.float32), h.shape,
                             "nat", lib="np")
    x = rng.random(jrel.shape[0]).astype(np.float32)
    got = _np(dd.sharded_contract(_port(jrel), x, mesh=mesh1))
    assert_same(got, np.asarray(jdd.sharded_contract(jrel, x,
                                                     mesh=jmesh1)))
    np.testing.assert_allclose(got, np.asarray(jcontract.vspm(
        jnp.asarray(x), jrel.as_jnp())), rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="⊖"):
        dd.sharded_seminaive_fixpoint(_port(jrel), x, mesh=mesh1)


def test_d1_planner_on_a_one_rank_mesh(mesh1):
    """A one-rank GraphMesh: the auto plan rejects sharding as single
    device, a forced plan executes on it and equals the auto plan."""
    b = programs.bm(a=3)
    jrel = jdata.powerlaw(120, 3, seed=5).sparse_adjacency()
    n = jrel.shape[0]
    db = engine.Database(b.original.schema, {"id": n},
                         {"E": _port(jrel),
                          "V": torch.ones(n, dtype=torch.bool)}, "cpu")
    auto = planner.plan_program(b.optimized, db, mesh=mesh1)
    assert "single device" in auto.strata[0].rejected["sparse_sharded"]
    forced = planner.plan_program(b.optimized, db, mode="sparse_sharded",
                                  mesh=mesh1)
    out, _ = planner.execute_plan(forced, b.optimized, db)
    want, _ = planner.execute_plan(auto, b.optimized, db)
    assert_same(out, want)
    jb = jprograms.bm(a=3)
    jdb = jengine.Database(jb.original.schema, {"id": n},
                           {"E": jrel, "V": jnp.ones((n,), bool)})
    assert_same(out, np.asarray(jrun_program(jb.optimized, jdb)[0]))


# --------------------------------------------------------------------------
# D ∈ {2, 4}: spawned gloo worlds, one batch of cases each
# --------------------------------------------------------------------------


HANDOFFS = (("sparse_jit", "sparse_sharded"),
            ("sparse_sharded", "sparse_frontier"))
SERVE_UPDATES = [[1, 149], [149, 4]]


def _exchange_examples():
    """The reference's auto ≡ dense property, at eight seeded draws of
    its strategy (random graphs, ragged per-shard nnz, duplicate edges;
    bool/trop; single and batched inits)."""
    out = []
    for k in range(8):
        rng = np.random.default_rng(100 + k)
        semiring = ("bool", "trop")[k % 2]
        n = int(rng.integers(8, 61))
        jrel = _random_rel(rng, n, semiring, int(rng.integers(0, 151)))
        b = (0, 1, 3)[k % 3]
        srcs = rng.integers(0, n, max(b, 1))
        init = _init_for(semiring, n, int(srcs[0])) if b == 0 else \
            np.stack([_init_for(semiring, n, int(s)) for s in srcs])
        out.append((jrel, init))
    return out


def _chain_hub(n_chain=30, hub=12, seed=0) -> JRel:
    rng = np.random.default_rng(seed)
    edges = [(i, i + 1) for i in range(n_chain - 1)]
    base = n_chain
    for i in range(hub):
        for j in range(hub):
            if i != j and rng.random() < 0.6:
                edges.append((base + i, base + j))
    edges.append((n_chain - 1, base))
    n = n_chain + hub
    coords = np.asarray(edges, np.int64)
    return JRel.from_coo(coords, np.ones(len(coords), bool), (n, n), "bool",
                         lib="np")


@pytest.fixture(scope="module")
def cases():
    """``{name: (case, args)}`` for the worlds, and the reference-side
    inputs the tests hold the results against."""
    c, ref = {}, {}
    for sem in ("bool", "trop", "maxplus"):
        jrel = _graph_rel(sem)
        init = _init_for(sem, jrel.shape[0])
        c[f"fix_{sem}"] = ("fixpoint", (_buf(jrel), init))
        ref[f"fix_{sem}"] = _single(jrel, init)
    for sem in ("bool", "trop"):
        jrel = _graph_rel(sem)
        init = np.stack([_init_for(sem, 90, s) for s in (0, 3, 7, 11)])
        c[f"batched_{sem}"] = ("fixpoint", (_buf(jrel), init))
        ref[f"batched_{sem}"] = _single(jrel, init)
    jb = _graph_rel("bool")
    for name, init in (("converged_batched",
                        np.stack([np.zeros(90, bool), _init_for("bool", 90)])),
                       ("converged_single", np.zeros(90, bool))):
        c[name] = ("fixpoint", (_buf(jb), init))
        ref[name] = _single(jb, init)
    # warm repair after a monotone update (test_sharded_resume_...)
    jt = _graph_rel("trop")
    init = np.stack([_init_for("trop", 90, s) for s in (0, 5)])
    y_star, _ = _single(jt, init)
    coords = np.array([[2, 40], [40, 60], [60, 2]])
    vals = np.ones(3, np.float32)
    jt2 = jt.apply_delta(coords, vals)
    d0 = np.asarray(jdelta_seed(JRel.from_coo(coords, vals, jt.shape, "trop",
                                              lib="np"), y_star,
                                backend="np"))
    c["resume"] = ("resume", (_buf(jt2), y_star, d0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref["resume"] = (_single(jt2, init)[0],
                         np.asarray(jresume(jt2, y_star, d0, mode="jit")[0]))
    for k, (jrel, init) in enumerate(_exchange_examples()):
        c[f"exchange_{k}"] = ("exchange", (_buf(jrel), init))
        ref[f"exchange_{k}"] = _single(jrel, init)
    jm = _graph_rel("maxplus")
    for name, init in (("maxplus_single", _init_for("maxplus", 90)),
                       ("maxplus_batched", np.stack(
                           [_init_for("maxplus", 90, s) for s in (0, 3)]))):
        c[name] = ("exchange", (_buf(jm), init))
        ref[name] = _single(jm, init)
    c["fallback"] = ("fallback", (_buf(jb), _init_for("bool", 90)))
    ref["fallback"] = (_single(jb, _init_for("bool", 90)), jb)
    # warm resume after apply_delta (test_exchange_warm_resume_...)
    jw = _graph_rel("trop", n=72, seed=3)
    iw = _init_for("trop", 72)
    yw0, _ = _single(jw, iw)
    wc = np.array([[0, 71], [71, 5]])
    wv = np.ones(2, np.float32)
    dw = np.asarray(jdelta_seed(JRel.from_coo(wc, wv, jw.shape, "trop",
                                              lib="np"), yw0, backend="np"))
    c["warm"] = ("warm", (_buf(jw), iw, wc, wv, dw))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref["warm"] = (yw0, np.asarray(jresume(jw.apply_delta(wc, wv), yw0,
                                               dw, mode="jit")[0]))
    c["no_geometry"] = ("no_geometry", (_buf(jb), _init_for("bool", 90)))
    ref["no_geometry"] = _single(jb, _init_for("bool", 90))
    c["mismatch"] = ("mismatch", (_buf(jb), _init_for("bool", 90)))
    # ℕ∞: the contraction probe, on the graph and on a ragged random one
    h = jb.as_np()
    kk = int(h.nnz)
    jn = JRel.from_coo(h.coords[:kk], np.ones(kk, np.float32), h.shape,
                       "nat", lib="np")
    x = np.random.default_rng(3).random(90).astype(np.float32)
    jn2 = _random_rel(np.random.default_rng(11), 50, "nat", 180)
    x2 = np.random.default_rng(11).random(50).astype(np.float32)
    for name, jrel, xv in (("contract", jn, x), ("contract_balanced", jn2,
                                                 x2)):
        c[name] = ("contract", (_buf(jrel), xv))
        ref[name] = np.asarray(jcontract.vspm(jnp.asarray(xv),
                                              jrel.as_jnp()))
    c["nat_refused"] = ("nat_refused", (_buf(jn), x))
    # forced ≡ auto (test_forced_matches_auto)
    jf = jdata.powerlaw(120, 3, seed=5).sparse_adjacency()
    c["forced"] = ("forced", (_buf(jf), 120))
    jbm = jprograms.bm(a=3)
    ref["forced"] = np.asarray(jrun_program(jbm.optimized, jengine.Database(
        jbm.original.schema, {"id": 120},
        {"E": jf, "V": jnp.ones((120,), bool)}))[0])
    # serve graph-mesh parity: the reference's plain server is the oracle
    js = jdata.powerlaw(150, 3, seed=2).sparse_adjacency()
    c["serve"] = ("serve", (_buf(js), 150, SERVE_UPDATES))
    srv0 = JServer(max_batch=4)
    srv0.register("reach", lambda a: jprograms.bm(a=a).optimized,
                  jengine.Database(jprograms.bm(a=0).original.schema,
                                   {"id": 150},
                                   {"E": js, "V": jnp.ones((150,), bool)}))
    reqs = [srv0.submit("reach", s) for s in (1, 4, 9)]
    srv0.run_until_idle()
    srv0.submit_update("reach", SERVE_UPDATES)
    reqs.append(srv0.submit("reach", 1))
    srv0.run_until_idle()
    ref["serve"] = ([np.asarray(r.result) for r in reqs],
                    [r.iters for r in reqs])
    jc = _chain_hub()
    ic = _init_for("bool", jc.shape[0])
    for start, target in HANDOFFS:
        c[f"handoff_{start}_{target}"] = ("handoff",
                                         (_buf(jc), ic, start, target))
    ref["handoff"] = _single(jc, ic)
    return c, ref


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def world(request, cases, tmp_path_factory):
    """One spawned world of D ranks running every case: ``(D, {name:
    result})``, after checking each rank returned rank 0's results (the
    multi-controller contract)."""
    d = request.param
    per_rank = spawn_graph_world(
        worker.run_cases, d, cases[0], device="cpu",
        workdir=str(tmp_path_factory.mktemp(f"world{d}")))
    assert len(per_rank) == d
    for other in per_rank[1:]:
        assert_same(other, per_rank[0])
    return d, per_rank[0]


@pytest.mark.parametrize("semiring", ["bool", "trop", "maxplus"])
def test_sharded_fixpoint_matches_single_device(world, cases, semiring):
    d, res = world
    y, it, rounds = res[f"fix_{semiring}"]
    wy, wit = cases[1][f"fix_{semiring}"]
    assert_same(y, wy)
    assert it == int(wit)
    assert sum(rounds) == it + 1      # the cold derive + one a round


@pytest.mark.parametrize("semiring", ["bool", "trop"])
def test_sharded_batched_matches_single_device(world, cases, semiring):
    _, res = world
    y, it, _ = res[f"batched_{semiring}"]
    wy, wit = cases[1][f"batched_{semiring}"]
    assert_same(y, wy)
    assert_same(it, wit)


def test_sharded_iters_match_on_already_converged_init(world, cases):
    """An inert all-0̄ row, and an all-0̄ single init, burn the first
    round as the single-device runner does."""
    _, res = world
    for name in ("converged_batched", "converged_single"):
        y, it, _ = res[name]
        wy, wit = cases[1][name]
        assert_same(y, wy)
        assert_same(np.asarray(it), np.asarray(wit))


def test_sharded_resume_matches_full_recompute(world, cases):
    _, res = world
    y, _ = res["resume"]
    full, single = cases[1]["resume"]
    assert_same(y, full)
    assert_same(y, single)


@pytest.mark.parametrize("k", range(8))
def test_exchange_matches_dense(world, cases, k):
    _, res = world
    ya, ia, yd, idn = res[f"exchange_{k}"]
    wy, wit = cases[1][f"exchange_{k}"]
    assert_same(ya, yd)
    assert_same(np.asarray(ia), np.asarray(idn))
    assert_same(ya, wy)
    assert_same(np.asarray(ia), np.asarray(wit))


@pytest.mark.parametrize("which", ["maxplus_single", "maxplus_batched"])
def test_exchange_matches_dense_maxplus_dag(world, cases, which):
    _, res = world
    ya, ia, yd, idn = res[which]
    wy, wit = cases[1][which]
    assert_same(ya, yd)
    assert_same(ya, wy)
    assert_same(np.asarray(ia), np.asarray(wit))


def test_exchange_fallback_boundary_rounds(world, cases):
    d, res = world
    r = res["fallback"]
    (wy, wit), jrel = cases[1]["fallback"]
    yd, itd = r["dense"]
    assert_same(yd, wy)
    assert itd == int(wit)
    y, it, rounds = r["tiny"]
    assert_same(y, yd)
    assert it == itd
    assert sum(rounds) == it + 1 and rounds[-1] >= 1
    y2, it2, rounds2 = r["roomy"]
    assert_same(y2, yd)
    assert rounds2[-1] == 0 and sum(rounds2) == it2 + 1
    report = r["report"]
    assert report["rounds"] == rounds2 and report["bytes_total"] > 0
    assert report["dense_bytes_per_iter"] == r["n_pad"] * r["row_bytes"]
    assert report == jdd.exchange_byte_report(
        jdd.shard_relation(jrel, d), rounds2,
        exchange_caps=r["roomy_caps"])


def test_exchange_warm_resume_matches_dense(world, cases):
    _, res = world
    y0, ya, ia, yd, idn, yf = res["warm"]
    wy0, wres = cases[1]["warm"]
    assert_same(y0, wy0)
    assert_same(ya, yd)
    assert ia == idn
    assert_same(ya, yf)
    assert_same(ya, wres)


def test_exchange_without_geometry_falls_back_dense(world, cases):
    _, res = world
    has_geo, y, it, rounds, no_perm, y2, it2 = res["no_geometry"]
    wy, wit = cases[1]["no_geometry"]
    assert not has_geo and no_perm
    assert_same(y, wy)
    assert it == int(wit)
    assert rounds == [it + 1]
    assert_same(y2, wy)
    assert it2 == int(wit)


def test_sharded_rejects_mismatched_d(world):
    _, res = world
    assert "re-shard" in res["mismatch"]


@pytest.mark.parametrize("which", ["contract", "contract_balanced"])
def test_sharded_contract_nat(world, cases, which):
    _, res = world
    np.testing.assert_allclose(res[which], cases[1][which], rtol=1e-6,
                               atol=1e-5)


def test_sharded_nat_fixpoint_refused(world):
    _, res = world
    assert "⊖" in res["nat_refused"]


def test_forced_matches_auto(world, cases):
    _, res = world
    auto, forced, forced_int, runner, text = res["forced"]
    assert runner == "sparse_sharded" and "forced" in text
    assert_same(forced, auto)
    assert_same(forced_int, auto)
    assert_same(forced, cases[1]["forced"])


@pytest.mark.parametrize("server", ["fifo", "continuous"])
def test_serve_graph_mesh_parity(world, cases, server):
    """Both servers on the mesh answer and repair across a merge as the
    reference's single-device server does."""
    d, res = world
    r = res["serve"][server]
    want, want_iters = cases[1]["serve"]
    assert r["runner"] == "sparse_sharded"
    assert r["applied"] and r["repaired"] == 3
    assert_same(r["results"], want)
    assert r["iters"] == want_iters
    if server == "fifo":
        assert r["sharded"] and r["compiled_d"] == [d]
        assert r["errors"] == [None] * 4
    else:
        assert r["packed_fallback"] > 0 and r["admitted"] == 0


@pytest.mark.parametrize("start,target", HANDOFFS)
def test_sharded_handoff_bit_exact(world, cases, start, target):
    _, res = world
    y, iters, final, switches = res[f"handoff_{start}_{target}"]
    wy, wit = cases[1]["handoff"]
    assert_same(y, wy)
    assert iters == int(wit)
    assert final == target and switches == [(start, target)]
