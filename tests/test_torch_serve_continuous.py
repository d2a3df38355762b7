"""Port parity: the continuous-batching scheduler and its slot pools.

``repro_torch.serve.ContinuousServer`` on CPU databases against
``repro.serve.ContinuousServer`` on the same host buffers, fed the same
request streams, over the cases ``tests/test_serve_continuous.py`` and
``tests/test_serve_soak.py`` cover.  Every case runs with
``host_kernels=True`` (the bitset and level-sync host steppers against
the reference's) and ``host_kernels=False`` (``TorchChunkStepper``
against ``JaxChunkStepper``): answers bit for bit, per-request
``iters``, delivery order and the ``stats()`` counters (compile cache,
family gauges and frontier observations included) must be equal.
"""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from helpers import given, settings, strategies as st

from repro.datalog import datasets as jdata
from repro.datalog import programs as jprograms
from repro.serve import BackpressureError as JBackpressureError
from repro.serve import ContinuousServer as JServer
from repro.serve import LRUCache as JLRU
from repro.serve import LatencyHistogram as JHist
from repro.serve import family as jfam
from repro.serve.slots import LevelSyncTropStepper as JLevelSync
from repro_torch.core import planner
from repro_torch.core.program import run_program
from repro_torch.datalog import programs
from repro_torch.serve import (BackpressureError, BitsetBoolStepper,
                               ContinuousServer, LRUCache,
                               LatencyHistogram, LevelSyncTropStepper,
                               TorchChunkStepper)
from repro_torch.serve import family as fam_mod
from repro_torch.sparse.coo import SparseRelation

from torch_serve_pairs import (LongestPath, Pair, Sssp, bm_dbs, jmk_bm,
                               np_of, pmk_bm)

HOST_KERNELS = [True, False]


def _pair(**kw):
    return Pair(JServer(**kw), ContinuousServer(**kw))


def _stepper_types(pr, fam):
    pool = pr.p._families[fam].pool
    return type(pool.stepper) if pool is not None else None


# --------------------------------------------------------------------------
# bounded caches & histograms
# --------------------------------------------------------------------------


def test_lru_cache_matches_reference():
    ops = [("put", "a", 1), ("put", "b", 2), ("get", "a"), ("put", "c", 3),
           ("get", "b"), ("get", "a"), ("get", "c"), ("peek", "a"),
           ("replace", "c", 9), ("get", "c"), ("pop", "a")]
    out = []
    for cache in (JLRU(2), LRUCache(2)):
        res = [getattr(cache, op)(*args) for op, *args in ops]
        out.append((res, cache.hits, cache.misses, cache.evictions,
                    list(cache.keys()), cache.clear(), len(cache)))
    assert out[0] == out[1]
    assert out[1][1:4] == (4, 1, 1)
    zero = LRUCache(0)
    zero.put("a", 1)
    assert zero.get("a") is None and len(zero) == 0
    with pytest.raises(ValueError):
        LRUCache(-1)


def test_latency_histogram_matches_reference():
    samples = np.random.default_rng(0).lognormal(-5, 2, 500)
    hs = [JHist(), LatencyHistogram()]
    for h in hs:
        for s in samples:
            h.record(s)
        h.record(0.0)
    assert hs[0].summary() == hs[1].summary()
    s = hs[1].summary()
    assert s["count"] == 501 and s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"]
    assert LatencyHistogram().summary()["p99_ms"] == 0.0


# --------------------------------------------------------------------------
# exactness: every stepper against the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("host_kernels", HOST_KERNELS)
def test_continuous_bool_exact(host_kernels):
    jdb, db = bm_dbs()
    pr = _pair(max_batch=8, chunk_iters=3, warm_answers=0,
               host_kernels=host_kernels)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    for s in np.random.default_rng(0).integers(0, 120, 20):
        pr.submit("reach", int(s))
    pr.run_until_idle()
    pr.check()
    assert _stepper_types(pr, "reach") is (
        BitsetBoolStepper if host_kernels else TorchChunkStepper)
    want, _ = run_program(pmk_bm(pr.reqs[3][1].source),
                          db.with_storage("E", "dense"), mode="seminaive")
    assert torch.equal(pr.reqs[3][1].result, want)


@pytest.mark.parametrize("host_kernels", HOST_KERNELS)
def test_continuous_trop_exact(host_kernels):
    ss = Sssp()
    pr = _pair(max_batch=8, chunk_iters=3, warm_answers=0,
               host_kernels=host_kernels)
    pr.register("sssp", ss.jmk, ss.jdb, ss.pmk, ss.db, jedges=ss.jrel,
                pedges=ss.rel)
    for s in np.random.default_rng(1).integers(0, ss.n, 16):
        pr.submit("sssp", int(s))
    pr.run_until_idle()
    pr.check()
    assert _stepper_types(pr, "sssp") is (
        LevelSyncTropStepper if host_kernels else TorchChunkStepper)


@pytest.mark.parametrize("host_kernels", HOST_KERNELS)
def test_continuous_maxplus_exact(host_kernels):
    """maxplus has no host stepper: both packages step it through the
    chunk stepper either way."""
    lp = LongestPath()
    pr = _pair(max_batch=4, chunk_iters=2, warm_answers=0,
               host_kernels=host_kernels)
    pr.register("lp", lp.jmk, lp.jdb, lp.pmk, lp.db)
    for s in (0, 3, 17, 40, 41, 2):
        pr.submit("lp", s)
    pr.run_until_idle()
    pr.check()
    assert _stepper_types(pr, "lp") is TorchChunkStepper


def test_continuous_dense_packed_fallback():
    jdb, db = bm_dbs(sparse=False)
    pr = _pair(max_batch=4, warm_answers=0)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    for s in (3, 14, 15, 92, 65):
        pr.submit("reach", s)
    pr.run_until_idle()
    pr.check()
    assert pr.p.stats()["packed_fallback"] >= 1


def test_trop_stepper_encoding_matches_reference():
    """Only {0, ∞} inits encode as a level-0 frontier (both refuse a
    finite non-zero entry); fractional weights are refused."""
    ss = Sssp()
    jst = JLevelSync(ss.jrel, ss.n, 4)
    pst = LevelSyncTropStepper(ss.rel, ss.n, 4)
    bad = np.full(ss.n, np.inf, np.float32)
    bad[3] = 2.0
    ok = np.full(ss.n, np.inf, np.float32)
    ok[3] = 0.0
    assert jst.admit(0, bad) is pst.admit(0, bad) is False
    assert jst.admit(0, ok) is pst.admit(0, ok) is True
    g0 = jdata.erdos_renyi(40, 3.0, seed=5)
    rel = SparseRelation.from_coo(g0.edges, np.full(len(g0.edges), 1.5),
                                  (40, 40), "trop", device="cpu")
    with pytest.raises(ValueError):
        LevelSyncTropStepper(rel, 40, 4)


@pytest.mark.parametrize("host_kernels", HOST_KERNELS)
def test_multi_chunk_long_chain_no_early_harvest(host_kernels):
    n = 64
    jdb, db = bm_dbs(n=n, edges=jdata.path_graph(n).edges)
    pr = _pair(max_batch=4, chunk_iters=2, warm_answers=0,
               host_kernels=host_kernels)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    pr.submit("reach", 0)
    pr.submit("reach", n - 2)
    pr.run_until_idle()
    pr.check()
    r0, r1 = pr.reqs[0][1], pr.reqs[1][1]
    assert int(r0.result.sum()) == n and int(r1.result.sum()) == 2
    assert r0.iters >= n - 2
    assert pr.p.stats()["chunks"] >= (n - 2) // 2


# --------------------------------------------------------------------------
# scheduling semantics
# --------------------------------------------------------------------------


@pytest.mark.parametrize("host_kernels", HOST_KERNELS)
def test_slots_reused_across_stream(host_kernels):
    jdb, db = bm_dbs()
    pr = _pair(max_batch=4, chunk_iters=2, warm_answers=0,
               host_kernels=host_kernels)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    for s in np.random.default_rng(3).integers(0, 120, 20):
        pr.submit("reach", int(s))
    pr.run_until_idle()
    pr.check()
    st_ = pr.p.stats()
    assert st_["admitted"] == st_["evicted"] == 20
    assert st_["families"]["reach"]["pool_b"] == 4


@pytest.mark.parametrize("host_kernels", HOST_KERNELS)
def test_fifo_delivery_per_family(host_kernels):
    """Rows converge out of order; delivery is in submission order, and
    the same order in both packages step by step."""
    jdb, db = bm_dbs()
    pr = _pair(max_batch=8, chunk_iters=1, warm_answers=0,
               host_kernels=host_kernels)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    for s in np.random.default_rng(4).integers(0, 120, 12):
        pr.submit("reach", int(s))
    while pr.p.pending() or pr.j.pending():
        a, b = pr.step()
        assert len(a) == len(b)
    pr.check()
    assert pr.delivered[1] == [p for _, p in pr.reqs]
    dones = [p.done_s for _, p in pr.reqs]
    assert dones == sorted(dones)


@pytest.mark.parametrize("host_kernels", HOST_KERNELS)
def test_update_fence_orders_answers(host_kernels):
    n = 16
    jdb, db = bm_dbs(n=n, edges=[[i, i + 1] for i in range(6)])
    pr = _pair(max_batch=4, chunk_iters=1, warm_answers=0,
               host_kernels=host_kernels)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    pr.submit("reach", 0)
    pr.submit_update("reach", [[6, 9]])
    pr.submit("reach", 0)
    pr.run_until_idle()
    pr.check()
    before, u, after = (p for _, p in pr.reqs)
    assert u.applied
    assert not before.result[9] and int(before.result.sum()) == 7
    assert after.result[9] and int(after.result.sum()) == 8


@pytest.mark.parametrize("host_kernels", HOST_KERNELS)
@pytest.mark.parametrize("op", ["delete", "merge"])
def test_update_repairs_warm_answers(host_kernels, op):
    """A warm answer repaired in place across a delete (the synthesized
    ⊖/recount rule) or a merge (delta-restart); the next query
    warm-hits it."""
    jdb, db = bm_dbs()
    pr = _pair(max_batch=4, host_kernels=host_kernels)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    pr.submit("reach", 5)
    pr.run_until_idle()
    pr.submit("reach", 5)
    pr.run_until_idle()
    e0 = db.relations["E"].as_np().coords[:1]
    coords = e0 if op == "delete" else [[5, 77]]
    pr.submit_update("reach", coords, op=op)
    pr.submit("reach", 5)
    pr.run_until_idle()
    pr.check()
    st_ = pr.p.stats()
    assert st_["answers_dropped"] == 0 and st_["answers_repaired"] >= 1
    assert st_["warm_hits"] == 2
    rel = db.relations["E"]
    rel = rel.delete_keys(e0) if op == "delete" else rel.apply_delta(coords)
    want, _ = run_program(pmk_bm(5), db.with_relations({"E": rel}))
    assert torch.equal(pr.reqs[-1][1].result, want)


def test_backpressure_sheds_at_queue_limit():
    jdb, db = bm_dbs()
    pr = _pair(max_batch=4, queue_limit=3)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    accepted = [pr.submit("reach", s) for s in range(8)]
    assert sum(a is not None for a in accepted) == 3
    for server, exc in ((pr.p, BackpressureError),
                        (pr.j, JBackpressureError)):
        with pytest.raises(exc) as e:
            server.submit("reach", 9)
        assert e.value.family == "reach" and e.value.limit == 3
    assert pr.p.stats()["shed"] == 6
    pr.run_until_idle()
    pr.submit("reach", 9)
    pr.submit_update("reach", db.relations["E"].as_np().coords[:1],
                     op="delete")
    pr.run_until_idle()
    pr.check()
    assert pr.p.stats()["updates"] == 1


def test_weighted_fairness_no_starvation():
    """A deep queue on one family cannot starve a light one: the light
    family finishes while the heavy backlog drains, after the same
    number of scheduling rounds in both packages."""
    jdb, db = bm_dbs()
    ss = Sssp()
    pr = _pair(max_batch=4, chunk_iters=1, warm_answers=0)
    pr.register("heavy", jmk_bm, jdb, pmk_bm, db)
    pr.register("light", ss.jmk, ss.jdb, ss.pmk, ss.db, jedges=ss.jrel,
                pedges=ss.rel)
    rng = np.random.default_rng(6)
    heavy = [pr.submit("heavy", int(s)) for s in rng.integers(0, 120, 40)]
    light = [pr.submit("light", int(s)) for s in rng.integers(0, ss.n, 3)]
    while any(p.done_s == 0.0 for _, p in light):
        pr.step()
    assert all(j.done_s > 0.0 for j, _ in light)
    assert sum(p.done_s > 0.0 for _, p in heavy) < len(heavy)
    pr.run_until_idle()
    pr.check()


def test_register_weight_validation():
    _, db = bm_dbs(n=20)
    cs = ContinuousServer()
    with pytest.raises(ValueError):
        cs.register("reach", pmk_bm, db, weight=0)
    with pytest.raises(ValueError):
        ContinuousServer(max_batch=0)


def test_bad_source_fails_without_stranding():
    jdb, db = bm_dbs()

    def jmk(a):
        return (jprograms.sssp(a=0, wmax=4, dmax=16).optimized if a == 999
                else jmk_bm(a))

    def pmk(a):
        return (programs.sssp(a=0, wmax=4, dmax=16).optimized if a == 999
                else pmk_bm(a))

    pr = _pair(max_batch=4, warm_answers=0)
    pr.register("reach", jmk, jdb, pmk, db)
    for s in (1, 2, 999, 3):
        pr.submit("reach", s)
    pr.run_until_idle()
    pr.check()
    assert pr.reqs[2][1].result is None and pr.reqs[2][1].error
    assert pr.p.stats()["failed"] == 1


@pytest.mark.parametrize("kind", ["bm", "sssp"])
def test_fast_init_matches_reference(kind):
    """The probed one-hot init: the port's family_init equals the
    reference's and the evaluated init; an operator swap at an in-range
    source falls back to the erroring slow path."""
    if kind == "bm":
        jdb, db = bm_dbs()
        jmk0, pmk0 = jmk_bm, pmk_bm
    else:
        ss = Sssp()
        jdb, db, jmk0, pmk0 = ss.jdb, ss.db, ss.jmk, ss.pmk

    def jmk(a):
        return jprograms.cc().optimized if a == 7 else jmk0(a)

    def pmk(a):
        return programs.cc().optimized if a == 7 else pmk0(a)

    jf = jfam.build_family("f", jmk, jdb)
    pf = fam_mod.build_family("f", pmk, db)
    assert (jf.fast_init is None) == (pf.fast_init is None) is False
    for s in (0, 1, 5, pf.n - 1):
        got = fam_mod.family_init(pf, s)
        want = jfam.family_init(jf, s)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        ev = planner.source_init(pf.plan, pmk(s), pf.host_db,
                                 hints=dict(pmk(s).sort_hints),
                                 backend="np")
        assert np.array_equal(got, ev)
    with pytest.raises(Exception, match="linear operator"):
        fam_mod.family_init(pf, 7)


# --------------------------------------------------------------------------
# bounded caches inside the servers
# --------------------------------------------------------------------------


def test_compile_cache_lru_bound_continuous():
    jdb, db = bm_dbs()
    pr = _pair(max_batch=8, warm_answers=0, compiled_cache=1,
               host_kernels=False)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    for batch in ((1, 2), (3, 4, 5), tuple(range(8))):
        for s in batch:
            pr.submit("reach", s)
        pr.run_until_idle()
    pr.check()
    cc = pr.p.stats()["compile_cache"]
    assert cc["size"] == 1 and cc["evictions"] >= 2


def test_compile_cache_lru_bound_shim():
    from repro.launch.datalog_serve import DatalogServer as JDS
    from repro_torch.launch.datalog_serve import DatalogServer
    jdb, db = bm_dbs()
    pr = Pair(JDS(max_batch=8, warm_answers=0, compiled_cache=1),
              DatalogServer(max_batch=8, warm_answers=0, compiled_cache=1))
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    for batch in ((1, 2), tuple(range(8)), (11, 12)):
        for s in batch:
            pr.submit("reach", s)
        pr.run_until_idle()
    pr.check()
    assert pr.p.stats["cache_evictions"] >= 2
    assert pr.p.stats["cache_misses"] >= 3


def test_warm_answer_lru_bound():
    jdb, db = bm_dbs()
    pr = _pair(max_batch=4, warm_answers=2)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    for s in (1, 2, 3):
        pr.submit("reach", s)
    pr.run_until_idle()
    pr.submit("reach", 1)
    pr.run_until_idle()
    pr.check()
    fs = pr.p.stats()["families"]["reach"]
    assert fs["warm_answers"] == 2 and fs["warm_evictions"] >= 1
    assert pr.p.stats()["warm_hits"] == 0 and pr.reqs[-1][1].iters >= 1


@pytest.mark.parametrize("host_kernels", HOST_KERNELS)
def test_stats_latency_and_gauges(host_kernels):
    jdb, db = bm_dbs()
    pr = _pair(max_batch=4, warm_answers=0, host_kernels=host_kernels)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db)
    for s in range(6):
        pr.submit("reach", s)
    pr.run_until_idle()
    pr.check()
    st_ = pr.p.stats()
    lat = st_["latency"]["total"]
    assert lat["count"] == 6
    assert 0 < lat["p50_ms"] <= lat["p95_ms"] <= lat["p99_ms"]
    fam = st_["families"]["reach"]
    assert (fam["queue_depth"], fam["in_flight"], fam["served"]) == (0, 0, 6)
    assert fam["frontier"]["chunks"] == st_["chunks"] > 0


def test_chunk_stepper_carry_stays_on_the_operator_device():
    """TorchChunkStepper keeps its (B, n) carry as tensors on the
    operator's device between chunks, across admit, step and harvest;
    its host copy of the live mask and counts matches the carry."""
    jdb, db = bm_dbs()
    cs = ContinuousServer(max_batch=4, chunk_iters=1, warm_answers=0,
                          host_kernels=False)
    cs.register("reach", pmk_bm, db)
    for s in (1, 2, 3):
        cs.submit("reach", s)
    cs.step()
    stp = cs._families["reach"].pool.stepper
    assert isinstance(stp, TorchChunkStepper)
    for t in (stp.y, stp.d, stp.it):
        assert isinstance(t, torch.Tensor) and t.device == db.device
    live = stp.d.any(dim=1).numpy()
    assert np.array_equal(stp.live_lanes(), live)
    assert stp.frontier_nnz() == int(stp.d.sum())
    assert np.array_equal(stp._iters, stp.it.numpy())
    cs.run_until_idle()


@pytest.mark.parametrize("sr_name", ["bool", "trop"])
def test_chunk_stepper_stages_admissions_until_the_chunk(sr_name):
    """Admission stages a row's init on the host and the next chunk
    writes every staged row at once, its seed formed on the device; a
    row admitted with no live seed is extracted as 0̄ in 0 rounds and is
    not live after the chunk; a released slot admitted again restarts
    from y = 0̄ with its count reset — each row equal to its own
    single-source fixpoint, answer and count."""
    from repro_torch.core import runners
    from repro_torch.datalog import datasets
    from repro_torch.sparse import fixpoint as fx
    rel = datasets.powerlaw(150, 4, seed=1).sparse_adjacency(
        semiring=sr_name, device="cpu")
    n = 150
    zero = 0.0 if sr_name == "bool" else np.inf
    src_val = 1.0 if sr_name == "bool" else 0.0
    dtype = bool if sr_name == "bool" else np.float32

    def init(s):
        v = np.full(n, zero, dtype)
        if s is not None:
            v[s] = src_val
        return v

    def alone(s):
        y, iters = fx.fixpoint(rel, torch.from_numpy(init(s)))
        return y, iters

    stp = TorchChunkStepper(rel, n, 4, runners.get(
        "sparse_frontier_pallas").serve_chunk_fn(2))
    d0 = stp.d.clone()
    assert stp.admit(0, init(3)) and stp.admit(1, init(7))
    assert stp.admit(2, init(None))
    assert torch.equal(stp.d, d0)            # nothing written yet
    assert list(stp.live_lanes()) == [True, True, True, False]
    y, iters = stp.extract(2)                # flushes the staged rows
    assert iters == 0 and not stp._sr.live(y).any()
    assert not stp._staged
    stp.step(2)
    assert list(stp.live_lanes())[2:] == [False, False]
    while stp.live_lanes().any():
        stp.step(2)
    for j, s in ((0, 3), (1, 7)):
        y, iters = stp.extract(j)
        want, w_iters = alone(s)
        assert torch.equal(y, want) and iters == w_iters
    stp.release(0)
    assert stp.admit(0, init(11))
    while stp.live_lanes().any():
        stp.step(2)
    y, iters = stp.extract(0)
    want, w_iters = alone(11)
    assert torch.equal(y, want) and iters == w_iters
    assert int(stp.it[0]) == w_iters


# --------------------------------------------------------------------------
# randomized soak: both packages, one stream
# --------------------------------------------------------------------------


def _bfs(n, edge_set, source):
    adj = {}
    for u, v in edge_set:
        adj.setdefault(u, []).append(v)
    seen = np.zeros(n, bool)
    seen[source] = True
    frontier = [source]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj.get(u, ()):
                if not seen[v]:
                    seen[v] = True
                    nxt.append(v)
        frontier = nxt
    return seen


@settings(max_examples=2, deadline=None)
@given(seed=st.integers(0, 2**20), chunk_iters=st.sampled_from([1, 2, 4]),
       host_kernels=st.booleans())
def test_soak_continuous_scheduler(seed, chunk_iters, host_kernels):
    """Interleaved queries, merges, deletes and backpressure bursts on
    two families, fed to both packages: the same answers, counts,
    delivery order and counters, no request lost or delivered twice, and
    every reach answer equal to BFS on the graph version in force at its
    submission."""
    rng = np.random.default_rng(seed)
    n_bm = 60
    g_bm = jdata.erdos_renyi(n_bm, 2.5, seed=seed % 97)
    jdb, db = bm_dbs(n=n_bm, edges=g_bm.edges)
    ss = Sssp(n=50, seed=(seed + 1) % 89)
    pr = _pair(max_batch=8, chunk_iters=chunk_iters, queue_limit=16,
               warm_answers=32, host_kernels=host_kernels)
    pr.register("reach", jmk_bm, jdb, pmk_bm, db, weight=2)
    pr.register("sssp", ss.jmk, ss.jdb, ss.pmk, ss.db, jedges=ss.jrel,
                pedges=ss.rel)
    eh = db.relations["E"].as_np()
    edge_sets = [{(int(u), int(v))
                  for u, v in np.asarray(eh.coords[:int(eh.nnz)])}]
    version = {}
    shed = 0

    def submit(fam, src):
        nonlocal shed
        out = pr.submit(fam, src)
        if out is None:
            shed += 1
        elif fam == "reach":
            version[id(out[1])] = len(edge_sets) - 1

    for _ in range(200):
        roll = rng.random()
        if roll < 0.45:
            submit("reach", int(rng.integers(0, n_bm)))
        elif roll < 0.80:
            submit("sssp", int(rng.integers(0, ss.n)))
        elif roll < 0.88 and len(edge_sets) <= 5:
            cur = edge_sets[-1]
            if roll < 0.84 or not cur:
                u, v = (int(x) for x in rng.integers(0, n_bm, 2))
                v = (v + 1) % n_bm if u == v else v
                pr.submit_update("reach", [[u, v]])
                edge_sets.append(cur | {(u, v)})
            else:
                u, v = sorted(cur)[int(rng.integers(0, len(cur)))]
                pr.submit_update("reach", [[u, v]], op="delete")
                edge_sets.append(cur - {(u, v)})
        elif roll < 0.93:
            for _ in range(25):
                submit("reach", int(rng.integers(0, n_bm)))
        else:
            pr.step()
        if rng.random() < 0.3:
            pr.step()
    pr.run_until_idle()
    pr.check()
    assert shed > 0 and pr.p.stats()["shed"] == shed
    ids = [id(r) for r in pr.delivered[1]]
    assert len(ids) == len(set(ids)) == len(pr.reqs)
    for _, p in pr.reqs:
        assert p.error is None, p.error
        if p.family == "reach" and hasattr(p, "source"):
            want = _bfs(n_bm, edge_sets[version[id(p)]], p.source)
            assert np.array_equal(np_of(p.result), want), p.source
