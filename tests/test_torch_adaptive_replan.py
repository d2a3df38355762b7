"""Port parity: mid-fixpoint adaptive re-planning.

``repro_torch``'s ``ReplanPolicy``, ``AdaptiveCostModel``, the runners'
``estimate``/``finalize``/``run_chunk`` hand-offs, ``adaptive_fixpoint``
and the planner's ``PlanHints(adaptive=, replan=)`` path against
``repro``'s, on the CPU, on the reference tests' inputs
(``tests/test_adaptive_replan.py``): the same numpy buffers go to both
packages, and each case compares answers and per-row iteration counts
bit for bit (bool and trop), and the switch history — chunk, iteration,
frontier nnz, density, runners, and the priced estimates to 1e-9
relative — with the reference's.  ``explain``'s adaptive and switch
lines must be the reference's, byte for byte.

The reference's two sharded hand-off cases need a mesh of two ranks:
they run in spawned gloo worlds in ``tests/test_torch_sharded.py``.
One case here holds, as the reference's
``test_sharded_candidate_dropped_without_mesh`` does, that the
registered ``sparse_sharded`` runner is infeasible without a mesh and
drops out silently, and the run equals the static one.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import planner as jplanner
from repro.core import runners as jrunners
from repro.core.program import run_program as jrun_program
from repro.datalog import datasets as jdata
from repro.datalog import programs as jprograms
from repro.sparse import adaptive as jadaptive
from repro.sparse import fixpoint as jfx
from repro.sparse.coo import SparseRelation as JRel
from repro_torch.core import engine, planner, runners
from repro_torch.core.program import run_program
from repro_torch.datalog import programs
from repro_torch.sparse import adaptive
from repro_torch.sparse import fixpoint as fx
from repro_torch.sparse.coo import SparseRelation


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want)


def _port_rel(jrel: JRel) -> SparseRelation:
    h = jrel.as_np()
    return SparseRelation.from_buffers(h.coords, h.values, h.nnz, h.shape,
                                       h.semiring, device="cpu")


def _chain_hub(n_chain=30, hub=12, seed=0):
    """The reference tests' drifting graph: a chain whose tail feeds a
    dense hub clique.  Returns both packages' relations and n."""
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
    jrel = JRel.from_coo(coords, np.ones(len(coords), bool), (n, n), "bool")
    return jrel.as_jnp(), _port_rel(jrel), n


def _one_hot(n, src=0):
    init = np.zeros(n, bool)
    init[src] = True
    return init


class _Favor:
    """A cost model that makes one runner permanently cheapest (every
    other runner prices 100× dearer)."""

    def __init__(self, favorite):
        self.favorite = favorite

    def round_ns(self, runner, **kw):
        return 1.0 if runner == self.favorite else 100.0


class _Oscillate:
    """Adversarial pricing: the cheapest runner flips every call."""

    def __init__(self):
        self.calls = 0

    def round_ns(self, runner, **kw):
        self.calls += 1
        flip = (self.calls // 2) % 2 == 0
        cheap = "sparse_jit" if flip else "sparse_frontier"
        return 1.0 if runner == cheap else 100.0


class _Flip:
    """The cheapest of two candidates flips at every boundary (two
    calls a boundary), so only the policy's guards hold switches back."""

    def __init__(self):
        self.calls = 0

    def round_ns(self, runner, **kw):
        self.calls += 1
        cheap = ("sparse_frontier", "sparse_jit")[(self.calls - 1) // 2 % 2]
        return 1.0 if runner == cheap else 100.0


def _patch_cost(monkeypatch, make):
    monkeypatch.setattr(jadaptive, "ADAPTIVE_COST", make())
    monkeypatch.setattr(adaptive, "ADAPTIVE_COST", make())


def assert_same_trace(got, want) -> None:
    """The port's AdaptiveRun against the reference's."""
    assert (got.start_runner, got.final_runner) == \
        (want.start_runner, want.final_runner)
    assert got.policy.chunk_iters == want.policy.chunk_iters
    assert [(c.nnz, c.iteration) for c in got.chunks] == \
        [(c.nnz, c.iteration) for c in want.chunks]
    for a, b in zip(got.chunks, want.chunks):
        assert a.density == pytest.approx(b.density, rel=1e-9)
    assert len(got.switches) == len(want.switches)
    for a, b in zip(got.switches, want.switches):
        assert (a.chunk, a.iteration, a.frontier_nnz, a.from_runner,
                a.to_runner) == (b.chunk, b.iteration, b.frontier_nnz,
                                 b.from_runner, b.to_runner)
        assert a.density == pytest.approx(b.density, rel=1e-9)
        assert a.est_from == pytest.approx(b.est_from, rel=1e-9)
        assert a.est_to == pytest.approx(b.est_to, rel=1e-9)


def _both_adaptive(jedges, edges, init, sr_name, *, start, candidates,
                   policy_kw):
    """One adaptive run in each package: ``(y, iters, trace)`` pairs."""
    jctx = jrunners.make_context(jedges, init, sr_name, 10_000)
    ctx = runners.make_context(edges, torch.from_numpy(init), sr_name,
                               10_000)
    ref = jrunners.adaptive_fixpoint(
        jctx, start=start, candidates=candidates,
        policy=jadaptive.ReplanPolicy(**policy_kw))
    got = runners.adaptive_fixpoint(
        ctx, start=start, candidates=candidates,
        policy=adaptive.ReplanPolicy(**policy_kw))
    return got, ref


# --------------------------------------------------------------------------
# ReplanPolicy and the cost model
# --------------------------------------------------------------------------

_GUARDS = [
    ((100.0, 10.0), dict(chunk_index=3, chunks_since_switch=4,
                         switches=0), True),
    ((100.0, 60.0), dict(chunk_index=3, chunks_since_switch=4,
                         switches=0), False),       # hysteresis floor
    ((100.0, 50.0), dict(chunk_index=3, chunks_since_switch=4,
                         switches=0), True),        # exactly 2× cheaper
    ((100.0, 10.0), dict(chunk_index=0, chunks_since_switch=1,
                         switches=0), False),       # warmup
    ((100.0, 10.0), dict(chunk_index=3, chunks_since_switch=1,
                         switches=0), False),       # spacing
    ((100.0, 10.0), dict(chunk_index=9, chunks_since_switch=5,
                         switches=1), False),       # hard cap
]


@pytest.mark.parametrize("costs, kw, want", _GUARDS)
def test_should_switch_guards(costs, kw, want):
    fields = dict(chunk_iters=4, hysteresis=2.0, min_chunks_between=2,
                  max_switches=1, warmup_chunks=1)
    got = adaptive.ReplanPolicy(**fields).should_switch(*costs, **kw)
    assert got == jadaptive.ReplanPolicy(**fields).should_switch(*costs,
                                                                  **kw)
    assert got is want


def test_policy_and_cost_model_defaults_are_the_reference():
    assert adaptive.ReplanPolicy() == adaptive.ReplanPolicy(
        **vars(jadaptive.ReplanPolicy()))
    assert vars(adaptive.AdaptiveCostModel()) == \
        vars(jadaptive.AdaptiveCostModel())


@pytest.mark.parametrize("runner", ["sparse_frontier", "sparse_jit",
                                    "sparse_frontier_pallas",
                                    "vector_dense", "sparse_sharded"])
@pytest.mark.parametrize("sr_name", ["bool", "trop"])
def test_round_ns_matches_reference(runner, sr_name):
    kw = dict(n=50_260, e_nnz=900_123, batch=64, frontier_nnz=4,
              live_rows=4, semiring=sr_name, fused_speedup=51.3,
              mesh_d=1)
    assert adaptive.ADAPTIVE_COST.round_ns(runner, **kw) == \
        jadaptive.ADAPTIVE_COST.round_ns(runner, **kw)
    with pytest.raises(ValueError, match="no adaptive cost model"):
        adaptive.ADAPTIVE_COST.round_ns("dense_gsn", **kw)


# --------------------------------------------------------------------------
# FixpointState observations, chunks and resume
# --------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [1, 3, 6])
def test_live_rows_matches_reference(budget):
    """``live_rows``/``frontier_nnz``/``density`` of the same carry (a
    (4, n) pack stopped after ``budget`` rounds, one inert row)."""
    jedges, edges, n = _chain_hub()
    init = np.zeros((4, n), bool)
    init[0, 0] = init[1, 25] = init[2, 33] = True
    jst = jfx.fixpoint(jedges, init, budget=budget, mode="jit")
    st = fx.fixpoint(edges, torch.from_numpy(init), budget=budget)
    assert_same(st.delta, jst.delta)
    assert st.live_rows() == jst.live_rows()
    assert st.frontier_nnz() == jst.frontier_nnz()
    assert st.density() == pytest.approx(jst.density(), rel=1e-12)
    assert 0 < st.live_rows() < 4


def test_fixpoint_requires_exactly_one_seed():
    jedges, edges, n = _chain_hub()
    init = torch.from_numpy(_one_hot(n))
    with pytest.raises(ValueError, match="exactly one"):
        fx.fixpoint(edges)
    st = fx.FixpointState.cold(edges, init)
    with pytest.raises(ValueError, match="exactly one"):
        fx.fixpoint(edges, init, state=st)


def test_fixpoint_chunked_matches_static():
    """Chained budget= calls across alternating runners converge to the
    static answer with the reference's counts and chunk count."""
    jedges, edges, n = _chain_hub()
    init = _one_hot(n)
    y_ref, it_ref = jfx.fixpoint(jedges, init, mode="jit")
    counts = []
    for mod, rel, i0 in ((jfx, jedges, init),
                         (fx, edges, torch.from_numpy(init))):
        st = mod.FixpointState.cold(rel, i0)
        k = 0
        while not st.converged:
            st = mod.fixpoint(rel, state=st, budget=3,
                              mode=("jit", "frontier")[k % 2])
            k += 1
        y, iters = st.solution()
        assert_same(y, y_ref)
        assert int(iters) == int(it_ref)
        counts.append(k)
    assert counts[0] == counts[1] > 3


def test_fixpoint_resume_from_state():
    jedges, edges, n = _chain_hub()
    init = _one_hot(n)
    y_ref, it_ref = jfx.fixpoint(jedges, init, mode="jit")
    st = fx.fixpoint(edges, torch.from_numpy(init), budget=4)
    jst = jfx.fixpoint(jedges, init, budget=4)
    assert_same(st.y[0], np.asarray(jst.y)[0])
    y, iters = fx.fixpoint(edges, state=st)
    assert_same(y, y_ref)
    assert iters == int(it_ref)


def test_deprecated_shims_warn_and_agree():
    jedges, edges, n = _chain_hub()
    init = torch.from_numpy(_one_hot(n))
    y_ref, it_ref = jfx.fixpoint(jedges, _one_hot(n), mode="jit")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        y1, it1 = fx.sparse_seminaive_fixpoint(edges, init, mode="jit")
        st = fx.FixpointState.cold(edges, init)
        y2, it2 = fx.resume_fixpoint(edges, st.y[0], st.delta[0],
                                     mode="jit")
        y3, d3, it3 = fx.resume_fixpoint_chunk(
            edges, st.y, st.delta, torch.zeros(1, dtype=torch.int32),
            max_iters=10_000)
    kinds = [x.category for x in w]
    assert kinds.count(DeprecationWarning) >= 3
    assert_same(y1, y_ref)
    assert it1 == int(it_ref)
    assert_same(y2, y_ref)
    assert_same(y3[0], y_ref)


# --------------------------------------------------------------------------
# Runner hand-offs, bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("start,target", [
    ("sparse_jit", "sparse_frontier"),
    ("sparse_frontier", "sparse_jit"),
    ("sparse_jit", "vector_dense"),
    ("vector_dense", "sparse_frontier"),
    ("sparse_jit", "sparse_frontier_pallas"),
    ("sparse_frontier_pallas", "sparse_frontier"),
])
def test_handoff_bit_exact(start, target, monkeypatch):
    jedges, edges, n = _chain_hub()
    init = _one_hot(n)
    y_ref, it_ref = jfx.fixpoint(jedges, init, mode="jit")
    _patch_cost(monkeypatch, lambda: _Favor(target))
    (y, iters, tr), (jy, jiters, jtr) = _both_adaptive(
        jedges, edges, init, "bool", start=start,
        candidates=(start, target), policy_kw=dict(chunk_iters=3))
    assert_same(y, y_ref)
    assert_same(y, jy)
    assert iters == int(it_ref) == int(np.asarray(jiters))
    assert_same_trace(tr, jtr)
    assert tr.final_runner == target
    assert [(e.from_runner, e.to_runner) for e in tr.switches] == \
        [(start, target)]
    assert tr.switches[0].est_to < tr.switches[0].est_from


def test_sharded_candidate_dropped_silently(monkeypatch):
    """``sparse_sharded`` is registered and chunkable, but without a mesh
    in the context it is infeasible: named as a candidate — even priced
    cheapest — it drops out, and the run equals the static one and the
    reference's mesh-less run."""
    jedges, edges, n = _chain_hub()
    init = _one_hot(n)
    y_ref, it_ref = jfx.fixpoint(jedges, init, mode="jit")
    _patch_cost(monkeypatch, lambda: _Favor("sparse_sharded"))
    (y, iters, tr), (jy, jiters, jtr) = _both_adaptive(
        jedges, edges, init, "bool", start="sparse_jit",
        candidates=("sparse_sharded", "sparse_jit"), policy_kw={})
    sharded = runners.RUNNER_REGISTRY["sparse_sharded"]
    assert sharded.chunkable
    assert not sharded.feasible(runners.make_context(
        edges, torch.from_numpy(init), "bool", 10_000))
    assert tr.switches == [] and tr.final_runner == "sparse_jit"
    assert tr.prices == []   # one candidate left: nothing was priced
    assert_same(y, y_ref)
    assert iters == int(it_ref)
    assert_same_trace(tr, jtr)


def test_unknown_start_runner_is_refused():
    jedges, edges, n = _chain_hub()
    ctx = runners.make_context(edges, torch.from_numpy(_one_hot(n)),
                               "bool", 10_000)
    for start in ("sparse_sharded", "dense_gsn"):
        with pytest.raises(ValueError, match="not a feasible"):
            runners.adaptive_fixpoint(ctx, start=start)


def test_trop_handoff_bit_exact(monkeypatch):
    """Hand-offs are exact on the tropical semiring (⊖ = masked keep)."""
    g = jdata.erdos_renyi(60, 3.0, seed=7, weighted=True)
    jrel = g.sparse_adjacency(semiring="trop").as_jnp()
    rel = _port_rel(jrel)
    init = np.full(60, np.inf, np.float32)
    init[0] = 0.0
    y_ref, it_ref = jfx.fixpoint(jrel, init, mode="jit")
    _patch_cost(monkeypatch, lambda: _Favor("sparse_frontier"))
    (y, iters, tr), (jy, jiters, jtr) = _both_adaptive(
        jrel, rel, init, "trop", start="sparse_jit",
        candidates=("sparse_frontier",), policy_kw=dict(chunk_iters=2))
    assert_same(y, y_ref)
    assert_same(y, jy)
    assert iters == int(it_ref) == int(np.asarray(jiters))
    assert_same_trace(tr, jtr)
    assert tr.final_runner == "sparse_frontier"


def test_estimates_match_reference_mid_run():
    """``Runner.estimate`` of every chunkable runner on a mid-run (4, n)
    carry: the reference's priced ns, the fused speedup read from
    ``SPMM_COST``'s entry for the operator's device (the CPU here)."""
    jedges, edges, n = _chain_hub()
    init = np.zeros((4, n), bool)
    init[:, [0, 10, 20, 31]] = np.eye(4, dtype=bool)
    jctx = jrunners.make_context(jedges, init, "bool", 10_000)
    ctx = runners.make_context(edges, torch.from_numpy(init), "bool",
                               10_000)
    jst = jfx.fixpoint(jedges, init, budget=3, mode="jit")
    st = fx.fixpoint(edges, torch.from_numpy(init), budget=3)
    for name in ("sparse_frontier", "sparse_jit", "sparse_frontier_pallas",
                 "vector_dense"):
        got = runners.get(name).estimate(ctx, st)
        want = jrunners.get(name).estimate(jctx, jst)
        assert got.total == pytest.approx(want.total, rel=1e-9), name
        assert (got.trips, got.source) == (1, "adaptive")
    assert planner.SPMM_COST.speedup("bool", "cpu") == 8.0


def test_vector_dense_chunks_on_a_dense_operator():
    """A dense operator (a ``vector_dense`` plan's) runs adaptively in
    the port; the reference's cold carry reads ``edges.semiring`` and
    fails there (ROADMAP C).  Chunks equal the reference's static
    dense runner."""
    jedges, edges, n = _chain_hub()
    init = _one_hot(n)
    dense = edges.to_dense()
    y_ref, it_ref = jrunners.get("vector_dense").full_fn(
        jrunners.make_context(jedges.to_dense(), init, "bool", 10_000))(
            jedges.to_dense(), jnp.asarray(init))
    ctx = runners.make_context(dense, torch.from_numpy(init), "bool",
                               10_000)
    y, iters, tr = runners.adaptive_fixpoint(
        ctx, start="vector_dense", candidates=("sparse_jit",),
        policy=adaptive.ReplanPolicy(chunk_iters=4))
    assert_same(y, y_ref)
    assert iters == int(it_ref)
    assert len(tr.chunks) == -(-iters // 4) and tr.switches == []


# --------------------------------------------------------------------------
# ReplanPolicy thrash guards
# --------------------------------------------------------------------------


def test_thrash_guard_bounds_switches(monkeypatch):
    jrel, _, _ = _chain_hub(n_chain=60, hub=8)
    jedges, edges, n = jrel, _port_rel(jrel), 68
    init = _one_hot(n)
    y_ref, it_ref = jfx.fixpoint(jedges, init, mode="jit")
    _patch_cost(monkeypatch, _Oscillate)
    pol = dict(chunk_iters=2, max_switches=2, min_chunks_between=2)
    (y, iters, tr), (jy, jiters, jtr) = _both_adaptive(
        jedges, edges, init, "bool", start="sparse_jit",
        candidates=("sparse_frontier",), policy_kw=pol)
    assert len(tr.switches) <= pol["max_switches"]
    for a, b in zip(tr.switches, tr.switches[1:]):
        assert b.chunk - a.chunk >= pol["min_chunks_between"]
    assert_same(y, y_ref)
    assert iters == int(it_ref)
    assert_same_trace(tr, jtr)


def test_trace_replays_through_its_policy(monkeypatch):
    """Every priced boundary of the trace replays through
    ``should_switch`` to the decision the executor took."""
    jrel, _, _ = _chain_hub(n_chain=60, hub=8)
    edges = _port_rel(jrel)
    monkeypatch.setattr(adaptive, "ADAPTIVE_COST", _Flip())
    pol = adaptive.ReplanPolicy(chunk_iters=2, max_switches=3,
                                min_chunks_between=2)
    ctx = runners.make_context(edges, torch.from_numpy(_one_hot(68)),
                               "bool", 10_000)
    _, iters, tr = runners.adaptive_fixpoint(
        ctx, start="sparse_jit", candidates=("sparse_frontier",),
        policy=pol)
    switched = {e.chunk: e for e in tr.switches}
    done = []
    for chunk, current, est in tr.prices:
        best = min(est, key=lambda c: (est[c], c != current, c))
        since = chunk - done[-1] if done else chunk + 1
        fire = best != current and pol.should_switch(
            est[current], est[best], chunk_index=chunk,
            chunks_since_switch=since, switches=len(done))
        assert fire == (chunk in switched)
        if fire:
            done.append(chunk)
            assert (switched[chunk].est_from, switched[chunk].est_to) == \
                (est[current], est[best])
    assert len(done) == pol.max_switches
    assert len(tr.chunks) == -(-iters // pol.chunk_iters)
    assert len(tr.prices) == len(tr.chunks) - 1


# --------------------------------------------------------------------------
# Planner integration: PlanHints, adaptive execution, explain
# --------------------------------------------------------------------------


def _bm_dbs(n=120, avg_deg=3.0, seed=2):
    g = jdata.erdos_renyi(n, avg_deg, seed=seed)
    schema = jprograms.bm(a=0).original.schema
    e = g.sparse_adjacency()
    jdb = jengine.Database(schema, {"id": n},
                           {"E": e, "V": jnp.ones((n,), bool)})
    h = e.as_np()
    db = engine.Database.from_numpy(
        programs.bm(a=0).original.schema, {"id": n},
        {"E": dict(coords=h.coords, values=h.values, nnz=h.nnz,
                   shape=h.shape, semiring=h.semiring),
         "V": np.ones(n, bool)}, device="cpu")
    return jdb, db


def _adaptive_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("    adaptive ", "    switch "))]


def test_plan_hints_validation():
    for mod in (planner, jplanner):
        with pytest.raises(TypeError):
            mod.PlanHints(sorts={1: "asc"})
        with pytest.raises(TypeError):
            mod.PlanHints(replan="yes")
    with pytest.raises(TypeError, match="ReplanPolicy"):
        planner.PlanHints(replan=jadaptive.ReplanPolicy())
    ph = planner.PlanHints(adaptive=True,
                           replan=adaptive.ReplanPolicy(chunk_iters=2))
    jph = jplanner.PlanHints(adaptive=True,
                             replan=jadaptive.ReplanPolicy(chunk_iters=2))
    assert ph.cache_key()[1] is True
    assert ph.cache_key()[:2] == jph.cache_key()[:2]
    assert planner.PlanHints().cache_key() == ((), False, None)
    jdb, db = _bm_dbs()
    prog = programs.bm(a=0).optimized
    plan = planner.plan_program(prog, db, hints=ph)
    assert plan.adaptive and plan.replan is ph.replan
    assert not planner.plan_program(prog, db).adaptive
    assert planner.plan_for(prog, db, hints=ph) is not \
        planner.plan_for(prog, db)


def test_adaptive_execution_matches_static_and_logs():
    jdb, db = _bm_dbs()
    jprog, prog = jprograms.bm(a=0).optimized, programs.bm(a=0).optimized
    ref, _ = jrun_program(jprog, jdb, mode="naive")
    jplan = jplanner.plan_program(jprog, jdb,
                                  hints=jplanner.PlanHints(adaptive=True))
    plan = planner.plan_program(prog, db,
                                hints=planner.PlanHints(adaptive=True))
    assert plan.adaptive and plan.strata[0].runner == \
        jplan.strata[0].runner
    jout, jst = jplanner.execute_plan(jplan, jprog, jdb)
    out, st = planner.execute_plan(plan, prog, db)
    assert_same(out, ref)
    assert st.iterations == jst.iterations
    sp = plan.strata[0]
    assert sp.switch_log is not None and sp.switch_log.chunks
    assert_same_trace(sp.switch_log, jplan.strata[0].switch_log)
    txt = planner.explain(plan)
    assert f"finished on {sp.switch_log.final_runner}" in txt
    assert _adaptive_lines(txt) == \
        _adaptive_lines(jplanner.explain(jplan)) != []


def test_adaptive_switch_rendered_in_explain(monkeypatch):
    """The CPU plan picks the worklist and keeps the staged runner in
    ``considered``; pricing the staged runner cheapest forces a switch,
    whose explain lines are the reference's byte for byte."""
    jdb, db = _bm_dbs()
    jprog, prog = jprograms.bm(a=0).optimized, programs.bm(a=0).optimized
    ref, _ = jrun_program(jprog, jdb, mode="naive")
    jplan = jplanner.plan_program(jprog, jdb)
    plan = planner.plan_program(prog, db)
    start = plan.strata[0].runner
    target = next(c for c in plan.strata[0].considered
                  if c != start and runners.get(c).chunkable)
    assert (start, target) == ("sparse_frontier", "sparse_jit")
    _patch_cost(monkeypatch, lambda: _Favor(target))
    jpol = jadaptive.ReplanPolicy(chunk_iters=1)
    pol = adaptive.ReplanPolicy(chunk_iters=1)
    jplanner.execute_plan(jplan, jprog, jdb,
                          hints=jplanner.PlanHints(adaptive=True,
                                                   replan=jpol))
    out, _ = planner.execute_plan(
        plan, prog, db, hints=planner.PlanHints(adaptive=True, replan=pol))
    assert_same(out, ref)
    tr = plan.strata[0].switch_log
    assert tr is not None and tr.policy is pol
    assert_same_trace(tr, jplan.strata[0].switch_log)
    lines = _adaptive_lines(planner.explain(plan))
    assert lines == _adaptive_lines(jplanner.explain(jplan))
    assert len(tr.switches) == 1
    assert f"{start} → {target}" in lines[1]


def test_adaptive_forced_plan_still_converges():
    """A forced single-runner plan has no ``considered`` alternatives:
    the adaptive executor still chunks it to convergence."""
    jdb, db = _bm_dbs()
    jprog, prog = jprograms.bm(a=0).optimized, programs.bm(a=0).optimized
    ref, _ = jrun_program(jprog, jdb, mode="naive")
    jplan = jplanner.plan_program(jprog, jdb, mode="sparse_jit")
    plan = planner.plan_program(prog, db, mode="sparse_jit")
    jplanner.execute_plan(jplan, jprog, jdb,
                          hints=jplanner.PlanHints(adaptive=True))
    out, _ = planner.execute_plan(plan, prog, db,
                                  hints=planner.PlanHints(adaptive=True))
    assert_same(out, ref)
    tr = plan.strata[0].switch_log
    assert tr is not None and tr.switches == []
    assert_same_trace(tr, jplan.strata[0].switch_log)
    assert _adaptive_lines(planner.explain(plan)) == \
        _adaptive_lines(jplanner.explain(jplan))


def test_explain_without_adaptive_run_has_no_switch_lines():
    jdb, db = _bm_dbs()
    prog = programs.bm(a=0).optimized
    plan = planner.plan_program(prog, db)
    before = planner.explain(plan)
    assert "adaptive " not in before and "switch " not in before
    out, _ = planner.execute_plan(plan, prog, db)
    assert planner.explain(plan) == before
    assert plan.strata[0].switch_log is None
    out2, _ = run_program(prog, db)
    assert_same(out, out2)
