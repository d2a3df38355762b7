"""Port parity: the frontier worklist, its CSR cache and their callers.

``repro_torch.sparse.fixpoint`` in ``mode="frontier"`` against
``repro.sparse.fixpoint`` in its frontier mode, on the same COO buffers
(a ``powerlaw(300, 3)`` graph; maxplus on its acyclic half, so longest
paths converge).  Each check is a case of a test over bool, trop and
maxplus — values, per-row iteration counts and both ``FrontierStats``
lists bit for bit — and nat, whose ⊕ has no ⊖: there the fixpoint
checks hold that both packages refuse it, and the index, overlay and
buffer checks compare exactly.

Also here: ``csr_index`` in both orientations, the ``apply_delta``
overlay and its compaction point, ``delete_keys`` poisoning, the
``apply_delta``/``delete_keys``/``union`` buffers, the deprecated
wrappers and their warnings, the ``sparse_frontier`` runner's chunks,
and the planner's picks and ``explain`` on CPU databases.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import fixpoint as jcore_fx
from repro.core import planner as jplanner
from repro.core import semiring as jsr
from repro.datalog import datasets as jdata
from repro.datalog import programs as jprograms
from repro.sparse import fixpoint as jfx
from repro.sparse.coo import SparseRelation as JRel
from repro_torch.core import fixpoint as core_fx
from repro_torch.core import planner, runners
from repro_torch.datalog import programs
from repro_torch.sparse import fixpoint as fx
from repro_torch.sparse.coo import SparseRelation

SRS = ("bool", "trop", "maxplus", "nat")
N = 300


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def _edges(sr_name: str, seed: int = 0):
    g = jdata.powerlaw(N, 3, seed=seed)
    e = g.edges
    if sr_name == "maxplus":          # acyclic half: longest paths converge
        e = e[e[:, 0] < e[:, 1]]
    rng = np.random.default_rng(seed)
    if sr_name == "bool":
        return e, np.ones(len(e), bool)
    return e, rng.integers(0, 5, len(e)).astype(np.float32)


def _both(sr_name: str, *, pad: int = 40, seed: int = 0):
    """The same padded COO buffers in both packages (host lib for the
    reference, so its CSR hooks run)."""
    e, w = _edges(sr_name, seed)
    jrel = JRel.from_coo(e, w, (N, N), sr_name, capacity=len(e) + pad,
                         lib="np")
    h = jrel.as_np()
    rel = SparseRelation.from_buffers(h.coords, h.values, h.nnz, h.shape,
                                      sr_name, device="cpu")
    return jrel, rel


def _init(b, sr_name, seed, *, inert_row=False):
    """``(b, N)`` inits: 1–3 seeds a row (1̄ or small values)."""
    sr = jsr.get(sr_name, lib="np")
    rng = np.random.default_rng(seed)
    init = np.full((b, N), sr.zero, sr.dtype)
    for r in range(b):
        k = int(rng.integers(1, 4))
        cols = rng.choice(N, k, replace=False)
        init[r, cols] = sr.one if sr_name == "bool" else \
            rng.integers(0, 3, k).astype(np.float32)
    if inert_row:
        init[-1] = sr.zero
    return init


def _lattice(sr_name: str) -> bool:
    return sr_name != "nat"


def _refuse_both(call_ref, call_port):
    """Both packages refuse a semiring without ⊖: the port by name; the
    reference by name too, except that a budgeted run fails earlier, at
    its cold carry's ⊖ call (a TypeError)."""
    with pytest.raises((ValueError, TypeError)):
        call_ref()
    with pytest.raises(ValueError, match="lacks"):
        call_port()


def _same_stats(got, want):
    assert got.frontier_sizes == want.frontier_sizes
    assert got.edges_expanded == want.edges_expanded
    assert got.total_edges == want.total_edges


@pytest.mark.parametrize("sr_name", SRS)
def test_frontier_one_source_matches_reference(sr_name):
    jrel, rel = _both(sr_name)
    init = _init(1, sr_name, seed=1)[0]
    if not _lattice(sr_name):
        _refuse_both(lambda: jfx.fixpoint(jrel, init, mode="frontier"),
                     lambda: fx.fixpoint(rel, torch.from_numpy(init),
                                         mode="frontier"))
        return
    want, wit, wst = jfx.sparse_seminaive_fixpoint_stats(jrel, init)
    got, it, st = fx.sparse_seminaive_fixpoint_stats(
        rel, torch.from_numpy(init))
    assert_same(got, want)
    assert it == wit and isinstance(it, int)
    _same_stats(st, wst)
    assert len(st.frontier_sizes) == it
    y, it2 = fx.fixpoint(rel, torch.from_numpy(init), mode="frontier")
    assert_same(y, want)
    assert it2 == wit


@pytest.mark.parametrize("sr_name", SRS)
def test_frontier_batch_matches_reference(sr_name):
    """A ``(B, n)`` init runs one worklist per row; the inert (all-0̄) row
    takes 0 rounds, as in the reference's frontier."""
    jrel, rel = _both(sr_name)
    init = _init(5, sr_name, seed=2, inert_row=True)
    if not _lattice(sr_name):
        _refuse_both(lambda: jfx.fixpoint(jrel, init, mode="frontier"),
                     lambda: fx.fixpoint(rel, torch.from_numpy(init),
                                         mode="frontier"))
        return
    want, wit, wsts = jfx.sparse_seminaive_fixpoint_stats(jrel, init)
    got, it, sts = fx.sparse_seminaive_fixpoint_stats(
        rel, torch.from_numpy(init))
    assert_same(got, want)
    assert_same(it, wit)
    assert int(it[-1]) == 0
    assert len(sts) == len(wsts) == 5
    for st, wst in zip(sts, wsts):
        _same_stats(st, wst)


@pytest.mark.parametrize("sr_name", SRS)
def test_frontier_warm_state_matches_reference(sr_name):
    """``fixpoint(state=..., mode="frontier")`` from a two-round carry:
    the converged answer, and iters including the carry's."""
    jrel, rel = _both(sr_name)
    init = _init(3, sr_name, seed=3)
    if not _lattice(sr_name):
        _refuse_both(
            lambda: jfx.fixpoint(jrel, init, budget=2, mode="frontier"),
            lambda: fx.fixpoint(rel, torch.from_numpy(init), budget=2,
                                mode="frontier"))
        return
    jst = jfx.fixpoint(jrel, init, budget=2, mode="frontier")
    st = fx.FixpointState.from_numpy(jst.y, jst.delta, jst.iters,
                                      sr_name, True, device="cpu")
    want, wit = jfx.fixpoint(jrel, state=jst, mode="frontier")
    got, it = fx.fixpoint(rel, state=st, mode="frontier")
    assert_same(got, want)
    assert_same(it, wit)
    # one source: the carry keeps its 1-D shape
    jst1 = jfx.fixpoint(jrel, init[0], budget=1, mode="frontier")
    st1 = fx.FixpointState.from_numpy(jst1.y, jst1.delta, jst1.iters,
                                      sr_name, False, device="cpu")
    want, wit = jfx.fixpoint(jrel, state=jst1, mode="frontier")
    got, it = fx.fixpoint(rel, state=st1, mode="frontier")
    assert_same(got, want)
    assert it == wit


@pytest.mark.parametrize("sr_name", SRS)
def test_frontier_budget_chunks_match_reference(sr_name):
    """Chained ``budget=2`` worklist chunks: every carry equal, and the
    chain ends at the cold run's answer."""
    jrel, rel = _both(sr_name)
    init = _init(3, sr_name, seed=4, inert_row=True)
    if not _lattice(sr_name):
        _refuse_both(
            lambda: jfx.fixpoint(jrel, init, budget=2, mode="frontier"),
            lambda: fx.fixpoint(rel, torch.from_numpy(init), budget=2,
                                mode="frontier"))
        return
    jst = jfx.FixpointState.cold(jrel, init)
    st = fx.FixpointState.cold(rel, torch.from_numpy(init))
    for _ in range(30):
        jst = jfx.fixpoint(jrel, state=jst, budget=2, mode="frontier")
        st = fx.fixpoint(rel, state=st, budget=2, mode="frontier")
        assert_same(st.y, jst.y)
        assert_same(st.delta, jst.delta)
        assert_same(st.iters, jst.iters)
        assert st.stats().nnz == jst.stats().nnz
        if jst.converged:
            break
    assert st.converged
    want, wit = fx.fixpoint(rel, torch.from_numpy(init), mode="frontier")
    assert_same(st.y, want)
    assert_same(st.iters, wit)


@pytest.mark.parametrize("sr_name", SRS)
def test_frontier_equals_the_staged_loop(sr_name):
    """Same answers as ``mode="jit"``; the same counts but for the inert
    row (0 rounds in the worklist, 1 in a cold staged run)."""
    _, rel = _both(sr_name)
    init = torch.from_numpy(_init(4, sr_name, seed=5, inert_row=True))
    if not _lattice(sr_name):
        with pytest.raises(ValueError, match="lacks"):
            fx.fixpoint(rel, init, mode="frontier")
        return
    yf, itf = fx.fixpoint(rel, init, mode="frontier")
    yj, itj = fx.fixpoint(rel, init, mode="jit")
    assert_same(yf, yj)
    assert_same(itf[:-1], itj[:-1])
    assert (int(itf[-1]), int(itj[-1])) == (0, 1)
    # auto: the worklist on CPU tensors; budgeted, the staged chunk
    ya, ita = fx.fixpoint(rel, init, mode="auto")
    assert_same(ita, itf)
    cold = fx.FixpointState.cold(rel, init)
    a = fx.fixpoint(rel, state=cold, budget=3, mode="auto")
    j = fx.fixpoint(rel, state=cold, budget=3, mode="jit")
    assert_same(a.y, j.y)
    assert torch.equal(a.iters, j.iters)


@pytest.mark.parametrize("sr_name", SRS)
@pytest.mark.parametrize("transpose", [False, True])
def test_csr_index_matches_reference(sr_name, transpose):
    jrel, rel = _both(sr_name)
    want = jfx.csr_index(jrel, transpose=transpose)
    got = fx.csr_index(rel, transpose=transpose)
    for k in ("counts", "starts", "src", "dst", "w", "xsrc", "xdst", "xw"):
        assert np.array_equal(_np(getattr(got, k)), getattr(want, k)), k
    assert got.w.dtype == rel.values.dtype
    # cached per buffer pair: a second call is the same object, a cast
    # sharing the coords is not
    assert fx.csr_index(rel, transpose=transpose) is got
    twin = SparseRelation(rel.coords, rel.values.clone(), rel.nnz,
                          rel.shape, rel.semiring)
    assert fx._csr_lookup(twin, transpose) is None


@pytest.mark.parametrize("sr_name", SRS)
def test_register_delta_overlay_and_compaction_point(sr_name):
    jrel, rel = _both(sr_name)
    for t in (False, True):
        jfx.csr_index(jrel, transpose=t)
        fx.csr_index(rel, transpose=t)
    rng = np.random.default_rng(6)
    coords = rng.integers(0, N, (30, 2))
    if sr_name == "maxplus":
        coords = np.sort(coords, axis=1)
        coords = coords[coords[:, 0] < coords[:, 1]]
    vals = None if sr_name == "bool" else \
        rng.integers(0, 4, len(coords)).astype(np.float32)  # some 0s
    jchild, child = jrel.apply_delta(coords, vals), rel.apply_delta(
        coords, vals)
    for t in (False, True):
        want, got = jfx._csr_lookup(jchild, t), fx._csr_lookup(child, t)
        assert want is not None and got is not None
        assert got.src is fx._csr_lookup(rel, t).src      # base shared
        for k in ("xsrc", "xdst", "xw", "w", "counts"):
            assert np.array_equal(_np(getattr(got, k)), getattr(want, k))
    if _lattice(sr_name):
        init = _init(2, sr_name, seed=7)
        want, wit, wsts = jfx.sparse_seminaive_fixpoint_stats(jchild, init)
        got, it, sts = fx.sparse_seminaive_fixpoint_stats(
            child, torch.from_numpy(init))
        assert_same(got, want)
        assert_same(it, wit)
        for st, wst in zip(sts, wsts):
            _same_stats(st, wst)
    # past max(1024, base/4) overlay rows the child is left unindexed
    big = np.stack([np.arange(1100) % N, (np.arange(1100) * 7) % N], 1)
    if sr_name == "maxplus":
        big = big[big[:, 0] < big[:, 1]]
        big = np.concatenate([big] * 3)
    bvals = None if sr_name == "bool" else np.ones(len(big), np.float32)
    assert len(big) > 1024
    jbig, tbig = jchild.apply_delta(big, bvals), child.apply_delta(big,
                                                                   bvals)
    assert jfx._csr_lookup(jbig) is None and fx._csr_lookup(tbig) is None


@pytest.mark.parametrize("sr_name", SRS)
def test_register_delete_poisons_the_index(sr_name):
    jrel, rel = _both(sr_name)
    rng = np.random.default_rng(8)
    extra = rng.integers(0, N, (12, 2))
    if sr_name == "maxplus":
        extra = np.sort(extra, axis=1)
        extra = extra[extra[:, 0] < extra[:, 1]]
    evals = None if sr_name == "bool" else \
        np.ones(len(extra), np.float32)
    for t in (False, True):
        jfx.csr_index(jrel, transpose=t)
        fx.csr_index(rel, transpose=t)
    jrel, rel = jrel.apply_delta(extra, evals), rel.apply_delta(extra, evals)
    e, _ = _edges(sr_name)
    gone = np.concatenate([e[rng.choice(len(e), 15, replace=False)],
                           extra[:3], [[N - 1, N + 5]]])
    jchild, child = jrel.delete_keys(gone), rel.delete_keys(gone)
    assert child.nnz == int(jchild.nnz)
    for t in (False, True):
        want, got = jfx._csr_lookup(jchild, t), fx._csr_lookup(child, t)
        assert got.counts is fx._csr_lookup(rel, t).counts   # no re-sort
        for k in ("w", "xw", "xsrc", "starts"):
            assert np.array_equal(_np(getattr(got, k)), getattr(want, k))
    if _lattice(sr_name):
        init = _init(2, sr_name, seed=9)
        want, wit, wsts = jfx.sparse_seminaive_fixpoint_stats(jchild, init)
        got, it, sts = fx.sparse_seminaive_fixpoint_stats(
            child, torch.from_numpy(init))
        assert_same(got, want)
        assert_same(it, wit)
        for st, wst in zip(sts, wsts):
            _same_stats(st, wst)
        fresh = SparseRelation(child.coords, child.values, child.nnz,
                               child.shape, child.semiring)
        assert_same(fx.fixpoint(fresh, torch.from_numpy(init),
                                mode="frontier")[0], got)


def _same_buffers(rel, jrel):
    h = jrel.as_np()
    assert rel.nnz == int(h.nnz) and rel.capacity == jrel.capacity
    assert rel.coords.dtype == torch.int32
    assert np.array_equal(rel.coords.numpy(), h.coords)
    assert_same(rel.values, h.values)


@pytest.mark.parametrize("sr_name", SRS)
def test_apply_delta_delete_keys_union_buffers(sr_name):
    jrel, rel = _both(sr_name, pad=8)
    rng = np.random.default_rng(10)
    for n_new in (5, 50):                         # fits; doubles capacity
        coords = rng.integers(0, N, (n_new, 2))
        vals = None if sr_name == "bool" else \
            rng.integers(0, 4, n_new).astype(np.float32)
        jrel, rel = jrel.apply_delta(coords, vals), rel.apply_delta(
            coords, torch.from_numpy(vals) if vals is not None else None)
        _same_buffers(rel, jrel)
    gone = np.concatenate([np.asarray(jrel.coords)[:7], [[0, N + 3]]])
    jdel, tdel = jrel.delete_keys(gone), rel.delete_keys(gone)
    _same_buffers(tdel, jdel)
    assert rel.delete_keys(np.zeros((0, 2), np.int64)) is rel
    other_j, other = _both(sr_name, pad=3, seed=1)
    for cap in (None, 4096):
        _same_buffers(tdel.union(other, capacity=cap),
                      jdel.union(other_j, capacity=cap))
    _same_buffers(other.union(other), other_j.union(other_j))
    with pytest.raises(ValueError, match="out of range"):
        rel.apply_delta([[0, N]])
    with pytest.raises(ValueError):
        rel.union(SparseRelation.from_coo([[0, 1]], [1.0], (N, N), "real",
                                          device="cpu"))


@pytest.mark.parametrize("sr_name", SRS)
def test_wrappers_warn_and_match_reference(sr_name):
    jrel, rel = _both(sr_name)
    init = _init(2, sr_name, seed=11)
    ti = torch.from_numpy(init)
    if not _lattice(sr_name):
        with pytest.warns(DeprecationWarning):
            with pytest.raises(ValueError, match="lacks"):
                fx.sparse_seminaive_fixpoint(rel, ti)
        return
    with pytest.warns(DeprecationWarning, match="fixpoint"):
        got, it = fx.sparse_seminaive_fixpoint(rel, ti)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want, wit = jfx.sparse_seminaive_fixpoint(jrel, init)
        assert_same(got, want)
        assert_same(it, wit)
        got, it = core_fx.sparse_seminaive_fixpoint(rel, ti[0])
        want, wit = jcore_fx.sparse_seminaive_fixpoint(jrel, init[0])
    assert_same(got, want)
    assert it == wit
    # resume from a two-round worklist carry: iters count only the
    # resumed rounds
    jst = jfx.fixpoint(jrel, init, budget=2, mode="frontier")
    y0, d0 = torch.from_numpy(np.asarray(jst.y)), torch.from_numpy(
        np.asarray(jst.delta))
    with pytest.warns(DeprecationWarning, match="resume_fixpoint"):
        got, it = fx.resume_fixpoint(rel, y0, d0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want, wit = jfx.resume_fixpoint(jrel, np.asarray(jst.y),
                                        np.asarray(jst.delta))
        got1, it1 = fx.resume_fixpoint(rel, y0[0], d0[0], mode="jit")
        want1, wit1 = jfx.resume_fixpoint(jrel, np.asarray(jst.y)[0],
                                          np.asarray(jst.delta)[0],
                                          mode="jit")
    assert_same(got, want)
    assert_same(it, wit)
    assert_same(got1, want1)
    assert it1 == int(wit1)
    it0 = np.asarray(jst.iters, np.int32)
    with pytest.warns(DeprecationWarning, match="resume_fixpoint_chunk"):
        y, d, its = fx.resume_fixpoint_chunk(rel, y0, d0,
                                             torch.from_numpy(it0),
                                             max_iters=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        wy, wd, wits = jfx.resume_fixpoint_chunk(
            jrel.as_jnp(), jnp.asarray(jst.y), jnp.asarray(jst.delta),
            jnp.asarray(it0), max_iters=3)
    assert_same(y, wy)
    assert_same(d, wd)
    assert_same(its, wits)


@pytest.mark.parametrize("sr_name", SRS)
def test_max_iters_truncates_the_worklist(sr_name):
    jrel, rel = _both(sr_name)
    init = _init(3, sr_name, seed=12)
    if not _lattice(sr_name):
        _refuse_both(
            lambda: jfx.fixpoint(jrel, init, mode="frontier", max_iters=2),
            lambda: fx.fixpoint(rel, torch.from_numpy(init),
                                mode="frontier", max_iters=2))
        return
    for cap in (0, 1, 2):
        want, wit, wsts = jfx.sparse_seminaive_fixpoint_stats(
            jrel, init, max_iters=cap)
        got, it, sts = fx.sparse_seminaive_fixpoint_stats(
            rel, torch.from_numpy(init), max_iters=cap)
        assert_same(got, want)
        assert_same(it, wit)
        assert int(it.max()) <= cap
        for st, wst in zip(sts, wsts):
            _same_stats(st, wst)


@pytest.mark.parametrize("sr_name", SRS)
def test_rejects_non_lattices_and_non_square_inputs(sr_name):
    e, w = _edges(sr_name)
    jrect = JRel.from_coo(e, w, (N, N + 1), sr_name, lib="np")
    rect = SparseRelation.from_coo(e, w, (N, N + 1), sr_name, device="cpu")
    init = _init(1, sr_name, seed=13)[0]
    for mode in ("frontier", "auto"):
        with pytest.raises(ValueError, match="square"):
            jfx.fixpoint(jrect, init, mode=mode)
        with pytest.raises(ValueError, match="square"):
            fx.fixpoint(rect, torch.from_numpy(init), mode=mode)
    jrel, rel = _both(sr_name)
    if _lattice(sr_name):
        fx.fixpoint(rel, torch.from_numpy(init), mode="frontier")
        return
    for s in (sr_name, "real"):
        jr = JRel.from_coo(e, w.astype(np.float32), (N, N), s, lib="np")
        r = SparseRelation.from_coo(e, w.astype(np.float32), (N, N), s,
                                    device="cpu")
        _refuse_both(lambda: jfx.fixpoint(jr, init, mode="frontier"),
                     lambda: fx.fixpoint(r, torch.from_numpy(init),
                                         mode="frontier"))
        with pytest.raises(ValueError, match="lacks"):
            fx.fixpoint(r, state=fx.FixpointState.cold(
                r, torch.from_numpy(init)), budget=1, mode="frontier")


@pytest.mark.parametrize("sr_name", SRS)
def test_frontier_runner_chunks_equal_the_cold_run(sr_name):
    """``FrontierRunner.run_chunk`` with ``budget=1`` chained to the end
    equals its ``full_fn``; the three sparse runners are chunkable and
    the frontier's batched form is the staged loop."""
    _, rel = _both(sr_name)
    init = torch.from_numpy(_init(2, sr_name, seed=14))
    r = runners.get("sparse_frontier")
    assert all(runners.get(n).chunkable for n in
               ("sparse_frontier", "sparse_jit", "sparse_frontier_pallas"))
    ctx = runners.make_context(rel, init, sr_name, 10_000)
    if not _lattice(sr_name):
        with pytest.raises(ValueError, match="lacks"):
            r.full_fn(ctx)(rel, init)
        return
    want, wit = r.full_fn(ctx)(rel, init)
    st = fx.FixpointState.cold(rel, init)
    for _ in range(40):
        st, stats = r.run_chunk(ctx, st, 1)
        assert stats.nnz == st.frontier_nnz()
        if st.converged:
            break
    assert_same(st.y, want)
    assert_same(st.iters, wit)
    for name in ("sparse_jit", "sparse_frontier_pallas"):
        s2, _ = runners.get(name).run_chunk(
            ctx, fx.FixpointState.cold(rel, init), 10_000)
        assert_same(s2.y, want)
    yb, itb = r.batched_fn(None, 10_000)(rel, init)
    yj, itj = fx.fixpoint(rel, init, mode="jit")
    assert_same(yb, yj)
    assert_same(itb, itj)


def _port_db(jdb, schema):
    rels = {}
    for name, v in jdb.relations.items():
        if isinstance(v, JRel):
            h = v.as_np()
            rels[name] = dict(coords=h.coords, values=h.values, nnz=h.nnz,
                              shape=h.shape, semiring=h.semiring)
        else:
            rels[name] = np.asarray(v)
    from repro_torch.core import engine
    return engine.Database.from_numpy(schema, jdb.domains, rels,
                                      device="cpu")


def _dbs(kind, graph):
    jb = jprograms.bm(a=0) if kind == "bm" else jprograms.cc()
    tb = programs.bm(a=0) if kind == "bm" else programs.cc()
    if graph == "sparse":
        g = jdata.powerlaw(N, 3, seed=0)
        e = g.sparse_adjacency(symmetric=kind == "cc")
        jdb = jengine.Database(jb.original.schema, {"id": g.n},
                               {"E": e, "V": g.vertex_set()})
    else:
        jdb = jb.make_db(jdata.erdos_renyi(64, 0.4 * 64, seed=1))
    return jb, tb, jdb, _port_db(jdb, tb.original.schema)


#: the reference's candidates the port has no runner for yet
_NOT_PORTED = ("sparse_sharded", "delta_restart", "synth_maintenance",
               "dense_host")


@pytest.mark.parametrize("objective", ["latency", "throughput"])
@pytest.mark.parametrize("kind", ["bm", "cc"])
@pytest.mark.parametrize("which", ["original", "optimized"])
@pytest.mark.parametrize("graph", ["sparse", "dense"])
def test_planner_picks_and_explain_match_reference(objective, kind, which,
                                                   graph):
    """On a CPU database the port considers and rejects the reference's
    runners (bar the unported ones) and picks the same one; the
    worklist's rejection reads as the reference's."""
    jb, tb, jdb, db = _dbs(kind, graph)
    jsp = jplanner.plan_program(getattr(jb, which), jdb,
                                objective=objective).strata[0]
    plan = planner.plan_program(getattr(tb, which), db, objective=objective)
    sp = plan.strata[0]
    assert sp.runner == jsp.runner
    assert sorted(sp.considered) == sorted(jsp.considered)
    assert sorted(sp.rejected) == sorted(
        k for k in jsp.rejected if k not in _NOT_PORTED)
    assert sp.rejected.get("sparse_frontier") == \
        jsp.rejected.get("sparse_frontier")
    # the sparse runners are priced alike (the dense engine's cast atoms
    # are not: the port's pricing correction, ROADMAP C)
    for k in ("sparse_jit", "sparse_frontier"):
        if k in sp.considered:
            assert sp.considered[k].total == pytest.approx(
                jsp.considered[k].total, rel=1e-9), k
    text = planner.explain(plan)
    for k in sp.rejected:
        assert f"rejected    {k}: " in text
    if which == "optimized" and graph == "sparse":
        want_pick = "sparse_frontier" if objective == "latency" else \
            "sparse_jit"
        assert sp.runner == want_pick
