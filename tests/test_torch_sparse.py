"""Port parity: sparse storage, contraction and the staged fixpoint.

The same numpy inputs go through ``repro.sparse`` and
``repro_torch.sparse`` on the CPU:

* ``from_coo``/``from_dense`` buffers (capacity, sentinels, value
  order), ``to_dense`` and ``transpose`` are identical;
* ``spmv``/``vspm``/``spmm``/``mspm``/``spmspm`` agree, also where the
  edges go in B3's segment-plan order over split hub rows;
* ``fixpoint`` agrees in values AND per-row iteration counts — cold,
  batched ``(B, n)``, warm ``state=`` resume, and budgeted chunks that
  chain to the same answer — with the port's ``"torch"`` backend held
  against the reference's jnp loop and its ``"kernel"`` backend (B1's
  plain version on CPU) against the reference's Pallas backend run in
  interpret mode.

bool/trop/maxplus values and counts are bit-exact, nat exact, real
within ``atol = rtol = 1e-4``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsr
from repro.datalog import datasets as jdata
from repro.sparse import adaptive as jadaptive
from repro.sparse import contract as jcontract
from repro.sparse import fixpoint as jfx
from repro.sparse.coo import SparseRelation as JRel
from repro_torch.sparse import adaptive, contract
from repro_torch.sparse import fixpoint as fx
from repro_torch.sparse.coo import SparseRelation

ALL = ("bool", "trop", "maxplus", "nat", "real")
LATTICES = ("bool", "trop", "maxplus")
BACKENDS = [("torch", "jnp"), ("kernel", "pallas")]


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


def _port(rel: JRel) -> SparseRelation:
    h = rel.as_np()
    return SparseRelation.from_buffers(h.coords, h.values, h.nnz, h.shape,
                                       h.semiring, device="cpu")


def _random_coo(sr_name, n, m, seed, *, shape=None):
    rng = np.random.default_rng(seed)
    shape = shape or (n, n)
    coords = np.stack([rng.integers(0, s, m) for s in shape], axis=1)
    coords = np.concatenate([coords, coords[: m // 5]])   # duplicates
    if sr_name == "bool":
        vals = rng.random(len(coords)) < 0.8                # explicit 0̄s
    else:
        vals = rng.integers(0, 4, len(coords)).astype(np.float32)
        vals[rng.random(len(coords)) < 0.1] = jsr.get(sr_name).zero
    return coords, vals, shape


def _graph_relation(n, sr_name, seed, *, deg=3):
    """A power-law operator whose GSN fixpoint converges (maxplus
    oriented low→high, so longest paths stay finite)."""
    g = jdata.powerlaw(n, deg, seed=seed)
    edges = g.edges
    rng = np.random.default_rng(seed + 1)
    if sr_name == "maxplus":
        edges = np.sort(edges, axis=1)
        edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.integers(1, 5, len(edges))
    if sr_name == "bool":
        w = np.ones(len(edges), bool)
    return JRel.from_coo(edges, w, (n, n), sr_name, capacity=len(edges) + 7)


def _init(n, b, sr_name, seed):
    rng = np.random.default_rng(seed)
    srn = jsr.get(sr_name, lib="np")
    shape = (n,) if b is None else (b, n)
    x = np.full(shape, srn.zero, srn.dtype)
    src = rng.integers(0, n, (1 if b is None else b))
    if b is None:
        x[src[0]] = srn.one
    else:
        x[np.arange(b), src] = srn.one
        x[b - 1] = srn.zero                 # an inert (all-0̄) padding row
    return x


# --------------------------------------------------------------------------
# COO storage
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("capacity", [None, 200])
def test_from_coo_buffers_identical(sr_name, capacity):
    coords, vals, shape = _random_coo(sr_name, 20, 120, seed=len(sr_name))
    want = JRel.from_coo(coords, vals, shape, sr_name,
                         capacity=capacity).as_np()
    got = SparseRelation.from_coo(coords, vals, shape, sr_name,
                                  capacity=capacity, device="cpu").as_np()
    assert np.array_equal(got.coords, want.coords)
    assert got.values.dtype == want.values.dtype
    assert np.array_equal(got.values, want.values)
    assert int(got.nnz) == int(want.nnz)
    assert got.shape == tuple(want.shape)


@pytest.mark.parametrize("sr_name", ALL)
def test_to_dense_transpose_from_dense(sr_name):
    coords, vals, shape = _random_coo(sr_name, 0, 90, seed=3,
                                      shape=(13, 17))
    jrel = JRel.from_coo(coords, vals, shape, sr_name, capacity=150)
    rel = _port(jrel)
    assert_match(rel.to_dense(), jrel.to_dense(), sr_name)
    assert_match(rel.transpose().to_dense(), jrel.transpose().to_dense(),
                 sr_name)
    dense = np.array(jrel.to_dense())
    back = SparseRelation.from_dense(torch.from_numpy(dense), sr_name)
    want = JRel.from_dense(dense, sr_name, lib="np")
    assert np.array_equal(back.as_np().coords, want.coords)
    assert np.array_equal(back.as_np().values, want.values)
    assert rel.density() == pytest.approx(float(jrel.density()))


def test_from_coo_rejects_overflow():
    with pytest.raises(ValueError, match="exceeds capacity"):
        SparseRelation.from_coo(np.array([[0, 1], [1, 0]]), [1.0, 2.0],
                                (2, 2), "trop", capacity=1, device="cpu")


def test_to_device_and_column_cache():
    rel = _port(_graph_relation(40, "trop", seed=1))
    assert rel.to("cpu") is rel
    c = rel.col(1, torch.int32)
    assert c.dtype == torch.int32 and c.is_contiguous()
    assert rel.col(1, torch.int32) is c


# --------------------------------------------------------------------------
# Contraction
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("op", ["spmv", "spmv_t", "vspm", "spmm", "spmm_t",
                                "mspm"])
def test_contract_matches_reference(sr_name, op):
    coords, vals, _ = _random_coo(sr_name, 30, 150, seed=11)
    jrel = JRel.from_coo(coords, vals, (30, 30), sr_name, capacity=200)
    rel = _port(jrel)
    rng = np.random.default_rng(5)
    srn = jsr.get(sr_name, lib="np")
    pool = jsr.np_value_pool(srn)
    vec = pool[rng.integers(0, len(pool), 30)]
    mat = pool[rng.integers(0, len(pool), (30, 6))]
    tv, tm = torch.from_numpy(vec), torch.from_numpy(mat)
    if op == "spmv":
        got, want = contract.spmv(rel, tv), jcontract.spmv(jrel, vec)
    elif op == "spmv_t":
        got = contract.spmv(rel, tv, transpose=True)
        want = jcontract.spmv(jrel, vec, transpose=True)
    elif op == "vspm":
        got, want = contract.vspm(tv, rel), jcontract.vspm(vec, jrel)
    elif op == "spmm":
        got, want = contract.spmm(rel, tm), jcontract.spmm(jrel,
                                                          jnp.asarray(mat))
    elif op == "spmm_t":
        got = contract.spmm(rel, tm, transpose=True)
        want = jcontract.spmm(jrel, jnp.asarray(mat), transpose=True)
    else:
        got = contract.mspm(tm.t().contiguous(), rel)
        want = jcontract.mspm(mat.T, jrel)
    assert_match(got, want, sr_name)


def _hub_coo(sr_name, n, fan=300, seed=7):
    """Random COO (explicit 0̄s, duplicates) plus a row and a column of
    ``fan`` distinct entries each, so that both contraction orientations
    reduce a row of more than two E_CHUNK items."""
    coords, vals, _ = _random_coo(sr_name, n, 200, seed=seed)
    rng = np.random.default_rng(seed)
    other = rng.permutation(n)[:fan]
    hub = np.concatenate([np.stack([np.full(fan, 5), other], 1),
                          np.stack([other, np.full(fan, 3)], 1)])
    srn = jsr.get(sr_name, lib="np")
    hvals = np.ones(2 * fan, bool) if sr_name == "bool" else \
        rng.integers(1, 4, 2 * fan).astype(srn.dtype)
    return np.concatenate([coords, hub]), np.concatenate([vals, hvals])


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("capacity", [None, 900])
@pytest.mark.parametrize("op", ["spmv", "spmv_t", "spmm", "spmm_t"])
def test_contract_in_plan_order_matches_reference(sr_name, capacity, op):
    """The contraction takes its edges in the plan order of the output
    column (B3's runs path; the plan, gather column and values memoized
    on the relation): answers equal the reference's, on a plain and a
    padded relation whose hub row and column are split into items."""
    n = 400
    coords, vals = _hub_coo(sr_name, n)
    jrel = JRel.from_coo(coords, vals, (n, n), sr_name, capacity=capacity)
    rel = _port(jrel)
    assert (rel.capacity > rel.nnz) == (capacity is not None)
    rng = np.random.default_rng(9)
    srn = jsr.get(sr_name, lib="np")
    pool = jsr.np_value_pool(srn)
    vec = pool[rng.integers(0, len(pool), n)]
    mat = pool[rng.integers(0, len(pool), (n, 3))]
    transpose = op.endswith("_t")
    if op.startswith("spmv"):
        got = contract.spmv(rel, torch.from_numpy(vec), transpose=transpose)
        want = jcontract.spmv(jrel, vec, transpose=transpose)
    else:
        got = contract.spmm(rel, torch.from_numpy(mat), transpose=transpose)
        want = jcontract.spmm(jrel, jnp.asarray(mat), transpose=transpose)
    assert_match(got, want, sr_name)
    out_ax, gather_ax = (1, 0) if transpose else (0, 1)
    plan, idx, pvals = rel.runs(out_ax, gather_ax)
    assert plan.items.n_split >= 1 and plan.m_live == rel.nnz
    assert rel.runs(out_ax, gather_ax)[0] is plan
    assert torch.equal(idx, rel.col(gather_ax)[plan.order])
    assert torch.equal(pvals, rel.values[plan.order])


@pytest.mark.parametrize("sr_name", ["bool", "trop", "nat"])
def test_spmm_kernel_backend_matches_torch_backend(sr_name):
    rel = _port(_graph_relation(60, sr_name, seed=2))
    x = torch.from_numpy(_init(60, 5, sr_name, seed=1).T.copy())
    for transpose in (False, True):
        assert torch.equal(
            contract.spmm(rel, x, transpose=transpose, backend="kernel"),
            contract.spmm(rel, x, transpose=transpose, backend="torch"))


@pytest.mark.parametrize("sr_name", ["trop", "nat", "bool"])
def test_spmspm_matches_reference(sr_name):
    a = _random_coo(sr_name, 15, 40, seed=1)
    b = _random_coo(sr_name, 15, 40, seed=2)
    ja = JRel.from_coo(*a[:2], (15, 15), sr_name, lib="np")
    jb = JRel.from_coo(*b[:2], (15, 15), sr_name, lib="np")
    want = jcontract.spmspm(ja, jb)
    got = contract.spmspm(_port(ja), _port(jb))
    assert np.array_equal(got.as_np().coords, want.coords)
    assert np.array_equal(got.as_np().values, want.values)


def test_contract_rejects_unknown_backend():
    rel = _port(_graph_relation(10, "bool", seed=1))
    with pytest.raises(ValueError, match="backend"):
        contract.spmm(rel, torch.zeros(10, 2, dtype=torch.bool),
                      backend="pallas")


# --------------------------------------------------------------------------
# Density switch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("frac", [0.01, 0.15, 0.9])
def test_adaptive_density_and_switch(frac):
    rng = np.random.default_rng(int(frac * 100))
    arr = rng.random((40, 40)) < frac
    assert adaptive.density(torch.from_numpy(arr), "bool") == \
        pytest.approx(jadaptive.density(arr, "bool"))
    for cur in ("sparse", "dense"):
        assert adaptive.decide(frac, cur) == jadaptive.decide(frac, cur)
    got = adaptive.adapt_value(torch.from_numpy(arr), "bool")
    want = jadaptive.adapt_value(arr, "bool")
    assert isinstance(got, SparseRelation) == isinstance(want, JRel)
    if isinstance(want, JRel):
        assert np.array_equal(got.as_np().coords, want.coords)
        assert got.capacity == want.capacity
        assert isinstance(adaptive.adapt_value(
            _port(JRel.from_dense(rng.random((20, 20)) < 0.9, "bool")),
            "bool"), torch.Tensor)


# --------------------------------------------------------------------------
# Staged fixpoint
# --------------------------------------------------------------------------


def _both(sr_name, n=300, seed=4):
    jrel = _graph_relation(n, sr_name, seed=seed)
    return jrel, _port(jrel)


@pytest.mark.parametrize("sr_name", LATTICES)
@pytest.mark.parametrize("backend,jbackend", BACKENDS)
def test_fixpoint_cold_single(sr_name, backend, jbackend):
    jrel, rel = _both(sr_name)
    init = _init(300, None, sr_name, seed=1)
    want, wit = jfx.fixpoint(jrel, jnp.asarray(init), mode="jit",
                             backend=jbackend)
    got, it = fx.fixpoint(rel, torch.from_numpy(init), backend=backend)
    assert_match(got, want, sr_name)
    assert it == int(np.asarray(wit))


@pytest.mark.parametrize("sr_name", LATTICES)
@pytest.mark.parametrize("batched", [False, True])
def test_fixpoint_with_split_hub_rows_matches_reference(sr_name, batched):
    """The latency path's loop (the torch backend: B3's runs path on the
    CPU) on an operator whose hub rows are cut into several items and
    whose buffers are padded: values and per-row iteration counts equal
    the reference's bit for bit."""
    g = jdata.powerlaw(400, 3, seed=2)
    fan = 3 * 128 + 10          # into node 399 and out of node 0: kept
    edges = np.concatenate([g.edges, np.stack([np.arange(fan),   # low→high
                                               np.full(fan, 399)], 1),
                            np.stack([np.zeros(fan, np.int64),
                                      np.arange(1, fan + 1)], 1)])
    if sr_name == "maxplus":
        edges = np.sort(edges, axis=1)
        edges = edges[edges[:, 0] != edges[:, 1]]
    w = np.random.default_rng(3).integers(1, 5, len(edges))
    if sr_name == "bool":
        w = np.ones(len(edges), bool)
    jrel = JRel.from_coo(edges, w, (400, 400), sr_name,
                         capacity=len(edges) + 11)
    rel = _port(jrel)
    init = _init(400, 6 if batched else None, sr_name, seed=5)
    want, wit = jfx.fixpoint(jrel, jnp.asarray(init), mode="jit",
                             backend="jnp")
    got, it = fx.fixpoint(rel, torch.from_numpy(init), backend="torch")
    assert_match(got, want, sr_name)
    assert np.array_equal(_np(it), np.asarray(wit))
    assert rel.runs(1, 0)[0].items.n_split >= 1


@pytest.mark.parametrize("sr_name", LATTICES)
@pytest.mark.parametrize("backend,jbackend", BACKENDS)
def test_fixpoint_cold_batched(sr_name, backend, jbackend):
    jrel, rel = _both(sr_name)
    init = _init(300, 8, sr_name, seed=2)
    want, wit = jfx.fixpoint(jrel, jnp.asarray(init), mode="jit",
                             backend=jbackend)
    got, it = fx.fixpoint(rel, torch.from_numpy(init), backend=backend)
    assert_match(got, want, sr_name)
    assert np.array_equal(_np(it), np.asarray(wit))
    assert it.dtype == torch.int32


@pytest.mark.parametrize("sr_name", LATTICES)
@pytest.mark.parametrize("backend,jbackend", BACKENDS)
@pytest.mark.parametrize("batched", [False, True])
def test_fixpoint_warm_resume(sr_name, backend, jbackend, batched):
    """Resume a carry two rounds in: ``state=`` without a budget runs to
    convergence, and its iters include the carry's."""
    jrel, rel = _both(sr_name)
    init = _init(300, 8 if batched else None, sr_name, seed=3)
    jst = jfx.fixpoint(jrel, jnp.asarray(init), budget=2, backend=jbackend)
    st = fx.FixpointState.from_numpy(np.asarray(jst.y), np.asarray(jst.delta),
                                     np.asarray(jst.iters), sr_name,
                                     jst.batched, device="cpu")
    want, wit = jfx.fixpoint(jrel, state=jst, backend=jbackend)
    got, it = fx.fixpoint(rel, state=st, backend=backend)
    assert_match(got, want, sr_name)
    assert np.array_equal(np.asarray(_np(it)).reshape(-1),
                          np.asarray(wit).reshape(-1))


@pytest.mark.parametrize("sr_name", LATTICES)
@pytest.mark.parametrize("backend,jbackend", BACKENDS)
def test_fixpoint_budgeted_chunks_chain(sr_name, backend, jbackend):
    """Budgeted chunks carry-for-carry equal to the reference's, and the
    chain converges to the one-shot answer and counts."""
    jrel, rel = _both(sr_name)
    init = _init(300, 8, sr_name, seed=4)
    jst = jfx.FixpointState.cold(jrel, init)
    st = fx.FixpointState.cold(rel, torch.from_numpy(init))
    for _ in range(30):
        jst = jfx.fixpoint(jrel, state=jst, budget=3, backend=jbackend)
        st = fx.fixpoint(rel, state=st, budget=3, backend=backend)
        assert_match(st.y, jst.y, sr_name)
        assert_match(st.delta, jst.delta, sr_name)
        assert np.array_equal(_np(st.iters), np.asarray(jst.iters))
        assert st.converged == jst.converged
        if st.converged:
            break
    assert st.converged
    once, it = fx.fixpoint(rel, torch.from_numpy(init), backend=backend)
    y, iters = st.solution()
    assert torch.equal(y, once)
    # a cold one-shot counts a round for the inert row too; the chained
    # carry (like the reference's) never enters it
    assert np.array_equal(_np(iters)[:-1], _np(it)[:-1])
    stats = st.stats()
    assert stats.nnz == 0 and stats.iteration == int(_np(iters).max())


def test_fixpoint_max_iters_clips_rounds():
    jrel, rel = _both("bool")
    init = _init(300, 4, "bool", seed=5)
    want, wit = jfx.fixpoint(jrel, jnp.asarray(init), mode="jit",
                             max_iters=2)
    got, it = fx.fixpoint(rel, torch.from_numpy(init), max_iters=2)
    assert_match(got, want, "bool")
    assert np.array_equal(_np(it), np.asarray(wit))


def test_fixpoint_argument_errors():
    _, rel = _both("bool", n=20)
    init = torch.zeros(20, dtype=torch.bool)
    with pytest.raises(ValueError, match="exactly one"):
        fx.fixpoint(rel)
    with pytest.raises(ValueError, match="not ported"):
        fx.fixpoint(rel, init, mode="frontier")
    with pytest.raises(ValueError, match="backend"):
        fx.fixpoint(rel, init, backend="fused")
    nat = _port(JRel.from_coo([[0, 1]], [1.0], (20, 20), "nat"))
    with pytest.raises(ValueError, match="lacks"):
        fx.fixpoint(nat, torch.zeros(20))
