"""Port parity: the plain versions of kernels B1–B3 against the JAX
package's Pallas kernels run as its own tests run them (interpret mode).

* B1 ``coo_spmm``: ``repro_torch.kernels.coo_spmm.spmm`` on CPU tensors
  vs ``repro.kernels.coo_spmm.spmm_pallas(plan, x, interpret=True)``.
* B2 ``semiring_matmul``: ``semiring_matmul`` on CPU tensors vs
  ``semiring_matmul_pallas(..., interpret=True)``.
* B3 ``coo_segment``: ``segment_reduce`` on CPU tensors vs
  ``segment_reduce_pallas(..., interpret=True)`` for ``(m,)`` payloads
  and vs the reference's jnp scatter for ``(m, B)`` payloads (the
  reference routes only scalar payloads to its kernel); the segment
  plan of the ``runs`` path pinned, and its plain version (items and
  folds emulated, payload in plan order) vs the Pallas kernel, one
  column at a time for ``(m, B)``.
* B5 ``flash_attention``: the launch plan of its two CUDA paths, and
  the precision of its tensor-core path's 3xTF32 products, emulated on
  the CPU (B5's plain version against the reference is in
  ``tests/test_torch_models.py``).

Tolerances: bool/trop/maxplus/nat exact (nat values are integers far
below 2²⁴); real ``atol = rtol = 1e-4`` (summation order differs).
The kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsr
from repro.datalog import datasets as jdata
from repro.kernels import coo_spmm as jspmm
from repro.kernels import ref as jref
from repro.kernels.coo_segment import segment_reduce_pallas
from repro.kernels.semiring_matmul import semiring_matmul_pallas
from repro.sparse.coo import SparseRelation as JRel
from repro_torch.core import semiring as tsr
from repro_torch.kernels import coo_segment, coo_spmm, ref, semiring_matmul
from repro_torch.kernels import flash_attention as fa
from repro_torch.sparse.coo import SparseRelation
from torch_tf32 import SPLITS, tf32_product, tf32_rna, tf32_trunc

ALL = ("bool", "trop", "maxplus", "nat", "real")


def assert_match(got: torch.Tensor, want, sr_name: str) -> None:
    got = got.cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if sr_name == "real":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        assert np.array_equal(got, want), sr_name


def _port_rel(rel: JRel) -> SparseRelation:
    h = rel.as_np()
    return SparseRelation.from_buffers(h.coords, h.values, h.nnz, h.shape,
                                       h.semiring, device="cpu")


def _relation(n, avg_deg, sr_name, seed):
    """The reference's kernel-test operator (tests/test_coo_spmm.py)."""
    g = jdata.powerlaw(n, avg_deg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    edges = g.edges
    if sr_name == "maxplus":
        edges = np.sort(edges, axis=1)
        edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.integers(1, 5, len(edges))
    if sr_name == "bool":
        return jdata.Graph(n, edges, w).sparse_adjacency()
    return JRel.from_coo(edges, w, (n, n), sr_name)


def _frontier(n, b, sr_name, seed, live_frac=0.1):
    rng = np.random.default_rng(seed)
    live = rng.random((n, b)) < live_frac
    srn = jsr.get(sr_name, lib="np")
    if sr_name == "bool":
        return live
    x = np.full((n, b), srn.zero, srn.dtype)
    x[live] = rng.integers(0, 8, int(live.sum())).astype(srn.dtype)
    return x


def _segment_inputs(sr_name, m, n, b, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n + 3, m).astype(np.int32)  # n.. emulate padding
    shape = (m,) if b is None else (m, b)
    if sr_name == "bool":
        return rng.random(shape) < 0.5, ids
    vals = rng.integers(0, 5, shape).astype(np.float32)
    vals[rng.random(shape) < 0.3] = jsr.get(sr_name).zero
    return vals, ids


def _matmul_inputs(sr_name, shape, seed):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    if sr_name == "bool":   # density 1/√k: a mixed answer, ≈63% true
        live = k ** -0.5
        return rng.random((m, k)) < live, rng.random((k, n)) < live
    a = rng.integers(0, 5, (m, k)).astype(np.float32)
    b = rng.integers(0, 5, (k, n)).astype(np.float32)
    if sr_name in ("trop", "maxplus"):
        a[rng.random((m, k)) < 0.2] = jsr.get(sr_name).zero
        b[rng.random((k, n)) < 0.2] = jsr.get(sr_name).zero
    return a, b


# --------------------------------------------------------------------------
# B3 coo_segment
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("m,n", [(0, 5), (37, 10), (64, 257)])
def test_segment_plain_vs_pallas(sr_name, m, n):
    vals, ids = _segment_inputs(sr_name, m, n, None, seed=m + n)
    want = segment_reduce_pallas(jnp.asarray(vals), jnp.asarray(ids), n,
                                 sr_name=sr_name, bk=16, bn=8,
                                 interpret=True)
    got = coo_segment.segment_reduce(sr_name, torch.from_numpy(vals),
                                     torch.from_numpy(ids), n)
    assert_match(got, want, sr_name)


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("m,n,b", [(50, 13, 1), (300, 40, 8)])
def test_segment_plain_payload_rows(sr_name, m, n, b):
    vals, ids = _segment_inputs(sr_name, m, n, b, seed=m * b)
    want = jref.segment_reduce_ref(jsr.get(sr_name), jnp.asarray(vals),
                                   jnp.asarray(ids), n)
    got = coo_segment.segment_reduce(sr_name, torch.from_numpy(vals),
                                     torch.from_numpy(ids), n)
    assert_match(got, want, sr_name)


def _segment_case(sr_name, m, n, lanes, seed, *, hub=0, shuffle=True):
    """Ids over n rows — the last fifth reached by none, a hub row of
    ``hub`` entries, ids below 0 and at or past n that every path drops —
    sorted or shuffled, and a payload (𝔹 at 10% live: a mixed answer)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n - n // 5, m)
    ids[:hub] = n // 3
    drop = rng.random(m) < 0.1
    ids[drop] = rng.choice([-2, -1, n, n + 1, n + 2], int(drop.sum()))
    ids = rng.permutation(ids) if shuffle else np.sort(ids, kind="stable")
    shape = (m,) if lanes is None else (m, lanes)
    if sr_name == "bool":
        vals = rng.random(shape) < 0.1
    else:
        vals = rng.integers(0, 5, shape).astype(np.float32)
        vals[rng.random(shape) < 0.3] = jsr.get(sr_name).zero
    return vals, ids.astype(np.int32)


@pytest.mark.parametrize("kind", ["shuffled", "sorted", "hub", "empty",
                                  "all_dropped"])
def test_plan_segment_items(kind):
    """The plan keeps the entries whose id lies in [0, n), stably sorted
    by id (negative ids and the sentinels dropped); its items tile them
    in order, at most E_CHUNK each and inside one row; a row no entry
    reaches gets one empty item; a longer row's items write consecutive
    partial slots, in item order, that its fold covers; every row is
    written exactly once."""
    n = 90
    m = {"empty": 0, "hub": 2000}.get(kind, 700)
    _, ids = _segment_case("nat", m, n, None, seed=3,
                           hub=1000 if kind == "hub" else 0,
                           shuffle=kind != "sorted")
    if kind == "all_dropped":
        ids[:] = np.where(np.arange(m) % 2, -1, n)
    plan = coo_segment.plan_segment(torch.from_numpy(ids), n)
    keep = (ids >= 0) & (ids < n)
    want_order = np.argsort(ids, kind="stable")
    want_order = want_order[keep[want_order]]
    assert np.array_equal(plan.order.numpy(), want_order)
    assert (plan.m, plan.n, plan.m_live) == (m, n, int(keep.sum()))
    it = plan.items
    edge, dst = it.edge.numpy().astype(np.int64), it.dst.numpy()
    span = np.diff(edge)
    assert edge[0] == 0 and edge[-1] == plan.m_live
    assert (span >= 0).all() and it.max_edges == span.max(initial=0)
    assert it.max_edges <= coo_segment.E_CHUNK
    fold_row, fold_seg = it.fold_row.numpy(), it.fold_seg.numpy()
    slot_fold = plan.slot_fold.numpy()
    assert np.array_equal(np.repeat(np.arange(it.n_split), np.diff(fold_seg)),
                          slot_fold) and plan.n_part == len(slot_fold)
    row = dst.astype(np.int64)
    row[dst < 0] = fold_row[slot_fold[~dst[dst < 0]]]
    assert np.array_equal(~dst[dst < 0], np.arange(plan.n_part))
    sorted_ids = ids[want_order]
    assert np.array_equal(sorted_ids, np.repeat(row, span))
    deg = np.bincount(sorted_ids, minlength=n)
    assert np.array_equal(np.bincount(row, minlength=n),
                          np.maximum(1, -(-deg // coo_segment.E_CHUNK)))
    assert np.array_equal(span[deg[row] == 0], np.zeros((deg == 0).sum()))
    written = np.concatenate([dst[dst >= 0], fold_row])
    assert np.array_equal(np.sort(written), np.arange(n))
    assert np.array_equal(fold_row, np.flatnonzero(deg > coo_segment.E_CHUNK))
    if kind == "hub":
        assert fold_row.tolist() == [n // 3] and plan.n_part == 8
    if kind in ("empty", "all_dropped"):
        assert it.n_items == n and plan.m_live == 0


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("lanes", [None, 2])
@pytest.mark.parametrize("shuffle", [False, True])
def test_segment_runs_plain_vs_pallas(sr_name, lanes, shuffle):
    """The runs path's plain version (items and folds emulated) on the
    payload in plan order against the reference's Pallas kernel in
    interpret mode on the unsorted payload, one column at a time; a
    1,000-entry hub row is cut into eight items and folded."""
    n = 60
    vals, ids = _segment_case(sr_name, 1600, n, lanes, seed=len(sr_name),
                              hub=1000, shuffle=shuffle)
    cols = vals[:, None] if lanes is None else vals
    want = np.stack([np.asarray(segment_reduce_pallas(
        jnp.asarray(np.ascontiguousarray(cols[:, b])), jnp.asarray(ids), n,
        sr_name=sr_name, bk=128, bn=128, interpret=True))
        for b in range(cols.shape[1])], axis=1)
    want = want[:, 0] if lanes is None else want
    if sr_name == "bool":
        assert 0.2 < want.mean() < 0.8
    tids = torch.from_numpy(ids)
    plan = coo_segment.plan_segment(tids, n)
    assert plan.items.n_split == 1 and plan.n_part == 8
    sorted_vals = torch.from_numpy(vals)[plan.order]
    got = coo_segment.segment_reduce(sr_name, sorted_vals, tids, n,
                                     plan=plan)
    assert_match(got, want, sr_name)
    assert_match(coo_segment.segment_runs_plain(tsr.get(sr_name), plan,
                                                sorted_vals), want, sr_name)


def test_plan_segment_is_cached_weakly():
    ids = torch.from_numpy(_segment_case("nat", 300, 40, None, seed=1)[1])
    p1 = coo_segment.plan_segment(ids, 40)
    assert coo_segment.plan_segment(ids, 40) is p1
    assert coo_segment.plan_segment(ids, 41) is not p1
    assert coo_segment.plan_segment(ids.clone(), 40) is not p1
    key = (id(ids), 40)
    del ids, p1
    assert key not in coo_segment._PLANS


def test_segment_reduce_refuses_a_plan_of_other_ids():
    """A plan serves only the ids tensor and row count it was built from,
    and a payload of its in-range entries."""
    vals, ids = _segment_case("trop", 300, 40, None, seed=2)
    tids = torch.from_numpy(ids)
    plan = coo_segment.plan_segment(tids, 40)
    sv = torch.from_numpy(vals)[plan.order]
    for args in ((sv, tids.clone(), 40), (sv, tids, 39),
                 (sv[1:], tids, 40), (torch.from_numpy(vals), tids, 40)):
        with pytest.raises(ValueError, match="plan"):
            coo_segment.segment_reduce("trop", *args, plan=plan)


@pytest.mark.parametrize("sr_name, lanes, kernel, row_len, vec, tpe, slabs", [
    ("trop", None, 0, 1, 1, 1, 1), ("bool", 1, 0, 1, 1, 1, 1),
    ("nat", 3, 1, 3, 1, 4, 1), ("real", 8, 1, 8, 4, 2, 1),
    ("trop", 300, 1, 300, 4, 32, 3), ("bool", 3, 1, 3, 1, 4, 1),
    ("bool", 256, 1, 64, 1, 32, 2),
])
def test_plan_runs_geometry(sr_name, lanes, kernel, row_len, vec, tpe, slabs):
    """(m,) and (m, 1) payloads take the scalar kernel; wider rows the
    rows kernel (f32 with 16-byte loads where B % 4 == 0, 𝔹 as words of
    four lanes where it divides), its lane groups and slabs covering the
    row, its grid the items."""
    ids = torch.from_numpy(_segment_case("nat", 500, 50, None, seed=4,
                                         hub=300)[1])
    plan = coo_segment.plan_segment(ids, 50)
    k, elem, geo = coo_segment.plan_runs(plan, sr_name, lanes)
    assert (k, geo.row_len, geo.vec, geo.threads_per_edge, geo.grid[1]) ==         (kernel, row_len, vec, tpe, slabs)
    assert elem == (4 if sr_name != "bool" or (lanes or 1) % 4 == 0 else 1)
    assert geo.slab * geo.grid[1] >= geo.row_len
    per_block = coo_segment.WARPS * coo_segment.ITEMS_PER_WARP
    assert geo.grid[0] == -(-plan.items.n_items // per_block)
    assert geo.scratch == plan.n_part * geo.row_len


def test_segment_cuda_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never takes the plain version: CPU tensors handed
    to it raise before anything is built or launched."""
    vals, ids = _segment_case("nat", 100, 20, None, seed=5)
    tids = torch.from_numpy(ids)
    plan = coo_segment.plan_segment(tids, 20)
    with pytest.raises(ValueError, match="CUDA"):
        coo_segment.segment_reduce_cuda("nat", torch.from_numpy(vals), tids,
                                        20)
    with pytest.raises(ValueError, match="CUDA"):
        coo_segment.segment_reduce_cuda(
            "nat", torch.from_numpy(vals)[plan.order], tids, 20, plan)


def test_reset_launch_counts_clears_b3_paths(monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(coo_segment.segment_reduce_cuda, "launches", 5)
    monkeypatch.setattr(coo_segment.segment_reduce_cuda, "by_path",
                        {"runs": 4, "scatter": 1})
    ops.reset_launch_counts()
    assert ops.launch_counts()["coo_segment"] == 0
    assert coo_segment.segment_reduce_cuda.by_path == {"runs": 0,
                                                       "scatter": 0}


# --------------------------------------------------------------------------
# B1 coo_spmm
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("b", [1, 8])
def test_spmm_plain_vs_pallas(sr_name, transpose, b):
    n = 300  # off every Pallas block multiple
    rel = _relation(n, 3, sr_name, seed=11)
    x = _frontier(n, b, sr_name, seed=5 + b)
    want = jspmm.spmm_pallas(jspmm.plan_geometry(rel, transpose=transpose),
                             x, interpret=True)
    plan = coo_spmm.plan_geometry(_port_rel(rel), transpose=transpose)
    got = coo_spmm.spmm(plan, torch.from_numpy(x))
    assert_match(got, want, sr_name)


@pytest.mark.parametrize("sr_name", ["bool", "trop", "nat"])
def test_spmm_plain_single_vector(sr_name):
    n = 130
    rel = _relation(n, 4, sr_name, seed=3)
    x = _frontier(n, 1, sr_name, seed=9)[:, 0]
    want = jspmm.spmm_pallas(jspmm.plan_geometry(rel, transpose=True), x,
                             interpret=True)
    got = coo_spmm.spmm(coo_spmm.plan_geometry(_port_rel(rel),
                                               transpose=True),
                        torch.from_numpy(x))
    assert got.shape == (n,)
    assert_match(got, want, sr_name)


@pytest.mark.parametrize("sr_name", ["bool", "trop"])
def test_spmm_plain_empty_operator(sr_name):
    n = 64
    rel = JRel.from_coo(np.zeros((0, 2), np.int64), np.zeros((0,)), (n, n),
                        sr_name)
    x = _frontier(n, 4, sr_name, seed=1)
    want = jspmm.spmm_pallas(jspmm.plan_geometry(rel, transpose=True), x,
                             interpret=True)
    plan = coo_spmm.plan_geometry(_port_rel(rel), transpose=True)
    assert plan.nnz == 0
    assert_match(coo_spmm.spmm(plan, torch.from_numpy(x)), want, sr_name)


@pytest.mark.parametrize("sr_name", ["trop", "nat"])
def test_spmm_plain_duplicate_edges_coalesce(sr_name):
    rng = np.random.default_rng(7)
    n = 80
    edges = rng.integers(0, n, (400, 2))
    edges = np.concatenate([edges, edges[:100]])       # duplicates
    w = rng.integers(1, 4, len(edges)).astype(np.float32)
    rel = JRel.from_coo(edges, w, (n, n), sr_name, capacity=600)
    x = _frontier(n, 8, sr_name, seed=2)
    want = jspmm.spmm_pallas(jspmm.plan_geometry(rel), x, interpret=True)
    got = coo_spmm.spmm(coo_spmm.plan_geometry(_port_rel(rel)),
                        torch.from_numpy(x))
    assert_match(got, want, sr_name)


def test_spmm_plan_geometry_matches_reference():
    rel = _relation(200, 3, "trop", seed=4)
    for transpose in (False, True):
        jp = jspmm.plan_geometry(rel, transpose=transpose)
        tp = coo_spmm.plan_geometry(_port_rel(rel), transpose=transpose)
        for f in ("src", "dst", "udst", "seg", "w"):
            assert np.array_equal(getattr(tp, f), getattr(jp, f)), f
        assert (tp.n_in, tp.n_out, tp.nnz) == (jp.n_in, jp.n_out, jp.nnz)


def test_spmm_plan_is_cached_weakly():
    rel = _port_rel(_relation(100, 3, "bool", seed=1))
    p1 = coo_spmm.plan_geometry(rel, transpose=True)
    assert coo_spmm.plan_geometry(rel, transpose=True) is p1
    assert coo_spmm.plan_geometry(rel, transpose=False) is not p1
    key = (id(rel.coords), id(rel.values), True)
    del rel, p1
    assert key not in coo_spmm._PLANS


def _hub_relation(sr_name, n=700, hub=5, seed=0):
    """A power-law operator plus one row of in-degree 4·E_CHUNK + 37
    (column ``hub`` of E: the transposed orientation's output row), so
    that the plan cuts it into five items."""
    g = jdata.powerlaw(n, 3, seed=seed)
    fan = 4 * coo_spmm.E_CHUNK + 37
    edges = np.concatenate([g.edges, np.stack([np.arange(fan),
                                               np.full(fan, hub)], 1)])
    if sr_name == "bool":
        return JRel.from_coo(edges, np.ones(len(edges), bool), (n, n), "bool")
    w = np.random.default_rng(seed).integers(1, 5, len(edges))
    return JRel.from_coo(edges, w, (n, n), sr_name)


def _operator(kind):
    """Operators for the item plan: a split hub row, no edges at all,
    coalesced duplicates, and rows that no edge reaches."""
    if kind == "hub":
        return _hub_relation("trop")
    if kind == "empty":
        return JRel.from_coo(np.zeros((0, 2), np.int64), np.zeros((0,)),
                             (64, 64), "bool")
    rng = np.random.default_rng(7)
    if kind == "duplicates":
        edges = rng.integers(0, 80, (400, 2))
        edges = np.concatenate([edges, edges[:100]])
        return JRel.from_coo(edges, rng.integers(1, 4, 500), (80, 80), "nat",
                             capacity=600)
    edges = rng.integers(0, 40, (300, 2))          # rows 40.. unreached
    return JRel.from_coo(edges, np.ones(300, bool), (90, 90), "bool")


@pytest.mark.parametrize("kind", ["hub", "empty", "duplicates", "isolated"])
@pytest.mark.parametrize("transpose", [False, True])
def test_plan_spmm_items_cover_each_row_once_in_order(kind, transpose):
    """The items tile [0, nnz) in order, none longer than E_CHUNK, each
    inside one row; a row has ceil(deg / E_CHUNK) items (one if it has
    no edge); every output row is written exactly once — by its one item
    or, for a split row, by the fold of its partial slots, which are
    consecutive and in item order."""
    plan = coo_spmm.plan_geometry(_port_rel(_operator(kind)),
                                  transpose=transpose)
    it, chunk = plan.items(), coo_spmm.E_CHUNK
    edge = it.edge.astype(np.int64)
    span = np.diff(edge)
    assert edge[0] == 0 and edge[-1] == plan.nnz
    assert (span >= 0).all() and it.max_edges == span.max(initial=0)
    assert it.max_edges <= chunk
    row = it.dst.astype(np.int64)
    slot_row = np.repeat(it.fold_row, np.diff(it.fold_seg))
    row[row < 0] = slot_row[~row[row < 0]]
    assert (np.diff(row) >= 0).all()
    assert np.array_equal(plan.dst, row[np.repeat(np.arange(it.n_items),
                                                  span)])
    deg = np.bincount(plan.dst, minlength=plan.n_out)
    assert np.array_equal(np.bincount(row, minlength=plan.n_out),
                          np.maximum(1, -(-deg // chunk)))
    written = np.concatenate([it.dst[it.dst >= 0], it.fold_row])
    assert np.array_equal(np.sort(written), np.arange(plan.n_out))
    assert np.array_equal(it.fold_row, np.flatnonzero(deg > chunk))
    assert np.array_equal(~it.dst[it.dst < 0], np.arange(it.n_part))
    if kind == "hub" and transpose:
        assert it.n_split >= 1 and it.n_part >= 5
    if kind == "empty":
        assert it.n_items == plan.n_out and it.max_edges == 0


@pytest.mark.parametrize("sr_name", ALL)
def test_plan_spmm_picks_the_path_by_semiring(sr_name):
    plan = coo_spmm.plan_geometry(_port_rel(_relation(120, 3, sr_name, 1)),
                                  transpose=True)
    path, geo = coo_spmm.plan_spmm(plan, 40)
    assert path == ("words_bool" if sr_name == "bool" else "lanes_f32")
    assert geo.row_len == (2 if sr_name == "bool" else 40)
    per_block = coo_spmm.WARPS * coo_spmm.ITEMS_PER_WARP
    assert geo.grid[0] == -(-geo.items.n_items // per_block)
    assert geo.scratch == geo.items.n_part * geo.row_len


def _bare_plan(sr_name, n):
    """A plan of ``n`` rows and no edges: the geometry's widths depend
    only on n and the lanes."""
    e = np.zeros(0, np.int64)
    return coo_spmm.SpmmPlan(sr_name, n, n, True, 0, e, e, e, e,
                             np.zeros(0, np.float32))


@pytest.mark.parametrize("sr_name", ["trop", "nat"])
def test_plan_spmm_slab_and_vector_at_the_main_path_shape(sr_name):
    """x (81,306 × 256) f32: 16-byte loads, 64-lane slabs (20.8 MB of x a
    slab, inside SLAB_BYTES; 128 lanes would be 41.6 MB), four slabs as
    the slowest grid dimension."""
    plan = _bare_plan(sr_name, 81_306)
    path, geo = coo_spmm.plan_spmm(plan, 256)
    assert path == "lanes_f32"
    assert (geo.vec, geo.threads_per_edge, geo.slab) == (4, 16, 64)
    per_block = coo_spmm.WARPS * coo_spmm.ITEMS_PER_WARP
    assert geo.grid == (-(-81_306 // per_block), 4)
    assert 81_306 * 64 * 4 <= coo_spmm.SLAB_BYTES < 81_306 * 128 * 4
    # a small x fits whole: one 128-lane slab of a warp's 32 × 4
    assert coo_spmm.plan_spmm(_bare_plan(sr_name, 500), 256)[1].slab == 128


@pytest.mark.parametrize("lanes, vec, tpe", [(1, 1, 1), (2, 1, 2),
                                             (6, 1, 8), (8, 4, 2),
                                             (301, 1, 32), (300, 4, 16)])
def test_plan_spmm_narrow_and_ragged_rows(lanes, vec, tpe):
    """Scalar loads where the width is not a multiple of 4, more lane
    groups an edge for narrow rows; slabs cover every lane."""
    _, geo = coo_spmm.plan_spmm(_bare_plan("real", 81_306), lanes)
    assert (geo.vec, geo.threads_per_edge) == (vec, tpe)
    assert geo.slab * geo.grid[1] >= lanes
    assert (geo.slab * (geo.grid[1] - 1)) < lanes


@pytest.mark.parametrize("lanes, words", [(1, 1), (31, 1), (32, 1), (33, 2),
                                          (64, 2), (256, 8), (300, 10)])
def test_plan_spmm_words_cover_the_lanes(lanes, words):
    _, geo = coo_spmm.plan_spmm(_bare_plan("bool", 81_306), lanes)
    assert geo.row_len == words == -(-lanes // 32)
    assert geo.vec == (4 if words % 4 == 0 else 1)
    assert geo.slab * geo.grid[1] >= words and geo.grid[1] == 1


def test_plan_spmm_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="unknown semiring"):
        coo_spmm.plan_spmm(_bare_plan("tropical", 4), 4)
    with pytest.raises(ValueError, match="negative"):
        coo_spmm.plan_spmm(_bare_plan("bool", 4), -1)


def test_spmm_cuda_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never takes the plain version: a CPU tensor
    handed to it raises before anything is built or launched."""
    plan = _bare_plan("trop", 8)
    with pytest.raises(ValueError, match="CUDA"):
        coo_spmm.spmm_cuda(plan, torch.zeros(8, 4))


def test_reset_launch_counts_clears_b1_paths(monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(coo_spmm.spmm_cuda, "launches", 3)
    monkeypatch.setattr(coo_spmm.spmm_cuda, "by_path",
                        {"words_bool": 2, "lanes_f32": 1})
    ops.reset_launch_counts()
    assert ops.launch_counts()["coo_spmm"] == 0
    assert coo_spmm.spmm_cuda.by_path == {"words_bool": 0, "lanes_f32": 0}


@pytest.mark.parametrize("b", [1, 63, 64, 65, 256])
def test_pack_lanes_matches_reference(b):
    x = np.random.default_rng(b).random((b, 37)) < 0.4
    want = jspmm.pack_lanes(x)
    got = coo_spmm.pack_lanes(torch.from_numpy(x))
    assert got.dtype == torch.uint64 and tuple(got.shape) == want.shape
    assert np.array_equal(got.view(torch.int64).numpy().view(np.uint64),
                          want)
    assert np.array_equal(coo_spmm.unpack_lanes(got, b).numpy(),
                          jspmm.unpack_lanes(want, b))
    words = coo_spmm.pack_words(torch.from_numpy(x.T.copy()))
    assert tuple(words.shape) == (37, -(-b // 32))
    assert torch.equal(coo_spmm.unpack_words(words, b),
                       torch.from_numpy(x.T.copy()))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("b", [1, 33, 64, 256])
def test_words_round_plain_matches_plain_and_reference(transpose, b):
    """The words_bool data flow — pack, items with split-row partials,
    the fold in item order, unpack — against B1's plain version, and
    its round on the reference's uint64 words against
    ``bool_round_packed``.  The answer is mixed (20–80% true)."""
    jrel = _hub_relation("bool")
    plan = coo_spmm.plan_geometry(_port_rel(jrel), transpose=transpose)
    if transpose:
        assert plan.items().n_split >= 1
    x = np.random.default_rng(b).random((plan.n_in, b)) < 0.12
    tx = torch.from_numpy(x)
    p = plan.on("cpu")
    want = ref.coo_spmm_ref(tsr.get("bool"), p["src"], p["w"], p["dst"], tx,
                            plan.n_out)
    assert 0.2 < float(want.float().mean()) < 0.8
    got = coo_spmm.unpack_words(
        coo_spmm.words_round_plain(plan, coo_spmm.pack_words(tx)), b)
    assert torch.equal(got, want)
    words64 = jspmm.pack_lanes(x.T)
    jplan = jspmm.plan_geometry(jrel, transpose=transpose)
    w32 = torch.from_numpy(words64.view(np.int32).copy())
    got64 = coo_spmm.words_round_plain(plan, w32).numpy().view(np.uint64)
    assert np.array_equal(got64, jspmm.bool_round_packed(jplan, words64))


# --------------------------------------------------------------------------
# B2 semiring_matmul
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("shape", [(8, 16, 8), (1, 70, 60), (130, 70, 60)])
def test_matmul_plain_vs_pallas(sr_name, shape):
    a, b = _matmul_inputs(sr_name, shape, seed=sum(shape))
    want = semiring_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                  sr_name=sr_name, interpret=True)
    got = semiring_matmul.semiring_matmul(sr_name, torch.from_numpy(a),
                                          torch.from_numpy(b))
    assert_match(got, want, sr_name)


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("m", [1, semiring_matmul.M_STREAM,
                               semiring_matmul.M_STREAM + 1])
@pytest.mark.parametrize("k", [33, 70])
def test_matmul_plain_vs_pallas_at_path_edges(sr_name, m, k):
    """Row counts on both sides of the stream/tile boundary, K that is
    no multiple of 16 or 32 and n that is none of 4 or 16."""
    a, b = _matmul_inputs(sr_name, (m, k, 45), seed=m * 100 + k)
    want = semiring_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                  sr_name=sr_name, interpret=True)
    got = semiring_matmul.semiring_matmul(sr_name, torch.from_numpy(a),
                                          torch.from_numpy(b))
    assert_match(got, want, sr_name)


@pytest.mark.parametrize("sr_name", ALL)
def test_plan_matmul_picks_the_path_at_m_stream(sr_name):
    ms = semiring_matmul.M_STREAM
    tile = "tc_bool" if sr_name == "bool" else "tile_f32"
    for m, want in ((1, "stream"), (ms, "stream"), (ms + 1, tile),
                    (4096, tile)):
        path, geo = semiring_matmul.plan_matmul(sr_name, m, 4096, 4096)
        assert path == want, (m, path)
        assert (geo.tile is None) == (path == "stream")


@pytest.mark.parametrize("sr_name", ["bool", "trop"])
@pytest.mark.parametrize("k, n", [(4096, 4096), (70, 45), (1, 300),
                                  (0, 16), (200_000, 8), (33, 70_000)])
def test_plan_matmul_stream_splits_cover_k(sr_name, k, n):
    path, geo = semiring_matmul.plan_matmul(sr_name, 1, k, n)
    assert path == "stream" and geo.tile is None
    strips, splits = geo.grid
    assert splits == geo.splits >= 1 and geo.k_per_split >= 1
    # every K row in exactly one split, no split empty (k > 0)
    assert splits * geo.k_per_split >= k
    assert k == 0 or (splits - 1) * geo.k_per_split < k
    assert splits <= 65535
    # the strips cover n in whole 16-byte loads a thread
    vec = 16 if sr_name == "bool" else 4
    assert geo.width == strips * semiring_matmul.THREADS * vec >= n
    # two waves of the card's SMs where K has the rows for it
    if k >= 2 * semiring_matmul.SMS:
        assert strips * splits >= 2 * semiring_matmul.SMS


def test_plan_matmul_stream_geometry_at_the_main_path_shape():
    """Π₂'s 1×4096×4096 𝔹 round: one strip of 4096 bytes a row, K cut
    into ≥ 264 splits of 15 rows."""
    path, geo = semiring_matmul.plan_matmul("bool", 1, 4096, 4096)
    assert path == "stream"
    assert geo.grid == (1, 274) and geo.k_per_split == 15
    assert geo.width == 4096
    path, geo = semiring_matmul.plan_matmul("trop", 1, 4096, 4096)
    assert geo.grid == (4, 67) and geo.k_per_split == 62


@pytest.mark.parametrize("sr_name", ["bool", "nat"])
def test_plan_matmul_tile_grid_and_row_limit(sr_name):
    mx = semiring_matmul._MAX_ROWS
    assert mx == 65535 * 128
    path, geo = semiring_matmul.plan_matmul(sr_name, 4096, 4096, 4096)
    assert geo.grid == (32, 32) and geo.tile == (128, 128)
    assert geo.splits == 1 and geo.k_per_split == 4096
    _, geo = semiring_matmul.plan_matmul(sr_name, 130, 70, 60)
    assert geo.grid == (1, 2)
    _, geo = semiring_matmul.plan_matmul(sr_name, mx, 8, 8)
    assert geo.grid[1] == 65535
    with pytest.raises(ValueError, match="grid limit"):
        semiring_matmul.plan_matmul(sr_name, mx + 1, 8, 8)


def test_plan_matmul_rejects_unknown_semirings():
    with pytest.raises(ValueError, match="unknown semiring"):
        semiring_matmul.plan_matmul("tropical", 4, 4, 4)


def test_matmul_cuda_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never takes the plain version: a CPU tensor
    handed to it raises before anything is built or launched."""
    a = torch.ones(2, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        semiring_matmul.semiring_matmul_cuda("bool", a, a.t())
    with pytest.raises(ValueError, match="bad shapes"):
        semiring_matmul.semiring_matmul_cuda("bool", a, a)


def test_plain_matmul_chunks_trop_rows():
    """The (min,+) plain version chunks rows to bound its intermediate;
    a chunk boundary must not change the result."""
    a, b = _matmul_inputs("trop", (50, 9, 7), seed=3)
    sr = tsr.get("trop")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    whole = ref.semiring_matmul_ref(sr, ta, tb)
    old = ref._CHUNK_ELEMS
    try:
        ref._CHUNK_ELEMS = 9 * 7 * 4          # four rows per chunk
        assert torch.equal(ref.semiring_matmul_ref(sr, ta, tb), whole)
    finally:
        ref._CHUNK_ELEMS = old


# --------------------------------------------------------------------------
# B5 flash_attention: the plan of its two CUDA paths
# --------------------------------------------------------------------------

#: the serving decode step: 8 rows of 1 query at position 543, 32 heads
#: of 80 (no GQA)
SERVE_DECODE = (8, 1, 544, 32, 32, 80)
#: mask kinds as plan_attention keywords, for decode-sized and
#: prefill-sized query blocks
MASKS = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window": dict(causal=True, window=48),
    "chunk": dict(causal=True, chunk=64),
    "chunk-full": dict(causal=False, chunk=32),
    "none-visible": dict(causal=True, window=4),
}


def _visible_by_mask(tq, tk, causal=True, window=None, chunk=None,
                     q_offset=0):
    """The keys some query sees, read off the plain version's mask."""
    qpos = np.arange(tq)[:, None] + q_offset
    kpos = np.arange(tk)[None, :]
    mask = np.ones((tq, tk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if chunk is not None:
        mask &= kpos // chunk == qpos // chunk
    return np.flatnonzero(mask.any(0))


@pytest.mark.parametrize("tq, group, path", [
    (1, 1, "decode_split"), (1, 16, "decode_split"), (4, 4, "decode_split"),
    (16, 1, "decode_split"), (17, 1, "prefill_tc"), (1, 32, "prefill_tc"),
    (3, 8, "prefill_tc"), (512, 1, "prefill_tc")])
def test_plan_attention_picks_the_path_by_query_rows(tq, group, path):
    """decode_split holds all tq · group query rows of a kv head in one
    block, up to DECODE_ROWS = 16; above that, the tensor-core path."""
    assert fa.DECODE_ROWS == 16
    got, geo = fa.plan_attention(2, tq, 600, 4 * group, 4, 80,
                                 q_offset=600 - tq)
    assert got == path
    if path == "decode_split":
        assert geo.q_tile == tq * group and geo.grid[1:] == (4, 2)
    else:
        assert geo.q_tile == fa.PREFILL_Q_TILE == 64 and geo.splits == 1


@pytest.mark.parametrize("d", [32, 80, 128])
@pytest.mark.parametrize("tq", [17, 64, 65, 100, 512, 544, 4097])
def test_plan_attention_prefill_grid_covers_tq(tq, d):
    path, geo = fa.plan_attention(3, tq, tq, 8, 2, d)
    assert path == "prefill_tc" and geo.scratch == 0
    assert geo.q_tile == 64
    gx, gy, gz = geo.grid
    assert gx * geo.q_tile >= tq > (gx - 1) * geo.q_tile
    assert (gy, gz) == (8, 3)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("tq, tk, q_offset, hq, hkv", [
    (1, 545, 544, 8, 2), (4, 600, 596, 16, 4), (1, 37, 36, 4, 4),
    (3, 32, 60, 4, 4), (1, 5000, 4999, 1, 1), (200, 200, 0, 4, 2),
    (20, 84, 64, 4, 4)])
def test_plan_attention_splits_cover_visible_keys(mask, tq, tk, q_offset,
                                                  hq, hkv):
    kw = MASKS[mask]
    path, geo = fa.plan_attention(2, tq, tk, hq, hkv, 64, q_offset=q_offset,
                                  **kw)
    seen = _visible_by_mask(tq, tk, q_offset=q_offset, **kw)
    lo, hi = fa.visible_keys(tq, tk, q_offset=q_offset, **kw)
    if len(seen):   # the plan's range is the visible keys' hull
        assert (lo, hi) == (seen.min(), seen.max() + 1)
    else:
        assert lo == hi
    n = hi - lo
    assert geo.splits >= 1 and geo.keys_per_split >= 1
    assert geo.splits * geo.keys_per_split >= n
    if path == "decode_split":
        assert geo.grid == (geo.splits, hkv, 2)
        assert geo.keys_per_split % fa.SPLIT_KEYS == 0
        assert n == 0 or (geo.splits - 1) * geo.keys_per_split < n
        rows = tq * (hq // hkv)
        assert geo.scratch == geo.splits * 2 * hkv * rows * (2 + 64)
    else:
        assert geo.splits == 1 and geo.keys_per_split == n


def test_plan_attention_decode_geometry_at_the_serving_shape():
    """The serving decode step: B · Hkv = 256 blocks a split, so ≥ 2
    splits for two waves of the card's 132 SMs; the plan cuts the 544
    keys into 3 splits of 184 (768 blocks)."""
    b, tq, tk, hq, hkv, d = SERVE_DECODE
    path, geo = fa.plan_attention(b, tq, tk, hq, hkv, d, q_offset=tk - 1)
    assert path == "decode_split"
    blocks = geo.grid[0] * geo.grid[1] * geo.grid[2]
    assert blocks >= 2 * fa.SMS == 264
    assert geo.grid == (3, 32, 8) and geo.keys_per_split == 184
    assert geo.q_tile == 1
    assert geo.scratch == 3 * 8 * 32 * (2 + 80)
    # the prefill of the same serving path: 8 q tiles × 32 heads × 8
    path, geo = fa.plan_attention(8, 512, 512, 32, 32, 80)
    assert path == "prefill_tc" and geo.grid == (8, 32, 8)


def test_plan_attention_rejects_what_the_kernels_do_not_take():
    # a head past 256 is taken (wide_chunk); a head of 0 is not
    assert fa.plan_attention(1, 4, 4, 2, 2, 257)[0] == "wide_chunk"
    with pytest.raises(ValueError, match="head dim"):
        fa.plan_attention(1, 4, 4, 2, 2, 0)
    with pytest.raises(ValueError, match="multiple"):
        fa.plan_attention(1, 4, 4, 3, 2, 8)
    with pytest.raises(ValueError, match="window"):
        fa.plan_attention(1, 4, 4, 2, 2, 8, window=0)
    with pytest.raises(ValueError, match="chunk"):
        fa.plan_attention(1, 4, 4, 2, 2, 8, chunk=-1)
    with pytest.raises(ValueError, match="negative"):
        fa.plan_attention(1, 4, 4, 2, 2, 8, q_offset=-1)
    with pytest.raises(ValueError, match="grid limit"):
        fa.plan_attention(70_000, 40, 40, 2, 2, 8)
    assert fa.plan_attention(1, 4, 4, 2, 2, 128)[0] == "decode_split"


def test_flash_attention_cuda_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never takes the plain version: a CPU tensor
    handed to it raises before anything is built or launched."""
    q = torch.ones(1, 2, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q)


# --------------------------------------------------------------------------
# B5 prefill_tc: 3xTF32 against one TF32 pass, emulated on the CPU
# --------------------------------------------------------------------------


def _tf32_attention(q, k, v, passes, split="kernel"):
    """Causal attention with QKᵀ and PV as TF32 products, as prefill_tc
    computes it: q pre-scaled in f32, P = exp(s − max) held in f32,
    O = P·V / Σ P."""
    b, tq, h, d = q.shape
    out = np.empty_like(q)
    mask = np.arange(k.shape[1])[None, :] <= np.arange(tq)[:, None]
    scale = np.float32(1.0 / np.sqrt(d))
    for bi in range(b):
        for hi in range(h):
            s = tf32_product(q[bi, :, hi] * scale, k[bi, :, hi].T, passes,
                             split)
            s = np.where(mask, s, -np.inf)
            p = np.exp(s - s.max(1, keepdims=True)).astype(np.float32)
            o = tf32_product(p, v[bi, :, hi], passes, split)
            out[bi, :, hi] = o / p.astype(np.float64).sum(1, keepdims=True)
    return out


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_needs_three_tf32_passes_for_float_tol(seed, split):
    """At D = 80, Tq = Tk = 512, causal: the 3-pass split of QKᵀ and PV
    meets B5's tolerance, 1e-4 · max(1, max |plain|), against the plain
    version (with two orders of magnitude to spare), with the kernel's
    split and with round-to-nearest alike; one TF32 pass misses it."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, 512, 2, 80)).astype(np.float32)
               for _ in range(3))
    want = ref.attention_ref(*map(torch.from_numpy, (q, k, v))).numpy()
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    err3 = float(np.abs(_tf32_attention(q, k, v, 3, split) - want).max())
    err1 = float(np.abs(_tf32_attention(q, k, v, 1, split) - want).max())
    assert err3 <= tol / 100, (err3, tol)
    assert err1 > tol, (err1, tol)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                  -(1.0 + 2.0 ** -11), 3.0 + 3 * 2.0 ** -11], np.float32)
    want = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                     -(1.0 + 2.0 ** -10), 3.0 + 2.0 ** -9], np.float32)
    assert np.array_equal(tf32_rna(x), want)
    lo = tf32_rna(x - tf32_rna(x))
    assert np.array_equal(tf32_rna(x) + lo, x)
    # toward zero: 1 + 2^-11 and -(1 + 2^-11) drop their last bit
    assert np.array_equal(tf32_trunc(x)[[2, 4, 5]],
                          np.array([1.0, -1.0, 3.0],
                                   np.float32))
