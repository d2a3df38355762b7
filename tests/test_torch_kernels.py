"""Port parity: the plain versions of kernels B1–B3 against the JAX
package's Pallas kernels run as its own tests run them (interpret mode).

* B1 ``coo_spmm``: ``repro_torch.kernels.coo_spmm.spmm`` on CPU tensors
  vs ``repro.kernels.coo_spmm.spmm_pallas(plan, x, interpret=True)``.
* B2 ``semiring_matmul``: ``semiring_matmul`` on CPU tensors vs
  ``semiring_matmul_pallas(..., interpret=True)``.
* B3 ``coo_segment``: ``segment_reduce`` on CPU tensors vs
  ``segment_reduce_pallas(..., interpret=True)`` for ``(m,)`` payloads
  and vs the reference's jnp scatter for ``(m, B)`` payloads (the
  reference routes only scalar payloads to its kernel).

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
from repro_torch.sparse.coo import SparseRelation

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
