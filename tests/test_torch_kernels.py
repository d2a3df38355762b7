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
    if sr_name == "bool":
        return rng.random((m, k)) < 0.3, rng.random((k, n)) < 0.3
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
