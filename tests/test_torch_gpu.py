"""The port's CUDA kernels on the card, held against their plain
PyTorch versions, and the main path on the card against the same path
on the CPU.

Every case needs a CUDA device and skips without one: the hand-written
kernels have no CPU or interpret mode.  This file imports no JAX, so it
runs on a GPU machine that has only PyTorch::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: bool/trop/maxplus/nat exact; real ``atol = rtol = 1e-4``
(the kernels and the plain versions sum in different orders); B4 and B5
``max |err| <= 1e-4 · max(1, max |plain|)`` (float kernels summing in
another order than their plain versions).

𝔹 products draw each operand at density 1/√k, so about one term of
each output's K sum is 1̄ and the answer is mixed: every 𝔹 product here
asserts that 20–80% of the plain answer is true before it compares, so
a kernel that saturates, or drops part of K, cannot pass.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core import semiring as sr_mod
from repro_torch.core.program import run_program
from repro_torch.datalog import datasets, programs
from repro_torch.kernels import coo_segment, coo_spmm, ref, semiring_matmul
from repro_torch.sparse import fixpoint as fx
from repro_torch.sparse.coo import SparseRelation

ALL = ("bool", "trop", "maxplus", "nat", "real")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


def assert_match(got: torch.Tensor, want: torch.Tensor, sr_name: str):
    assert got.shape == want.shape and got.dtype == want.dtype
    if sr_name == "real":
        torch.testing.assert_close(got.cpu(), want.cpu(), atol=1e-4,
                                   rtol=1e-4)
    else:
        assert torch.equal(got.cpu(), want.cpu()), sr_name


def _relation(n, sr_name, seed, device):
    g = datasets.powerlaw(n, 4, seed=seed)
    edges = g.edges
    if sr_name == "maxplus":  # acyclic, so longest paths converge
        edges = np.sort(edges, axis=1)
        edges = edges[edges[:, 0] != edges[:, 1]]
    w = np.random.default_rng(seed).integers(1, 5, len(edges))
    if sr_name == "bool":
        w = np.ones(len(edges), bool)
    return SparseRelation.from_coo(edges, w, (n, n), sr_name, device=device)


def _values(rng, shape, sr_name, live=0.3):
    """Random operand in the semiring: ``live`` of it non-0̄ (𝔹: see
    :func:`_live`)."""
    sr = sr_mod.get(sr_name, lib="np")
    mask = rng.random(shape) < live
    if sr_name == "bool":
        return torch.from_numpy(mask)
    x = np.full(shape, sr.zero, sr.dtype)
    x[mask] = rng.integers(0, 5, int(mask.sum()))
    return torch.from_numpy(x)


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("b", [None, 8])
def test_segment_kernel_vs_plain(cuda, sr_name, b):
    rng = np.random.default_rng(3)
    m, n = 5000, 300
    vals = _values(rng, (m,) if b is None else (m, b), sr_name).to(cuda)
    ids = torch.from_numpy(rng.integers(0, n + 3, m).astype(np.int32)
                           ).to(cuda)       # n.. emulate padding sentinels
    before = coo_segment.segment_reduce_cuda.launches
    got = coo_segment.segment_reduce(sr_name, vals, ids, n)
    assert coo_segment.segment_reduce_cuda.launches == before + 1
    assert_match(got, ref.segment_reduce_ref(sr_mod.get(sr_name), vals,
                                             ids, n), sr_name)


#: the runs cases: rows n; a hub row of SEG_HUB entries (eight items of
#: E_CHUNK); rows reached by no in-range id (n - 40 ..); ids below 0 and
#: at or past n (sentinels) that the plan must drop
SEG_N, SEG_M, SEG_HUB = 400, 6000, 1000


def _segment_ids(rng, *, shuffle=True):
    ids = rng.integers(0, SEG_N - 40, SEG_M)
    ids[:SEG_HUB] = 7
    ids[SEG_HUB:SEG_HUB + 30] = -1 - rng.integers(0, 3, 30)
    ids[SEG_HUB + 30:SEG_HUB + 90] = SEG_N + rng.integers(0, 3, 60)
    ids = ids if shuffle else np.sort(ids, kind="stable")
    if shuffle:
        rng.shuffle(ids)
    return torch.from_numpy(ids.astype(np.int32))


def _segment_payload(rng, sr_name, lanes, live=None):
    """A payload for the runs cases; 𝔹 at 5% live, so about half of the
    rows (≈15 entries each) come out true."""
    shape = (SEG_M,) if lanes is None else (SEG_M, lanes)
    return _values(rng, shape, sr_name,
                   live if live is not None else
                   (0.05 if sr_name == "bool" else 0.3))


def _runs(sr_name, vals, ids, n=SEG_N):
    """B3's runs path: the ids' plan, the payload in plan order."""
    plan = coo_segment.plan_segment(ids, n)
    return coo_segment.segment_reduce(sr_name, vals[plan.order], ids, n,
                                      plan=plan)


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("lanes", [None, 1, 3, 8, 64, 300])
@pytest.mark.parametrize("shuffle", [False, True])
def test_segment_runs_kernel_vs_plain(cuda, sr_name, lanes, shuffle):
    """The runs path against the plain oracle on the unsorted payload:
    a split hub row, unreached rows, dropped ids, (m,) and (m, B)."""
    rng = np.random.default_rng(11)
    ids = _segment_ids(rng, shuffle=shuffle).to(cuda)
    vals = _segment_payload(rng, sr_name, lanes).to(cuda)
    plan = coo_segment.plan_segment(ids, SEG_N)
    assert plan.items.n_split >= 1 and plan.m_live == SEG_M - 90
    got = _runs(sr_name, vals, ids)
    want = ref.segment_reduce_ref(sr_mod.get(sr_name), vals, ids, SEG_N)
    if sr_name == "bool":
        _assert_mixed(want)
    assert_match(got, want, sr_name)


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("lanes", [None, 8])
def test_segment_runs_misaligned_payload(cuda, sr_name, lanes):
    """A payload view that starts off its alignment (words, 16 bytes)."""
    rng = np.random.default_rng(12)
    ids = _segment_ids(rng).to(cuda)
    plan = coo_segment.plan_segment(ids, SEG_N)
    width = 1 if lanes is None else lanes
    flat = _values(rng, (plan.m_live * width + 1,), sr_name,
                   0.05 if sr_name == "bool" else 0.3).to(cuda)
    vals = flat[1:] if lanes is None else flat[1:].view(plan.m_live, lanes)
    got = coo_segment.segment_reduce(sr_name, vals, ids, SEG_N, plan=plan)
    want = coo_segment.segment_runs_plain(sr_mod.get(sr_name), plan, vals)
    assert_match(got, want, sr_name)


@pytest.mark.parametrize("sr_name", ["bool", "trop", "real"])
@pytest.mark.parametrize("lanes", [None, 8])
def test_segment_runs_is_bitwise_repeatable(cuda, sr_name, lanes):
    """No atomics on rows: items fold in a fixed tree, split rows in
    item order, so real sums repeat bit for bit."""
    rng = np.random.default_rng(13)
    ids = _segment_ids(rng).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (SEG_M,) if lanes is None else (SEG_M, lanes)
    vals = torch.rand(shape, generator=g, device=cuda)
    vals = vals < 0.05 if sr_name == "bool" else vals
    first = _runs(sr_name, vals, ids)
    for _ in range(3):
        assert torch.equal(_runs(sr_name, vals, ids), first)


@pytest.mark.parametrize("sr_name", ["bool", "trop", "nat"])
@pytest.mark.parametrize("lanes", [None, 8, 64])
def test_segment_runs_one_live_entry_in_the_last_item_of_a_split_row(
        cuda, sr_name, lanes):
    """The only non-0̄ entry sits in the last item of the split hub row: a
    fold that drops or misplaces a partial, or a ticket that fires early,
    fails.  The hub row must be 1̄ and every other row 0̄; the call is
    repeated, so a ticket left set by one call would show in the next."""
    rng = np.random.default_rng(14)
    ids = _segment_ids(rng).to(cuda)
    plan = coo_segment.plan_segment(ids, SEG_N)
    it = plan.items
    k = int(torch.nonzero(it.fold_row == 7)[0])
    last_slot = int(it.fold_seg[k + 1]) - 1
    item = int(torch.nonzero(it.dst == ~last_slot)[0])
    pos = int(it.edge[item + 1]) - 1      # its last entry, in plan order
    sr = sr_mod.get(sr_name)
    shape = (plan.m_live,) if lanes is None else (plan.m_live, lanes)
    vals = sr.zeros(shape, cuda)
    vals[pos] = sr.one
    want = sr.zeros((SEG_N,) + shape[1:], cuda)
    want[7] = sr.one
    for _ in range(2):
        got = coo_segment.segment_reduce(sr_name, vals, ids, SEG_N,
                                         plan=plan)
        assert torch.equal(got, want)
    assert torch.equal(coo_segment.segment_runs_plain(sr, plan, vals), want)


def test_segment_runs_refuses_a_foreign_payload(cuda):
    """A plan built from one ids tensor takes neither another ids tensor
    (even an equal one), another row count, nor a payload of another
    length or device."""
    rng = np.random.default_rng(15)
    ids = _segment_ids(rng).to(cuda)
    plan = coo_segment.plan_segment(ids, SEG_N)
    vals = torch.ones(plan.m_live, device=cuda)
    before = coo_segment.segment_reduce_cuda.launches
    for args in ((vals, ids.clone(), SEG_N), (vals, ids, SEG_N + 1),
                 (vals[1:], ids, SEG_N), (torch.ones(SEG_M, device=cuda),
                                          ids, SEG_N)):
        with pytest.raises(ValueError, match="plan"):
            coo_segment.segment_reduce("nat", *args, plan=plan)
    with pytest.raises(ValueError):
        coo_segment.segment_reduce("nat", vals.cpu(), ids.cpu(), SEG_N,
                                   plan=plan)
    assert coo_segment.segment_reduce_cuda.launches == before


@pytest.mark.parametrize("sr_name", ALL)
def test_segment_counts_launches_by_path(cuda, sr_name):
    rng = np.random.default_rng(16)
    ids = _segment_ids(rng).to(cuda)
    vals = _segment_payload(rng, sr_name, None).to(cuda)
    paths = dict(coo_segment.segment_reduce_cuda.by_path)
    before = coo_segment.segment_reduce_cuda.launches
    _runs(sr_name, vals, ids)
    coo_segment.segment_reduce(sr_name, vals, ids, SEG_N)
    paths["runs"] += 1
    paths["scatter"] += 1
    assert coo_segment.segment_reduce_cuda.by_path == paths
    assert coo_segment.segment_reduce_cuda.launches == before + 2


def _bend_runs(geo, change):
    it = geo.items
    return {"long_item": lambda: geo._replace(items=it._replace(
                max_edges=coo_spmm.E_CHUNK + 1)),
            "few_items": lambda: geo._replace(items=it._replace(
                dst=it.dst[:10])),
            "grid": lambda: geo._replace(grid=(1, geo.grid[1])),
            "slabs": lambda: geo._replace(grid=(geo.grid[0], 1)),
            "vec": lambda: geo._replace(vec=2),
            "tpe": lambda: geo._replace(threads_per_edge=3),
            "scratch": lambda: geo._replace(scratch=0),
            }[change]()


@pytest.mark.parametrize("lanes, change", [
    (None, "long_item"), (None, "few_items"), (None, "grid"),
    (None, "scratch"), (None, "vec"), (300, "slabs"), (300, "vec"),
    (300, "tpe"), (300, "grid"), (300, "scratch"),
])
def test_segment_runs_c_side_refuses_a_foreign_geometry(cuda, monkeypatch,
                                                        lanes, change):
    """The C entry launches the plan's geometry and raises (through the
    wrapper, RuntimeError) on items longer than E_CHUNK or fewer than the
    rows, a grid that does not cover the items or the row, a vector or
    lane-group width that was not compiled, or short scratch."""
    rng = np.random.default_rng(17)
    ids = _segment_ids(rng).to(cuda)
    plan = coo_segment.plan_segment(ids, SEG_N)
    shape = (plan.m_live,) if lanes is None else (plan.m_live, lanes)
    vals = torch.ones(shape, device=cuda)
    real = coo_segment.plan_runs

    def bent(*args):
        kernel, elem, geo = real(*args)
        return kernel, elem, _bend_runs(geo, change)
    monkeypatch.setattr(coo_segment, "plan_runs", bent)
    before = coo_segment.segment_reduce_cuda.launches
    with pytest.raises(RuntimeError, match="coo_segment"):
        coo_segment.segment_reduce("trop", vals, ids, SEG_N, plan=plan)
    assert coo_segment.segment_reduce_cuda.launches == before


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("b", [1, 8, 300])
@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_kernel_vs_plain(cuda, sr_name, b, transpose):
    rel = _relation(500, sr_name, seed=1, device=cuda)
    plan = coo_spmm.plan_geometry(rel, transpose=transpose)
    x = _values(np.random.default_rng(b), (500, b), sr_name, 0.1).to(cuda)
    before = coo_spmm.spmm_cuda.launches
    got = coo_spmm.spmm(plan, x)
    assert coo_spmm.spmm_cuda.launches == before + 1
    p = plan.on(cuda)
    assert_match(got, ref.coo_spmm_ref(sr_mod.get(sr_name), p["src"],
                                       p["w"], p["dst"], x, plan.n_out),
                 sr_name)


N_HUB, HUB = 700, 5
#: in-degree of the hub row: more than four items of E_CHUNK edges
HUB_FAN = 4 * coo_spmm.E_CHUNK + 37


def _hub_relation(sr_name, device, *, drop_from=None, one=False):
    """A small power-law operator plus one row of in-degree HUB_FAN
    (column HUB of E: the output row of the transposed orientation, cut
    into five items).  ``drop_from``: leave that source no edge but its
    hub edge; ``one``: every edge weighs 1̄."""
    g = datasets.powerlaw(N_HUB, 3, seed=0)
    edges = np.concatenate([g.edges, np.stack([np.arange(HUB_FAN),
                                               np.full(HUB_FAN, HUB)], 1)])
    if drop_from is not None:
        edges = edges[(edges[:, 0] != drop_from) | (edges[:, 1] == HUB)]
    sr = sr_mod.get(sr_name, lib="np")
    if sr_name == "bool" or one:
        w = np.full(len(edges), sr.one, sr.dtype)
    else:
        w = np.random.default_rng(0).integers(1, 5, len(edges))
    return SparseRelation.from_coo(edges, w, (N_HUB, N_HUB), sr_name,
                                   device=device)


def _hub_plan(sr_name, device, **kw):
    plan = coo_spmm.plan_geometry(_hub_relation(sr_name, device, **kw),
                                  transpose=True)
    it = plan.items()
    assert np.bincount(plan.dst).max() > 4 * coo_spmm.E_CHUNK
    assert it.n_split >= 1 and it.max_edges <= coo_spmm.E_CHUNK
    return plan


def _spmm_plain(plan, x):
    p = plan.on(x.device)
    return ref.coo_spmm_ref(sr_mod.get(plan.sr_name), p["src"], p["w"],
                            p["dst"], x, plan.n_out)


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("lanes", [None, 1, 8, 256])
def test_spmm_split_hub_row_vs_plain(cuda, sr_name, lanes):
    """A row of in-degree > 4·E_CHUNK runs as several items whose
    partials the fold combines; every semiring, both x shapes."""
    plan = _hub_plan(sr_name, cuda)
    shape = (N_HUB,) if lanes is None else (N_HUB, lanes)
    x = _values(np.random.default_rng(2), shape, sr_name,
                0.15 if sr_name == "bool" else 0.3).to(cuda)
    got = coo_spmm.spmm(plan, x)
    want = _spmm_plain(plan, x)
    if sr_name == "bool":
        _assert_mixed(want)
    assert_match(got, want, sr_name)


@pytest.mark.parametrize("lanes", [1, 31, 32, 33, 64, 256, 300])
def test_spmm_bool_lane_counts_vs_plain(cuda, lanes):
    """words_bool at lane counts around the 32-bit word edges."""
    plan = _hub_plan("bool", cuda)
    x = torch.from_numpy(np.random.default_rng(lanes).random((N_HUB, lanes))
                         < 0.15).to(cuda)
    want = _spmm_plain(plan, x)
    _assert_mixed(want)
    assert torch.equal(coo_spmm.spmm(plan, x), want)


def _last_item_of_hub(plan):
    """The edge range of the last item of the hub row's partials."""
    it = plan.items()
    k = int(np.flatnonzero(it.fold_row == HUB)[0])
    item = int(np.flatnonzero(it.dst == ~(int(it.fold_seg[k + 1]) - 1))[0])
    return int(it.edge[item]), int(it.edge[item + 1])


@pytest.mark.parametrize("sr_name", ["bool", "trop", "nat"])
@pytest.mark.parametrize("lanes", [None, 1, 32, 256])
def test_spmm_one_hot_source_in_the_last_item_of_a_split_row(cuda, sr_name,
                                                             lanes):
    """x is 1̄ only at a source whose one edge sits in the last item of
    the split hub row: a fold that drops or misplaces a partial fails.
    The hub row must be 1̄ and every other row 0̄."""
    probe = _hub_plan(sr_name, cuda)
    lo, hi = _last_item_of_hub(probe)
    hot = int(probe.src[hi - 1])
    plan = _hub_plan(sr_name, cuda, drop_from=hot, one=True)
    lo, hi = _last_item_of_hub(plan)
    assert hot in plan.src[lo:hi] and (plan.src == hot).sum() == 1
    sr = sr_mod.get(sr_name)
    shape = (N_HUB,) if lanes is None else (N_HUB, lanes)
    x = sr.zeros(shape, cuda)
    x[hot] = sr.one
    got = coo_spmm.spmm(plan, x)
    want = sr.zeros(shape, cuda)
    want[HUB] = sr.one
    assert torch.equal(got, want)
    assert torch.equal(_spmm_plain(plan, x), want)


@pytest.mark.parametrize("sr_name", ["bool", "trop", "real"])
def test_spmm_is_bitwise_repeatable(cuda, sr_name):
    """No atomics: items sum in a fixed order, the fold in item order."""
    plan = _hub_plan(sr_name, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand((N_HUB, 256), generator=g, device=cuda)
    x = x < 0.15 if sr_name == "bool" else x
    first = coo_spmm.spmm(plan, x)
    for _ in range(2):
        assert torch.equal(coo_spmm.spmm(plan, x), first)


@pytest.mark.parametrize("sr_name", ALL)
def test_spmm_counts_launches_by_path(cuda, sr_name):
    plan = _hub_plan(sr_name, cuda)
    x = _values(np.random.default_rng(3), (N_HUB, 8), sr_name).to(cuda)
    paths = dict(coo_spmm.spmm_cuda.by_path)
    before = coo_spmm.spmm_cuda.launches
    coo_spmm.spmm(plan, x)
    paths["words_bool" if sr_name == "bool" else "lanes_f32"] += 1
    assert coo_spmm.spmm_cuda.by_path == paths
    assert coo_spmm.spmm_cuda.launches == before + 1


def _bend(geo, change):
    it = geo.items
    return {"last_edge": lambda: geo._replace(items=it._replace(
                edge=np.append(it.edge[:-1], it.edge[-1] - 1))),
            "long_item": lambda: geo._replace(items=it._replace(
                max_edges=coo_spmm.E_CHUNK + 1)),
            "few_items": lambda: geo._replace(items=it._replace(
                dst=it.dst[:10])),
            "vec": lambda: geo._replace(vec=2),
            "tpe": lambda: geo._replace(threads_per_edge=3),
            "grid": lambda: geo._replace(grid=(1, geo.grid[1])),
            "slabs": lambda: geo._replace(grid=(geo.grid[0], 1)),
            "scratch": lambda: geo._replace(scratch=0),
            "words": lambda: geo._replace(row_len=geo.row_len + 1),
            }[change]()


@pytest.mark.parametrize("sr_name, change", [
    ("trop", "last_edge"), ("trop", "long_item"), ("trop", "few_items"),
    ("trop", "vec"), ("trop", "tpe"), ("trop", "grid"), ("trop", "slabs"),
    ("trop", "scratch"), ("bool", "words"), ("bool", "scratch"),
])
def test_spmm_c_side_refuses_a_foreign_geometry(cuda, monkeypatch, sr_name,
                                                change):
    """The C entries launch the plan's geometry, and raise (through the
    wrapper, RuntimeError) on one whose items do not cover the edges or
    the rows, whose item is longer than E_CHUNK, whose vector or slab
    width was not compiled, whose grid or scratch falls short, or whose
    words do not cover the lanes."""
    plan = _hub_plan(sr_name, cuda)
    x = _values(np.random.default_rng(4), (N_HUB, 256), sr_name).to(cuda)
    real = coo_spmm.plan_spmm

    def bent(*args):
        path, geo = real(*args)
        return path, _bend(geo, change)
    monkeypatch.setattr(coo_spmm, "plan_spmm", bent)
    before = coo_spmm.spmm_cuda.launches
    with pytest.raises(RuntimeError, match="coo_spmm"):
        coo_spmm.spmm(plan, x)
    assert coo_spmm.spmm_cuda.launches == before


def test_spmm_c_side_refuses_another_chunk(cuda, monkeypatch):
    """Items cut at another E_CHUNK than the kernels were compiled for."""
    plan = _hub_plan("nat", cuda)
    x = _values(np.random.default_rng(5), (N_HUB, 8), "nat").to(cuda)
    monkeypatch.setattr(coo_spmm, "E_CHUNK", 2 * coo_spmm.E_CHUNK)
    with pytest.raises(RuntimeError, match="coo_spmm"):
        coo_spmm.spmm(plan, x)


def _live(sr_name, k, live):
    """Operand density: ``live``, or 1/√k for 𝔹 (each output's K sum then
    holds one 1̄ term on average: about 63% of it is true)."""
    return k ** -0.5 if sr_name == "bool" else live


def _assert_mixed(want):
    """A 𝔹 answer that a wrong kernel could miss only by luck: 20–80%
    true, not all of one value."""
    share = float(want.float().mean())
    assert 0.2 < share < 0.8, f"saturated check: {share:.3f} of it true"


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("shape", [(1, 300, 300), (130, 70, 60),
                                   (256, 512, 128)])
def test_matmul_kernel_vs_plain(cuda, sr_name, shape):
    m, k, n = shape
    rng = np.random.default_rng(1)
    live = _live(sr_name, k, 0.6)
    a = _values(rng, (m, k), sr_name, live).to(cuda)
    b = _values(rng, (k, n), sr_name, live).to(cuda)
    before = semiring_matmul.semiring_matmul_cuda.launches
    got = semiring_matmul.semiring_matmul(sr_name, a, b)
    assert semiring_matmul.semiring_matmul_cuda.launches == before + 1
    want = ref.semiring_matmul_ref(sr_mod.get(sr_name), a, b)
    if sr_name == "bool":
        _assert_mixed(want)
    assert_match(got, want, sr_name)


MS = semiring_matmul.M_STREAM


def _tile_path(sr_name):
    return "tc_bool" if sr_name == "bool" else "tile_f32"


def _product(sr_name, a, b, path):
    """B2 on the card through the path ``path``, against its plain
    version (NaN equal to NaN: min/max-plus propagate it as the plain
    reductions do; a 𝔹 answer must be mixed)."""
    by = semiring_matmul.semiring_matmul_cuda.by_path
    before = dict(by)
    got = semiring_matmul.semiring_matmul(sr_name, a, b)
    torch.cuda.synchronize()
    assert by[path] == before[path] + 1, (path, by)
    want = ref.semiring_matmul_ref(sr_mod.get(sr_name), a, b)
    assert got.shape == want.shape and got.dtype == want.dtype
    if sr_name == "bool":
        _assert_mixed(want)
    if sr_name == "real":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(got, want, atol=0, rtol=0,
                                   equal_nan=True)
    return got


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("m", [1, MS, MS + 1])
def test_matmul_each_path_vs_plain(cuda, sr_name, m):
    """Both sides of the stream/tile boundary; k = 70 and n = 45 are no
    multiples of 16 or 32 (masked staging, ragged edge tiles)."""
    rng = np.random.default_rng(m)
    live = _live(sr_name, 70, 0.6)
    a = _values(rng, (m, 70), sr_name, live).to(cuda)
    b = _values(rng, (70, 45), sr_name, live).to(cuda)
    _product(sr_name, a, b, "stream" if m <= MS else _tile_path(sr_name))


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("m", [3, 150])
def test_matmul_transposed_operands(cuda, sr_name, m):
    """``.t()`` views, as the engine hands them (B2 makes them
    contiguous; a ``.t()`` B is tc_bool's K-major layout as it is)."""
    rng = np.random.default_rng(m + 7)
    live = _live(sr_name, 96, 0.5)
    a = _values(rng, (96, m), sr_name, live).to(cuda).t()
    b = _values(rng, (200, 96), sr_name, live).to(cuda).t()
    assert not a.is_contiguous() and not b.is_contiguous()
    _product(sr_name, a, b, "stream" if m <= MS else _tile_path(sr_name))


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("m", [2, 140])
def test_matmul_misaligned_operands(cuda, sr_name, m):
    """Contiguous operands whose first element is not 16-byte aligned
    (k, n multiples of 16): the kernels' masked loads, not 16-byte
    copies."""
    rng = np.random.default_rng(m + 11)
    live = _live(sr_name, 64, 0.5)
    a0 = _values(rng, (m * 64 + 1,), sr_name, live).to(cuda)
    b0 = _values(rng, (64 * 48 + 1,), sr_name, live).to(cuda)
    a, b = a0[1:].view(m, 64), b0[1:].view(64, 48)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    _product(sr_name, a, b, "stream" if m <= MS else _tile_path(sr_name))


@pytest.mark.parametrize("m", [1, 200])
def test_matmul_bool_all_ones_rows_at_k4096(cuda, m):
    """Rows of ones against 0/1 columns at k = 4096: counts up to 4096
    stay exact (u8·u8 → s32 on tensor cores), a zero column stays 0.  B
    at density 1/k leaves about 37% of the columns empty."""
    a = torch.ones((m, 4096), dtype=torch.bool, device=cuda)
    rng = np.random.default_rng(m)
    b = torch.from_numpy(rng.random((4096, 96)) < 1 / 4096).to(cuda)
    b[:, 0] = True           # count 4096
    b[:, 1] = False          # count 0
    b[:, 2] = False
    b[4095, 2] = True        # the last K row alone
    got = _product("bool", a, b, "stream" if m <= MS else "tc_bool")
    assert bool(got[:, 0].all()) and not bool(got[:, 1].any())
    assert bool(got[:, 2].all())


@pytest.mark.parametrize("m", [1, MS, 200])
def test_matmul_bool_one_hot_rows_at_k4096(cuda, m):
    """Π₂'s Δ rows: one-hot rows of A against a 40%-dense 4096² B, so
    row i of C must be row hot[i] of B.  A kernel that drops a K split
    or a K slab, or ignores A, fails.  m = 1 is the main path's
    1×4096×4096 stream geometry (274 splits of 15 K rows), swept over
    the first, last and a middle split and a split's edges; the other
    rows' hot positions spread over all of K."""
    rng = np.random.default_rng(m)
    b = torch.from_numpy(rng.random((4096, 4096)) < 0.4).to(cuda)
    path = "stream" if m <= MS else "tc_bool"
    if m == 1:
        sweeps = [[0], [14], [15], [2047], [4095]]
    else:
        sweeps = [np.linspace(0, 4095, m).round().astype(np.int64)]
    for hot in sweeps:
        a = torch.zeros((m, 4096), dtype=torch.bool, device=cuda)
        a[torch.arange(m), torch.as_tensor(hot)] = True
        got = _product("bool", a, b, path)
        assert torch.equal(got, b[torch.as_tensor(hot, device=cuda)])


@pytest.mark.parametrize("m", [1, 17, 130])
def test_matmul_nat_counts_above_2_11(cuda, m):
    """nat counts to 4096 (2¹², above where TF32 stops being exact):
    f32 FMA on every path."""
    a = torch.ones((m, 4096), device=cuda)
    b = torch.ones((4096, 70), device=cuda)
    b[:100, 3] = 0
    got = _product("nat", a, b, "stream" if m <= MS else "tile_f32")
    assert float(got.max()) == 4096.0 and float(got[0, 3]) == 3996.0


@pytest.mark.parametrize("sr_name", ["trop", "maxplus"])
@pytest.mark.parametrize("m", [1, 40])
def test_matmul_tropical_infinities(cuda, sr_name, m):
    """±inf entries: 0̄ in both operands (a 0̄ column of B), and the
    opposite infinity in A, which wins row 0 outright and meets a 0̄ of
    B in row m-1, column 11 (NaN there, propagated as the plain
    reductions propagate it)."""
    rng = np.random.default_rng(m)
    a = _values(rng, (m, 300), sr_name, 0.6).to(cuda)
    b = _values(rng, (300, 50), sr_name, 0.6).to(cuda)
    zero = sr_mod.get(sr_name).zero
    other = -zero
    b[5, :] = 1.0
    b[9, :] = 2.0
    b[9, 11] = zero
    b[:, 7] = zero
    a[0, 5] = other
    a[-1, 9] = other
    got = _product(sr_name, a, b, "stream" if m <= MS else "tile_f32")
    assert float(got[0, 0]) == other
    assert bool(torch.isnan(got[-1, 11]))
    if m > 2:
        assert float(got[1, 7]) == zero


@pytest.mark.parametrize("m", [1, 40])
def test_matmul_real_is_bitwise_repeatable(cuda, m):
    """real sums within 1e-4 of the plain version, and bitwise equal
    from run to run (the stream path folds its K splits in a fixed
    order; the tile path sums each K slab in order)."""
    g = torch.Generator(device=cuda).manual_seed(m)
    a = torch.randn((m, 3000), generator=g, device=cuda)
    b = torch.randn((3000, 500), generator=g, device=cuda)
    got = _product("real", a, b, "stream" if m <= MS else "tile_f32")
    for _ in range(3):
        assert torch.equal(semiring_matmul.semiring_matmul("real", a, b),
                           got)


def test_matmul_wrapper_rejects_what_kernels_do_not_take(cuda):
    x = torch.ones(4, 4, device=cuda)
    with pytest.raises(TypeError):
        semiring_matmul.semiring_matmul("bool", x, x)        # 𝔹 wants bool
    with pytest.raises(TypeError):
        semiring_matmul.semiring_matmul("trop", x.bool(), x.bool())
    with pytest.raises(TypeError):
        semiring_matmul.semiring_matmul("nat", x.double(), x.double())
    with pytest.raises(ValueError, match="bad shapes"):
        semiring_matmul.semiring_matmul("nat", x, x[:3])
    with pytest.raises(ValueError, match="bad shapes"):
        semiring_matmul.semiring_matmul("nat", x[0], x)
    with pytest.raises(ValueError, match="unknown semiring"):
        semiring_matmul.semiring_matmul_cuda("tropical", x, x)
    with pytest.raises(ValueError, match="CUDA"):
        semiring_matmul.semiring_matmul("nat", x, x.cpu())


def test_wrappers_reject_what_kernels_do_not_take(cuda):
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        coo_segment.segment_reduce("trop", torch.ones(4, device=cuda).bool(),
                                   ids, 2)
    with pytest.raises(ValueError):
        coo_segment.segment_reduce("trop", torch.ones(3, 4, device=cuda).t(),
                                   ids, 2)
    with pytest.raises(TypeError):
        coo_segment.segment_reduce("trop", torch.ones(4, device=cuda),
                                   ids.long(), 2)


@pytest.mark.parametrize("sr_name", ["bool", "trop", "maxplus"])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_fixpoint_on_card_matches_cpu(cuda, sr_name, backend):
    """Values and per-row counts of the batched fixpoint on the card
    (B3 or B1 advancing Δ) equal the CPU run (the plain versions)."""
    rel = _relation(2000, sr_name, seed=4, device="cpu")
    rng = np.random.default_rng(2)
    srn = sr_mod.get(sr_name, lib="np")
    init = np.full((16, 2000), srn.zero, srn.dtype)
    init[np.arange(16), rng.integers(0, 2000, 16)] = srn.one
    init = torch.from_numpy(init)
    want, wit = fx.fixpoint(rel, init, backend=backend)
    got, it = fx.fixpoint(rel.to(cuda), init.to(cuda), backend=backend)
    assert_match(got, want, sr_name)
    assert torch.equal(it.cpu(), wit)
    one, one_it = fx.fixpoint(rel.to(cuda), init[0].to(cuda),
                              backend=backend)
    assert_match(one, got[0], sr_name)
    assert one_it == int(it[0])


@pytest.mark.parametrize("kind", ["bm", "cc"])
@pytest.mark.parametrize("which", ["original", "optimized"])
def test_run_program_on_card_matches_cpu(cuda, kind, which):
    """BM/CC Π₁ and Π₂ on a dense graph (E stays dense: B2 joins) and
    Π₂ on a sparse one (B3), card against CPU."""
    bench = programs.bm(a=0) if kind == "bm" else programs.cc()
    prog = getattr(bench, which)
    g = datasets.erdos_renyi(160, 0.4 * 160, seed=1)
    graphs = [(bench.make_db(g, device="cpu"), bench.make_db(g, device=cuda))]
    if which == "optimized":
        p = datasets.powerlaw(3000, 4, seed=0)
        graphs.append(tuple(engine.Database(
            bench.original.schema, {"id": p.n},
            {"E": p.sparse_adjacency(device=d), "V": p.vertex_set(device=d)},
            d) for d in ("cpu", cuda)))
    for cpu_db, gpu_db in graphs:
        want, wst = run_program(prog, cpu_db)
        got, st = run_program(prog, gpu_db)
        assert got.device.type == "cuda"
        assert_match(got, want, prog.outputs[-1].body.semiring)
        assert st.iterations == wst.iterations


# --------------------------------------------------------------------------
# the frontier worklist and its CSR cache on the card
# --------------------------------------------------------------------------


def _sources(n, b, sr_name, seed):
    srn = sr_mod.get(sr_name, lib="np")
    init = np.full((b, n), srn.zero, srn.dtype)
    init[np.arange(b), np.random.default_rng(seed).integers(0, n, b)] = \
        srn.one
    return torch.from_numpy(init)


@pytest.mark.parametrize("sr_name", ["bool", "trop", "maxplus"])
def test_frontier_on_card_matches_cpu(cuda, sr_name):
    """The worklist on the card equals the one on the CPU — values,
    counts and both FrontierStats lists — and each of its rounds
    launches B3 once, through the scatter path."""
    rel = _relation(2000, sr_name, seed=5, device="cpu")
    init = _sources(2000, 3, sr_name, seed=3)
    want, wit, wsts = fx.sparse_seminaive_fixpoint_stats(rel, init)
    grel = rel.to(cuda)
    paths0 = dict(coo_segment.segment_reduce_cuda.by_path)
    got, it, sts = fx.sparse_seminaive_fixpoint_stats(grel, init.to(cuda))
    paths = {k: v - paths0[k]
             for k, v in coo_segment.segment_reduce_cuda.by_path.items()}
    assert got.device.type == "cuda"
    assert_match(got, want, sr_name)
    assert torch.equal(it.cpu(), wit)
    for st, wst in zip(sts, wsts):
        assert st.frontier_sizes == wst.frontier_sizes
        assert st.edges_expanded == wst.edges_expanded
    assert paths == {"runs": 0, "scatter": int(wit.sum())}
    assert fx.csr_index(grel).w.device.type == "cuda"
    # the same after an overlay and a poisoned delete, on the device
    e = rel.as_np().coords[:rel.nnz]
    add = np.random.default_rng(1).integers(0, 2000, (40, 2))
    if sr_name == "maxplus":
        add = np.sort(add, axis=1)
        add = add[add[:, 0] < add[:, 1]]
    for step in ("delta", "delete"):
        if step == "delta":
            rel, grel = rel.apply_delta(add), grel.apply_delta(add)
        else:
            rel, grel = rel.delete_keys(e[:25]), grel.delete_keys(e[:25])
        idx = fx._csr_lookup(grel)
        assert idx is not None and idx.xw.device.type == "cuda"
        want, wit = fx.fixpoint(rel, init, mode="frontier")
        got, it = fx.fixpoint(grel, init.to(cuda), mode="frontier")
        assert_match(got, want, sr_name)
        assert torch.equal(it.cpu(), wit)


@pytest.mark.parametrize("transpose", [False, True])
def test_csr_index_on_card_matches_cpu(cuda, transpose):
    rel = _relation(3000, "trop", seed=6, device="cpu")
    want = fx.csr_index(rel, transpose=transpose)
    got = fx.csr_index(rel.to(cuda), transpose=transpose)
    for k in ("counts", "starts", "src", "dst", "w"):
        t = getattr(got, k)
        assert t.device.type == "cuda"
        assert torch.equal(t.cpu(), getattr(want, k)), k


def test_np_backend_raises_on_a_cuda_database(cuda):
    bench = programs.bm(a=0)
    g = datasets.erdos_renyi(40, 2.0, seed=1)
    body = bench.optimized.strata[0].rules["Q"].body
    db = bench.make_db(g, device=cuda)
    with pytest.raises(ValueError, match="CPU database only"):
        engine.eval_ssp(body, db, {}, backend="np")
    got = engine.eval_ssp(body, db.with_relations(
        {"Q": torch.zeros(40, dtype=torch.bool, device=cuda)}), {})
    assert got.device.type == "cuda"


@pytest.mark.parametrize("kind", ["bm", "cc"])
def test_planner_rejects_the_frontier_on_a_cuda_database(cuda, kind):
    """On the card the latency plan rejects the worklist with the
    reference's reason and keeps the staged runner; asked for by name
    it runs and equals the staged answer."""
    from repro_torch.core import planner
    bench = programs.bm(a=0) if kind == "bm" else programs.cc()
    p = datasets.powerlaw(3000, 4, seed=0)
    db = engine.Database(bench.original.schema, {"id": p.n},
                         {"E": p.sparse_adjacency(device=cuda),
                          "V": p.vertex_set(device=cuda)}, cuda)
    sp = planner.plan_program(bench.optimized, db).strata[0]
    assert sp.runner == "sparse_jit"
    assert sp.rejected["sparse_frontier"] == (
        "host worklist loses to the staged while_loop off-CPU / for "
        "batches")
    want, wst = run_program(bench.optimized, db)
    paths0 = dict(coo_segment.segment_reduce_cuda.by_path)
    got, st = run_program(bench.optimized, db, mode="sparse_frontier")
    assert st.plan.strata[0].runner == "sparse_frontier"
    assert coo_segment.segment_reduce_cuda.by_path["scatter"] \
        - paths0["scatter"] == st.iterations[0]
    assert_match(got, want, bench.optimized.outputs[-1].body.semiring)
    assert st.iterations == wst.iterations


# --------------------------------------------------------------------------
# incremental maintenance on the card
# --------------------------------------------------------------------------


def _b3_paths_since(paths0):
    return {k: v - paths0[k]
            for k, v in coo_segment.segment_reduce_cuda.by_path.items()}


def _warm_on(rel, sr_name, b, seed):
    """The relation with every in-edge of its last 200 vertices cut, a
    warm pack solved on it on the CPU from sources among the first 50,
    and a merge delta from reached vertices into the cut ones — so the
    repair has rounds to run in every semiring (maxplus stays acyclic:
    the relation's edges go from lower to higher ids)."""
    n = rel.shape[0]
    live = rel.coords[:rel.nnz].long()
    rel = rel.delete_keys(live[live[:, 1] >= n - 200])
    srn = sr_mod.get(sr_name, lib="np")
    rng = np.random.default_rng(seed)
    init = np.full((b, n), srn.zero, srn.dtype)
    init[np.arange(b), rng.integers(0, 50, b)] = srn.one
    init = torch.from_numpy(init)
    prev, _ = fx.fixpoint(rel, init)
    reached = np.flatnonzero(sr_mod.get(sr_name).live(prev[0]).numpy())
    reached = reached[reached < n - 200]
    add = np.stack([rng.choice(reached, 60), rng.integers(n - 200, n, 60)],
                   1)
    vals = np.ones(len(add), bool) if sr_name == "bool" else \
        rng.integers(1, 5, len(add)).astype(np.float32)
    return rel, init, prev, add, vals


@pytest.mark.parametrize("sr_name", ["bool", "trop", "maxplus"])
@pytest.mark.parametrize("mode", ["jit", "frontier"])
@pytest.mark.parametrize("b", [1, 4])
def test_delta_restart_on_card_matches_cpu(cuda, sr_name, mode, b):
    """Delta-restart on the card equals the CPU run, values and resumed
    rounds.  The staged resume (and the seed over Δ's plan) launch B3
    through ``runs`` only; the worklist's rounds through ``scatter``."""
    from repro_torch.incremental import delta_restart_fixpoint
    rel, init, prev, add, vals = _warm_on(
        _relation(2000, sr_name, seed=7, device="cpu"), sr_name, b, seed=8)
    prev = prev if b > 1 else prev[0]
    delta = SparseRelation.from_coo(add, vals, rel.shape, sr_name,
                                    device="cpu")
    want, wit = delta_restart_fixpoint(rel.apply_delta(add, vals), delta,
                                       prev, mode=mode)
    grel = rel.to(cuda)
    fx.csr_index(grel)
    g2 = grel.apply_delta(add, vals)
    paths0 = dict(coo_segment.segment_reduce_cuda.by_path)
    got, it = delta_restart_fixpoint(g2, delta.to(cuda), prev.to(cuda),
                                     mode=mode)
    paths = _b3_paths_since(paths0)
    assert got.device.type == "cuda"
    assert_match(got, want, sr_name)
    if b > 1:
        assert torch.equal(it.cpu(), wit)
    else:
        assert it == wit
    rounds = int(wit.max()) if b > 1 else wit
    assert rounds > 0
    if mode == "jit" or b > 1:
        assert paths == {"runs": rounds + 1, "scatter": 0}, paths
    else:
        assert paths == {"runs": 1, "scatter": rounds}, paths
        assert fx._csr_lookup(g2).xsrc.shape[0] == len(add)


def test_delta_restart_auto_mode_is_the_staged_loop_on_card(cuda,
                                                           monkeypatch):
    from repro_torch.incremental import delta_restart_fixpoint, restart
    seen = []
    real = restart.fixpoint

    def spy(edges, **kw):
        seen.append(kw["mode"])
        return real(edges, **kw)
    monkeypatch.setattr(restart, "fixpoint", spy)
    rel, init, prev, add, vals = _warm_on(
        _relation(500, "bool", seed=2, device="cpu"), "bool", 1, seed=3)
    rel = rel.to(cuda)
    delta = SparseRelation.from_coo(add, vals, rel.shape, "bool",
                                    device=cuda)
    delta_restart_fixpoint(rel.apply_delta(add, vals), delta,
                           prev[0].numpy())
    assert seen == ["jit"]


def test_delta_restart_refuses_a_warm_answer_off_the_card(cuda):
    """A CUDA answer is never carried to a CPU relation (nor the other
    way for a CUDA Δ): the work would leave the relation's device."""
    from repro_torch.incremental import delta_restart_fixpoint, delta_seed
    rel, init, prev, add, vals = _warm_on(
        _relation(500, "bool", seed=2, device="cpu"), "bool", 1, seed=3)
    delta = SparseRelation.from_coo(add, vals, rel.shape, "bool",
                                    device="cpu")
    with pytest.raises(ValueError, match="for a relation on cpu"):
        delta_seed(delta, prev[0].to(cuda))
    with pytest.raises(ValueError, match="for a relation on cpu"):
        delta_restart_fixpoint(rel.apply_delta(add, vals), delta,
                               prev[0].to(cuda))


@pytest.mark.parametrize("sr_name", ["bool", "trop", "maxplus"])
@pytest.mark.parametrize("b", [1, 3])
def test_maintain_nonmonotone_on_card_matches_cpu(cuda, sr_name, b):
    """The synthesized repair of a delete on the card equals the CPU
    run; its recount ⊕ launches B3 through ``scatter`` (one a row), the
    staged resume through ``runs``."""
    from repro_torch.incremental import maintenance
    rule = maintenance.synthesize_maintenance(sr_name, "delete")
    rel, init, prev, _, _ = _warm_on(
        _relation(2000, sr_name, seed=9, device="cpu"), sr_name, b, seed=10)
    # every in-edge of the 5 reached vertices with the fewest in-edges:
    # their support goes, so the answer moves
    live = rel.coords[:rel.nnz].long()
    sr = sr_mod.get(sr_name)
    reached = sr.live(prev).any(0) & ~sr.live(init).any(0)
    indeg = torch.bincount(live[:, 1], minlength=rel.shape[0])
    pick = torch.nonzero(reached).squeeze(1)
    pick = pick[torch.argsort(indeg[pick], stable=True)[:5]]
    gone = live[torch.isin(live[:, 1], pick)]
    dvals = maintenance._gather_values(rel, gone)
    prev, init = (prev, init) if b > 1 else (prev[0], init[0])
    new = rel.delete_keys(gone)
    want, wit = maintenance.maintain_nonmonotone(new, gone, dvals, prev,
                                                 init, rule)
    grel = rel.to(cuda)
    fx.csr_index(grel)
    fx.csr_index(grel, transpose=True)
    gnew = grel.delete_keys(gone.to(cuda))
    assert torch.equal(maintenance._gather_values(grel, gone.to(cuda)
                                                  ).cpu(), dvals)
    paths0 = dict(coo_segment.segment_reduce_cuda.by_path)
    got, it = maintenance.maintain_nonmonotone(
        gnew, gone.to(cuda), dvals.to(cuda), prev.to(cuda), init.to(cuda),
        rule)
    paths = _b3_paths_since(paths0)
    assert got.device.type == "cuda"
    assert_match(got, want, sr_name)
    assert torch.equal(it.cpu(), wit) if b > 1 else it == wit
    assert 1 <= paths["scatter"] <= b, paths
    assert paths["runs"] == (int(wit.max()) if b > 1 else wit), paths
    assert not torch.equal(want, prev)
    assert_match(got, fx.fixpoint(new, init)[0], sr_name)


@pytest.mark.parametrize("kind", ["bm", "cc"])
@pytest.mark.parametrize("op", ["insert", "delete"])
def test_refresh_program_on_card_picks_the_repair(cuda, kind, op):
    """``refresh_program`` on a CUDA database picks delta_restart for a
    merge and synth_maintenance for a delete, and answers as the same
    refresh on a CPU database."""
    from repro_torch.incremental import DeltaLog, refresh_program
    bench = programs.bm(a=0) if kind == "bm" else programs.cc()
    p = datasets.powerlaw(3000, 4, seed=0)
    dbs = [engine.Database(bench.original.schema, {"id": p.n},
                           {"E": p.sparse_adjacency(device=d),
                            "V": p.vertex_set(device=d)}, d)
           for d in ("cpu", cuda)]
    rng = np.random.default_rng(4)
    log = DeltaLog().insert("E", rng.integers(0, p.n, (50, 2))) \
        if op == "insert" else \
        DeltaLog().delete("E", p.edges[rng.choice(len(p.edges), 50)])
    out = []
    for db in dbs:
        prev, _ = run_program(bench.optimized, db)
        y, db2, rep = refresh_program(bench.optimized, db, prev, log)
        assert y.device.type == db2.device.type == db.device.type
        out.append((y, rep))
    (want, wrep), (got, rep) = out
    assert rep.strategy == wrep.strategy == (
        "delta_restart" if op == "insert" else "synth_maintenance")
    assert_match(got, want, bench.optimized.outputs[-1].body.semiring)
    assert rep.iters == wrep.iters


# --------------------------------------------------------------------------
# B4 ssm_scan, B5 flash_attention and the Zamba2 serving path
# --------------------------------------------------------------------------
#
# B4 and B5 are float kernels that sum in another order than their plain
# versions (B4: time tiles with a carry, serial sub-chunks whose
# aggregates meet in doubling rounds, against a doubling scan over all
# of T; B5: an online softmax over key tiles against one softmax), so
# they are held to max |err| <= 1e-4 · max(1, max |plain|).  B4 is also
# held against ``ref.ssm_scan_blocked`` at the blocking the built kernel
# reports; at that tolerance any correct order passes, so this is a check
# of the same kind as the one against ``ssm_scan_ref``, not of the order.
# That the kernel's blocking is the one the CPU tests give
# ``ssm_scan_blocked`` (``ssm_scan.TILE``, ``GROUPS``) is checked apart.


def assert_float_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= 1e-4 * scale, (err, scale)


#: (B, T, D, kind of a): small and ragged shapes, the stress cases of
#: tests/test_torch_scan.py, xLSTM's prefill and one long prompt at its
#: width, and D not a multiple of 4 (4-byte copies) at both widths the
#: kernel picks (16 and 32 channels a block)
SCAN_CASES = [(2, 1, 8, "half"), (3, 97, 160, "half"), (2, 300, 80, "half"),
              (1, 1000, 33, "half"), (3, 1, 40, "decay"),
              (2, 300, 48, "decay"), (2, 4096, 12, "decay"),
              (2, 4096, 12, "near1"), (2, 517, 20, "zeros"),
              (2, 260, 33, "decay"), (8, 512, 1536, "decay"),
              (1, 8192, 1536, "decay"), (2, 640, 1534, "decay"),
              (8, 300, 1534, "decay")]


@pytest.mark.parametrize("shape,kind", [(c[:3], c[3]) for c in SCAN_CASES])
def test_ssm_scan_kernel_vs_plain(cuda, shape, kind):
    from repro_torch.kernels import ssm_scan
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    if kind == "half":
        a = torch.rand(shape, generator=g, device=cuda) * 0.5 + 0.5
    elif kind == "near1":
        a = (1.0 - torch.rand(shape, generator=g, device=cuda) * 1e-3
             ).clamp(max=1.0 - 2 ** -24)
    else:   # the sigmoid decay the models feed B4
        a = torch.sigmoid(torch.randn(shape, generator=g, device=cuda) + 2)
    if kind == "zeros":
        a[torch.rand(shape, generator=g, device=cuda) < 0.1] = 0.0
    b = torch.randn(shape, generator=g, device=cuda)
    before = ssm_scan.ssm_scan_cuda.launches
    got = ssm_scan.ssm_scan(a, b)
    assert ssm_scan.ssm_scan_cuda.launches == before + 1
    assert_float_close(got, ref.ssm_scan_ref(a, b))
    tile, groups = ssm_scan.blocking()
    assert_float_close(got, ref.ssm_scan_blocked(a, b, tile=tile,
                                                 groups=groups))
    assert_float_close(got, ref.ssm_scan_sequential(a, b))


def test_ssm_scan_kernel_blocking_is_the_cpu_order(cuda):
    """The built kernel's time tile and groups are the ``TILE`` and
    ``GROUPS`` that the CPU tests hold ``ssm_scan_blocked`` to."""
    from repro_torch.kernels import ssm_scan
    assert ssm_scan.blocking() == (ssm_scan.TILE, ssm_scan.GROUPS)


def test_ssm_scan_kernel_takes_unaligned_inputs(cuda):
    """D % 4 == 0 but the tensors start 4 bytes into their storage: the
    kernel must take its 4-byte copies, not 16-byte ones."""
    from repro_torch.kernels import ssm_scan
    shape = (2, 300, 64)
    n = 2 * 300 * 64
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.sigmoid(torch.randn(n + 1, generator=g, device=cuda) + 2)
    b = torch.randn(n + 1, generator=g, device=cuda)
    a, b = a[1:].view(shape), b[1:].view(shape)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    before = ssm_scan.ssm_scan_cuda.launches
    got = ssm_scan.ssm_scan(a, b)
    assert ssm_scan.ssm_scan_cuda.launches == before + 1
    assert_float_close(got, ref.ssm_scan_ref(a, b))


#: (b, tq, tk, hq, hkv, d, causal, window, chunk, q_offset)
FLASH_CASES = {
    "prefill-d80": (2, 128, 128, 4, 4, 80, True, None, None, 0),
    "ragged-d80": (2, 100, 100, 4, 4, 80, True, None, None, 0),
    "full-gqa2-d64": (1, 70, 130, 8, 4, 64, False, None, None, 0),
    "decode-d80": (3, 1, 37, 4, 4, 80, True, None, None, 36),
    "decode-gqa4-d32": (2, 1, 545, 8, 2, 32, True, None, None, 544),
    "window-d80": (1, 200, 200, 4, 2, 80, True, 48, None, 0),
    "chunk-d32": (1, 150, 150, 4, 1, 32, True, None, 64, 0),
    "chunk-full-d128": (1, 90, 90, 2, 2, 128, False, None, 32, 0),
    "offset-prefill-d80": (2, 20, 84, 4, 4, 80, True, None, None, 64),
    "masked-rows-d80": (1, 3, 32, 4, 4, 80, True, 4, None, 60),
    # D not a multiple of 8 (nor of 4: the 4-byte staging branch)
    "prefill-d33": (2, 70, 90, 4, 2, 33, True, None, None, 0),
    "decode-d33": (2, 1, 90, 4, 2, 33, True, None, None, 89),
    # the serving full forward's shape, ragged against the 64-row q tile
    "full-forward-544-d80": (2, 544, 544, 32, 32, 80, True, None, None, 0),
    # serving decode steps at the path's widths
    "decode-serve-513-d80": (8, 1, 513, 32, 32, 80, True, None, None, 512),
    "decode-serve-544-d80": (8, 1, 544, 32, 32, 80, True, None, None, 543),
    # 16 rows (4 queries × GQA 4) in one block; the window hides the
    # second split from query 0 entirely
    "decode-gqa4-window-d64": (1, 4, 600, 16, 4, 64, True, 8, None, 596),
    "decode-chunk-d64": (2, 2, 100, 4, 4, 64, True, None, 16, 98),
    # the other model families' shapes: DeepSeekMoE-16B's D = 128, group
    # 1 prefill; Llama 3's group 16 (one decode row per DECODE_ROWS
    # slot) and Mistral Large's 12; StarCoder2's 4,096 window binding in
    # prefill and decode (group 9); Llama 4's 8,192 chunk crossed (group
    # 5); Whisper's cross-attention (non-causal, Tq != Tk)
    "prefill-g1-d128": (8, 512, 512, 16, 16, 128, True, None, None, 0),
    "decode-g16-d128": (2, 1, 544, 32, 2, 128, True, None, None, 543),
    "decode-g12-d128": (2, 1, 544, 24, 2, 128, True, None, None, 543),
    "window4096-g9-d128": (1, 4600, 4600, 9, 1, 128, True, 4096, None, 0),
    "window4096-decode-g9-d128": (2, 1, 4616, 9, 1, 128, True, 4096, None,
                                  4615),
    "chunk8192-g5-d128": (1, 8320, 8320, 5, 1, 128, True, None, 8192, 0),
    "chunk8192-decode-g5-d128": (1, 1, 8336, 5, 1, 128, True, None, 8192,
                                 8335),
    "cross-prefill-d64": (2, 48, 75, 8, 8, 64, False, None, None, 0),
    "cross-decode-d64": (8, 1, 512, 8, 8, 64, False, None, None, 543),
}


def _flash_inputs(dev, case, b, tq, tk, hq, hkv, d):
    g = torch.Generator(device=dev).manual_seed(len(case))
    return (torch.randn((b, tq, hq, d), generator=g, device=dev),
            torch.randn((b, tk, hkv, d), generator=g, device=dev),
            torch.randn((b, tk, hkv, d), generator=g, device=dev))


def _flash_path(tq, hq, hkv):
    return "decode_split" if tq * (hq // hkv) <= 16 else "prefill_tc"


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_kernel_vs_plain(cuda, case):
    from repro_torch.kernels import flash_attention as fa
    b, tq, tk, hq, hkv, d, causal, window, chunk, q_off = FLASH_CASES[case]
    q, k, v = _flash_inputs(cuda, case, b, tq, tk, hq, hkv, d)
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_off)
    before = fa.flash_attention_cuda.launches
    paths = dict(fa.flash_attention_cuda.by_path)
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.flash_attention_cuda.launches == before + 1
    path = _flash_path(tq, hq, hkv)
    paths[path] += 1
    assert fa.flash_attention_cuda.by_path == paths, case
    want = ref.attention_ref(q, k, v, **kw)
    assert_float_close(got, want)
    if case == "masked-rows-d80":   # rows past Tk + window see no key
        assert torch.equal(got, torch.zeros_like(got))
    if case == "decode-gqa4-window-d64":   # query 0 misses a whole split
        geo = fa.plan_attention(b, tq, tk, hq, hkv, d, **kw)[1]
        lo = fa.visible_keys(tq, tk, **kw)[0]
        assert geo.splits >= 2 and lo + geo.keys_per_split > q_off


@pytest.mark.parametrize("case", ["full-forward-544-d80",
                                  "decode-serve-544-d80"])
def test_flash_attention_is_bitwise_repeatable(cuda, case):
    """No atomics: prefill_tc sums each row in a fixed order, and
    decode_split folds its KV splits in a fixed order."""
    from repro_torch.kernels import flash_attention as fa
    b, tq, tk, hq, hkv, d, causal, window, chunk, q_off = FLASH_CASES[case]
    q, k, v = _flash_inputs(cuda, case, b, tq, tk, hq, hkv, d)
    first = fa.flash_attention(q, k, v, q_offset=q_off)
    for _ in range(2):
        assert torch.equal(fa.flash_attention(q, k, v, q_offset=q_off), first)


@pytest.mark.parametrize("tq", [100, 1])
def test_flash_attention_misaligned_cache_views(cuda, tq):
    """K and V views whose base is 4 bytes past a 16-byte boundary (and
    whose rows are 3 · (D + 1) floats apart) take each path's 4-byte
    staging branch."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(tq)
    ck = torch.randn((2, 130, 3, 81), generator=g, device=cuda)
    cv = torch.randn((2, 130, 3, 81), generator=g, device=cuda)
    k, v = ck[:, :, :, 1:], cv[:, :, :, 1:]
    assert k.data_ptr() % 16 == 4 and k.stride(1) % 4 != 0
    q = torch.randn((2, tq, 3, 80), generator=g, device=cuda)
    kw = dict(q_offset=130 - tq)
    paths = dict(fa.flash_attention_cuda.by_path)
    got = fa.flash_attention(q, k, v, **kw)
    paths[_flash_path(tq, 3, 3)] += 1
    assert fa.flash_attention_cuda.by_path == paths
    assert_float_close(got, ref.attention_ref(q, k.contiguous(),
                                              v.contiguous(), **kw))


@pytest.mark.parametrize("path, change", [
    ("prefill_tc", dict(q_tile=32)),
    ("prefill_tc", dict(grid=(1, 4, 2))),
    ("decode_split", dict(keys_per_split=1)),
    ("decode_split", dict(grid=(1, 2, 2))),
    ("decode_split", dict(scratch=8)),
])
def test_flash_attention_c_side_refuses_a_foreign_geometry(cuda, monkeypatch,
                                                           path, change):
    """The C entries launch the plan's geometry, and raise (through the
    wrapper, RuntimeError) on one they were not built for or that does
    not cover the queries and keys — never leave output unwritten."""
    from repro_torch.kernels import flash_attention as fa
    tq = 100 if path == "prefill_tc" else 1
    q = torch.randn((2, tq, 4, 80), device=cuda)
    k = torch.randn((2, 100, 4, 80), device=cuda)
    plan = fa.plan_attention

    def bent(*args, **kw):
        got, geo = plan(*args, **kw)
        assert got == path
        return got, geo._replace(**change)
    monkeypatch.setattr(fa, "plan_attention", bent)
    before = fa.flash_attention_cuda.launches
    with pytest.raises(RuntimeError, match=path):
        fa.flash_attention(q, k, k, q_offset=100 - tq)
    assert fa.flash_attention_cuda.launches == before


def test_flash_attention_kernel_reads_strided_cache_views(cuda):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(1)
    ck = torch.randn((2, 64, 4, 80), generator=g, device=cuda)
    cv = torch.randn((2, 64, 4, 80), generator=g, device=cuda)
    q = torch.randn((2, 1, 4, 80), generator=g, device=cuda)
    k, v = ck[:, :41], cv[:, :41]
    assert not k.is_contiguous()
    got = fa.flash_attention(q, k, v, q_offset=40)
    assert_float_close(got, ref.attention_ref(q, k.contiguous(),
                                              v.contiguous(), q_offset=40))


def test_scan_and_attention_wrappers_reject_what_kernels_do_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan
    x = torch.ones(2, 4, 8, device=cuda)
    with pytest.raises(TypeError):
        ssm_scan.ssm_scan(x.double(), x.double())
    with pytest.raises(ValueError):
        ssm_scan.ssm_scan(x.transpose(0, 1), x.transpose(0, 1))
    # a head past 256 is taken (wide_chunk, the plain version's answer);
    # a head of 0 is not
    q = torch.randn(1, 2, 2, 264, device=cuda)
    before = fa.flash_attention_cuda.by_path["wide_chunk"]
    assert_float_close(fa.flash_attention(q, q, q),
                       ref.attention_ref(q, q, q))
    assert fa.flash_attention_cuda.by_path["wide_chunk"] == before + 1
    with pytest.raises(ValueError, match="head dim"):
        fa.plan_attention(1, 2, 2, 2, 2, 0)
    q = torch.ones(1, 2, 3, 8, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    kv = torch.ones(1, 2, 8, 3, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, kv, kv)


def test_serve_batch_on_card_matches_cpu(cuda):
    """Zamba2 smoke serving on the card (B4 in prefill, B5 in every
    shared-attention application) against the same weights on the CPU:
    equal tokens, close logits, and the kernels' launch counts."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    arch = "zamba2-2.7b"
    cfg = configs.get(arch, smoke=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, n) for n in (7, 20, 13)]
    runs = {}
    for dev, p in (("cpu", params), (cuda, on_card)):
        reqs = [serve.Request(pr, max_new=6) for pr in prompts]
        ops.reset_launch_counts()
        stats = serve.serve_batch(arch, reqs, t_max=32, device=dev, params=p)
        runs[str(dev)] = (np.array([r.out for r in reqs]),
                          stats["last_logits"], ops.launch_counts())
    cpu_tok, cpu_logits, cpu_counts = runs["cpu"]
    tok, logits, counts = runs["cuda"]
    assert all(v == 0 for v in cpu_counts.values())
    n_seg = cfg.n_layers // cfg.hybrid_attn_every
    assert counts["ssm_scan"] == cfg.n_layers          # one prefill
    assert counts["flash_attention"] == n_seg * (1 + 6)
    assert np.array_equal(tok, cpu_tok)
    assert_float_close(logits.cpu(), cpu_logits)


#: the families beside Zamba2, at their smoke sizes
FAMILY_ARCHS = ("deepseek-moe-16b", "llama3-405b",
                "llama4-maverick-400b-a17b", "llava-next-mistral-7b",
                "minicpm-2b", "mistral-large-123b", "starcoder2-7b",
                "whisper-base", "xlstm-125m")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_serving_on_card_matches_cpu(cuda, arch):
    """Each family's smoke serving on the card against the same weights
    on the CPU: equal tokens, close logits, and B4/B5 launched once a
    recurrent layer (prefill) and once an attention a forward.  A 70-token
    prompt makes StarCoder2's window and Llama 4's chunk (64) bind."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = configs.get(arch, smoke=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, n) for n in (7, 70, 13)]
    runs = {}
    for dev, p in (("cpu", params), (cuda, on_card)):
        reqs = [serve.Request(pr, max_new=6) for pr in prompts]
        ops.reset_launch_counts()
        stats = serve.serve_batch(arch, reqs, t_max=80, device=dev, params=p)
        runs[str(dev)] = (np.array([r.out for r in reqs]),
                          stats["last_logits"], ops.launch_counts())
    cpu_tok, cpu_logits, cpu_counts = runs["cpu"]
    tok, logits, counts = runs["cuda"]
    assert all(v == 0 for v in cpu_counts.values())
    if cfg.family == "ssm":
        want = {"ssm_scan": cfg.n_layers, "flash_attention": 0}
    elif cfg.family == "encdec":   # encoder; decoder self and cross
        want = {"ssm_scan": 0, "flash_attention": cfg.encoder_layers
                + 2 * cfg.n_layers * (1 + 6)}
    else:
        want = {"ssm_scan": 0, "flash_attention": cfg.n_layers * (1 + 6)}
    assert {k: counts[k] for k in want} == want
    assert np.array_equal(tok, cpu_tok)
    assert_float_close(logits.cpu(), cpu_logits)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# training on the card: B4's and B5's gradients, the train step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 37, 1536), (2, 1, 40), (1, 300, 33),
                                   (4, 256, 1536)])
def test_scan_fn_on_card_vs_plain_autograd(cuda, shape):
    """``ScanFn`` on CUDA tensors: forward and backward are B4 (one
    launch each), the gradients those of autograd through the plain scan
    on the same tensors."""
    from repro_torch.kernels import ops, ssm_scan
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    a = torch.sigmoid(torch.randn(shape, generator=g, device=cuda) + 2)
    b = torch.randn(shape, generator=g, device=cuda)
    gh = torch.randn(shape, generator=g, device=cuda)
    a, b = a.requires_grad_(True), b.requires_grad_(True)
    before = ssm_scan.ssm_scan_cuda.launches
    h = ops.ssm_scan(a, b)
    assert ssm_scan.ssm_scan_cuda.launches == before + 1
    da, db = torch.autograd.grad(h, (a, b), gh)
    assert ssm_scan.ssm_scan_cuda.launches == before + 2
    hp = ref.ssm_scan_ref(a, b)
    want = torch.autograd.grad(hp, (a, b), gh, allow_unused=True,
                               materialize_grads=True)
    assert_float_close(h.detach(), hp.detach())
    for got, w in zip((da, db), want):
        assert got.is_cuda
        assert_float_close(got, w)


def test_scan_fn_on_card_never_takes_the_plain_version(cuda, monkeypatch):
    from repro_torch.kernels import ops, ssm_scan

    def refuse(a, b):
        raise AssertionError("plain scan called on the card")
    monkeypatch.setattr(ssm_scan, "ssm_scan_plain", refuse)
    a = torch.full((2, 20, 8), 0.5, device=cuda, requires_grad=True)
    b = torch.ones((2, 20, 8), device=cuda, requires_grad=True)
    ops.ssm_scan(a, b).sum().backward()
    assert a.grad.is_cuda and b.grad.is_cuda


def test_serving_on_card_makes_one_scan_launch_a_layer_and_no_backward(
        cuda):
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = configs.get("xlstm-125m", smoke=True)
    reqs = [serve.Request(np.arange(1, 9), max_new=4) for _ in range(2)]
    ops.reset_launch_counts()
    serve.serve_batch("xlstm-125m", reqs, t_max=16, device=cuda)
    assert ops.launch_counts()["ssm_scan"] == cfg.n_layers


#: B5's backward cases: (b, tq, tk, hq, hkv, d, causal, window, chunk,
#: q_offset).  Every mask, Tq != Tk, groups 1 to 16, D not a multiple of
#: 8 and at the largest tile, rows that see no key, and short sequences
#: whose forward takes decode_split (tq · group <= 16), whose lse comes
#: from its fold
BWD_CASES = {
    "causal-d80": (2, 130, 130, 4, 4, 80, True, None, None, 0),
    "full-d64": (2, 70, 70, 4, 4, 64, False, None, None, 0),
    "cross-d64": (2, 48, 75, 8, 8, 64, False, None, None, 0),
    # windows and chunks whose edges fall inside the 64-row tiles
    "window-g2-d80": (1, 200, 200, 4, 2, 80, True, 48, None, 0),
    "window-g9-d128": (1, 300, 300, 9, 1, 128, True, 100, None, 0),
    "chunk-d32": (1, 150, 150, 4, 1, 32, True, None, 40, 0),
    "chunk-g5-d128": (1, 200, 200, 5, 1, 128, True, None, 96, 0),
    "global-g5-d128": (1, 200, 200, 5, 1, 128, True, None, None, 0),
    "chunk-full-d128": (1, 90, 90, 2, 2, 128, False, None, 32, 0),
    "offset-d80": (2, 20, 84, 4, 4, 80, True, None, None, 64),
    "g4-d64": (2, 100, 100, 8, 2, 64, True, None, None, 0),
    "g16-d128": (1, 70, 70, 16, 1, 128, True, None, None, 0),
    "d33": (2, 70, 90, 4, 2, 33, True, None, None, 0),
    "masked-rows-d80": (1, 3, 32, 4, 4, 80, True, 4, None, 60),
    "decode-path-d64": (2, 4, 4, 4, 1, 64, True, None, None, 0),
    "decode-path-offset-d32": (3, 2, 40, 8, 4, 32, True, 8, None, 38),
    # the tensor-core kernels' tile edges: Tq and Tk not multiples of 16,
    # 32 or 64; D of 1, 8, 96 and 112 padded to 8·NT; a group of 8 at
    # D = 128 (32-row q tiles); window and chunk edges inside a warp's 16
    # keys
    "ragged-causal-d64": (2, 93, 93, 4, 2, 64, True, None, None, 0),
    "ragged-cross-d80": (1, 75, 101, 4, 4, 80, False, None, None, 0),
    "ragged-offset-d32": (2, 45, 83, 4, 1, 32, True, None, None, 38),
    "d1": (2, 50, 50, 4, 2, 1, True, None, None, 0),
    "d8": (1, 45, 45, 4, 4, 8, True, None, None, 0),
    "d96": (1, 100, 100, 4, 2, 96, True, None, None, 0),
    "d112": (1, 70, 70, 4, 4, 112, True, 30, None, 0),
    "g8-d128": (1, 100, 100, 8, 1, 128, True, None, None, 0),
    "window-edge-d64": (1, 130, 130, 4, 4, 64, True, 21, None, 0),
    "chunk-edge-d80": (1, 130, 130, 4, 2, 80, True, None, 24, 0),
}


def _bwd_inputs(dev, case, b, tq, tk, hq, hkv, d):
    q, k, v = _flash_inputs(dev, case, b, tq, tk, hq, hkv, d)
    g = torch.Generator(device=dev).manual_seed(len(case) + 1)
    return q, k, v, torch.randn(q.shape, generator=g, device=dev)


def assert_grad_close(got, want):
    """A gradient within 1e-4 of the largest entry of the plain one."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), (err, want.abs().max())


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_attention_backward_kernels_vs_plain(cuda, case):
    """``AttnFn`` on CUDA tensors: one forward launch (writing lse), one
    backward (its three kernels once each); the output, lse and the
    gradients against the plain forward, ``attention_lse_ref``,
    ``attention_backward_ref`` and autograd through ``attention_ref``
    on the same tensors."""
    from repro_torch.kernels import flash_attention as fa, ops
    b, tq, tk, hq, hkv, d, causal, window, chunk, q_off = BWD_CASES[case]
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_off)
    q, k, v, do = _bwd_inputs(cuda, case, b, tq, tk, hq, hkv, d)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fwd, bwd = fa.flash_attention_cuda.launches, \
        fa.attention_backward_cuda.launches
    kernels = dict(fa.attention_backward_cuda.by_kernel)
    o = ops.flash_attention(*leaves, **kw)
    assert type(o.grad_fn).__name__ == "AttnFnBackward"
    grads = torch.autograd.grad(o, leaves, do)
    assert fa.flash_attention_cuda.launches == fwd + 1
    assert fa.attention_backward_cuda.launches == bwd + 1
    assert fa.attention_backward_cuda.by_kernel == {
        n: c + 1 for n, c in kernels.items()}
    o_ref = ref.attention_ref(q, k, v, **kw)
    assert_float_close(o.detach(), o_ref)
    _, lse = fa.flash_attention_lse(q, k, v, **kw)
    lse_ref = ref.attention_lse_ref(q, k, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    fin = torch.isfinite(lse_ref)
    assert_float_close(lse[fin], lse_ref[fin])
    plain = ref.attention_backward_ref(q, k, v, o_ref, lse_ref, do, **kw)
    want = torch.autograd.grad(ref.attention_ref(*leaves, **kw), leaves, do,
                               allow_unused=True, materialize_grads=True)
    for got, p, w in zip(grads, plain, want):
        assert got.is_cuda
        assert_grad_close(got, p)
        assert_grad_close(got, w)
    if case == "masked-rows-d80":   # rows past Tk + window see no key
        assert torch.isinf(lse).all()
        assert not grads[0].any() and not grads[1].any()


@pytest.mark.parametrize("case", ["causal-d80", "window-g9-d128",
                                  "decode-path-d64", "g8-d128",
                                  "window-edge-d64"])
def test_attention_backward_is_bitwise_repeatable(cuda, case):
    """No atomics and a fixed loop order: two backward calls give the
    same bits; the forward's output is the same bits with and without
    lse."""
    from repro_torch.kernels import flash_attention as fa
    b, tq, tk, hq, hkv, d, causal, window, chunk, q_off = BWD_CASES[case]
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_off)
    q, k, v, do = _bwd_inputs(cuda, case, b, tq, tk, hq, hkv, d)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))
    first = fa.attention_backward(q, k, v, o, lse, do, **kw)
    for _ in range(2):
        again = fa.attention_backward(q, k, v, o, lse, do, **kw)
        assert all(torch.equal(x, y) for x, y in zip(again, first))


#: B5's wide routes, wide_simt for 128 < D ≤ 256 and wide_chunk past it:
#: (B, Tq, Tk, Hq, Hkv, D, causal, window, chunk, q_offset).  Prefill and
#: decode, every mask, GQA groups 1 to 3, a q_offset, rows that are not a
#: multiple of a block's 16, head dims past 256 that are and are not a
#: multiple of wide_chunk's 256 columns
WIDE_CASES = {
    "prefill-causal-gqa2-d256": (2, 100, 100, 4, 2, 256, True, None, None,
                                 0),
    "prefill-unmasked-d136": (2, 70, 70, 4, 4, 136, False, None, None, 0),
    "window-gqa3-d200": (1, 130, 130, 6, 2, 200, True, 33, None, 0),
    "chunk-d256": (1, 130, 130, 4, 4, 256, True, None, 48, 0),
    "decode-gqa2-d256": (3, 1, 77, 8, 4, 256, True, None, None, 76),
    "decode-window-d136": (2, 1, 90, 4, 2, 136, True, 40, None, 89),
    "q-offset-d200": (2, 9, 60, 4, 2, 200, True, None, None, 51),
    "odd-window-d200": (2, 37, 53, 6, 2, 200, True, 20, None, 16),
    "prefill-causal-gqa2-d320": (2, 100, 100, 4, 2, 320, True, None, None,
                                 0),
    "chunk-d512": (1, 130, 130, 4, 4, 512, True, None, 48, 0),
    "decode-gqa2-d576": (3, 1, 77, 8, 4, 576, True, None, None, 76),
    "odd-window-d576": (2, 37, 53, 6, 2, 576, True, 20, None, 16),
}


def _wide_path(d: int) -> str:
    return "wide_simt" if d <= 256 else "wide_chunk"


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_attention_forward_vs_plain(cuda, case):
    """One ``wide_simt`` (``wide_chunk`` past 256) launch a call; the
    output and, on request, each row's log-sum-exp against the plain
    versions; the output the same bits with and without lse, and from
    call to call."""
    from repro_torch.kernels import flash_attention as fa
    b, tq, tk, hq, hkv, d, causal, window, chunk, q_off = WIDE_CASES[case]
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_off)
    q, k, v = _flash_inputs(cuda, case, b, tq, tk, hq, hkv, d)
    paths = dict(fa.flash_attention_cuda.by_path)
    got = fa.flash_attention(q, k, v, **kw)
    paths[_wide_path(d)] += 1
    assert fa.flash_attention_cuda.by_path == paths
    assert_float_close(got, ref.attention_ref(q, k, v, **kw))
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    lse_ref = ref.attention_lse_ref(q, k, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    fin = torch.isfinite(lse_ref)
    assert_float_close(lse[fin], lse_ref[fin])
    assert torch.equal(o, got)
    assert torch.equal(fa.flash_attention(q, k, v, **kw), got)


@pytest.mark.parametrize("d", [136, 200, 256, 320, 576])
@pytest.mark.parametrize("misaligned", [False, True])
def test_wide_attention_reads_strided_cache_views(cuda, d, misaligned):
    """A decode step and a 20-query chunk over the written prefix of a
    96-slot cache, as views; misaligned (base 4 bytes past a 16-byte
    boundary, rows D + 1 floats apart) they take the 4-byte staging."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(d)
    w = d + 1 if misaligned else d
    ck = torch.randn((2, 96, 2, w), generator=g, device=cuda)
    cv = torch.randn((2, 96, 2, w), generator=g, device=cuda)
    k, v = (c[:, :61, :, w - d:] for c in (ck, cv))
    assert not k.is_contiguous()
    assert (k.data_ptr() % 16 != 0) == misaligned
    for tq in (1, 20):
        q = torch.randn((2, tq, 4, d), generator=g, device=cuda)
        kw = dict(q_offset=61 - tq)
        paths = dict(fa.flash_attention_cuda.by_path)
        got = fa.flash_attention(q, k, v, **kw)
        paths[_wide_path(d)] += 1
        assert fa.flash_attention_cuda.by_path == paths
        assert_float_close(got, ref.attention_ref(
            q, k.contiguous(), v.contiguous(), **kw))


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_attention_backward_vs_plain(cuda, case):
    """``AttnFn`` at D > 128: one forward launch through ``wide_simt``
    (``wide_chunk`` past 256), one backward through the same route
    (rowdot, dkdv, dq once each);
    the gradients against ``attention_backward_ref`` and autograd
    through ``attention_ref``; two backward calls bit for bit equal."""
    from repro_torch.kernels import flash_attention as fa, ops
    b, tq, tk, hq, hkv, d, causal, window, chunk, q_off = WIDE_CASES[case]
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_off)
    q, k, v, do = _bwd_inputs(cuda, case, b, tq, tk, hq, hkv, d)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    paths = dict(fa.flash_attention_cuda.by_path)
    bwd = dict(fa.attention_backward_cuda.by_path)
    kernels = dict(fa.attention_backward_cuda.by_kernel)
    o = ops.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(o, leaves, do)
    paths[_wide_path(d)] += 1
    bwd[_wide_path(d)] += 1
    assert fa.flash_attention_cuda.by_path == paths
    assert fa.attention_backward_cuda.by_path == bwd
    assert fa.attention_backward_cuda.by_kernel == {
        n: c + 1 for n, c in kernels.items()}
    o_ref = ref.attention_ref(q, k, v, **kw)
    lse_ref = ref.attention_lse_ref(q, k, **kw)
    plain = ref.attention_backward_ref(q, k, v, o_ref, lse_ref, do, **kw)
    want = torch.autograd.grad(ref.attention_ref(*leaves, **kw), leaves, do,
                               allow_unused=True, materialize_grads=True)
    for got, p, w in zip(grads, plain, want):
        assert got.is_cuda
        assert_grad_close(got, p)
        assert_grad_close(got, w)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    first = fa.attention_backward(q, k, v, o, lse, do, **kw)
    again = fa.attention_backward(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(again, first))


def test_attention_backward_on_card_never_takes_the_plain_version(
        cuda, monkeypatch):
    from repro_torch.kernels import flash_attention as fa, ops

    def refuse(*a, **k):
        raise AssertionError("plain attention called on the card")
    for name in ("flash_attention_plain", "attention_lse_plain",
                 "attention_backward_plain"):
        monkeypatch.setattr(fa, name, refuse)
    q = torch.randn(2, 40, 4, 32, device=cuda, requires_grad=True)
    k = torch.randn(2, 40, 2, 32, device=cuda, requires_grad=True)
    v = torch.randn(2, 40, 2, 32, device=cuda, requires_grad=True)
    ops.flash_attention(q, k, v, window=16).square().sum().backward()
    assert q.grad.is_cuda and k.grad.is_cuda and v.grad.is_cuda


def test_attention_backward_wrapper_rejects_what_kernels_do_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn(1, 8, 2, 16, device=cuda)
    o, lse = fa.flash_attention_lse(q, q, q)
    with pytest.raises(TypeError):
        fa.attention_backward(q.double(), q, q, o, lse, o)
    with pytest.raises(ValueError, match="contiguous"):
        fa.attention_backward(q, q, q, o, lse, o.transpose(1, 2)
                              .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        fa.attention_backward(q, q, q, o, lse[:, :, :4], o)
    with pytest.raises(ValueError, match="CUDA"):
        fa.attention_backward_cuda(q.cpu(), q, q, o, lse, o)


def test_serving_on_card_records_no_attention_graph(cuda):
    """Serving runs under no_grad with frozen weights: B5 forward only,
    no backward, no lse."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    reqs = [serve.Request(np.arange(1, 9), max_new=3)]
    ops.reset_launch_counts()
    serve.serve_batch("minicpm-2b", reqs, t_max=16, device=cuda)
    counts = ops.launch_counts()
    assert len(reqs[0].out) == 3 and counts["flash_attention"] > 0
    assert counts["flash_attention_backward"] == 0


def _attention_calls(cfg):
    """B5 calls of one full forward of ``cfg``."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    if cfg.family == "encdec":     # encoder self; decoder self + cross
        return cfg.encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b", "minicpm-2b",
                                  "deepseek-moe-16b", "whisper-base"])
def test_smoke_train_on_card_matches_cpu(cuda, arch):
    """Two smoke train steps on the card (B4 forward and backward, B5
    forward and backward) and on the CPU from the same weights and
    batches: equal losses and grad norms within 1e-4, B4 launched 2 ·
    n_layers a step (recurrent layers), B5 one forward and one backward
    per attention a step.  xLSTM's card steps run free.  Before an
    attention family's second card step, the entries whose first CPU
    gradient is nonzero but below 1e-4 of its leaf's largest (the CPU
    train tests' mask: their sign is rounding, and AdamW moves them a
    full lr either way) take the CPU's weights and AdamW moments; every
    other entry runs free (as ``chip_smoke.py``'s ``masked`` run)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.train import data_config
    from repro_torch.data import synthetic_stream
    from repro_torch.models import transformer as T
    from repro_torch.optimizer import OptConfig, cosine_schedule
    cfg = configs.get(arch, smoke=True)
    base = T.init_params(cfg, seed=0, device="cpu")
    it = synthetic_stream(data_config(cfg, batch=4, seq=64, seed=0))
    batches = [next(it) for _ in range(2)]
    runs, starts, unknown = {}, [], []
    for dev in ("cpu", cuda):
        params = _copy_to(base, dev)    # each run updates its own copy
        for p in _leaves_of(params):
            p.requires_grad_(True)
        step, init = steps.make_train_step(
            cfg, OptConfig(lr=cosine_schedule(3e-3, 2, 10)), remat="none")
        state = init(params)
        ops.reset_launch_counts()
        out = []
        for i, b in enumerate(batches):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            leaves = list(_leaves_of(params))
            now = leaves + list(_leaves_of(state["m"])) \
                + list(_leaves_of(state["v"]))
            if dev == "cpu":
                starts.append([x.detach().clone() for x in now])
                if i == 0:
                    gs = torch.autograd.grad(
                        T.loss_fn(params, cfg, batch)[0], leaves,
                        allow_unused=True, materialize_grads=True)
                    unknown = [(g != 0) & (g.abs() < 1e-4 * g.abs().max())
                               for g in gs] * 3
            elif i and arch != "xlstm-125m":
                with torch.no_grad():
                    for x, y, u in zip(now, starts[i], unknown):
                        x[u.to(dev)] = y.to(dev)[u.to(dev)]
            params, state, m = step(params, state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs[str(dev)] = (out, ops.launch_counts())
    assert not any(runs["cpu"][1].values())
    recurrent = {"ssm": cfg.n_layers, "hybrid": cfg.n_layers}.get(
        cfg.family, 0)
    attn = _attention_calls(cfg)
    assert runs["cuda"][1] == {
        **dict.fromkeys(runs["cuda"][1], 0), "ssm_scan": 2 * 2 * recurrent,
        "flash_attention": 2 * attn, "flash_attention_backward": 2 * attn}
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch, remat", [("xlstm-125m", "none"),
                                         ("zamba2-2.7b", "full"),
                                         ("starcoder2-7b", "selective")])
def test_train_entry_point_on_card(cuda, arch, remat):
    from repro_torch.launch import train
    history = []
    _, losses = train.train(arch, steps=2, batch=2, seq=32, remat=remat,
                            device=cuda, history=history)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert all(np.isfinite(h["grad_norm"]) for h in history)


# --------------------------------------------------------------------------
# half types in B4 and B5; checkpoints and resume on the card
# --------------------------------------------------------------------------

HALF_TYPES = [torch.bfloat16, torch.float16]


def assert_half_close(got, want, units=1):
    """``got`` within ``units`` ulps of its type at the largest entry of
    ``want``, the plain f32 result cast to that type: the kernel and the
    plain version sum in f32 in other orders, then both round."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    eps = torch.finfo(got.dtype).eps
    err = float((got.float() - want.float()).abs().max())
    assert err <= units * eps * max(1.0, float(want.float().abs().max())), \
        err


@pytest.mark.parametrize("dtype", HALF_TYPES)
def test_scan_on_card_takes_half_types(cuda, dtype):
    """B4 forward and backward (``ScanFn``) on bf16/f16 inputs: one
    launch each, on the f32 cast; output and gradients in the input's
    type against autograd through the plain f32 scan on the upcast
    inputs, cast to that type."""
    from repro_torch.kernels import ops, ssm_scan
    g = torch.Generator(device=cuda).manual_seed(7)
    shape = (2, 300, 1536)
    a = torch.sigmoid(torch.randn(shape, generator=g, device=cuda) + 2)
    b = torch.randn(shape, generator=g, device=cuda)
    gh = torch.randn(shape, generator=g, device=cuda)
    leaves = [x.to(dtype).requires_grad_(True) for x in (a, b)]
    before = ssm_scan.ssm_scan_cuda.launches
    h = ops.ssm_scan(*leaves)
    assert ssm_scan.ssm_scan_cuda.launches == before + 1
    grads = torch.autograd.grad(h, leaves, gh.to(dtype))
    assert ssm_scan.ssm_scan_cuda.launches == before + 2
    f32 = [x.detach().float().requires_grad_(True) for x in leaves]
    hp = ref.ssm_scan_ref(*f32)
    want = torch.autograd.grad(hp, f32, gh.to(dtype).float())
    assert_half_close(h.detach(), hp.detach().to(dtype))
    for got, w in zip(grads, want):
        assert got.is_cuda
        assert_half_close(got, w.to(dtype), units=2)


@pytest.mark.parametrize("dtype", HALF_TYPES)
@pytest.mark.parametrize("case", ["causal-d80", "window-g9-d128",
                                  "decode-path-d64"])
def test_attention_on_card_takes_half_types(cuda, case, dtype):
    """B5 forward (writing lse) and backward (``AttnFn``) on bf16/f16:
    one launch each, on the f32 cast; the output and the gradients in
    the input's type against the plain f32 versions on the upcast
    inputs, cast to that type."""
    from repro_torch.kernels import flash_attention as fa, ops
    b, tq, tk, hq, hkv, d, causal, window, chunk, q_off = BWD_CASES[case]
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_off)
    q, k, v, do = (x.to(dtype) for x in
                   _bwd_inputs(cuda, case, b, tq, tk, hq, hkv, d))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fwd, bwd = fa.flash_attention_cuda.launches, \
        fa.attention_backward_cuda.launches
    o = ops.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(o, leaves, do)
    assert fa.flash_attention_cuda.launches == fwd + 1
    assert fa.attention_backward_cuda.launches == bwd + 1
    f32 = [x.float() for x in (q, k, v)]
    o_ref = ref.attention_ref(*f32, **kw)
    lse_ref = ref.attention_lse_ref(*f32[:2], **kw)
    assert_half_close(o.detach(), o_ref.to(dtype))
    plain = ref.attention_backward_ref(*f32, o_ref, lse_ref, do.float(),
                                       **kw)
    for got, p in zip(grads, plain):
        assert got.is_cuda
        assert_half_close(got, p.to(dtype), units=2)


def test_checkpoint_round_trip_of_card_tensors(cuda, tmp_path):
    """bf16 and f32 CUDA leaves and an int step through
    ``CheckpointManager``: the async save is a snapshot (the leaves are
    updated in place before the write ends), the restore lands on the
    card in each target's dtype, bit for bit, and an in-place restore
    allocates nothing there."""
    from repro_torch import checkpoint as ck
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"params": {"w": torch.randn(512, 256, generator=g, device=cuda)
                       .to(torch.bfloat16),
                       "b": torch.randn(256, generator=g, device=cuda)},
            "opt": {"step": 3}}
    saved = {k: v.clone() for k, v in tree["params"].items()}
    mgr = ck.CheckpointManager(str(tmp_path), every=1)
    mgr.maybe_save(3, tree)
    with torch.no_grad():
        for x in tree["params"].values():
            x.add_(1)
    mgr.wait()
    like = {"params": {k: torch.zeros_like(v) for k, v in saved.items()},
            "opt": {"step": 0}}
    out, step = mgr.restore_latest(like)
    assert step == 3 and out["opt"]["step"] == 3
    for k, v in saved.items():
        got = out["params"][k]
        assert got.is_cuda and got.dtype == v.dtype
        assert torch.equal(got, v)
    # in place, as train restores: into the target's own tensors, with
    # nothing allocated on the card
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out, step = mgr.restore_latest(like, inplace=True)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() == before
    assert out is like and step == 3 and like["opt"]["step"] == 3
    for k, v in saved.items():
        assert torch.equal(like["params"][k], v)


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b"])
def test_resumed_train_on_card_equals_uninterrupted(cuda, tmp_path, arch):
    """28 steps saving at 25 and 28, and a resume from 25 alone: the
    resumed losses, parameters, moments and step equal the first run's,
    bit for bit (B4 and, for Zamba2, B5 on the resume path)."""
    import os
    import shutil
    from repro_torch import checkpoint as ck
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.optimizer import optimizers as opt
    kw = dict(steps=28, batch=2, seq=64, device=cuda, log_every=100)
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    params_a, losses_a = train.train(arch, ckpt_dir=a_dir, **kw)
    os.makedirs(b_dir)
    shutil.copytree(os.path.join(a_dir, "step_25"),
                    os.path.join(b_dir, "step_25"))
    params_b, losses_b = train.train(arch, ckpt_dir=b_dir, **kw)
    assert losses_b == losses_a[25:]
    for x, y in zip(opt.tree_leaves(params_b), opt.tree_leaves(params_a)):
        assert x.is_cuda and x.requires_grad and torch.equal(x, y)
    params = T.init_params(configs.get(arch, smoke=True), 1, device="cpu")
    like = {"params": params, "opt": opt.adamw_init(params)}
    got = ck.load_checkpoint(b_dir, 28, like)
    want = ck.load_checkpoint(a_dir, 28, like)
    assert got["opt"]["step"] == want["opt"]["step"] == 28
    for x, y in zip(opt.tree_leaves(got), opt.tree_leaves(want)):
        if isinstance(y, torch.Tensor):
            assert torch.equal(x, y)


def _copy_to(tree, dev):
    return {k: _copy_to(v, dev) if isinstance(v, dict) else
            v.to(dev, copy=True) for k, v in tree.items()}


def _leaves_of(tree):
    for v in tree.values():
        yield from (_leaves_of(v) if isinstance(v, dict) else (v,))


# --------------------------------------------------------------------------
# Datalog° serving on the card
# --------------------------------------------------------------------------


def _serve_families(dev, kind, n=3000):
    """BM over powerlaw(n, 4) or SSSP over its weighted (1–4) COO
    override, on ``dev``: (make_program, db, edges)."""
    g = datasets.powerlaw(n, 4, seed=1)
    if kind == "bm":
        return ((lambda a: programs.bm(a=a).optimized),
                programs.bm(a=0).make_db(g, device=dev)
                .with_storage("E", "sparse"), None)
    w = np.random.default_rng(3).integers(1, 5, len(g.edges))
    gw = datasets.Graph(g.n, g.edges, w)
    db = engine.Database(programs.sssp(a=0, wmax=4, dmax=64).original.schema,
                         {"id": n, "w": 4, "d": 64}, {}, dev)
    return ((lambda a: programs.sssp(a=a, wmax=4, dmax=64).optimized), db,
            gw.sparse_adjacency(semiring="trop", device=dev))


def _serve_stream(server, kind, mk, db, edges, sources):
    server.register(kind, mk, db, edges=edges)
    reqs = [server.submit(kind, int(s)) for s in sources]
    server.run_until_idle()
    assert all(r.error is None for r in reqs)
    return reqs


@pytest.mark.parametrize("kind", ["bm", "sssp"])
@pytest.mark.parametrize("server", ["continuous", "fifo"])
def test_serve_on_card_matches_cpu(cuda, kind, server):
    """Both servers on the card (pools of TorchChunkStepper over B1, or
    packed B1 runs) give the CPU port's answers and counts, bit for
    bit; B1 launched through the semiring's path."""
    from repro_torch.launch.datalog_serve import DatalogServer
    from repro_torch.serve import ContinuousServer, TorchChunkStepper
    sources = np.random.default_rng(5).integers(0, 3000, 40)

    def make():
        if server == "fifo":
            return DatalogServer(max_batch=16, warm_answers=0)
        return ContinuousServer(max_batch=16, chunk_iters=3,
                                warm_answers=0, host_kernels=False)
    cpu = _serve_stream(make(), kind, *_serve_families("cpu", kind), sources)
    launches0 = coo_spmm.spmm_cuda.launches
    paths0 = dict(coo_spmm.spmm_cuda.by_path)
    srv = make()
    card = _serve_stream(srv, kind, *_serve_families(cuda, kind), sources)
    n = coo_spmm.spmm_cuda.launches - launches0
    path = "words_bool" if kind == "bm" else "lanes_f32"
    assert n > 0
    assert coo_spmm.spmm_cuda.by_path[path] - paths0[path] == n
    for c, g in zip(cpu, card):
        assert g.result.device.type == "cuda"
        assert torch.equal(g.result.cpu(), c.result) and g.iters == c.iters
    if server == "continuous":
        assert isinstance(srv._families[kind].pool.stepper,
                          TorchChunkStepper)
        assert srv.stats()["latency_routed"] == 0
    else:
        assert srv.stats["latency_routed"] == 0


@pytest.mark.parametrize("kind", ["bm", "sssp"])
def test_serve_cuda_family_never_gets_a_host_stepper(cuda, kind):
    """host_kernels=True asks for the bitset / level-sync host steppers;
    a family on the card gets TorchChunkStepper all the same, and the
    host steppers refuse a CUDA operator outright."""
    from repro_torch.serve import ContinuousServer, slots
    mk, db, edges = _serve_families(cuda, kind)
    cs = ContinuousServer(max_batch=8, host_kernels=True)
    _serve_stream(cs, kind, mk, db, edges, range(5))
    fam = cs._families[kind].fam
    st = slots.build_stepper(fam, 8, host_kernels=True,
                             chunk_fn_factory=lambda: None)
    assert isinstance(st, slots.TorchChunkStepper)
    host = (slots.BitsetBoolStepper if kind == "bm"
            else slots.LevelSyncTropStepper)
    with pytest.raises(ValueError, match="host kernel"):
        host(fam.edges, fam.n, 8)


def test_fused_backend_refuses_cuda(cuda):
    """"fused" is the CPU host loop, never a way around B1."""
    rel = datasets.powerlaw(500, 4, seed=1).sparse_adjacency(device=cuda)
    init = torch.zeros(2, 500, dtype=torch.bool, device=cuda)
    init[:, 0] = True
    with pytest.raises(ValueError, match="fused"):
        fx.fixpoint(rel, init, backend="fused")
    with pytest.raises(ValueError, match="fused"):
        fx.fixpoint(rel.to("cpu"), init, backend="fused")
    plan = coo_spmm.plan_geometry(rel, transpose=True)
    words = coo_spmm.pack_lanes(init.cpu()).to(cuda)
    with pytest.raises(ValueError, match="host"):
        coo_spmm.bool_round_packed(plan, words)
    from repro_torch.core import planner
    assert planner.spmm_exec_backend("sparse_frontier_pallas",
                                     cuda) == "kernel"


def test_serve_carry_stays_on_the_card(cuda):
    """The scheduler's (B, n) carry lives on the card across admit, step
    and harvest; harvested answers and warm answers are CUDA tensors."""
    from repro_torch.serve import ContinuousServer
    mk, db, edges = _serve_families(cuda, "sssp")
    cs = ContinuousServer(max_batch=8, chunk_iters=1)
    cs.register("sssp", mk, db, edges=edges)
    for s in range(6):
        cs.submit("sssp", s)
    cs.step()
    st = cs._families["sssp"].pool.stepper
    for t in (st.y, st.d, st.it):
        assert t.device.type == "cuda"
    assert np.array_equal(st.live_lanes(),
                          (st.d != float("inf")).any(dim=1).cpu().numpy())
    cs.run_until_idle()
    for t in (st.y, st.d, st.it):
        assert t.device.type == "cuda"
    fam = cs._families["sssp"].fam
    assert len(fam.answers) == 6
    assert all(v.device.type == "cuda" for _, v in fam.answers.items())


@pytest.mark.parametrize("kind, op", [("sssp", "merge"), ("bm", "delete"),
                                      ("bm", "merge")])
def test_serve_update_repair_on_card_equals_cold(cuda, kind, op):
    """Warm answers repaired on the card across an update (delta-restart
    for a merge, the ⊖/recount rule for a delete, B3 in both) equal a
    cold fixpoint over the mutated operator, and the CPU port's repair."""
    from repro_torch.serve import ContinuousServer
    from repro_torch.serve.family import family_init
    rng = np.random.default_rng(9)
    sources = rng.choice(3000, 12, replace=False)
    g = datasets.powerlaw(3000, 4, seed=1)
    if op == "delete":
        coords, vals = g.edges[rng.choice(len(g.edges), 30, replace=False)], \
            None
    else:
        coords = rng.integers(0, 3000, (50, 2))
        vals = (rng.integers(1, 5, 50).astype(np.float32)
                if kind == "sssp" else None)
    out = {}
    for dev in ("cpu", cuda):
        mk, db, edges = _serve_families(dev, kind)
        cs = ContinuousServer(max_batch=16, host_kernels=False)
        _serve_stream(cs, kind, mk, db, edges, sources)
        b3 = dict(coo_segment.segment_reduce_cuda.by_path)
        u = cs.submit_update(kind, coords, vals, op=op)
        cs.run_until_idle()
        assert u.applied and u.error is None
        assert cs.stats()["answers_repaired"] == len(sources)
        fam = cs._families[kind].fam
        rep = torch.stack([fam.answers.peek(int(s)) for s in sources])
        init = torch.stack([torch.from_numpy(np.asarray(
            family_init(fam, int(s)))) for s in sources]).to(dev)
        cold, _ = fx.fixpoint(fam.edges, init)
        assert torch.equal(rep, cold)
        out[str(dev)] = rep.cpu()
        if dev != "cpu":
            used = {k: v - b3[k] for k, v in
                    coo_segment.segment_reduce_cuda.by_path.items()}
            assert used["runs"] > 0
            if op == "delete":
                assert used["scatter"] > 0
    assert torch.equal(out["cpu"], out["cuda"])


# --------------------------------------------------------------------------
# adaptive re-planning on the card
# --------------------------------------------------------------------------


class _Favor:
    """A cost model pricing one runner 100× under every other one, so
    the executor switches to it at the first boundary the policy
    allows."""

    def __init__(self, favorite):
        self.favorite = favorite

    def round_ns(self, runner, **kw):
        return 1.0 if runner == self.favorite else 100.0


def _chain_hub_rel(sr_name, device, n_chain=40, hub=200, seed=0):
    """A chain into a random hub: one-vertex frontiers for ``n_chain``
    rounds, then a wide one (weights 1–4 off 𝔹)."""
    rng = np.random.default_rng(seed)
    n = n_chain + hub
    chain = np.stack([np.arange(n_chain - 1), np.arange(1, n_chain)], 1)
    m = hub * 6
    h = np.stack([rng.integers(0, hub, m), rng.integers(0, hub, m)],
                 1) + n_chain
    coords = np.concatenate([chain, h, [[n_chain - 1, n_chain]]])
    w = np.ones(len(coords), bool) if sr_name == "bool" else \
        rng.integers(1, 5, len(coords)).astype(np.float32)
    return SparseRelation.from_coo(coords, w, (n, n), sr_name,
                                   device=device), n


def _adaptive_pair(cuda, sr_name, start, target, monkeypatch, b=4):
    """One adaptive run on the card and one on the CPU, both priced to
    switch from ``start`` to ``target``: ``(card, cpu, launched)``, the
    last B1/B2/B3 calls by path during the card's run."""
    from repro_torch.core import runners
    from repro_torch.sparse import adaptive
    monkeypatch.setattr(adaptive, "ADAPTIVE_COST", _Favor(target))
    rel, n = _chain_hub_rel(sr_name, "cpu")
    init = _sources(n, b, sr_name, seed=2)
    init[0] = sr_mod.get(sr_name).zero
    init[0, 0] = sr_mod.get(sr_name).one      # row 0 walks the chain
    pol = adaptive.ReplanPolicy(chunk_iters=3)
    runs = []
    for dev in ("cpu", cuda):
        r = rel.to(dev)
        ctx = runners.make_context(r, init.to(dev), sr_name, 10_000)
        before = {k: dict(f.by_path) for k, f in (
            ("b1", coo_spmm.spmm_cuda), ("b2",
                                         semiring_matmul.semiring_matmul_cuda),
            ("b3", coo_segment.segment_reduce_cuda))}
        y, it, tr = runners.adaptive_fixpoint(
            ctx, start=start, candidates=(target,), policy=pol)
        launched = {k: {p: v - before[k][p] for p, v in f.by_path.items()}
                    for k, f in (("b1", coo_spmm.spmm_cuda),
                                 ("b2", semiring_matmul.semiring_matmul_cuda),
                                 ("b3", coo_segment.segment_reduce_cuda))}
        runs.append((y, it, tr, launched))
    (wy, wit, wtr, _), (y, it, tr, launched) = runs
    assert y.device.type == "cuda"
    assert_match(y, wy, sr_name)
    assert torch.equal(it.cpu(), wit)
    assert [(e.chunk, e.iteration, e.frontier_nnz, e.from_runner,
             e.to_runner) for e in tr.switches] == \
        [(e.chunk, e.iteration, e.frontier_nnz, e.from_runner,
          e.to_runner) for e in wtr.switches] == \
        [(1, 6, wtr.switches[0].frontier_nnz, start, target)]
    assert [c.nnz for c in tr.chunks] == [c.nnz for c in wtr.chunks]
    static, sit = fx.fixpoint(rel.to(cuda), init.to(cuda))
    assert_match(y, static, sr_name)
    assert torch.equal(it, sit)
    return launched


_STAGED = ("sparse_jit", "sparse_frontier_pallas", "sparse_frontier")


@pytest.mark.parametrize("sr_name", ["bool", "trop"])
@pytest.mark.parametrize("start,target", [
    (a, b) for a in _STAGED for b in _STAGED if a != b])
def test_adaptive_handoff_on_card_matches_cpu(cuda, sr_name, start, target,
                                              monkeypatch):
    """A carry handed between any two of the sparse runners on the card
    gives the CPU port's answer, counts and switch history; each runner
    launched its own kernel path (B1 for the fused loop, B3 ``runs`` for
    the staged one, B3 ``scatter`` for the worklist)."""
    launched = _adaptive_pair(cuda, sr_name, start, target, monkeypatch)
    runs = {"sparse_frontier_pallas": launched["b1"][
                "words_bool" if sr_name == "bool" else "lanes_f32"],
            "sparse_jit": launched["b3"]["runs"],
            "sparse_frontier": launched["b3"]["scatter"]}
    assert runs[start] > 0 and runs[target] > 0
    assert all(v == 0 for k, v in runs.items() if k not in (start, target))
    assert sum(launched["b2"].values()) == 0


@pytest.mark.parametrize("sr_name", ["bool", "trop"])
@pytest.mark.parametrize("start,target", [("vector_dense", "sparse_jit"),
                                          ("sparse_jit", "vector_dense")])
def test_vector_dense_chunks_on_card_hand_off(cuda, sr_name, start, target,
                                              monkeypatch):
    """``vector_dense.run_chunk`` on the card (B2 over the densified
    240 × 240 operator) hands its carry to ``sparse_jit`` and takes one
    from it, bit for bit with the CPU port and the static run."""
    launched = _adaptive_pair(cuda, sr_name, start, target, monkeypatch)
    assert sum(launched["b2"].values()) > 0
    assert launched["b3"]["runs"] > 0 and sum(launched["b1"].values()) == 0


def test_estimate_reads_the_cuda_speedup(cuda):
    """``Runner.estimate`` prices the fused loop with ``SPMM_COST``'s
    entry for the operator's device type: ``cuda`` on the card."""
    from repro_torch.core import planner, runners
    rel, n = _chain_hub_rel("bool", cuda)
    init = _sources(n, 4, "bool", seed=1).to(cuda)
    ctx = runners.make_context(rel, init, "bool", 10_000)
    st = fx.fixpoint(rel, init, budget=2)
    jit = runners.get("sparse_jit").estimate(ctx, st).total
    fused = runners.get("sparse_frontier_pallas").estimate(ctx, st).total
    assert fused == pytest.approx(
        jit / planner.SPMM_COST.speedup("bool", "cuda"), rel=1e-12)
    assert planner.SPMM_COST.speedup("bool", "cuda") != \
        planner.SPMM_COST.speedup("bool", "cpu")
    cpu = runners.make_context(rel.to("cpu"), init.cpu(), "bool", 10_000)
    st_cpu = fx.fixpoint(rel.to("cpu"), init.cpu(), budget=2)
    assert runners.get("sparse_frontier_pallas").estimate(
        cpu, st_cpu).total == pytest.approx(
            jit / planner.SPMM_COST.speedup("bool", "cpu"), rel=1e-12)


@pytest.mark.parametrize("kind", ["bm", "cc"])
def test_cuda_adaptive_plan_never_offers_the_worklist(cuda, kind,
                                                      monkeypatch):
    """An adaptive plan on a CUDA database chooses among its considered
    runners, which never hold the worklist: priced cheapest, it is still
    never switched to, and the answer equals the static plan's."""
    from repro_torch.core import planner, runners
    from repro_torch.sparse import adaptive
    monkeypatch.setattr(adaptive, "ADAPTIVE_COST",
                        _Favor("sparse_frontier"))
    bench = programs.bm(a=0) if kind == "bm" else programs.cc()
    p = datasets.powerlaw(3000, 4, seed=0)
    db = engine.Database(bench.original.schema, {"id": p.n},
                         {"E": p.sparse_adjacency(device=cuda),
                          "V": p.vertex_set(device=cuda)}, cuda)
    for objective in ("latency", "throughput"):
        plan = planner.plan_program(
            bench.optimized, db, objective=objective,
            hints=planner.PlanHints(
                adaptive=True, replan=adaptive.ReplanPolicy(chunk_iters=1)))
        sp = plan.strata[0]
        assert "sparse_frontier" not in sp.considered
        assert "sparse_frontier" in sp.rejected
        got, st = planner.execute_plan(plan, bench.optimized, db)
        want, wst = run_program(bench.optimized, db)
        assert_match(got, want, bench.optimized.outputs[-1].body.semiring)
        tr = sp.switch_log
        assert tr is not None and tr.final_runner != "sparse_frontier"
        assert all(e.to_runner != "sparse_frontier" for e in tr.switches)
        assert all("sparse_frontier" not in est
                   for _, _, est in tr.prices)
        assert {c for _, _, est in tr.prices for c in est} <= \
            {c for c in sp.considered if runners.get(c).chunkable}


# --------------------------------------------------------------------------
# graph-axis sharded fixpoints on a one-rank NCCL mesh
# --------------------------------------------------------------------------


@pytest.fixture
def mesh1(cuda):
    from repro_torch.launch.mesh import make_graph_mesh
    return make_graph_mesh(1)


@pytest.mark.parametrize("sr_name", ["bool", "trop", "maxplus"])
@pytest.mark.parametrize("batched", [False, True])
def test_sharded_d1_on_card_matches_sparse_jit(mesh1, sr_name, batched):
    """The sharded loop at D = 1 on the card (NCCL) equals the
    single-device staged loop, values and per-row counts, under both
    exchanges; its B3 launches follow its round counters: ``runs`` once
    a dense round, ``scatter`` once a sparse one."""
    from repro_torch.distributed import datalog as dd
    from repro_torch.kernels import ops
    rel = _relation(20_000, sr_name, seed=5, device=mesh1.device)
    srn = sr_mod.get(sr_name, lib="np")
    rng = np.random.default_rng(6)
    init = np.full((8, 20_000), srn.zero, srn.dtype)
    init[np.arange(8), rng.choice(20_000, 8, replace=False)] = srn.one
    init = torch.from_numpy(init if batched else init[0]).to(mesh1.device)
    want, wit = fx.fixpoint(rel, init, mode="jit")
    sh = dd.shard_relation(rel, mesh1)
    for exchange in ("auto", "dense"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got, it, rounds = dd.sharded_seminaive_fixpoint_stats(
            sh, init, mesh=mesh1, exchange=exchange)
        torch.cuda.synchronize()
        paths = dict(coo_segment.segment_reduce_cuda.by_path)
        assert_match(got, want, sr_name)
        if batched:
            assert torch.equal(it.cpu(), wit.cpu())
        else:
            assert it == wit
        rounds = rounds.tolist()
        assert paths == {"runs": rounds[-1], "scatter": sum(rounds[:-1])}


@pytest.mark.parametrize("b", [1, 5, 8, 64])
def test_sharded_bool_codec_round_trip_on_card(cuda, b):
    from repro_torch.distributed import datalog as dd
    sr = sr_mod.get("bool")
    x = torch.from_numpy(np.random.default_rng(b).random((4099, b)) < 0.5)
    packed = dd._pack(sr, x.to(cuda))
    assert packed.shape == (4099, dd.payload_row_bytes("bool", b))
    assert torch.equal(packed.cpu(), dd._pack(sr, x))
    assert torch.equal(dd._unpack(sr, packed, b).cpu(), x)


@pytest.mark.parametrize("sr_name", ["bool", "trop"])
@pytest.mark.parametrize("lanes", [1, 8])
def test_segment_on_shard_shaped_payloads(cuda, sr_name, lanes):
    """B3 at a shard's shapes: ``runs`` over a local derive's payload (the
    shard's segment plan, the gathered frontier ⊗ its values in plan
    order) and ``scatter`` over an expansion's (ids of ``nb`` rows with
    sentinel ``nb`` in the dead slots), against the plain versions."""
    from repro_torch.distributed import datalog as dd
    rel = _relation(20_000, sr_name, seed=7, device=cuda)
    sh = dd.shard_relation(rel, 2)
    part = dd._local_shard(sh, 1, cuda)
    nb, sr = sh.row_block, sr_mod.get(sr_name)
    rng = np.random.default_rng(8)
    frontier = _values(rng, (sh.n_pad, lanes), sr_name, live=0.08).to(cuda)
    vals = sr.mul(part.w[:, None], frontier.index_select(0, part.src))
    want = ref.segment_reduce_ref(
        sr, vals, part.dst.index_select(0, part.plan.order), nb)
    m = 2 * nb
    ids = torch.from_numpy(rng.integers(0, nb, m).astype(np.int32))
    ids[m // 2:] = nb                     # the expansion's dead slots
    pay = _values(rng, (m, lanes), sr_name, live=0.6)
    want_x = ref.segment_reduce_ref(sr, pay, ids, nb)
    if sr_name == "bool":
        shares = [float(w.float().mean()) for w in (want, want_x)]
        assert all(0.2 <= x <= 0.8 for x in shares), shares
    assert_match(coo_segment.segment_reduce(sr_name, vals, part.dst, nb,
                                            plan=part.plan), want, sr_name)
    assert_match(coo_segment.segment_reduce(sr_name, pay.to(cuda),
                                            ids.to(cuda), nb),
                 want_x.to(cuda), sr_name)


# --------------------------------------------------------------------------
# the data axis: a one-rank NCCL mesh, and two gloo ranks on the card
# --------------------------------------------------------------------------


def test_sharded_step_on_a_one_rank_nccl_mesh_is_the_unsharded_step(mesh1):
    """``train(mesh=make_host_mesh())`` on the one-rank NCCL world: the
    gather, reduce-scatter and norm all-reduce run on NCCL, stage no byte
    through the host, and give the unsharded run's losses and parameters
    bit for bit."""
    from repro_torch.distributed import collectives
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optimizer.optimizers import tree_leaves
    kw = dict(steps=3, batch=4, seq=64, lr=3e-3, log_every=100,
              device="cuda")
    p0, l0 = train_mod.train("xlstm-125m", **kw)
    collectives.reset_stats()
    p1, l1 = train_mod.train("xlstm-125m", mesh=make_host_mesh(), **kw)
    stats = collectives.reset_stats()
    assert stats["calls"] > 0 and stats["host_staged_bytes"] == 0
    assert l0 == l1
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a.detach(), b)


def test_data_axis_on_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """Two gloo ranks sharing the card, CUDA tensors staged through the
    host: bf16 and int8 reductions equal the reference's arithmetic done
    on the host; GPipe (2 stages, 4 micro-batches) equals the stack; the
    data-mesh server (16 rows a rank) answers as a one-device server,
    B1 launched on each rank."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    import torch_mesh_worker as worker
    from repro_torch.launch.mesh import spawn_world
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 7)).astype(np.float32)
    w = (rng.standard_normal((2, 16, 16)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((4, 2, 16)).astype(np.float32)
    # the serve phase's BM graph, where the planner takes B1
    g = datasets.powerlaw(50_000, 4, seed=1)
    sources = [int(s) for s in rng.integers(0, g.n, 32)]
    ranks = spawn_world(worker.run_cases, 2,
                        {"c": ("card", (x, w, xs, g.edges, g.n, sources))},
                        device="cuda", workdir=str(tmp_path))
    t = torch.from_numpy(x)
    b = t.to(torch.bfloat16).float()
    want_bf16 = (b[0] + b[1]).to(torch.bfloat16).float()
    scale = t.abs().amax((1, 2)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(t / scale[:, None, None]), -127, 127)
    want_int8 = q.sum(0) * (scale.sum() / 2)
    seq = torch.from_numpy(xs)
    for s in range(2):
        seq = torch.tanh(seq @ torch.from_numpy(w[s]))
    for r in ranks:
        got = r["c"]
        assert torch.equal(got["bf16"], want_bf16)
        torch.testing.assert_close(got["int8"], want_int8, rtol=1e-6,
                                   atol=1e-7)
        assert np.array_equal(got["tree"]["bf16"]["g"],
                              (want_bf16 / 2).numpy())
        np.testing.assert_allclose(got["tree"]["int8"]["g"],
                                   (want_int8 / 2).numpy(), rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(got["pipe"], seq, rtol=1e-5, atol=1e-5)
        (y1, it1, st1, b1_1, rows1), (y2, it2, st2, b1_2, rows2) = \
            got["serve"]
        assert all(torch.equal(a, b) for a, b in zip(y1, y2))
        assert it1 == it2 and st1 == st2
        assert rows1 == [32] and rows2 == [16]
        assert b1_1 > 0 and b1_2 > 0


# --------------------------------------------------------------------------
# the model axis: two gloo ranks on the card at (data 1, model 2)
# --------------------------------------------------------------------------


def test_model_axis_on_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """``train(model_parallel=2)`` and ``serve_batch(model_parallel=2)``
    on two gloo ranks sharing the card (CUDA tensors staged through the
    host): xLSTM's, Zamba2's and DeepSeekMoE's smoke configs train 3
    steps within 1e-4 of one rank's losses, serve one rank's tokens, and
    launch B4 (the recurrent families), B5 and B5's backward (the
    attention families) on the rank's channels and heads; DeepSeekMoE
    with each rank's experts on the rank."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    import functools
    import torch_model_axis_worker as worker
    from repro_torch.launch import serve, train as train_mod
    from repro_torch.launch.mesh import make_host_mesh, spawn_world
    archs = ("xlstm-125m", "zamba2-2.7b", "deepseek-moe-16b")
    batch, seq, max_new = 4, 64, 6
    prompts = [np.random.default_rng(5).integers(1, 512, n)
               for n in (7, 12)]
    ranks = spawn_world(worker.run_cases, 2,
                        {"c": ("card", (archs, batch, seq, prompts,
                                        max_new))},
                        device="cuda", workdir=str(tmp_path),
                        mesh_fn=functools.partial(make_host_mesh, 2))
    for arch in archs:
        _, want = train_mod.train(arch, steps=3, batch=batch, seq=seq,
                                  lr=3e-3, device="cuda", log_every=100)
        reqs = [serve.Request(p, max_new=max_new) for p in prompts]
        serve.serve_batch(arch, reqs, t_max=64, device="cuda")
        for r in ranks:
            losses, toks, launches = r["c"][arch]
            np.testing.assert_allclose(losses, want, rtol=1e-4, atol=1e-4)
            assert toks == [q.out for q in reqs]
            if arch != "deepseek-moe-16b":
                assert launches["ssm_scan"] > 0
            if arch != "xlstm-125m":
                assert launches["flash_attention"] > 0
                assert launches["flash_attention_backward"] > 0

def test_uneven_heads_on_four_gloo_ranks_on_the_card(cuda, tmp_path):
    """Whole heads that the model axis does not divide, on four gloo
    ranks sharing the card (``sharding.head_split``): Mistral's smoke
    config (6 query / 2 kv heads: 2, 1 query heads a kv head's two
    ranks), MiniCPM's with 6 heads (2, 2, 1, 1 a rank) and Whisper's
    with 2 (each head on two ranks) train 3 steps within 1e-4 of one
    rank's losses, serve one rank's tokens, and launch B5 and its
    backward on every rank."""
    import dataclasses
    import functools
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    import torch_model_axis_worker as worker
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh, spawn_world
    cfgs = [configs.get("mistral-large-123b", smoke=True),
            dataclasses.replace(configs.get("minicpm-2b", smoke=True),
                                n_heads=6, n_kv_heads=6, head_dim=32),
            dataclasses.replace(configs.get("whisper-base", smoke=True),
                                n_heads=2, n_kv_heads=2, head_dim=32)]
    batch, seq, max_new = 4, 64, 6
    prompts = [np.random.default_rng(5).integers(1, 512, n)
               for n in (7, 12)]
    ranks = spawn_world(worker.run_cases, 4,
                        {"c": ("card", (cfgs, batch, seq, prompts, max_new,
                                        4))},
                        device="cuda", workdir=str(tmp_path),
                        mesh_fn=functools.partial(make_host_mesh, 4))
    for cfg in cfgs:
        _, want = train_mod.train(cfg, steps=3, batch=batch, seq=seq,
                                  lr=3e-3, device="cuda", log_every=100)
        reqs = [serve.Request(p, max_new=max_new) for p in prompts]
        serve.serve_batch(cfg, reqs, t_max=64, device="cuda")
        for r in ranks:
            losses, toks, launches = r["c"][cfg.name]
            np.testing.assert_allclose(losses, want, rtol=1e-4, atol=1e-4)
            assert toks == [q.out for q in reqs]
            assert launches["flash_attention"] > 0
            assert launches["flash_attention_backward"] > 0


# -- the CEGIS group and the staged cost model on the card -------------------


def _costed_calls(dev):
    """One call down each path of B1, B2 and B3, on ``dev``: name →
    (thunk, "kernel/path")."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    out = {}
    for name, m, path in (("bool", 4, "stream"), ("trop", 16, "stream"),
                          ("bool", 64, "tc_bool"), ("nat", 64, "tile_f32"),
                          ("trop", 40, "tile_f32")):
        a = _values(rng, (m, 96), name).to(dev)
        b = _values(rng, (96, 80), name).to(dev)
        out[f"b2_{path}_{name}"] = (
            lambda sr=sr_mod.get(name), a=a, b=b:
            ops.semiring_matmul(sr, a, b), f"semiring_matmul/{path}")
    for name, lanes, path in (("bool", 64, "words_bool"),
                              ("trop", 8, "lanes_f32")):
        rel = _relation(300, name, 1, dev)
        x = _values(rng, (300, lanes), name).to(dev)
        out[f"b1_{path}"] = (lambda rel=rel, x=x: ops.coo_spmm(
            rel, x, transpose=True), f"coo_spmm/{path}")
    sr = sr_mod.get("trop")
    ids = torch.from_numpy(rng.integers(0, 70, 500).astype(np.int32)).to(dev)
    vals = _values(rng, (500, 8), "trop").to(dev)
    plan = coo_segment.plan_segment(ids, 70)
    out["b3_runs"] = (lambda: ops.semiring_segment_reduce(
        sr, vals[plan.order], ids, 70, plan=plan), "coo_segment/runs")
    out["b3_scatter"] = (lambda: ops.semiring_segment_reduce(
        sr, vals, ids, 70), "coo_segment/scatter")
    return out


def test_staged_cost_counts_each_kernel_as_on_the_cpu(cuda):
    """Every path of B1, B2 and B3 launched on the card counts once, with
    the operations and bytes its plain version counts on the CPU; the
    kernel launched (a warm call and the counted one)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import hlo_cost
    on_cpu = _costed_calls(torch.device("cpu"))
    for case, (call, key) in _costed_calls(cuda).items():
        launches = ops.launch_counts()[key.split("/")[0]]
        got = hlo_cost.staged_cost(call)
        want = hlo_cost.staged_cost(on_cpu[case][0])
        assert got.kernels == want.kernels == {key: 1}, case
        assert (got.flops, got.bytes) == (want.flops, want.bytes), case
        assert ops.launch_counts()[key.split("/")[0]] == launches + 2, case


@pytest.mark.parametrize("kind", ["bm", "cc"])
def test_hlo_plan_on_card_prices_as_on_the_cpu(cuda, kind):
    """``cost_model="hlo"`` on a CUDA database: every candidate priced
    from its staged step, the pick the CPU database's counts give among
    the candidates both offer (the worklist is the CPU's alone; an aten
    op may split differently by device, so the counts need not be
    equal), and the analytic plan's answer."""
    from repro_torch.core import planner
    g = datasets.erdos_renyi(256, 3.0, seed=2)
    b = programs.bm(a=0) if kind == "bm" else programs.cc()
    plans, answers = {}, {}
    for dev in (torch.device("cpu"), cuda):
        db = engine.Database(b.original.schema, {"id": g.n}, {
            "E": g.sparse_adjacency(symmetric=kind == "cc", device=dev),
            "V": g.vertex_set(device=dev)}, dev)
        plan = plans[dev.type] = planner.plan_program(b.optimized, db,
                                                      cost_model="hlo")
        answers[dev.type] = run_program(b.optimized, db, plan=plan)[0]
        assert torch.equal(answers[dev.type],
                           run_program(b.optimized, db)[0].to(dev))
    cpu, card = plans["cpu"].strata[0], plans["cuda"].strata[0]
    assert all(c.source == "hlo" for c in card.considered.values())
    both = set(cpu.considered) & set(card.considered)
    pref = list(planner.RUNNERS)
    assert card.runner == min(both, key=lambda k: (
        cpu.considered[k].total, pref.index(k)))
    assert torch.equal(answers["cuda"].cpu(), answers["cpu"])


def test_bc_on_card_matches_cpu(cuda):
    """BC Π₁ (three strata, ℕ path counts) and Π₂ (Brandes) on the
    card against the CPU within ``1e-4``; Π₁ = Π₂."""
    g = datasets.erdos_renyi(48, 2.0, seed=4)
    b = programs.bc(dmax=16)
    got = {}
    for dev in (torch.device("cpu"), cuda):
        db = b.make_db(g, device=dev)
        got[dev.type] = [run_program(p, db)[0].cpu()
                         for p in (b.original, b.optimized)]
    for a, w in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got["cuda"][0], got["cuda"][1], atol=1e-4,
                               rtol=1e-4)


def test_host_mode_on_card_equals_naive(cuda):
    b = programs.ws(window=10, vmax=6)
    db = b.make_db(datasets.vector_data(64, seed=0, vmax=6), device=cuda)
    x, st = run_program(b.original, db, mode="host")
    y, st2 = run_program(b.original, db, mode="naive")
    assert st.plan.strata[0].runner == "dense_host"
    assert torch.equal(x, y) and st.iterations == st2.iterations


# -- the dry run (ROADMAP A8) ----------------------------------------------------


def test_meta_tensors_never_launch_b4_or_b5(cuda):
    """On meta tensors (a dry run's count) B4's and B5's wrappers, forward
    and backward, return empty outputs of the right shapes and dtypes and
    launch nothing; the same calls on the card launch once each."""
    from repro_torch.kernels import flash_attention as fa, ops, ssm_scan
    before = ops.launch_counts()
    meta = torch.device("meta")
    q = torch.empty((2, 8, 4, 64), device=meta, dtype=torch.bfloat16)
    k = torch.empty((2, 8, 2, 64), device=meta, dtype=torch.bfloat16)
    assert fa.flash_attention(q, k, k).shape == q.shape
    o, lse = fa.flash_attention_lse(q, k, k)
    assert o.dtype == torch.bfloat16 and lse.shape == (2, 4, 8)
    assert lse.dtype == torch.float32
    assert [g.shape for g in fa.attention_backward(q, k, k, o, lse, q)] == [
        q.shape, k.shape, k.shape]
    a = torch.empty((2, 16, 32), device=meta)
    assert ssm_scan.ssm_scan(a, a).shape == a.shape
    assert [g.shape for g in ssm_scan.scan_backward(a, a, a)] == [
        a.shape, a.shape]
    assert ops.launch_counts() == before
    qc = torch.randn((2, 8, 4, 64), device=cuda)
    kc = torch.randn((2, 8, 2, 64), device=cuda)
    fa.flash_attention(qc, kc, kc)
    ssm_scan.ssm_scan(torch.rand((2, 16, 32), device=cuda),
                      torch.randn((2, 16, 32), device=cuda))
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["ssm_scan"] == before["ssm_scan"] + 1


@pytest.mark.parametrize("arch, shape, kw", [
    ("xlstm-125m", "train_4k", dict(batch=4, seq=64, remat="none")),
    ("zamba2-2.7b", "prefill_32k", dict(batch=4, seq=64)),
    ("zamba2-2.7b", "decode_32k", dict(batch=4, seq=64))])
def test_calibrate_counts_the_card_step_as_the_meta_one(cuda, arch, shape,
                                                        kw):
    """``dryrun.calibrate`` at a smoke config: the card's step counts the
    meta step's FLOPs, bytes and collectives exactly, its kernels as one
    op each, and the same arguments; its peak is at least them (the 10%
    gate on the peak is ``chip_smoke.py``'s, at full size: at a smoke
    size the allocator's 512-byte rounding of small tensors weighs)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    out = dryrun.calibrate(configs.get(arch, smoke=True), shape,
                           device=cuda, **kw)
    meta, dev = out["meta"], out["device"]
    for key in ("flops", "bytes_accessed", "collectives", "kernels"):
        assert meta[key] == dev[key], key
    assert meta["kernels"]
    args = meta["memory"]["argument_bytes"]
    assert dev["memory"]["argument_bytes"] == args
    assert dev["device_peak_bytes"] >= args
