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
# B4 ssm_scan, B5 flash_attention and the Zamba2 serving path
# --------------------------------------------------------------------------
#
# B4 and B5 are float kernels that sum in another order than their plain
# versions (B4: a serial FMA walk against a doubling scan; B5: an online
# softmax over key tiles against one softmax), so they are held to
# max |err| <= 1e-4 · max(1, max |plain|).


def assert_float_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.parametrize("shape", [(2, 1, 8), (3, 97, 160), (2, 300, 80),
                                   (1, 1000, 33)])
def test_ssm_scan_kernel_vs_plain(cuda, shape):
    from repro_torch.kernels import ssm_scan
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    a = torch.rand(shape, generator=g, device=cuda) * 0.5 + 0.5
    b = torch.randn(shape, generator=g, device=cuda)
    before = ssm_scan.ssm_scan_cuda.launches
    got = ssm_scan.ssm_scan(a, b)
    assert ssm_scan.ssm_scan_cuda.launches == before + 1
    assert_float_close(got, ref.ssm_scan_ref(a, b))
    assert_float_close(got, ref.ssm_scan_sequential(a, b))


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
    q = torch.ones(1, 2, 2, 160, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
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


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}
