"""The paper's CEGIS group (Fig. 12) in the port against the JAX package:
BC (Π₁ with its stratified negation and ℕ path counts, Π₂ as Brandes'
algorithm), ``datasets.tree_depth`` that sizes R and MLM, and the host
runner (``mode="host"``, ``dense_host``).

Both packages get the same numpy-seeded inputs (the generators are the
reference's numpy code; ``port_db`` hands the reference's buffers to the
port).  BC's answers are sums of path-count ratios in f32, compared
within ``atol = rtol = 1e-4``; everything else bit for bit, iteration
counts included.  The three BC planner regressions of
``tests/test_planner.py`` have their twins here.
"""

import numpy as np
import pytest
import torch

from repro.core import program as jprogram
from repro.datalog import datasets as jdata
from repro.datalog import programs as jprograms
from repro_torch.core import planner, program
from repro_torch.core import program as prog_mod
from repro_torch.datalog import datasets, programs

from test_torch_program import assert_match, port_db

TOL = dict(atol=1e-4, rtol=1e-4)


# -- tree_depth ---------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(2, 0), (25, 5), (64, 0), (128, 3)])
@pytest.mark.parametrize("gen", ["random_recursive_tree", "decay_tree"])
def test_tree_depth_matches_reference(gen, n, seed):
    g = getattr(datasets, gen)(n, seed=seed)
    jg = getattr(jdata, gen)(n, seed=seed)
    assert np.array_equal(g.edges, jg.edges)
    depth = datasets.tree_depth(g)
    assert isinstance(depth, int)
    assert depth == jdata.tree_depth(jg)


def test_tree_depth_is_the_longest_root_path():
    """A path of n vertices is n - 1 deep; a star is 1 deep."""
    assert datasets.tree_depth(datasets.path_graph(7)) == 6
    star = datasets.Graph(5, np.array([[0, i] for i in range(1, 5)]))
    assert datasets.tree_depth(star) == 1


# -- the host runner ----------------------------------------------------------


def _host_case(name):
    if name == "ws":
        return (jprograms.ws(), programs.ws(),
                jdata.vector_data(20, seed=1))
    jb = jprograms.bm(a=0) if name == "bm" else jprograms.cc()
    tb = programs.bm(a=0) if name == "bm" else programs.cc()
    return jb, tb, jdata.erdos_renyi(24, 2.0, seed=3)


@pytest.mark.parametrize("mode", ["host", "dense_host"])
@pytest.mark.parametrize("name", ["bm", "cc", "ws"])
def test_host_mode_matches_reference_host_fixpoint(name, mode):
    """``mode="host"`` (and the runner's own name) runs ``dense_host``:
    the reference's ``host_fixpoint`` answers and iteration counts on
    Π₁."""
    jb, tb, data = _host_case(name)
    jdb = jb.make_db(data)
    db = port_db(jdb, tb.original.schema)
    want, wst = jprogram.run_program(jb.original, jdb, mode=mode)
    got, st = program.run_program(tb.original, db, mode=mode)
    assert [sp.runner for sp in st.plan.strata] == ["dense_host"]
    assert_match(got, want, tb.original.outputs[-1].body.semiring)
    assert st.iterations == wst.iterations


def test_host_fixpoint_stops_at_max_iters():
    """A loop that does not converge returns ``max_iters``, as the
    reference's does."""
    from repro_torch.core import fixpoint
    x, it = fixpoint.host_fixpoint(lambda s: {"x": s["x"] + 1},
                                   {"x": torch.zeros(2)}, max_iters=5)
    assert it == 5 and torch.equal(x["x"], torch.full((2,), 5.0))
    x, it = fixpoint.host_fixpoint(lambda s: {"x": s["x"].clamp(max=2) + 0},
                                   {"x": torch.zeros(2)}, max_iters=5)
    assert it == 1


def test_an_unknown_mode_raises():
    """The reference runs ``dense_host`` for any mode string it does not
    know; the port raises, so a misspelt mode does not run the host loop
    unnoticed."""
    tb = programs.bm(a=0)
    db = tb.make_db(datasets.erdos_renyi(24, 2.0, seed=3), device="cpu")
    with pytest.raises(ValueError, match="unknown mode 'hots'"):
        program.run_program(tb.original, db, mode="hots")


# -- BC -----------------------------------------------------------------------


#: the reference's test_bc_matches_networkx case, and one size larger
BC_CASES = {"n12": (12, 4, 14), "n32": (32, 4, 16)}


def _bc(case):
    n, seed, dmax = BC_CASES[case]
    jb, tb = jprograms.bc(dmax=dmax), programs.bc(dmax=dmax)
    jdb = jb.make_db(jdata.erdos_renyi(n, 2.0, seed=seed))
    return jb, tb, jdb, port_db(jdb, tb.original.schema)


@pytest.mark.parametrize("which", ["original", "optimized"])
@pytest.mark.parametrize("case", list(BC_CASES))
def test_bc_matches_reference(case, which):
    jb, tb, jdb, db = _bc(case)
    want, wst = jprogram.run_program(getattr(jb, which), jdb)
    got, st = program.run_program(getattr(tb, which), db)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert st.iterations == wst.iterations
    assert float(np.abs(np.asarray(want)).max()) > 0   # not all zero


@pytest.mark.parametrize("case", list(BC_CASES))
def test_bc_original_equals_brandes(case):
    """Π₁ (levels, ℕ counts, the post's triple join) = Π₂ (Brandes) =
    ``optimized_fn``; Π₁'s strata take the reference's runners."""
    jb, tb, jdb, db = _bc(case)
    p1, st = program.run_program(tb.original, db)
    p2, _ = program.run_program(tb.optimized, db)
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), **TOL)
    assert torch.equal(tb.optimized_fn(db), p2)
    _, wst = jprogram.run_program(jb.original, jdb)
    assert [sp.runner for sp in st.plan.strata] == \
        [sp.runner for sp in wst.plan.strata]
    assert "bc" in programs.ALL and programs.ALL["bc"] is programs.bc


def test_bc_post_blocks_give_the_same_answer(monkeypatch):
    """The post batches the vertices v; blocks of one vertex give the
    answer of one block."""
    _, tb, _, db = _bc("n32")
    whole, _ = program.run_program(tb.original, db)
    monkeypatch.setattr(programs, "BC_BLOCK_ENTRIES", 1)
    cut, _ = program.run_program(programs.bc(dmax=16).original, db)
    np.testing.assert_allclose(cut.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_brandes_leaves_the_tf32_flag_as_it_found_it():
    """Brandes' products run without TF32 whatever the global flag
    says, and the flag is restored."""
    _, tb, _, db = _bc("n12")
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            programs.bc_brandes(db)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


# -- the reference's BC planner regressions -----------------------------------


def test_multi_stratum_cache_sees_prior_stratum_outputs():
    """A later stratum whose rules read only earlier-stratum IDBs (BC's
    Lv reads only R3) fingerprints those inputs: one Program over two
    databases gives each its own answer."""
    b = programs.bc(dmax=8)
    g1 = datasets.erdos_renyi(6, 1.5, seed=0)
    g2 = datasets.erdos_renyi(6, 1.5, seed=11)
    db1, db2 = b.make_db(g1, device="cpu"), b.make_db(g2, device="cpu")
    a1, _ = program.run_program(b.original, db1, mode="naive")
    a2, _ = program.run_program(b.original, db2, mode="naive")
    fresh2, _ = program.run_program(programs.bc(dmax=8).original, db2,
                                    mode="naive")
    assert torch.equal(a2, fresh2)
    assert not torch.equal(a1, a2)


def _count_ico(monkeypatch):
    calls = {"ico": 0}
    real = prog_mod.make_ico

    def count(*a, **k):
        calls["ico"] += 1
        return real(*a, **k)

    monkeypatch.setattr(prog_mod, "make_ico", count)
    return calls


def test_auto_and_forced_plans_do_not_alias_staged_cache(monkeypatch):
    """Same runner, different storage decisions (auto sparsifies E for
    the sig stratum, forced keeps it) must not share staged closures."""
    b = programs.bc(dmax=8)
    db = b.make_db(datasets.erdos_renyi(40, 1.5, seed=0), device="cpu")
    sig_sp = planner.plan_for(b.original, db).strata[2]
    assert sig_sp.runner == "dense_naive" and \
        sig_sp.storage == {"E": "sparse"}, (sig_sp.runner, sig_sp.storage)
    calls = _count_ico(monkeypatch)
    a_auto, _ = program.run_program(b.original, db, mode="auto")
    auto_calls = calls["ico"]
    a_forced, _ = program.run_program(b.original, db, mode="naive")
    assert calls["ico"] == auto_calls + len(b.original.strata)
    assert torch.equal(a_auto, a_forced)


def test_multi_stratum_second_run_hits_cache(monkeypatch):
    """Later strata key their staged cache on the input database, not on
    the previous stratum's fresh outputs: a repeat run rebuilds
    nothing."""
    b = programs.bc(dmax=8)
    db = b.make_db(datasets.erdos_renyi(6, 1.5, seed=0), device="cpu")
    calls = _count_ico(monkeypatch)
    a1, _ = program.run_program(b.original, db, mode="naive")
    first = calls["ico"]
    assert first == len(b.original.strata)
    a2, _ = program.run_program(b.original, db, mode="naive")
    assert calls["ico"] == first
    assert torch.equal(a1, a2)
