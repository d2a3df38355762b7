"""Port parity: synthesized ⊖/recount maintenance.

``repro_torch.incremental.maintenance`` against ``repro.incremental.
maintenance``: CEGIS gives the reference's rule — the same (seeds,
cone), ``verified``, reason, refutation trail and probe count — for
delete and increase on bool, trop and maxplus, and the reference's
failure on nat; the executor (``maintain_nonmonotone``: seed, cone,
recount, resume) on CPU tensors equals the reference's on the same host
buffers, values and iteration counts bit for bit, for random deletes,
increases, mixed batches and (B, n) packs; ``_gather_values`` combines
duplicate keys as the reference does.

Each rule is synthesized once per (semiring, op) and package, in a
module-scoped fixture.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import semiring as jsr
from repro.core import verify as jverify
from repro.incremental import delta_restart_fixpoint as jrestart
from repro.incremental import maintenance as jm
from repro.sparse import fixpoint as jfx
from repro.sparse.coo import SparseRelation as JRel
from repro_torch.core import egraph, verify
from repro_torch.incremental import (delta_restart_fixpoint,
                                     maintain_nonmonotone)
from repro_torch.incremental import maintenance as m
from repro_torch.sparse import fixpoint as fx
from repro_torch.sparse.coo import SparseRelation

LATTICES = ("bool", "trop", "maxplus")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def _port(jrel) -> SparseRelation:
    h = jrel.as_np()
    return SparseRelation.from_buffers(h.coords, h.values, h.nnz, h.shape,
                                       jrel.semiring, device="cpu")


@pytest.fixture(scope="module")
def rules():
    """``rules(semiring, op) -> (reference rule, port rule)``, each
    synthesized once."""
    cache = {}

    def get(semiring, op):
        if (semiring, op) not in cache:
            cache[semiring, op] = (jm.synthesize_maintenance(semiring, op),
                                   m.synthesize_maintenance(semiring, op))
        return cache[semiring, op]
    return get


def _random_rel(rng, n, semiring, avg_deg=2.5):
    """Random digraph in both packages (host lib for the reference);
    DAG for maxplus (positive cycles have no finite longest path)."""
    p = min(1.0, avg_deg / n)
    adj = rng.random((n, n)) < p
    np.fill_diagonal(adj, False)
    if semiring == "maxplus":
        adj = np.triu(adj)
    coords = np.argwhere(adj).astype(np.int64)
    sr = jsr.get(semiring, lib="np")
    values = (np.ones(len(coords), sr.dtype) if semiring == "bool"
              else rng.integers(1, 6, len(coords)).astype(sr.dtype))
    jrel = JRel.from_coo(coords, values, (n, n), semiring, lib="np")
    return jrel, _port(jrel)


def _one_hot(n, src, semiring):
    sr = jsr.get(semiring, lib="np")
    init = np.full(n, sr.zero, sr.dtype)
    init[src] = sr.one
    return init


def _live_edges(rel):
    h = rel.as_np()
    return np.asarray(h.coords[:int(h.nnz)]), np.asarray(
        h.values[:int(h.nnz)])


# --------------------------------------------------------------------------
# CEGIS outcomes
# --------------------------------------------------------------------------


def _same_rule(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.name == want.name


@pytest.mark.parametrize("semiring", LATTICES + ("nat",))
@pytest.mark.parametrize("op", ["delete", "increase"])
def test_cegis_gives_the_references_rule(rules, semiring, op):
    """Every field of the outcome equals the reference's: (seeds, cone),
    verified, reason, normalized term, probe count and the refutation
    trail (each refuted candidate with the probe that killed it)."""
    want, got = rules(semiring, op)
    _same_rule(got, want)
    if semiring == "nat":
        assert not got.verified and "⊖" in got.reason
    elif op == "delete":
        assert got.verified and (got.seeds, got.cone) == ("supported",
                                                          "tight")
        assert got.name == "⊖-recount[seed=supported, cone=tight]"
        refuted = {(s, c) for s, c, _ in got.refuted}
        assert {("supported", "seeds"), ("supported", "one_hop")} <= refuted
    elif semiring == "bool":
        assert not got.verified
    else:
        assert got.verified
        assert got.cone == ("seeds" if semiring == "maxplus" else "tight")


def test_maintain_refuses_an_unverified_rule(rules):
    _, nat = rules("nat", "delete")
    jrel, rel = _random_rel(np.random.default_rng(0), 8, "bool")
    with pytest.raises(ValueError, match="unverified"):
        maintain_nonmonotone(rel, np.zeros((0, 2), np.int64), np.zeros(0),
                             _one_hot(8, 0, "bool"), _one_hot(8, 0, "bool"),
                             nat)


@pytest.mark.parametrize("semiring", ("bool", "trop"))
def test_cyclic_probes_refute_dred_counting(semiring):
    """DRed-style support counting (seed=unsupported) fails on the same
    cyclic probe as in the reference (its per-seed host loop)."""
    cand = m.MaintenanceRule("unsupported", "tight", semiring, "delete",
                             False, "", m.rule_term("unsupported", "tight"))
    jcand = jm.MaintenanceRule("unsupported", "tight", semiring, "delete",
                               False, "", jm.rule_term("unsupported",
                                                       "tight"))
    bad = m._first_failure(cand, verify.sample_update_probes(
        semiring, np.random.default_rng(0), 8))
    jbad = jm._first_failure(jcand, jverify.sample_update_probes(
        semiring, np.random.default_rng(0), 8))
    assert bad is not None and bad.name == jbad.name
    assert "cycle" in bad.name or "loop" in bad.name


def test_egraph_rejects_the_full_cone_by_proof(rules):
    for seeds in m.SEED_KINDS:
        assert egraph.normalize(m.rule_term(seeds, "all")) == \
            "cold_fixpoint"
    _, rule = rules("bool", "delete")
    assert all("egraph" in why for s, c, why in rule.refuted if c == "all")
    assert m._candidates() == jm._candidates()


def test_rule_cache_round_trip():
    m.clear_rule_cache()
    assert m.cached_rule("sig-x", "trop", "delete") is None
    r1 = m.ensure_rule("sig-x", "trop", "delete")
    assert r1.verified
    assert m.cached_rule("sig-x", "trop", "delete") is r1
    assert m.ensure_rule("sig-x", "trop", "delete") is r1
    failed = m.ensure_rule("sig-x", "nat", "delete")
    assert not failed.verified and m.cached_rule("sig-x", "nat",
                                                 "delete") is failed
    m.clear_rule_cache()
    assert m.cached_rule("sig-x", "trop", "delete") is None


# --------------------------------------------------------------------------
# _gather_values
# --------------------------------------------------------------------------


@pytest.mark.parametrize("semiring", LATTICES + ("nat",))
def test_gather_values_combines_duplicates_as_the_reference(semiring):
    """Old stored values at the wanted keys: absent keys 0̄, keys stored
    twice (an apply_delta append) ⊕-combined, wanted keys repeated and
    out of order, a padded relation."""
    rng = np.random.default_rng(3)
    jrel, rel = _random_rel(rng, 20, semiring, avg_deg=4.0)
    coords, vals = _live_edges(jrel)
    dup = coords[:5]
    dv = (np.ones(5, bool) if semiring == "bool"
          else rng.integers(1, 9, 5).astype(np.float32))
    jrel, rel = jrel.apply_delta(dup, dv), rel.apply_delta(dup, dv)
    want_keys = np.concatenate([dup[::-1], coords[3:9], [[19, 19], [0, 0]],
                                dup[:2]])
    got = m._gather_values(rel, want_keys)
    assert got.device.type == "cpu"
    assert_same(got, jm._gather_values(jrel, want_keys))
    assert_same(m._gather_values(rel, torch.from_numpy(want_keys)),
                jm._gather_values(jrel, want_keys))
    empty = SparseRelation.from_coo(np.zeros((0, 2)), np.zeros(0), (4, 4),
                                    semiring, capacity=3, device="cpu")
    assert_same(m._gather_values(empty, [[1, 2]]),
                jm._gather_values(JRel.from_coo(
                    np.zeros((0, 2)), np.zeros(0), (4, 4), semiring,
                    capacity=3, lib="np"), [[1, 2]]))


# --------------------------------------------------------------------------
# maintain_nonmonotone against the reference
# --------------------------------------------------------------------------


def _solve(jrel, init):
    return np.array(jfx.fixpoint(jrel, init, mode="frontier")[0])


@pytest.mark.parametrize("semiring", LATTICES)
@pytest.mark.parametrize("mode", ["frontier", "jit"])
def test_random_deletes_match_reference(rules, semiring, mode):
    """Random deletes on random graphs: values and resumed rounds equal
    the reference's executor, and the from-scratch answer."""
    jrule, rule = rules(semiring, "delete")
    rng = np.random.default_rng(7)
    changed = 0
    for trial in range(10):
        n = int(rng.integers(8, 40))
        jrel, rel = _random_rel(rng, n, semiring)
        coords, vals = _live_edges(jrel)
        if len(coords) < 2:
            continue
        init = _one_hot(n, int(rng.integers(n)), semiring)
        y_star = _solve(jrel, init)
        k = int(rng.integers(1, min(6, len(coords))))
        sel = rng.choice(len(coords), k, replace=False)
        jnew, new = jrel.delete_keys(coords[sel]), rel.delete_keys(
            coords[sel])
        want, wit = jm.maintain_nonmonotone(jnew, coords[sel], vals[sel],
                                            y_star, init, jrule, mode=mode)
        got, it = maintain_nonmonotone(new, coords[sel], vals[sel], y_star,
                                       init, rule, mode=mode)
        assert_same(got, want)
        assert it == int(np.asarray(wit)), (trial, it, wit)
        assert_same(got, fx.fixpoint(new, torch.from_numpy(init),
                                     mode=mode)[0])
        changed += not np.array_equal(_np(got), y_star)
    assert changed >= 2


@pytest.mark.parametrize("semiring", ("trop", "maxplus"))
def test_increases_match_reference(rules, semiring):
    """Weight increases (delete the old value, merge the new one): the
    increase rule, the merge seeded through delta_seed on top."""
    jrule, rule = rules(semiring, "increase")
    rng = np.random.default_rng(11)
    for trial in range(8):
        n = int(rng.integers(8, 30))
        jrel, rel = _random_rel(rng, n, semiring)
        coords, vals = _live_edges(jrel)
        if len(coords) < 2:
            continue
        init = _one_hot(n, int(rng.integers(n)), semiring)
        y_star = _solve(jrel, init)
        k = int(rng.integers(1, min(4, len(coords))))
        sel = rng.choice(len(coords), k, replace=False)
        bigger = vals[sel] + rng.integers(1, 5, k).astype(np.float32)
        jnew = jrel.delete_keys(coords[sel]).apply_delta(coords[sel],
                                                         bigger)
        new = rel.delete_keys(coords[sel]).apply_delta(coords[sel], bigger)
        jmerge = JRel.from_coo(coords[sel], bigger, jrel.shape, semiring,
                               lib="np")
        want, wit = jm.maintain_nonmonotone(jnew, coords[sel], vals[sel],
                                            y_star, init, jrule,
                                            merge_delta=jmerge)
        got, it = maintain_nonmonotone(new, coords[sel], vals[sel], y_star,
                                       init, rule, merge_delta=_port(jmerge))
        assert_same(got, want)
        assert it == int(np.asarray(wit))
        assert_same(got, fx.fixpoint(new, torch.from_numpy(init),
                                     mode="frontier")[0])


@pytest.mark.parametrize("semiring", LATTICES)
def test_mixed_delete_and_insert_match_reference(rules, semiring):
    """Deletes and ⊕-merges in one batch: the delete rule plus merge
    seeding, on an index both poisoned and overlaid."""
    jrule, rule = rules(semiring, "delete")
    rng = np.random.default_rng(13)
    for trial in range(6):
        n = int(rng.integers(12, 40))
        jrel, rel = _random_rel(rng, n, semiring)
        fx.csr_index(rel)
        fx.csr_index(rel, transpose=True)
        coords, vals = _live_edges(jrel)
        if len(coords) < 3:
            continue
        init = _one_hot(n, int(rng.integers(n)), semiring)
        y_star = _solve(jrel, init)
        sel = rng.choice(len(coords), 2, replace=False)
        add = rng.integers(0, n, (3, 2))
        if semiring == "maxplus":
            add = np.sort(add, axis=1)
            add = add[add[:, 0] < add[:, 1]]
        av = (np.ones(len(add), bool) if semiring == "bool"
              else rng.integers(1, 6, len(add)).astype(np.float32))
        jnew = jrel.delete_keys(coords[sel]).apply_delta(add, av)
        new = rel.delete_keys(coords[sel]).apply_delta(add, av)
        jmerge = JRel.from_coo(add, av, jrel.shape, semiring, lib="np")
        want, wit = jm.maintain_nonmonotone(jnew, coords[sel], vals[sel],
                                            y_star, init, jrule,
                                            merge_delta=jmerge)
        got, it = maintain_nonmonotone(new, coords[sel], vals[sel], y_star,
                                       init, rule, merge_delta=_port(jmerge))
        assert_same(got, want)
        assert it == int(np.asarray(wit))
        assert fx._csr_lookup(new) is not None


@pytest.mark.parametrize("semiring", LATTICES)
def test_batched_matches_per_row_and_reference(rules, semiring):
    """A (B, n) pack with per-row inits equals each row repaired alone
    and the reference's pack, rounds per row included."""
    jrule, rule = rules(semiring, "delete")
    rng = np.random.default_rng(5)
    jrel, rel = _random_rel(rng, 30, semiring, avg_deg=3.0)
    coords, vals = _live_edges(jrel)
    sel = rng.choice(len(coords), 4, replace=False)
    jnew, new = jrel.delete_keys(coords[sel]), rel.delete_keys(coords[sel])
    sources = (0, 7, 19)
    init = np.stack([_one_hot(30, s, semiring) for s in sources])
    prev = np.stack([_solve(jrel, i) for i in init])
    want, wit = jm.maintain_nonmonotone(jnew, coords[sel], vals[sel], prev,
                                        init, jrule)
    got, it = maintain_nonmonotone(new, coords[sel], vals[sel], prev, init,
                                   rule)
    assert_same(got, want)
    assert_same(it, np.asarray(wit, np.int32))
    for i, s in enumerate(sources):
        y1, i1 = maintain_nonmonotone(new, coords[sel], vals[sel], prev[i],
                                      init[i], rule)
        assert_same(got[i], y1)
        assert int(it[i]) == i1


def test_delete_then_reinsert_round_trips(rules):
    """Delete a batch, repair, re-insert the same edges, delta-restart:
    back on the original fixpoint, as in the reference."""
    jrule, rule = rules("trop", "delete")
    rng = np.random.default_rng(3)
    jrel, rel = _random_rel(rng, 25, "trop")
    coords, vals = _live_edges(jrel)
    init = _one_hot(25, 0, "trop")
    y_star = _solve(jrel, init)
    sel = rng.choice(len(coords), 3, replace=False)
    shrunk = rel.delete_keys(coords[sel])
    y_del, _ = maintain_nonmonotone(shrunk, coords[sel], vals[sel], y_star,
                                    init, rule)
    back = shrunk.apply_delta(coords[sel], vals[sel])
    delta = SparseRelation.from_coo(coords[sel], vals[sel], rel.shape,
                                    "trop", device="cpu")
    y_back, it = delta_restart_fixpoint(back, delta, y_del,
                                        mode="frontier")
    assert_same(y_back, y_star)
    jy_del, _ = jm.maintain_nonmonotone(jrel.delete_keys(coords[sel]),
                                        coords[sel], vals[sel], y_star,
                                        init, jrule)
    jback = jrel.delete_keys(coords[sel]).apply_delta(coords[sel],
                                                      vals[sel])
    _, wit = jrestart(jback, JRel.from_coo(coords[sel], vals[sel],
                                           rel.shape, "trop", lib="np"),
                      np.asarray(jy_del), mode="frontier")
    assert it == int(np.asarray(wit))


@pytest.mark.parametrize("cone", ["seeds", "one_hop", "forward"])
def test_other_cones_match_reference(cone):
    """The grammar's other cones (CEGIS refutes or never reaches them)
    walk the index as the reference's: same repair on random deletes."""
    rng = np.random.default_rng(17)
    rule = m.MaintenanceRule("touched", cone, "trop", "delete", True, "")
    jrule = jm.MaintenanceRule("touched", cone, "trop", "delete", True, "")
    for trial in range(5):
        jrel, rel = _random_rel(rng, 30, "trop", avg_deg=3.0)
        coords, vals = _live_edges(jrel)
        sel = rng.choice(len(coords), 3, replace=False)
        init = _one_hot(30, 0, "trop")
        y_star = _solve(jrel, init)
        want, wit = jm.maintain_nonmonotone(jrel.delete_keys(coords[sel]),
                                            coords[sel], vals[sel], y_star,
                                            init, jrule)
        got, it = maintain_nonmonotone(rel.delete_keys(coords[sel]),
                                       coords[sel], vals[sel], y_star,
                                       init, rule)
        assert_same(got, want)
        assert it == int(np.asarray(wit))
        cone = m._cone(rule, torch.from_numpy(y_star), torch.from_numpy(
            coords[sel].astype(np.int64)), torch.from_numpy(vals[sel]),
            rel.delete_keys(coords[sel]), rel.sr())
        assert np.array_equal(cone.numpy(), jm._cone(
            jrule, y_star, coords[sel], vals[sel],
            jrel.delete_keys(coords[sel]), jsr.get("trop", lib="np")))
