"""Shared fixtures of the serve parity tests: the same numpy-seeded
graphs in both packages (the port's relations adopt the reference's
host buffers), and :class:`Pair`, which drives one reference server and
one port server with the same request stream and holds answers,
iteration counts, delivery order and ``stats()`` counters equal."""

import numpy as np
import torch

import jax.numpy as jnp

from repro.core import engine as jengine
from repro.datalog import datasets as jdata
from repro.datalog import programs as jprograms
from repro_torch.core import engine
from repro_torch.datalog import datasets as pdata
from repro_torch.datalog import programs
from repro_torch.sparse.coo import SparseRelation


def port_rel(jrel) -> SparseRelation:
    h = jrel.as_np()
    return SparseRelation.from_buffers(h.coords, h.values, h.nnz, h.shape,
                                       jrel.semiring, device="cpu")


def jmk_bm(a):
    return jprograms.bm(a=a).optimized


def pmk_bm(a):
    return programs.bm(a=a).optimized


def bm_dbs(n=120, seed=2, sparse=True, edges=None):
    """BM's database in both packages: ``erdos_renyi(n, 3.0, seed)``, or
    the given edge list."""
    if edges is None:
        edges = jdata.erdos_renyi(n, 3.0, seed=seed).edges
    g = jdata.Graph(n, np.asarray(edges).reshape(-1, 2))
    schema = jprograms.bm(a=0).original.schema
    je = g.sparse_adjacency() if sparse else g.adjacency()
    jdb = jengine.Database(schema, {"id": n},
                           {"E": je, "V": jnp.ones((n,), bool)})
    pe = port_rel(je) if sparse else torch.from_numpy(np.array(je))
    db = engine.Database(programs.bm(a=0).original.schema, {"id": n},
                         {"E": pe, "V": torch.ones(n, dtype=torch.bool)},
                         "cpu")
    return jdb, db


def bridge_edges(n=80):
    """Two disjoint paths 0..n/2-1 and n/2..n-1: a merge that bridges
    them changes answers visibly."""
    h = n // 2
    return np.concatenate(
        [np.stack([np.arange(0, h - 1), np.arange(1, h)], 1),
         np.stack([np.arange(h, n - 1), np.arange(h + 1, n)], 1)]), h


class Sssp:
    """An integer-weighted SSSP family in both packages: the make
    functions, the databases and the weighted COO override."""

    def __init__(self, n=90, wmax=4, seed=3, deg=3.0, dmax=None):
        dmax = dmax or 12 * wmax
        self.g = jdata.erdos_renyi(n, deg, seed=seed, weighted=True,
                                   wmax=wmax)
        self.n = n
        self.jmk = lambda a: jprograms.sssp(a=a, wmax=wmax,
                                            dmax=dmax).optimized
        self.pmk = lambda a: programs.sssp(a=a, wmax=wmax,
                                           dmax=dmax).optimized
        self.jdb = jprograms.sssp(a=0, wmax=wmax, dmax=dmax).make_db(self.g)
        pg = pdata.Graph(self.g.n, self.g.edges, self.g.weights)
        self.db = programs.sssp(a=0, wmax=wmax, dmax=dmax).make_db(
            pg, device="cpu")
        self.jrel = self.g.sparse_adjacency(semiring="trop")
        self.rel = port_rel(self.jrel)


def _lp_make(irm, prog_mod, schema):
    """``make_program(a)`` of longest paths from ``a`` in maxplus over a
    stored sparse ``W``: LP(x) = [x = a] ⊕ ⊕_y LP(y) ⊗ W(y, x)."""
    def mk(a):
        body = irm.SSP(("x",), (
            irm.Term((irm.PredAtom("eq", ("x", irm.C(a))),), ()),
            irm.Term((irm.RelAtom("LP", ("y",)),
                      irm.RelAtom("W", ("y", "x"))), ("y",))), "maxplus")
        out = prog_mod.Rule("LPans", irm.SSP(("x",), (irm.Term(
            (irm.RelAtom("LP", ("x",)),), ()),), "maxplus"))
        return prog_mod.Program(
            "LP", schema, [prog_mod.Stratum({"LP": prog_mod.Rule(
                "LP", body)})], [out])
    return mk


class LongestPath:
    """A maxplus family in both packages: longest paths over a stored
    sparse acyclic weighted ``W`` (edges u < v, weights 1–5)."""

    def __init__(self, n=80, seed=7, deg=2.5):
        from repro.core import ir as jir
        from repro.core import program as jprog
        from repro.sparse.coo import SparseRelation as JRel
        from repro_torch.core import ir
        from repro_torch.core import program as pprog
        g = jdata.erdos_renyi(n, deg, seed=seed)
        e = g.edges[g.edges[:, 0] < g.edges[:, 1]]
        w = np.random.default_rng(seed).integers(1, 6, len(e)).astype(
            np.float32)
        self.n, self.edges, self.weights = n, e, w
        schemas = []
        for irm in (jir, ir):
            sc = irm.Schema()
            sc.declare("W", ("id", "id"), "maxplus")
            sc.declare("LP", ("id",), "maxplus")
            schemas.append(sc)
        self.jmk = _lp_make(jir, jprog, schemas[0])
        self.pmk = _lp_make(ir, pprog, schemas[1])
        self.jrel = JRel.from_coo(e, w, (n, n), "maxplus")
        self.jdb = jengine.Database(schemas[0], {"id": n}, {"W": self.jrel})
        self.db = engine.Database(schemas[1], {"id": n},
                                  {"W": port_rel(self.jrel)}, "cpu")


def np_of(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_request(jr, pr) -> None:
    assert (jr.family, jr.source) == (pr.family, pr.source)
    assert (jr.error is None) == (pr.error is None), (jr.error, pr.error)
    if jr.error is not None:
        assert jr.error.split(":")[0] == pr.error.split(":")[0]
        return
    want, got = np.asarray(jr.result), np_of(pr.result)
    assert isinstance(pr.result, torch.Tensor)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), (jr.family, jr.source)
    assert jr.iters == pr.iters, (jr.source, jr.iters, pr.iters)


def counters(stats: dict) -> dict:
    """The comparable part of ``stats()``: scalar counters, cache and
    family gauges, histogram sample counts (times differ by design)."""
    out = {k: v for k, v in stats.items() if not isinstance(v, dict)}
    if "compile_cache" in stats:
        out["compile_cache"] = stats["compile_cache"]
    if "latency" in stats:
        out["latency"] = {k: v["count"] for k, v in stats["latency"].items()}
    if "families" in stats:
        out["families"] = stats["families"]
    return out


class Pair:
    """One reference server and one port server fed the same stream."""

    def __init__(self, jserver, pserver):
        self.j, self.p = jserver, pserver
        self.reqs = []          # (jreq, preq) in submission order
        self.delivered = ([], [])

    def register(self, name, jmk, jdb, pmk, pdb, *, jedges=None,
                 pedges=None, **kw):
        jf = self.j.register(name, jmk, jdb, edges=jedges, **kw)
        pf = self.p.register(name, pmk, pdb, edges=pedges, **kw)
        assert jf.backend == pf.backend and jf.n == pf.n
        assert jf.plan.strata[0].runner == pf.plan.strata[0].runner
        return jf, pf

    def _both(self, fn):
        out, errs = [], []
        for s in (self.j, self.p):
            try:
                out.append(fn(s))
                errs.append(None)
            except Exception as e:      # both must refuse alike
                out.append(None)
                errs.append(type(e).__name__)
        assert errs[0] == errs[1], errs
        if errs[0] is not None:
            return None
        self.reqs.append(tuple(out))
        return tuple(out)

    def submit(self, family, source):
        return self._both(lambda s: s.submit(family, source))

    def submit_update(self, family, coords, values=None, op="merge"):
        return self._both(lambda s: s.submit_update(
            family, coords, values, op=op))

    def step(self):
        a, b = self.j.step(), self.p.step()
        self.delivered[0].extend(a)
        self.delivered[1].extend(b)
        return a, b

    def run_until_idle(self) -> int:
        """Step both until idle; returns how many items they delivered."""
        before = len(self.delivered[1])
        while self.j.pending() or self.p.pending():
            self.step()
        assert len(self.delivered[0]) == len(self.delivered[1])
        return len(self.delivered[1]) - before

    def check(self) -> None:
        """Every answer, count and error equal; delivery in the same
        order; the same counters."""
        for jr, pr in self.reqs:
            if hasattr(jr, "source"):
                assert_same_request(jr, pr)
            else:
                assert (jr.applied, jr.error is None, jr.op) == \
                    (pr.applied, pr.error is None, pr.op)
        index = {id(p): i for i, (_, p) in enumerate(self.reqs)}
        jindex = {id(j): i for i, (j, _) in enumerate(self.reqs)}
        assert [jindex[id(r)] for r in self.delivered[0]] == \
            [index[id(r)] for r in self.delivered[1]]
        js = self.j.stats() if callable(self.j.stats) else self.j.stats
        ps = self.p.stats() if callable(self.p.stats) else self.p.stats
        assert counters(ps) == counters(js)
