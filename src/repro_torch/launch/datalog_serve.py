"""Packed-FIFO Datalog° serving over :mod:`repro_torch.serve`.

The counterpart of ``repro/launch/datalog_serve.py``: a shared FIFO of
queries and updates, a packer that groups up to ``max_batch``
same-family queries, and one batched GSN fixpoint per (signature,
B-bucket) answering each pack to *global* convergence — on the card
through the plan runner's batched form (kernel B1 for a
``sparse_frontier_pallas`` plan).  The continuous-batching scheduler
(:class:`repro_torch.serve.ContinuousServer`) steps persistent slot
pools instead; ``DatalogServer`` is the stable packed-FIFO API and the
baseline the scheduler is measured against.

All family machinery is shared with :mod:`repro_torch.serve.family`:
registration and planning, per-request init evaluation, and the
streaming-update path.  Answers are tensors on the family's device; the
warm-answer store and the compiled-runner cache are capacity-bounded
LRUs (``warm_answers=`` / ``compiled_cache=``).  A batch with exactly
one live request on a CPU family routes down the planner's per-source
worklist (:func:`repro_torch.serve.family.latency_serve`).

FGH families: :func:`fgh_make_program` derives Π₂ from a Π₁ benchmark
*twice* at distinct placeholder sources and diffs the results to locate
the source-constant sites, so one synthesis run serves every source; if
the diff is ambiguous it falls back to re-optimizing per source.

Graph-sharded serving: ``mesh=`` a :class:`~repro_torch.launch.mesh.
GraphMesh` offers every family's plan the mesh's ranks; a family whose
plan picks ``sparse_sharded`` is served from its ``ShardedRelation`` on
every rank (one server per rank, each fed the same requests), with no
latency route.

Query-batch serving: ``mesh=`` a :class:`~repro_torch.launch.mesh.
ShardMesh` (``make_datalog_mesh(d)``) installs ``make_rules(mesh,
"datalog")``.  Every rank packs the same batch (one server per rank,
each fed the same requests); ``sharding.put(packed, ("query_batch",
"vertex"))`` gives the rank its rows — a block where the bucket divides
d, the whole batch where it does not, as ``spec_for`` decides — the
batched fixpoint runs on those rows, and ``y`` and the per-row
iteration counts are all-gathered over ``"data"``.  Answers, counts,
delivery order and ``stats`` are the one-device server's (no latency
route, as for any mesh).

    PYTHONPATH=src python -m repro_torch.launch.datalog_serve   # GPU
    PYTHONPATH=src python -m repro_torch.launch.datalog_serve --device cpu
"""

from __future__ import annotations

import argparse
import collections
import time
from typing import Callable

import numpy as np

from repro_torch.core import engine, ir, planner, verify
from repro_torch.core.program import Program
from repro_torch.device import resolve
from repro_torch.serve import family as fam_mod
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.family import (Family as _Family, QueryRequest,
                                      UpdateRequest, bucket as _bucket)

__all__ = ["DatalogServer", "QueryRequest", "UpdateRequest",
           "fgh_make_program", "_bucket"]


def _is_graph_mesh(mesh) -> bool:
    # imported here: a server without a mesh never loads torch.distributed
    from repro_torch.launch.mesh import GraphMesh, ShardMesh
    if isinstance(mesh, GraphMesh):
        return True
    if not isinstance(mesh, ShardMesh) or "data" not in mesh.axis_names:
        raise TypeError(f"DatalogServer(mesh=) takes a GraphMesh "
                        f"(make_graph_mesh) or a ShardMesh with a 'data' "
                        f"axis (make_datalog_mesh), not {mesh!r}")
    return False


class DatalogServer:
    """Request-queue serve loop over batched GSN fixpoints."""

    def __init__(self, *, max_batch: int = 64, mesh=None,
                 max_iters: int = 10_000, warm_answers: int = 256,
                 compiled_cache: int = 32):
        self.mesh = mesh
        # a GraphMesh partitions the vertex axis; a ShardMesh shards the
        # query-batch axis over "data"
        graph = mesh is not None and _is_graph_mesh(mesh)
        self.graph_mesh = mesh if graph else None
        self.graph_d = mesh.d if graph else 1
        self.rules = None
        if mesh is not None and not graph:
            from repro_torch.launch.rules import make_rules
            self.rules = make_rules(mesh, "datalog")
        self.max_batch = max_batch
        self.max_iters = max_iters
        self.warm_answers = warm_answers
        self._families: dict[str, _Family] = {}
        self._queue: collections.deque = collections.deque()
        self._compiled = LRUCache(compiled_cache)
        self.stats = {"served": 0, "failed": 0, "batches": 0,
                      "padded_rows": 0, "cache_hits": 0,
                      "cache_misses": 0, "cache_evictions": 0,
                      "updates": 0, "warm_hits": 0,
                      "answers_repaired": 0, "answers_dropped": 0,
                      "latency_routed": 0}

    # -- registration -------------------------------------------------------

    def register(self, name: str, make_program: Callable[[int], Program],
                 db: engine.Database, *, edges=None,
                 template_source: int = 0) -> _Family:
        """Register a family of source-parameterized Π₂ programs
        (:func:`repro_torch.serve.family.build_family`)."""
        fam = fam_mod.build_family(
            name, make_program, db, edges=edges,
            template_source=template_source, graph_mesh=self.graph_mesh,
            max_iters=self.max_iters, warm_answers=self.warm_answers)
        self._families[name] = fam
        return fam

    # -- request queue ------------------------------------------------------

    def submit(self, family: str, source: int) -> QueryRequest:
        if family not in self._families:
            raise KeyError(f"unknown family {family!r}; "
                           f"registered: {sorted(self._families)}")
        req = QueryRequest(family, int(source),
                           submitted_s=time.perf_counter())
        self._queue.append(req)
        return req

    def submit_update(self, family: str, coords, values=None, *,
                      op: str = "merge") -> UpdateRequest:
        """Enqueue a batch of edge mutations behind every already-queued
        request (FIFO: queries submitted after this update are never
        answered from the pre-update graph)."""
        if family not in self._families:
            raise KeyError(f"unknown family {family!r}; "
                           f"registered: {sorted(self._families)}")
        if op not in ("merge", "delete", "increase"):
            raise ValueError(f"unknown update op {op!r}")
        if op == "increase" and values is None:
            raise ValueError("op='increase' needs the new (larger) values")
        req = UpdateRequest(family,
                            np.atleast_2d(np.asarray(coords, np.int64)),
                            None if values is None
                            else np.asarray(values).reshape(-1), op,
                            submitted_s=time.perf_counter())
        self._queue.append(req)
        return req

    def pending(self) -> int:
        return len(self._queue)

    def step(self) -> list:
        """Process the queue head: a run of updates is applied (and the
        family's warm answers repaired) in one pass; a query is packed
        with up to ``max_batch - 1`` later same-family queries — but
        never past an intervening same-family update, which would let a
        pre-update answer overtake an acknowledged mutation."""
        if not self._queue:
            return []
        lead = self._queue.popleft()
        if isinstance(lead, UpdateRequest):
            ups = [lead]
            while (self._queue
                   and isinstance(self._queue[0], UpdateRequest)
                   and self._queue[0].family == lead.family
                   and self._queue[0].op == lead.op):
                ups.append(self._queue.popleft())
            fam_mod.apply_updates(self._families[lead.family], ups,
                                  self.stats, graph_mesh=self.graph_mesh)
            return ups
        batch = [lead]
        rest: collections.deque = collections.deque()
        while self._queue and len(batch) < self.max_batch:
            req = self._queue.popleft()
            if isinstance(req, UpdateRequest) and req.family == lead.family:
                # fence: no later same-family query may join this batch,
                # so nothing further can be packed — stop scanning
                rest.append(req)
                break
            if isinstance(req, QueryRequest) and req.family == lead.family:
                batch.append(req)
            else:
                rest.append(req)
        self._queue = rest + self._queue
        return self._serve_batch(self._families[lead.family], batch)

    def _serve_batch(self, fam: _Family, batch: list) -> list:
        live, inits = [], []
        started = time.perf_counter()
        for r in batch:
            # the batch was taken off the queue: the request's queue
            # time ends here (the packed run is its compute time)
            r.admitted_s = started
            warm = fam.answers.get(r.source)
            if warm is not None:
                r.result = warm
                r.iters = 0
                r.done_s = time.perf_counter()
                self.stats["warm_hits"] += 1
                self.stats["served"] += 1
                continue
            try:
                inits.append(fam_mod.family_init(fam, r.source))
                live.append(r)
            except Exception as e:  # bad source must not strand the batch
                r.error = f"{type(e).__name__}: {e}"
                r.done_s = time.perf_counter()
                self.stats["failed"] += 1
        if not live:
            self.stats["batches"] += 1
            return batch
        if len(live) == 1 and self.mesh is None:
            # single-slot requests skip the (1, n) batched fixpoint for
            # the planner's per-source latency path (B=1 regression fix)
            out = fam_mod.latency_serve(fam, inits[0])
            if out is not None:
                req = live[0]
                req.result, req.iters = out
                req.done_s = time.perf_counter()
                self._remember(fam, req.source, req.result)
                self.stats["latency_routed"] += 1
                self.stats["served"] += 1
                self.stats["batches"] += 1
                return batch
        bb = _bucket(len(live), self.max_batch)
        packed = fam_mod.inits_on(fam, inits, bb)
        self.stats["padded_rows"] += bb - len(live)

        operand = fam.sharded if fam.sharded is not None else fam.edges
        if self.rules is not None:
            y, iters = self._run_on_data_mesh(fam, operand, packed)
        else:
            y, iters = self._compiled_fixpoint(fam, bb)(operand, packed)
        # the counts' host read waits for the run: done_s follows it
        iters = iters.cpu().numpy()
        now = time.perf_counter()
        for i, req in enumerate(live):
            req.result = y[i]
            req.iters = int(iters[i])
            req.converged_s = req.done_s = now
            self._remember(fam, req.source, y[i])
        self.stats["served"] += len(live)
        self.stats["batches"] += 1
        return batch

    def run_until_idle(self) -> int:
        done = 0
        while self._queue:
            done += len(self.step())
        return done

    # -- internals ----------------------------------------------------------

    def _remember(self, fam: _Family, source: int, y) -> None:
        fam.answers.put(source, y)

    def _run_on_data_mesh(self, fam: _Family, operand, packed):
        """This rank's rows of ``packed`` through the batched fixpoint,
        and every rank's rows of ``y`` and the counts gathered back."""
        from repro_torch.distributed import sharding as sh
        with sh.use_rules(self.mesh, self.rules):
            logical = ("query_batch", "vertex")
            spec = sh.spec_for(logical, tuple(packed.shape))
            rows = sh.put(packed, logical).contiguous()
        y, iters = self._compiled_fixpoint(fam, rows.shape[0])(operand, rows)
        return (sh.gather_block(y, spec, self.mesh),
                sh.gather_block(iters, sh.P(spec[0]), self.mesh))

    def _compiled_fixpoint(self, fam: _Family, bb: int) -> Callable:
        key = (fam.plan.signature, bb, self.graph_d)
        run = self._compiled.get(key)
        if run is not None:
            self.stats["cache_hits"] += 1
            return run
        self.stats["cache_misses"] += 1
        run = planner.compile_batched(fam.plan, max_iters=fam.max_iters)
        self._compiled.put(key, run)
        self.stats["cache_evictions"] = self._compiled.evictions
        return run


# --------------------------------------------------------------------------
# FGH routing: synthesize Π₂ once, serve every source
# --------------------------------------------------------------------------


def fgh_make_program(make_bench, edbs: list[str], *,
                     placeholders: tuple[int, int] = (0, 1),
                     rng=None) -> Callable[[int], Program]:
    """Derive Π₂ from a Π₁ benchmark family with the FGH optimizer and
    return a ``make_program(source)`` suitable for
    :meth:`DatalogServer.register`.

    ``make_bench(source)`` builds the :class:`~repro_torch.datalog.programs.Bench`
    for a source vertex.  The optimizer runs (and fully verifies) at the
    two placeholder sources; diffing the two derived programs pinpoints
    exactly which constants are the query source, so serving source ``s``
    is a constant substitution, not a re-synthesis.  When the diff is
    structurally ambiguous (normalization reordered terms between the
    runs) the returned function falls back to re-optimizing per source,
    memoized.
    """
    from repro_torch.core import fgh

    derived = {}
    for p in placeholders:
        b = make_bench(p)
        task = verify.task_from_program(b.original, edbs,
                                        constraint=b.constraint)
        rep = fgh.optimize(task, rng=rng or np.random.default_rng(0))
        if not rep.ok:
            raise RuntimeError(f"FGH synthesis failed for source {p}: "
                               f"{rep.stats}")
        if b.original.post is not None:
            rep.program.post = b.original.post
        derived[p] = rep.program
    p0, p1 = placeholders
    # serve only p0's derivation directly; p1 (like every other source)
    # goes through substitution so served programs share p0's variable
    # names — derived[p1] exists purely to locate the source constants
    cache: dict[int, Program] = {p0: derived[p0]}

    def make_program(source: int) -> Program:
        if source in cache:
            return cache[source]
        try:
            prog = _subst_sources(derived[p0], derived[p1],
                                  placeholders, source)
        except ValueError:
            b = make_bench(source)
            task = verify.task_from_program(b.original, edbs,
                                            constraint=b.constraint)
            rep = fgh.optimize(task, rng=np.random.default_rng(0))
            if not rep.ok:
                raise RuntimeError(
                    f"FGH synthesis failed for source {source}")
            if b.original.post is not None:
                rep.program.post = b.original.post
            prog = rep.program
        cache[source] = prog
        return prog

    return make_program


def _subst_sources(prog0: Program, prog1: Program,
                   placeholders: tuple[int, int], source: int) -> Program:
    """Rebuild ``prog0`` with every constant site where ``prog0`` and
    ``prog1`` disagree (and agree with the respective placeholders)
    replaced by ``source``.  Variable-name differences (fresh-counter
    drift between the two synthesis runs) are ignored; any structural
    mismatch raises ``ValueError``."""
    from repro_torch.core.program import Rule, Stratum

    def walk_args(a0, a1):
        out = []
        for x0, x1 in zip(a0.args, a1.args):
            c0, c1 = isinstance(x0, ir.C), isinstance(x1, ir.C)
            if c0 != c1:
                raise ValueError("const/var mismatch")
            if c0 and x0.value != x1.value:
                if (x0.value, x1.value) != placeholders:
                    raise ValueError(
                        f"differing constants {x0}/{x1} are not the "
                        f"placeholder pair {placeholders}")
                out.append(ir.C(source))
            else:
                out.append(x0)
        return tuple(out)

    def walk_atom(a0, a1):
        if type(a0) is not type(a1):
            raise ValueError("atom type mismatch")
        if isinstance(a0, ir.RelAtom):
            if (a0.name, a0.cast, a0.neg) != (a1.name, a1.cast, a1.neg):
                raise ValueError("rel atom mismatch")
            return ir.RelAtom(a0.name, walk_args(a0, a1), a0.cast, a0.neg)
        if isinstance(a0, ir.PredAtom):
            if a0.pred != a1.pred:
                raise ValueError("pred mismatch")
            return ir.PredAtom(a0.pred, walk_args(a0, a1))
        if isinstance(a0, ir.ValFnAtom):
            if a0.fn != a1.fn:
                raise ValueError("valfn mismatch")
            return ir.ValFnAtom(a0.fn, walk_args(a0, a1))
        if isinstance(a0, ir.ConstAtom):
            if a0.value != a1.value:
                raise ValueError("semiring constants differ between "
                                 "placeholder derivations")
            return a0
        return a0  # ValAtom: var names may drift, keep prog0's

    def walk_ssp(e0, e1):
        if (len(e0.terms) != len(e1.terms)
                or len(e0.head) != len(e1.head)
                or e0.semiring != e1.semiring):
            raise ValueError("SSP shape mismatch")
        terms = []
        for t0, t1 in zip(e0.terms, e1.terms):
            if len(t0.atoms) != len(t1.atoms) \
                    or len(t0.bound) != len(t1.bound):
                raise ValueError("term shape mismatch")
            terms.append(ir.Term(
                tuple(walk_atom(a0, a1)
                      for a0, a1 in zip(t0.atoms, t1.atoms)), t0.bound))
        return ir.SSP(e0.head, tuple(terms), e0.semiring)

    strata = []
    for s0, s1 in zip(prog0.strata, prog1.strata):
        if tuple(s0.rules) != tuple(s1.rules):
            raise ValueError("stratum IDB mismatch")
        rules = {n: Rule(n, walk_ssp(s0.rules[n].body, s1.rules[n].body))
                 for n in s0.rules}
        init = None
        if s0.init is not None:
            if s1.init is None or set(s0.init) != set(s1.init):
                raise ValueError("stratum init mismatch")
            init = {n: walk_ssp(s0.init[n], s1.init[n]) for n in s0.init}
        strata.append(Stratum(rules, init=init))
    if len(prog0.strata) != len(prog1.strata) \
            or len(prog0.outputs) != len(prog1.outputs):
        raise ValueError("program shape mismatch")
    outputs = [Rule(r0.head, walk_ssp(r0.body, r1.body))
               for r0, r1 in zip(prog0.outputs, prog1.outputs)]
    return Program(prog0.name, prog0.schema, strata, outputs,
                   post=prog0.post, sort_hints=dict(prog0.sort_hints))


# --------------------------------------------------------------------------
# CLI demo
# --------------------------------------------------------------------------


def main():
    from repro_torch.datalog import datasets, programs

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="'cpu' to serve on the CPU (default: the GPU)")
    ap.add_argument("--fgh", action="store_true",
                    help="derive Π₂ with the FGH optimizer instead of "
                         "using the published rewrite")
    args = ap.parse_args()

    dev = resolve(args.device)
    g = datasets.powerlaw(args.n, 4, seed=0)
    b0 = programs.bm(a=0)
    db = engine.Database(b0.original.schema, {"id": g.n},
                         {"E": g.sparse_adjacency(device=dev),
                          "V": g.vertex_set(device=dev)}, dev)
    server = DatalogServer(max_batch=args.max_batch)
    if args.fgh:
        make_program = fgh_make_program(
            lambda a: programs.bm(a=a), ["E", "V"])
    else:
        make_program = lambda a: programs.bm(a=a).optimized
    server.register("reach", make_program, db)

    rng = np.random.default_rng(0)
    reqs = [server.submit("reach", int(s))
            for s in rng.integers(0, g.n, args.requests)]
    t0 = time.perf_counter()
    server.run_until_idle()
    dt = time.perf_counter() - t0
    lat = sorted(r.latency_s for r in reqs)
    print(f"served {server.stats['served']} queries on {dev} in {dt:.3f}s "
          f"({server.stats['served'] / dt:.1f} qps, "
          f"{server.stats['batches']} batches, "
          f"compile cache {server.stats['cache_hits']} hits / "
          f"{server.stats['cache_misses']} misses)")
    print(f"latency p50 {lat[len(lat) // 2] * 1e3:.1f} ms  "
          f"p99 {lat[int(len(lat) * 0.99)] * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
