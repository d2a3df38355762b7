"""Continuous-batching serve scheduler.

The counterpart of ``repro/serve/scheduler.py``.
:class:`ContinuousServer` replaces the packed-FIFO serving shape (pack a
batch, run it to *global* convergence, answer, repeat) with the loop
the per-row convergence masks were built for:

* one persistent :class:`~repro_torch.serve.slots.SlotPool` per
  registered family holds a live ``(B, n)`` fixpoint on the family's
  device; each scheduling round steps it a bounded chunk of rounds,
  **evicts** rows whose mask fired, and **admits** queued sources into
  the freed slots by splicing their init rows — the batch never waits
  for its slowest row, and the runner's chunk function is reused across
  the request stream (cache key ``(plan.signature, backend, B-bucket,
  D)``, the backend from :func:`repro_torch.core.planner.
  spmm_exec_backend` on the family's device);
* **admission control**: each family's queue is bounded; ``submit``
  raises :class:`BackpressureError` (and counts a shed) past the limit;
* **fairness**: weighted round-robin over families — every scheduling
  round gives each family with work ``weight`` step-quanta;
* **update fencing**: queries and updates share one FIFO per family; a
  queued update blocks later same-family admissions, applies once the
  pool drains, then reopens admission;
* **FIFO-per-family delivery** through a per-family reorder buffer;
* **single-request latency routing**: a lone query with an idle pool on
  a CPU family runs the planner's per-source worklist
  (:func:`repro_torch.serve.family.latency_serve`); on the card it
  takes the pool;
* **metrics**: queue/compute/total latency of every request into the
  streaming histograms of :mod:`repro_torch.serve.metrics`.  A
  ``converged_s`` stamp always follows a host read of the work it
  times — the pool's live mask after its chunk, or the iteration counts
  of a packed run — so on the card the histograms measure the device's
  work, not its enqueue.

Families whose operator is dense or graph-sharded have no row splice
(a dense runner carries no per-row state the host can cheaply edit; a
sharded operand lives partitioned over the mesh's ranks); they fall
back to packed whole-run serving inside this scheduler.  A server made
with ``graph_mesh=`` (a :class:`~repro_torch.launch.mesh.GraphMesh`)
offers every family's plan the mesh, as ``DatalogServer(mesh=)`` does.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from repro_torch.core import engine, planner
from repro_torch.serve import family as fam_mod
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.family import (Family, QueryRequest, UpdateRequest,
                                      bucket)
from repro_torch.serve.metrics import FrontierMetrics, RequestMetrics
from repro_torch.serve.slots import SlotPool
from repro_torch.sparse.coo import SparseRelation


class BackpressureError(RuntimeError):
    """Raised by ``submit`` when a family's queue is at its bound."""

    def __init__(self, family: str, depth: int, limit: int):
        super().__init__(
            f"family {family!r} queue at {depth}/{limit}: request shed "
            f"(retry with backoff or raise queue_limit)")
        self.family = family
        self.depth = depth
        self.limit = limit


@dataclasses.dataclass
class _FamilyState:
    fam: Family
    weight: int
    queue: collections.deque = dataclasses.field(
        default_factory=collections.deque)
    pool: SlotPool | None = None
    seq: int = 0                 # next submission sequence number
    next_deliver: int = 0        # FIFO delivery cursor
    done: dict = dataclasses.field(default_factory=dict)
    served: int = 0
    frontier: FrontierMetrics = dataclasses.field(
        default_factory=FrontierMetrics)


class ContinuousServer:
    """Slot-based continuous batching over registered program families."""

    def __init__(self, *, max_batch: int = 64, chunk_iters: int = 4,
                 queue_limit: int = 1024, warm_answers: int = 256,
                 compiled_cache: int = 32, max_iters: int = 10_000,
                 host_kernels: bool = True, graph_mesh=None):
        if max_batch < 1 or chunk_iters < 1 or queue_limit < 1:
            raise ValueError("max_batch, chunk_iters and queue_limit "
                             "must be >= 1")
        self.max_batch = max_batch
        self.chunk_iters = chunk_iters
        self.queue_limit = queue_limit
        self.warm_answers = warm_answers
        self.max_iters = max_iters
        self.host_kernels = host_kernels
        self.graph_mesh = graph_mesh
        self.graph_d = 1 if graph_mesh is None else graph_mesh.d
        self._families: dict[str, _FamilyState] = {}
        self._compiled = LRUCache(compiled_cache)
        self.metrics = RequestMetrics()
        self._counters = {
            "served": 0, "failed": 0, "shed": 0, "updates": 0,
            "warm_hits": 0, "answers_repaired": 0, "answers_dropped": 0,
            "admitted": 0, "evicted": 0, "chunks": 0, "migrated": 0,
            "latency_routed": 0, "packed_fallback": 0,
        }

    # -- registration -------------------------------------------------------

    def register(self, name: str, make_program, db: engine.Database, *,
                 edges=None, template_source: int = 0,
                 weight: int = 1) -> Family:
        """Register a family (see :func:`repro_torch.serve.family.
        build_family`) with a fairness ``weight``: step-quanta per
        scheduling round."""
        if weight < 1:
            raise ValueError(f"weight must be >= 1, got {weight}")
        fam = fam_mod.build_family(
            name, make_program, db, edges=edges,
            template_source=template_source, graph_mesh=self.graph_mesh,
            max_iters=self.max_iters, warm_answers=self.warm_answers)
        self._families[name] = _FamilyState(fam, weight)
        return fam

    # -- submission ---------------------------------------------------------

    def _state(self, family: str) -> _FamilyState:
        if family not in self._families:
            raise KeyError(f"unknown family {family!r}; "
                           f"registered: {sorted(self._families)}")
        return self._families[family]

    def submit(self, family: str, source: int) -> QueryRequest:
        fs = self._state(family)
        if len(fs.queue) >= self.queue_limit:
            self._counters["shed"] += 1
            raise BackpressureError(family, len(fs.queue),
                                    self.queue_limit)
        req = QueryRequest(family, int(source),
                           submitted_s=time.perf_counter())
        req._seq = fs.seq
        fs.seq += 1
        fs.queue.append(req)
        return req

    def submit_update(self, family: str, coords, values=None, *,
                      op: str = "merge") -> UpdateRequest:
        """Updates share the family FIFO with queries (fencing) and are
        never shed — dropping an acknowledged mutation would silently
        fork the graph state."""
        fs = self._state(family)
        if op not in ("merge", "delete", "increase"):
            raise ValueError(f"unknown update op {op!r}")
        if op == "increase" and values is None:
            raise ValueError("op='increase' needs the new (larger) values")
        req = UpdateRequest(family,
                            np.atleast_2d(np.asarray(coords, np.int64)),
                            None if values is None
                            else np.asarray(values).reshape(-1), op,
                            submitted_s=time.perf_counter())
        req._seq = fs.seq
        fs.seq += 1
        fs.queue.append(req)
        return req

    def pending(self) -> int:
        return sum(len(fs.queue) + (fs.pool.occupied if fs.pool else 0)
                   for fs in self._families.values())

    # -- the scheduling loop ------------------------------------------------

    def step(self) -> list:
        """One scheduling round: per family (weighted), apply due
        updates, admit into free slots, step one chunk, harvest fired
        rows.  Returns the requests *delivered* this round (FIFO per
        family)."""
        delivered: list = []
        for fs in self._families.values():
            for _ in range(fs.weight):
                self._apply_due_updates(fs, delivered)
                self._admit(fs, delivered)
                if fs.pool is None or fs.pool.occupied == 0:
                    break
                fs.pool.step(self.chunk_iters)
                self._counters["chunks"] += 1
                fs.frontier.record(fs.pool.frontier_nnz(),
                                   fs.pool.frontier_density())
                self._harvest(fs, delivered)
        return delivered

    def run_until_idle(self) -> int:
        """Drive ``step`` until every queue and pool is empty; returns
        the number of requests delivered."""
        done = 0
        while self.pending():
            before = (self._counters["chunks"], self._counters["admitted"],
                      self._counters["updates"])
            n = len(self.step())
            done += n
            after = (self._counters["chunks"], self._counters["admitted"],
                     self._counters["updates"])
            assert n or after != before or not self.pending(), \
                "scheduler made no progress"
        return done

    drain = run_until_idle

    # -- internals ----------------------------------------------------------

    def _apply_due_updates(self, fs: _FamilyState, delivered: list):
        """The update fence: a queued update waits for the pool to drain
        (every earlier query was admitted before it), applies, then
        reopens admission for the queries behind it."""
        while (fs.queue and isinstance(fs.queue[0], UpdateRequest)
               and (fs.pool is None or fs.pool.occupied == 0)):
            lead = fs.queue.popleft()
            ups = [lead]
            while (fs.queue and isinstance(fs.queue[0], UpdateRequest)
                   and fs.queue[0].op == lead.op):
                ups.append(fs.queue.popleft())
            fam_mod.apply_updates(fs.fam, ups, self._counters,
                                  graph_mesh=self.graph_mesh)
            # the operator changed: steppers index stale edge buffers,
            # so the pool is rebuilt lazily on next admission
            fs.pool = None
            for u in ups:
                self._publish(fs, u, delivered)

    def _head_run(self, fs: _FamilyState) -> int:
        """How many queries are admissible before the next fence."""
        n = 0
        for item in fs.queue:
            if not isinstance(item, QueryRequest):
                break
            n += 1
        return n

    def _admit(self, fs: _FamilyState, delivered: list) -> None:
        fam = fs.fam
        while fs.queue and isinstance(fs.queue[0], QueryRequest):
            req = fs.queue[0]
            now = time.perf_counter()
            warm = fam.answers.get(req.source)
            if warm is not None:
                fs.queue.popleft()
                req.admitted_s = req.converged_s = now
                req.result = warm
                req.iters = 0
                self._counters["warm_hits"] += 1
                self._finish(fs, req, delivered)
                continue
            try:
                init = fam_mod.family_init(fam, req.source)
            except Exception as e:  # bad source must not strand the rest
                fs.queue.popleft()
                req.error = f"{type(e).__name__}: {e}"
                req.admitted_s = req.converged_s = now
                self._counters["failed"] += 1
                self._finish(fs, req, delivered)
                continue
            poolable = (isinstance(fam.edges, SparseRelation)
                        and fam.sharded is None)
            run_len = self._head_run(fs)
            idle = fs.pool is None or fs.pool.occupied == 0
            if run_len == 1 and idle:
                y = fam_mod.latency_serve(fam, init)
                if y is not None:
                    fs.queue.popleft()
                    req.admitted_s = now
                    req.result, req.iters = y
                    req.converged_s = time.perf_counter()
                    self._counters["latency_routed"] += 1
                    self._remember(fam, req.source, req.result)
                    self._finish(fs, req, delivered)
                    continue
            if not poolable:
                self._serve_packed(fs, delivered)
                continue
            occ = fs.pool.occupied if fs.pool is not None else 0
            want = bucket(max(run_len + occ, 2), self.max_batch)
            if fs.pool is not None and occ and fs.pool.b < want:
                # demand outgrew an undersized pool (built during the
                # first trickle of a burst): rebuild at the larger
                # bucket and re-splice the in-flight rows from their
                # inits.  A restarted row's trajectory is identical
                # (the splice is the cold GSN seed), and the few
                # restarts at ramp-up are far cheaper than letting the
                # pool drain serially — a continuously-refilled pool
                # never hits occupied == 0.
                live = [r for r in fs.pool.slots if r is not None]
                fs.pool = None
                self._ensure_pool(fs, want)
                self._counters["migrated"] += len(live)
                for lr in live:
                    linit = fam_mod.family_init(fam, lr.source)
                    if not fs.pool.admit(lr, linit):
                        self._serve_solo(fs, lr, linit, delivered)
            else:
                self._ensure_pool(fs, want)
            if fs.pool.free_slots == 0:
                break
            req.admitted_s = now
            if not fs.pool.admit(req, init):
                # the stepper cannot encode this init — solo fallback
                fs.queue.popleft()
                self._serve_solo(fs, req, init, delivered)
                continue
            fs.queue.popleft()
            self._counters["admitted"] += 1

    def _ensure_pool(self, fs: _FamilyState, want: int) -> None:
        # grow-only: a pool bigger than current demand is kept (free
        # lanes are near-free; rebuilding costs an edge re-sort), so a
        # stream's tail doesn't thrash 64 → 32 → … → 2 rebuilds
        if fs.pool is not None and (fs.pool.occupied > 0
                                    or fs.pool.b >= want):
            return
        fam = fs.fam

        def chunk_fn_factory(b=want):
            # the chunk is the plan runner's serve_chunk_fn, keyed on the
            # SpMM backend it resolves to on the family's device
            runner = fam.plan.strata[0].runner
            be = planner.spmm_exec_backend(runner, fam.edges.device)
            key = (fam.plan.signature, be, b, 1)
            fn = self._compiled.get(key)
            if fn is None:
                from repro_torch.core import runners as runners_mod
                fn = runners_mod.get(runner).serve_chunk_fn(
                    self.chunk_iters)
                self._compiled.put(key, fn)
            return fn

        fs.pool = SlotPool(fam, want, host_kernels=self.host_kernels,
                           chunk_fn_factory=chunk_fn_factory)

    def _harvest(self, fs: _FamilyState, delivered: list) -> None:
        for req, y, iters in fs.pool.harvest():
            req.converged_s = time.perf_counter()
            req.result = y
            req.iters = iters
            self._counters["evicted"] += 1
            self._remember(fs.fam, req.source, y)
            self._finish(fs, req, delivered)

    def _serve_solo(self, fs: _FamilyState, req: QueryRequest, init,
                    delivered: list) -> None:
        """A request no stepper can host: the per-source latency path,
        else a one-row packed run."""
        req.admitted_s = time.perf_counter()
        y = fam_mod.latency_serve(fs.fam, init)
        if y is not None:
            req.result, req.iters = y
            self._counters["latency_routed"] += 1
        else:
            y, iters = self._packed_run(
                fs.fam, fam_mod.inits_on(fs.fam, [init]))
            req.result, req.iters = y[0], int(iters[0])
        req.converged_s = time.perf_counter()
        self._remember(fs.fam, req.source, req.result)
        self._finish(fs, req, delivered)

    def _serve_packed(self, fs: _FamilyState, delivered: list) -> None:
        """Whole-run fallback for dense and sharded operators (no row
        splice): behaves like one packed-FIFO batch."""
        self._counters["packed_fallback"] += 1
        fam = fs.fam
        batch, inits = [], []
        while (fs.queue and isinstance(fs.queue[0], QueryRequest)
               and len(batch) < self.max_batch):
            req = fs.queue.popleft()
            req.admitted_s = time.perf_counter()
            warm = fam.answers.get(req.source)
            if warm is not None:
                req.result, req.iters = warm, 0
                req.converged_s = req.admitted_s
                self._counters["warm_hits"] += 1
                self._finish(fs, req, delivered)
                continue
            try:
                inits.append(fam_mod.family_init(fam, req.source))
                batch.append(req)
            except Exception as e:
                req.error = f"{type(e).__name__}: {e}"
                req.converged_s = req.admitted_s
                self._counters["failed"] += 1
                self._finish(fs, req, delivered)
        if not batch:
            return
        packed = fam_mod.inits_on(fam, inits,
                                  bucket(len(batch), self.max_batch))
        y, iters = self._packed_run(fam, packed)
        now = time.perf_counter()
        for i, req in enumerate(batch):
            req.result = y[i]
            req.iters = int(iters[i])
            req.converged_s = now
            self._remember(fam, req.source, y[i])
            self._finish(fs, req, delivered)

    def _packed_run(self, fam: Family, packed):
        """One ``(bb, n)`` pack to convergence: the answers stay on the
        family's device; the iteration counts come to the host, and that
        read is what the caller's ``converged_s`` stamp follows."""
        be = planner.spmm_exec_backend(fam.plan.strata[0].runner,
                                       packed.device)
        key = ("packed", fam.plan.signature, be, packed.shape[0],
               self.graph_d)
        run = self._compiled.get(key)
        if run is None:
            run = planner.compile_batched(fam.plan,
                                          max_iters=fam.max_iters)
            self._compiled.put(key, run)
        operand = fam.sharded if fam.sharded is not None else fam.edges
        y, iters = run(operand, packed)
        return y, iters.cpu().numpy()

    def _remember(self, fam: Family, source: int, y) -> None:
        fam.answers.put(source, y)

    # -- delivery & metrics -------------------------------------------------

    def _finish(self, fs: _FamilyState, req: QueryRequest,
                delivered: list) -> None:
        """A query's answer is ready; publish it and everything behind
        it that was already waiting (FIFO per family)."""
        if req.error is None:
            fs.served += 1
            self._counters["served"] += 1
        self._publish(fs, req, delivered)

    def _publish(self, fs: _FamilyState, item, delivered: list) -> None:
        fs.done[item._seq] = item
        while fs.next_deliver in fs.done:
            out = fs.done.pop(fs.next_deliver)
            fs.next_deliver += 1
            out.done_s = time.perf_counter()
            if isinstance(out, QueryRequest):
                self.metrics.total.record(out.latency_s)
                if out.admitted_s:
                    self.metrics.queue.record(
                        out.admitted_s - out.submitted_s)
                if out.converged_s and out.admitted_s:
                    self.metrics.compute.record(
                        out.converged_s - out.admitted_s)
            delivered.append(out)

    def stats(self) -> dict:
        """Counters, cache stats, latency percentiles, family gauges."""
        out = dict(self._counters)
        out["compile_cache"] = {"size": len(self._compiled),
                                "hits": self._compiled.hits,
                                "misses": self._compiled.misses,
                                "evictions": self._compiled.evictions}
        out["latency"] = self.metrics.summary()
        out["families"] = {
            name: {"queue_depth": len(fs.queue),
                   "in_flight": fs.pool.occupied if fs.pool else 0,
                   "pool_b": fs.pool.b if fs.pool else 0,
                   "served": fs.served,
                   "weight": fs.weight,
                   "warm_answers": len(fs.fam.answers),
                   "warm_evictions": fs.fam.answers.evictions,
                   "frontier": fs.frontier.summary()}
            for name, fs in self._families.items()}
        return out
