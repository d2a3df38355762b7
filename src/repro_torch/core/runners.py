"""Registered physical fixpoint runners (the Runner protocol) and the
adaptive re-planning executor.

The counterpart of ``repro/core/runners.py``.  The planner picks a
runner per stratum by name; each registered :class:`Runner` executes
that choice:

* ``full_fn(ctx)`` — ``fn(operand, init) → (x*, iters)``, the static
  path of a vector-form stratum;
* ``stratum_fn`` — the dense engine runners' whole-stratum path;
* ``batched_fn(plan, max_iters)`` — the ``compile_batched`` body over a
  ``(B, n)`` init pack;
* ``run_chunk(ctx, state, budget) → (state, stats)`` — for ``chunkable``
  runners, advance a :class:`~repro_torch.sparse.fixpoint.FixpointState`
  by at most ``budget`` GSN rounds and report the chunk-boundary
  :class:`~repro_torch.sparse.fixpoint.FrontierStats`.  Every runner
  shares the round body, so a carry from one resumes in another;
* ``estimate(ctx, state) → CostEstimate`` — price the runner's *next
  round* from the observed frontier
  (:data:`repro_torch.sparse.adaptive.ADAPTIVE_COST`);
* ``finalize(ctx, state)`` — ``(x*, iters)`` from the carry;
* ``serve_chunk_fn(chunk_iters)`` — the serve scheduler's unit
  ``(edges, y, d, it) → (y, d, it)``: the slot pool's ``(B, n)`` carry
  advanced by at most ``chunk_iters`` rounds on the carry's device
  (:mod:`repro_torch.serve.slots`).

Ported: ``sparse_frontier`` (the worklist over the CSR index, B3's
``scatter`` path), ``sparse_jit`` (staged loop, torch advance with B3's
``runs`` path), ``sparse_frontier_pallas`` (the same loop with the
fused B1 advance — the name is the reference's, so plans and
``explain()`` line up), ``vector_dense`` (B2 rounds, chunkable too),
``dense_gsn``, ``dense_naive``, ``dense_host`` (the naive loop with a
host test of every key each round, :func:`~repro_torch.core.fixpoint.
host_fixpoint`; forced by ``mode="host"``) and ``sparse_sharded`` (the
graph-axis loop of :mod:`repro_torch.distributed.datalog` over the
context's :class:`~repro_torch.launch.mesh.GraphMesh`; chunkable, so a
carry moves between it and the single-device runners bit for bit).  The
``sparse_frontier_pallas`` runner's backend follows the operator's
device (:func:`spmm_exec_backend`): B1 on CUDA, the packed host loop on
the CPU.

:func:`adaptive_fixpoint` runs a fixpoint in bounded chunks and, under
a :class:`~repro_torch.sparse.adaptive.ReplanPolicy`, hands the carry
to whichever chunkable runner prices cheapest for the next round — the
answer and per-row counts equal any static runner's.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.sparse import adaptive
from repro_torch.sparse import fixpoint as fx
from repro_torch.sparse.coo import SparseRelation


@dataclasses.dataclass
class RunnerContext:
    """Everything a runner needs to execute one vector-form stratum:
    the materialized linear operator, the init vector, the graph mesh of
    the sharded candidate (None: single-device) and a memo dict
    (``extras``) for prepared operands."""

    edges: object            # SparseRelation or dense (n, n) tensor
    init: object             # (n,) or (B, n) tensor
    semiring: str
    max_iters: int
    n: int
    e_nnz: int
    mesh: object = None      # GraphMesh of the sparse_sharded runner
    extras: dict = dataclasses.field(default_factory=dict)


def spmm_exec_backend(runner: str, device) -> str:
    """The fixpoint backend a runner's SpMM executes with on the
    operator's ``device``: ``sparse_frontier_pallas`` launches kernel
    B1 on CUDA (``"kernel"``) and runs the host loop over bit-packed 𝔹
    lanes on the CPU (``"fused"``); every other runner keeps the torch
    composition (``"torch"``).  Decided by the device, never by what is
    installed."""
    if runner != "sparse_frontier_pallas":
        return "torch"
    return "kernel" if torch.device(device).type == "cuda" else "fused"


def make_context(edges, init, semiring: str, max_iters: int, *,
                 mesh=None) -> RunnerContext:
    if isinstance(edges, SparseRelation):
        n, e_nnz = int(edges.shape[1]), int(edges.nnz)
    else:
        sr = sr_mod.get(semiring)
        n, e_nnz = int(edges.shape[1]), int(sr.live(edges).sum())
    return RunnerContext(edges, init, semiring, max_iters, n, e_nnz,
                         mesh=mesh)


class Runner:
    """One physical fixpoint runner (see the module docstring)."""

    name: str = ""
    chunkable: bool = False

    def feasible(self, ctx: RunnerContext) -> bool:
        return True

    def operand(self, ctx: RunnerContext):
        """The runner-specific form of the linear operator, memoized on
        ``ctx.extras``."""
        return ctx.edges

    def full_fn(self, ctx: RunnerContext):
        raise NotImplementedError(self.name)

    def run_chunk(self, ctx: RunnerContext, state: fx.FixpointState,
                  budget: int):
        raise NotImplementedError(f"runner {self.name} is not chunkable")

    def estimate(self, ctx: RunnerContext, state: fx.FixpointState):
        """Price this runner's next GSN round from the chunk-boundary
        frontier (ns; trips cancel across candidates).  The fused
        kernel's speedup is ``SPMM_COST``'s entry for the operator's
        device type."""
        from repro_torch.core import planner
        ns = adaptive.ADAPTIVE_COST.round_ns(
            self.name, n=ctx.n, e_nnz=ctx.e_nnz, batch=state.batch,
            frontier_nnz=state.frontier_nnz(),
            live_rows=state.live_rows(), semiring=ctx.semiring,
            fused_speedup=planner.SPMM_COST.speedup(
                ctx.semiring, ctx.edges.device.type),
            mesh_d=_mesh_d(ctx.mesh))
        return planner.CostEstimate(ns, 0.0, 1, "adaptive")

    def finalize(self, ctx: RunnerContext, state: fx.FixpointState):
        return state.solution()

    def stratum_fn(self, stratum, cur_db, hints, max_iters: int):
        """Non-vector runners: ``(fn, x0)`` executing a whole stratum."""
        raise NotImplementedError(self.name)

    def batched_fn(self, plan, max_iters: int):
        raise NotImplementedError(self.name)

    def serve_chunk_fn(self, chunk_iters: int):
        """``(edges, y, d, it) → (y, d, it)``: at most ``chunk_iters``
        staged rounds of the ``(B, n)`` carry, on its device."""
        return _serve_chunk(chunk_iters, lambda e: "torch")


def _mesh_d(mesh) -> int:
    if mesh is None:
        return 1
    from repro_torch.distributed.datalog import mesh_size
    return mesh_size(mesh)


def _serve_chunk(chunk_iters: int, backend_of):
    def chunk(edges, y, d, it):
        st = fx.fixpoint(edges, state=fx.FixpointState(
            y, d, it, edges.semiring, True), budget=chunk_iters, mode="jit",
            backend=backend_of(edges))
        return st.y, st.delta, st.iters
    return chunk


RUNNER_REGISTRY: dict[str, Runner] = {}


def register(runner_cls):
    r = runner_cls()
    RUNNER_REGISTRY[r.name] = r
    return runner_cls


def get(name: str) -> Runner:
    r = RUNNER_REGISTRY.get(name)
    if r is None:
        raise KeyError(f"no registered runner {name!r}; have "
                       f"{sorted(RUNNER_REGISTRY)}")
    return r


# --------------------------------------------------------------------------
# Vector-equation runners
# --------------------------------------------------------------------------


class _SparseRunner(Runner):
    chunkable = True
    mode = "jit"

    def feasible(self, ctx):
        return isinstance(ctx.edges, SparseRelation)

    def backend(self, edges) -> str:
        """The staged loop's advance for an operator (on its device)."""
        return "torch"

    def full_fn(self, ctx):
        mi, mode = ctx.max_iters, self.mode
        return lambda e, i: fx.fixpoint(e, i, max_iters=mi, mode=mode,
                                        backend=self.backend(e))

    def run_chunk(self, ctx, state, budget):
        st = fx.fixpoint(ctx.edges, state=state, budget=budget,
                         mode=self.mode, backend=self.backend(ctx.edges))
        return st, st.stats()

    def batched_fn(self, plan, max_iters):
        # the batched form of the staged and the frontier runner alike is
        # the staged loop: the worklist is per source and cannot batch
        return lambda e, i: fx.fixpoint(e, i, max_iters=max_iters,
                                        mode="jit", backend=self.backend(e))


@register
class FrontierRunner(_SparseRunner):
    """Worklist rounds over the CSR index: a round's work tracks the
    live frontier's out-degrees, not nnz(E)."""

    name = "sparse_frontier"
    mode = "frontier"


@register
class JitRunner(_SparseRunner):
    """The staged GSN loop: O(nnz(E)) per round, the advance composed of
    a torch gather/⊗ and the B3 segment-⊕."""

    name = "sparse_jit"


@register
class PallasRunner(_SparseRunner):
    """The staged GSN loop with the fused SpMM advance: kernel B1 on a
    CUDA operator, the packed host loop (``"fused"``) on a CPU one."""

    name = "sparse_frontier_pallas"

    def backend(self, edges) -> str:
        return spmm_exec_backend(self.name, edges.device)

    def serve_chunk_fn(self, chunk_iters):
        return _serve_chunk(chunk_iters, self.backend)


@register
class ShardedRunner(_SparseRunner):
    """The graph-axis row-partitioned loop over the context's mesh: each
    rank derives its destination block, the frontier crosses ranks by
    the Δ-sparse exchange (:mod:`repro_torch.distributed.datalog`)."""

    name = "sparse_sharded"

    def feasible(self, ctx):
        return ctx.mesh is not None and super().feasible(ctx)

    def operand(self, ctx):
        es = ctx.extras.get("sharded_edges")
        if es is None:
            from repro_torch.distributed.datalog import shard_relation
            es = ctx.extras["sharded_edges"] = shard_relation(ctx.edges,
                                                              ctx.mesh)
        return es

    def full_fn(self, ctx):
        from repro_torch.distributed.datalog import \
            sharded_seminaive_fixpoint
        m, mi = ctx.mesh, ctx.max_iters
        return lambda e, i: sharded_seminaive_fixpoint(e, i, mesh=m,
                                                       max_iters=mi)

    def batched_fn(self, plan, max_iters):
        from repro_torch.core import planner
        from repro_torch.distributed.datalog import \
            sharded_seminaive_fixpoint
        mesh = planner.exec_mesh(plan)
        return lambda e, i: sharded_seminaive_fixpoint(
            e, i, mesh=mesh, max_iters=max_iters)

    def run_chunk(self, ctx, state, budget):
        from repro_torch.distributed.datalog import sharded_resume_chunk
        y, d, it = sharded_resume_chunk(
            self.operand(ctx), state.y, state.delta, state.iters,
            mesh=ctx.mesh, max_iters=budget)
        st = fx.FixpointState(y, d, it, state.semiring, state.batched)
        return st, st.stats()


@register
class DenseVectorRunner(Runner):
    """Dense semiring matmul rounds (kernel B2) — wins when E is dense."""

    name = "vector_dense"
    chunkable = True

    def operand(self, ctx):
        if not isinstance(ctx.edges, SparseRelation):
            return ctx.edges
        dense = ctx.extras.get("dense_edges")
        if dense is None:
            dense = ctx.extras["dense_edges"] = ctx.edges.to_dense()
        return dense

    def full_fn(self, ctx):
        sr, mi = sr_mod.get(ctx.semiring), ctx.max_iters
        return lambda e, i: _dense_vector_fixpoint(e, i, sr, mi)

    def batched_fn(self, plan, max_iters):
        sr = sr_mod.get(plan.strata[0].vf.semiring)
        return lambda e, i: _batched_dense_vector_fixpoint(e, i, sr,
                                                           max_iters)

    def run_chunk(self, ctx, state, budget):
        # the staged GSN round on the (n, B) carry with the dense advance
        # Δ ⊗ E (B2): the same ⊗/⊕ contraction as the SpMM over the
        # 0̄-filled matrix, so a hand-off either way resumes bit for bit
        from repro_torch.kernels import ops as kops
        edge = self.operand(ctx)
        sr = sr_mod.get(ctx.semiring)
        y, d, it = fx._gsn_loop(
            lambda dd: kops.semiring_matmul(sr, dd.t(), edge).t(), sr,
            state.y.t().contiguous(), state.delta.t().contiguous(),
            state.iters.clone(), budget)
        st = fx.FixpointState(y.t(), d.t(), it, state.semiring,
                              state.batched)
        return st, st.stats()


def _batched_dense_vector_fixpoint(edge, init, sr, max_iters):
    """The vectorized ``x = init ⊕ x ⊗ E`` GSN step over a dense E for a
    ``(B, n)`` init pack."""
    from repro_torch.core import fixpoint
    from repro_torch.kernels import ops as kops

    def ico(s):
        return {"x": sr.add(init, kops.semiring_matmul(sr, s["x"], edge))}

    def dico(s):
        return {"x": kops.semiring_matmul(sr, s["x"], edge)}

    x0 = {"x": sr.zeros(init.shape, init.device)}
    y, iters = fixpoint.batched_seminaive_fixpoint(
        ico, dico, x0, {"x": sr}, max_iters=max_iters)
    return y["x"], iters


def _dense_vector_fixpoint(edge, init, sr, max_iters):
    y, iters = _batched_dense_vector_fixpoint(edge, init.reshape(1, -1),
                                              sr, max_iters)
    return y[0], int(iters[0])


# --------------------------------------------------------------------------
# Dense engine runners (whole-stratum)
# --------------------------------------------------------------------------


class _IcoRunner(Runner):
    def _prep(self, stratum, cur_db, hints):
        from repro_torch.core import program as prog_mod
        ico = prog_mod.make_ico(stratum, cur_db, hints)
        x0 = prog_mod.init_state(stratum, cur_db, hints)
        return ico, x0


@register
class DenseGsnRunner(_IcoRunner):
    name = "dense_gsn"

    def stratum_fn(self, stratum, cur_db, hints, max_iters):
        from repro_torch.core import fixpoint
        from repro_torch.core import program as prog_mod
        ico, x0 = self._prep(stratum, cur_db, hints)
        srs = {n: sr_mod.get(cur_db.schema[n].semiring)
               for n in stratum.idbs}
        dico = prog_mod.make_delta_ico(stratum, cur_db, hints)
        return (lambda x: fixpoint.seminaive_fixpoint(
            ico, dico, x, srs, max_iters=max_iters)), x0


@register
class DenseNaiveRunner(_IcoRunner):
    name = "dense_naive"

    def stratum_fn(self, stratum, cur_db, hints, max_iters):
        from repro_torch.core import fixpoint
        ico, x0 = self._prep(stratum, cur_db, hints)
        return (lambda x: fixpoint.naive_fixpoint(
            ico, x, max_iters=max_iters)), x0


@register
class DenseHostRunner(_IcoRunner):
    name = "dense_host"

    def stratum_fn(self, stratum, cur_db, hints, max_iters):
        from repro_torch.core import fixpoint
        ico, x0 = self._prep(stratum, cur_db, hints)
        return (lambda x: fixpoint.host_fixpoint(
            ico, x, max_iters=max_iters)), x0


# --------------------------------------------------------------------------
# The adaptive executor
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ReplanEvent:
    """One mid-fixpoint runner switch, as logged in ``explain(plan)``."""

    chunk: int           # 0-based index of the chunk just finished
    iteration: int       # global iteration at the switch boundary
    frontier_nnz: int
    density: float
    from_runner: str
    to_runner: str
    est_from: float      # incumbent's priced next round (ns)
    est_to: float        # challenger's priced next round (ns)


@dataclasses.dataclass
class AdaptiveRun:
    """Execution trace of one adaptive fixpoint: per-chunk frontier
    observations plus the switch history (rendered by ``explain``).
    ``prices`` holds every priced boundary as ``(chunk, runner in
    charge, {candidate: ns})``, so a trace can be replayed through its
    policy."""

    start_runner: str
    final_runner: str
    chunks: list
    switches: list
    policy: adaptive.ReplanPolicy
    prices: list = dataclasses.field(default_factory=list)


def adaptive_fixpoint(ctx: RunnerContext, *, start: str,
                      candidates=(), policy=None, observer=None):
    """Execute the fixpoint in bounded chunks, re-pricing the remaining
    work at every chunk boundary and handing the carry to another
    runner when the :class:`~repro_torch.sparse.adaptive.ReplanPolicy`
    allows.

    Returns ``(x*, iters, AdaptiveRun)``; the answer and per-row
    iteration counts equal any static chunkable runner's (shared GSN
    round body, exact carry hand-off).  A candidate that is not a
    registered, chunkable, feasible runner here (``sparse_sharded``
    without a mesh, the whole-stratum ``dense_host``) is dropped
    silently.  ``observer``, if given,
    receives each chunk's :class:`~repro_torch.sparse.fixpoint.
    FrontierStats` as it lands.
    """
    policy = policy if policy is not None else adaptive.ReplanPolicy()
    cands = [start] + [c for c in candidates if c != start]
    cands = [c for c in cands
             if c in RUNNER_REGISTRY and get(c).chunkable
             and get(c).feasible(ctx)]
    if start not in cands:
        raise ValueError(f"start runner {start!r} is not a feasible "
                         f"chunkable runner here")
    state = fx.FixpointState.cold(ctx.edges, ctx.init,
                                  semiring=ctx.semiring)
    current = start
    trace = AdaptiveRun(start, start, [], [], policy)
    rounds_done = 0
    while not state.converged and rounds_done < ctx.max_iters:
        budget = int(min(policy.chunk_iters, ctx.max_iters - rounds_done))
        state, stats = get(current).run_chunk(ctx, state, budget)
        # a chunk only stops early on global convergence, so a
        # non-converged chunk ran exactly `budget` global rounds
        rounds_done += budget
        trace.chunks.append(stats)
        if observer is not None:
            observer(stats)
        if state.converged or rounds_done >= ctx.max_iters:
            break
        if len(cands) < 2:
            continue  # nothing to re-plan against; keep chunking
        ests = {c: get(c).estimate(ctx, state) for c in cands}
        best = min(ests, key=lambda c: (ests[c].total, c != current, c))
        chunk_index = len(trace.chunks) - 1
        trace.prices.append((chunk_index, current,
                             {c: e.total for c, e in ests.items()}))
        since = chunk_index - trace.switches[-1].chunk \
            if trace.switches else chunk_index + 1
        if best != current and policy.should_switch(
                ests[current].total, ests[best].total,
                chunk_index=chunk_index, chunks_since_switch=since,
                switches=len(trace.switches)):
            trace.switches.append(ReplanEvent(
                chunk=chunk_index, iteration=stats.iteration,
                frontier_nnz=stats.nnz, density=stats.density,
                from_runner=current, to_runner=best,
                est_from=ests[current].total, est_to=ests[best].total))
            current = best
    trace.final_runner = current
    y, iters = get(current).finalize(ctx, state)
    return y, iters, trace
