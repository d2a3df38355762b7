"""Program-family machinery shared by both serve loops.

The counterpart of ``repro/serve/family.py``.  A *family* is one
source-parameterized Π₂ program registered with a server: its
cost-based plan (``objective="throughput"``), materialized linear
operator ``E`` on the family's device, a CPU twin of the database for
eager per-request ``init`` evaluation (the engine's ``backend="np"``),
memoized init vectors (numpy, on the host) and the capacity-bounded
warm-answer LRU (tensors on the family's device).  The continuous
scheduler (:class:`repro_torch.serve.scheduler.ContinuousServer`) and
the packed-FIFO server (:class:`repro_torch.launch.datalog_serve.
DatalogServer`) share one registration, init-evaluation and
streaming-update implementation: monotone ⊕-merges append to the
operator and repair every warm answer in one batched delta-restart
(:func:`repro_torch.incremental.delta_restart_fixpoint`, on the card
kernel B3's ``runs`` path); deletes and weight increases apply at
unchanged capacity and repair warm answers through the synthesized
⊖/recount rule (:func:`repro_torch.incremental.maintain_nonmonotone`,
B3's ``scatter`` path for the recount) when one verifies, dropping them
otherwise.

The single-request latency path (:func:`latency_serve`) runs the
planner's per-source worklist for a lone request on a CPU family; on
the card it declines (the worklist does not win there), so a lone
request takes the batched runner.

Graph-sharded families: with ``graph_mesh=`` (a
:class:`~repro_torch.launch.mesh.GraphMesh`) the plan is offered the
row-partitioned ``sparse_sharded`` runner, and when it picks it the
family keeps the operator's :class:`~repro_torch.distributed.datalog.
ShardedRelation` (``sharded``), the batched runner's operand on every
rank of the mesh.  A merge routes the new edges to their owning shards
(``ShardedRelation.apply_delta``) and repairs the warm answers with
:func:`~repro_torch.distributed.datalog.sharded_resume_fixpoint`; a
delete re-shards the mutated operator and drops them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import engine, ir, planner, vectorize
from repro_torch.core import semiring as sr_mod
from repro_torch.core.program import Program
from repro_torch.serve.cache import LRUCache
from repro_torch.sparse.coo import SparseRelation


@dataclasses.dataclass
class QueryRequest:
    """One (program family, source vertex) query; filled in by the server.

    ``result`` is a tensor on the family's device.  A request that
    cannot be served (e.g. its source changed the family's linear
    operator) comes back with ``result=None`` and the failure message in
    ``error`` — it never takes its batch down.
    """

    family: str
    source: int
    result: torch.Tensor | None = None
    iters: int | None = None
    error: str | None = None
    submitted_s: float = 0.0
    done_s: float = 0.0
    #: continuous scheduler stamps: admitted into a slot / mask fired
    admitted_s: float = 0.0
    converged_s: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.done_s - self.submitted_s


@dataclasses.dataclass
class UpdateRequest:
    """One batch of edge mutations against a family's linear operator.

    ``op="merge"`` is the monotone ⊕-merge (edge insertion; tropical
    weight decrease); ``op="delete"`` removes keys and ``op="increase"``
    replaces stored values with larger ones — both non-monotone,
    repaired through the synthesized maintenance rule when one verifies.
    Coordinates live in the space the family's operator was built from:
    the stored edge relation ``E(i, j)`` when one exists (the server
    re-orients them for the operator), else the ``edges=`` override
    given at registration.  Once ``applied`` is set the server
    guarantees no later-served answer predates the update.
    """

    family: str
    coords: np.ndarray
    values: np.ndarray | None = None
    op: str = "merge"
    applied: bool = False
    repaired: int = 0           # warm answers repaired in place
    error: str | None = None
    submitted_s: float = 0.0
    done_s: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.done_s - self.submitted_s


#: per-family cap on memoized init vectors (n values each)
INIT_CACHE_MAX = 4096


@dataclasses.dataclass
class Family:
    name: str
    make_program: Callable[[int], Program]
    db: engine.Database
    host_db: engine.Database    # CPU twin for eager per-request init eval
    plan: planner.ExecutionPlan
    edges: object               # SparseRelation or dense (n, n) tensor
    hints: dict
    n: int
    max_iters: int
    #: graph-sharded twin of ``edges`` (a ShardedRelation) when the plan
    #: picked the row-partitioned runner; the batched runner's operand
    sharded: object | None = None
    edge_rel: str | None = None  # stored relation behind E (None: override)
    init_reads_edges: bool = False  # init term references edge_rel too
    init_cache: dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)
    #: warm x* per source (tensors on the family's device), repaired on
    #: update (capacity-bounded LRU)
    answers: LRUCache = dataclasses.field(
        default_factory=lambda: LRUCache(256))
    #: host-kernel geometry reused across pool rebuilds; invalidated
    #: whenever ``edges`` mutates
    kernel_cache: dict = dataclasses.field(default_factory=dict)
    #: one-hot init fast path: ``(template_prog, template_source,
    #: background, source_value, dtype)`` when registration probed the
    #: init as "uniform background + one value at the source" — then a
    #: request's init is two writes instead of a host program eval (the
    #: request's program is still structurally verified against the
    #: template first).  None = probe failed / not applicable.
    fast_init: tuple | None = None
    #: lazily planned objective="latency" route for B=1 requests;
    #: False = probed and unavailable (no cheap per-source form)
    latency_plan: object = None

    @property
    def backend(self) -> str:
        # derived from the plan so it can never disagree with the routing
        return "sparse" if self.plan.strata[0].runner in (
            "sparse_jit", "sparse_sharded",
            "sparse_frontier_pallas") else "dense"

    @property
    def semiring(self) -> str:
        return self.plan.strata[0].vf.semiring

    @property
    def device(self) -> torch.device:
        return self.db.device


def bucket(b: int, max_batch: int) -> int:
    """Smallest power of two ≥ b, capped at max_batch."""
    out = 1
    while out < b:
        out <<= 1
    return min(out, max_batch)


def build_family(name: str, make_program: Callable[[int], Program],
                 db: engine.Database, *, edges=None,
                 template_source: int = 0, graph_mesh=None,
                 max_iters: int = 10_000,
                 warm_answers: int = 256) -> Family:
    """Plan and materialize one family on the database's device.

    ``make_program(source)`` must return the optimized program for that
    source; all sources must share the linear operator (checked per
    request by ``planner.source_init`` via the vector-form signature).
    ``edges`` overrides the extracted E — e.g. a weighted COO adjacency
    for SSSP-style families whose schema-level edge relation is a dense
    3-ary tensor that would not scale; it is moved to the database's
    device.  ``graph_mesh`` offers the plan the mesh's ranks (module
    docstring); it must compute on the database's device type.
    """
    if graph_mesh is not None:
        from repro_torch.launch.mesh import GraphMesh
        if not isinstance(graph_mesh, GraphMesh):
            raise TypeError(f"graph_mesh must be a GraphMesh "
                            f"(launch.mesh.make_graph_mesh), got "
                            f"{type(graph_mesh).__name__}")
        if graph_mesh.device.type != db.device.type:
            raise ValueError(f"a graph mesh on {graph_mesh.device} cannot "
                             f"serve a {db.device.type} database")
    if isinstance(edges, SparseRelation):
        edges = edges.to(db.device)
    template = make_program(template_source)
    hints = dict(template.sort_hints)
    plan = planner.plan_program(
        template, db, planner.PlanHints(sorts=hints),
        objective="throughput", edges=edges, adapt_storage=False,
        require_vector=True, mesh=graph_mesh)
    edges = planner.materialize_edges(plan, db, hints)
    n = db.dom(plan.strata[0].vf.out_sort)
    # the CPU twin: per-request init evaluation runs eagerly on the host
    # through the engine's np backend (an init term may read the edge
    # relation itself, which the evaluator then densifies host-side)
    host_db = engine.Database(db.schema, dict(db.domains),
                              dict(db.relations), "cpu")
    fam = Family(name, make_program, db, host_db, plan, edges, hints, n,
                 max_iters, answers=LRUCache(warm_answers))
    if plan.strata[0].runner == "sparse_sharded":
        from repro_torch.distributed.datalog import shard_relation
        fam.sharded = shard_relation(edges, graph_mesh)
    if plan.strata[0].edges_override is None:
        a = vectorize.edge_atom(plan.strata[0].vf)
        if a is not None and isinstance(db.relations.get(a.name),
                                        SparseRelation):
            fam.edge_rel = a.name
            fam.init_reads_edges = vectorize.init_reads(
                plan.strata[0].vf, a.name)
    _probe_fast_init(fam, template, template_source)
    return fam


def _probe_fast_init(fam: Family, template: Program, s0: int) -> None:
    """Enable the one-hot init fast path when two probe sources show
    the init is "uniform background + one value at the source" and the
    two programs differ only in that source constant.  Disabled for
    edge-reading inits (their vectors change under updates)."""
    if fam.init_reads_edges or fam.n < 2:
        return
    s1 = s0 + 1 if s0 + 1 < fam.n else s0 - 1
    try:
        p1 = fam.make_program(s1)
        if not _source_equiv(template, p1, s0, s1):
            return
        i0 = planner.source_init(fam.plan, template, fam.host_db,
                                 hints=dict(template.sort_hints),
                                 backend="np")
        i1 = planner.source_init(fam.plan, p1, fam.host_db,
                                 hints=dict(p1.sort_hints), backend="np")
    except Exception:
        return
    i0, i1 = np.asarray(i0), np.asarray(i1)
    bg, src_val = i0[s1], i0[s0]
    rest = np.delete(i0, s0)
    if (src_val != bg and i1[s1] == src_val and i1[s0] == bg
            and np.all(rest == bg)
            and np.array_equal(np.delete(i1, s1), rest)):
        fam.fast_init = (template, s0, bg, src_val, i0.dtype)
        fam.init_cache[s0] = i0
        fam.init_cache[s1] = i1


def _source_equiv(p0: Program, p1: Program, s0: int, s1: int) -> bool:
    """True iff ``p1`` is exactly ``p0`` with the source constant ``s0``
    replaced by ``s1`` (variable names ignored).  When it holds, the
    request's program kept the family's linear operator by
    construction."""

    def args_ok(a0, a1):
        if len(a0.args) != len(a1.args):
            return False
        for x0, x1 in zip(a0.args, a1.args):
            c0, c1 = isinstance(x0, ir.C), isinstance(x1, ir.C)
            if c0 != c1:
                return False
            if c0 and x0.value != x1.value \
                    and (x0.value, x1.value) != (s0, s1):
                return False
        return True

    def atom_ok(a0, a1):
        if type(a0) is not type(a1):
            return False
        if isinstance(a0, ir.RelAtom):
            return ((a0.name, a0.cast, a0.neg)
                    == (a1.name, a1.cast, a1.neg) and args_ok(a0, a1))
        if isinstance(a0, ir.PredAtom):
            return a0.pred == a1.pred and args_ok(a0, a1)
        if isinstance(a0, ir.ValFnAtom):
            return a0.fn == a1.fn and args_ok(a0, a1)
        if isinstance(a0, ir.ConstAtom):
            return a0.value == a1.value
        return True  # ValAtom: var names may drift

    def ssp_ok(e0, e1):
        if (len(e0.terms) != len(e1.terms)
                or len(e0.head) != len(e1.head)
                or e0.semiring != e1.semiring):
            return False
        return all(
            len(t0.atoms) == len(t1.atoms)
            and len(t0.bound) == len(t1.bound)
            and all(atom_ok(a0, a1)
                    for a0, a1 in zip(t0.atoms, t1.atoms))
            for t0, t1 in zip(e0.terms, e1.terms))

    if (len(p0.strata) != len(p1.strata)
            or len(p0.outputs) != len(p1.outputs)):
        return False
    for st0, st1 in zip(p0.strata, p1.strata):
        if tuple(st0.rules) != tuple(st1.rules):
            return False
        if not all(ssp_ok(st0.rules[nm].body, st1.rules[nm].body)
                   for nm in st0.rules):
            return False
        if (st0.init is None) != (st1.init is None):
            return False
        if st0.init is not None:
            if set(st0.init) != set(st1.init):
                return False
            if not all(ssp_ok(st0.init[nm], st1.init[nm])
                       for nm in st0.init):
                return False
    return all(r0.head == r1.head and ssp_ok(r0.body, r1.body)
               for r0, r1 in zip(p0.outputs, p1.outputs))


def family_init(fam: Family, source: int) -> np.ndarray:
    """The per-request O(n) host work, memoized per source: rebuild the
    source's program, check it kept the family's linear operator,
    produce its init vector (numpy; the stepper moves it to the device
    on admission).  One-hot families take the probed fast path
    (structural check + two writes); everything else evaluates through
    ``planner.source_init`` on the CPU twin."""
    if source in fam.init_cache:
        return fam.init_cache[source]
    prog = fam.make_program(source)
    init = None
    if fam.fast_init is not None and 0 <= source < fam.n:
        template, t0, bg, src_val, dtype = fam.fast_init
        if _source_equiv(template, prog, t0, source):
            init = np.full(fam.n, bg, dtype)
            init[source] = src_val
    if init is None:
        init = planner.source_init(fam.plan, prog, fam.host_db,
                                   hints=dict(prog.sort_hints),
                                   backend="np")
    if len(fam.init_cache) >= INIT_CACHE_MAX:
        fam.init_cache.pop(next(iter(fam.init_cache)))  # FIFO evict
    fam.init_cache[source] = init
    return init


def inits_on(fam: Family, inits, rows: int | None = None) -> torch.Tensor:
    """Stack host init vectors into a ``(rows, n)`` pack on the family's
    device (rows past ``len(inits)`` are inert 0̄ padding): built on the
    host, moved in one copy."""
    srn = sr_mod.get(fam.semiring, lib="np")
    packed = np.full((rows or len(inits), fam.n), srn.zero, srn.dtype)
    for i, v in enumerate(inits):
        packed[i] = np.asarray(v)
    return torch.from_numpy(packed).to(fam.device)


# --------------------------------------------------------------------------
# B=1 latency routing
# --------------------------------------------------------------------------


def _latency_plan(fam: Family):
    """The family's ``objective="latency"`` plan, probed lazily once
    (same template and edges override, so every signature-keyed cache is
    unchanged).  ``False`` caches a probe that found no per-source
    route."""
    if fam.latency_plan is None:
        try:
            template = fam.make_program(0)
            plan = planner.plan_program(
                template, fam.db,
                planner.PlanHints(sorts=dict(template.sort_hints)),
                objective="latency",
                edges=fam.plan.strata[0].edges_override,
                adapt_storage=False, require_vector=True)
            fam.latency_plan = (
                plan if plan.strata[0].runner == "sparse_frontier"
                else False)
        except Exception:
            fam.latency_plan = False
    return fam.latency_plan


def latency_serve(fam: Family, init: np.ndarray):
    """Serve ONE request down the planner's per-source worklist.

    Returns ``(x*, iters)`` or ``None`` when the family has no cheaper
    single-source form: a dense operator, a sharded one, a family on the
    card (the reference's non-CPU backend test, read through the device
    — the worklist does not win on the card), or a latency plan that
    picked a batched runner.  The caller then serves a ``(1, n)``
    batched run."""
    if fam.sharded is not None or not isinstance(fam.edges, SparseRelation):
        return None
    if fam.device.type != "cpu" or _latency_plan(fam) is False:
        return None
    from repro_torch.sparse.fixpoint import fixpoint
    y, iters = fixpoint(fam.edges, torch.from_numpy(np.asarray(init)),
                        mode="frontier", max_iters=fam.max_iters)
    return y, int(iters)


# --------------------------------------------------------------------------
# Streaming updates: shared by both serve loops
# --------------------------------------------------------------------------


def apply_updates(fam: Family, ups: list, stats: dict,
                  graph_mesh=None) -> None:
    """Apply a run of same-op updates in one pass: mutate the stored
    relation + operator, then repair (or drop) the warm answer cache.
    The family's plan, signature and compiled runners are untouched.  A
    failing update is marked (``error``) and counted, never raised: a
    bad update must not kill the queue.  ``graph_mesh`` is the mesh a
    sharded family was built on."""
    now = time.perf_counter()
    try:
        coords = np.concatenate([u.coords for u in ups])
        values = None
        if any(u.values is not None for u in ups):
            one = np.asarray(sr_mod.get(rel_semiring(fam), lib="np").one)
            values = np.concatenate(
                [u.values if u.values is not None
                 else np.full(len(u.coords), one) for u in ups])
        if ups[0].op == "merge":
            _merge_edges(fam, coords, values, stats, graph_mesh)
        else:
            _nonmono_edges(fam, coords, values, ups[0].op, stats,
                           graph_mesh)
    except Exception as e:
        for u in ups:
            u.error = f"{type(e).__name__}: {e}"
            u.done_s = now
        stats["failed"] += len(ups)
        return
    for u in ups:
        u.applied = True
        u.done_s = time.perf_counter()
    stats["updates"] += len(ups)


def rel_semiring(fam: Family) -> str:
    if fam.edge_rel is not None:
        return fam.db.schema[fam.edge_rel].semiring
    vf = fam.plan.strata[0].vf
    return (fam.edges.semiring
            if isinstance(fam.edges, SparseRelation) else vf.semiring)


def operator_delta(fam: Family, coords, values) -> SparseRelation:
    """The update batch as a sparse Δ in the operator's own space, on
    the family's device: re-oriented from stored-relation order when
    needed, values cast into the vector equation's semiring."""
    vf = fam.plan.strata[0].vf
    rel_sr = rel_semiring(fam)
    srn = sr_mod.get(rel_sr, lib="np")
    delta = SparseRelation.from_coo(
        coords,
        np.ones(len(coords), srn.dtype) * srn.one if values is None
        else values, (fam.n, fam.n), rel_sr, device=fam.device)
    if fam.edge_rel is not None:
        a = vectorize.edge_atom(vf)
        if tuple(a.args) != vf.edge.head:
            delta = delta.transpose()
    return vectorize._sparse_into_semiring(delta, vf.semiring)


def _drop_answers(fam: Family, stats: dict) -> None:
    stats["answers_dropped"] += fam.answers.clear()


def _warm_pack(fam: Family, sources: list, rows: int) -> torch.Tensor:
    """The warm answers of ``sources`` as a ``(rows, n)`` pack on the
    family's device, inert 0̄ rows past them."""
    sr = sr_mod.get(fam.semiring)
    out = sr.zeros((rows, fam.n), fam.device)
    if sources:
        out[:len(sources)] = torch.stack(
            [fam.answers.peek(s).to(fam.device, sr.dtype) for s in sources])
    return out


def _dense_keys(fam: Family, coords: torch.Tensor) -> torch.Tensor:
    """Flat ``i·n + j`` keys of a dense operator's coordinates, −1 where
    out of range (dropped by the scatter)."""
    c = coords.long().reshape(-1, 2)
    ok = ((c >= 0) & (c < fam.n)).all(dim=1)
    return torch.where(ok, c[:, 0] * fam.n + c[:, 1], -1)


def _merge_edges(fam: Family, coords, values, stats: dict,
                 graph_mesh) -> None:
    from repro_torch.incremental import DeltaEntry, delta_restart_fixpoint
    fam.kernel_cache.clear()
    delta_op = operator_delta(fam, coords, values)
    k = delta_op.nnz
    if fam.edge_rel is not None:
        ent = [DeltaEntry(fam.edge_rel, coords, values, "merge")]
        fam.db = fam.db.apply_delta(ent)
        fam.host_db = fam.host_db.apply_delta(ent)
    if isinstance(fam.edges, SparseRelation):
        fam.edges = fam.edges.apply_delta(delta_op.coords[:k],
                                          delta_op.values[:k])
        if fam.sharded is not None:
            # the same rows, routed to their owning destination shards
            fam.sharded = fam.sharded.apply_delta(delta_op.coords[:k],
                                                  delta_op.values[:k])
    else:  # dense operator: ⊕-scatter
        keys = _dense_keys(fam, delta_op.coords[:k])
        fam.edges = sr_mod.scatter_op(
            delta_op.semiring, fam.edges.reshape(-1), keys,
            delta_op.values[:k]).reshape(fam.edges.shape)
    if fam.init_reads_edges:
        # the merge also changed the init term: memoized init vectors
        # are stale and a Δ-seeded repair would miss the init
        # contribution — recompute cold
        fam.init_cache.clear()
        _drop_answers(fam, stats)
        return
    if not len(fam.answers):
        return
    if not isinstance(fam.edges, SparseRelation):
        # no sparse Δ-seed path for a dense operator — recompute cold
        _drop_answers(fam, stats)
        return
    # one batched delta-restart pass repairs every warm answer: bucketed
    # to a power of two with inert 0̄ rows, one contraction a round
    sources = list(fam.answers.keys())
    prev = _warm_pack(fam, sources, bucket(len(sources), 1 << 30))
    if fam.sharded is not None:
        # the O(nnz(Δ)) seed on the family's device, then the graph-axis
        # resume loop re-converges every row on the mesh
        from repro_torch.distributed.datalog import sharded_resume_fixpoint
        from repro_torch.incremental import delta_seed
        d0 = delta_seed(delta_op, prev, backend="torch")
        y, _ = sharded_resume_fixpoint(fam.sharded, prev, d0,
                                       mesh=graph_mesh,
                                       max_iters=fam.max_iters)
    else:
        y, _ = delta_restart_fixpoint(fam.edges, delta_op, prev,
                                      max_iters=fam.max_iters, mode="jit")
    for i, s in enumerate(sources):
        fam.answers.replace(s, y[i])
    stats["answers_repaired"] += len(sources)


def _nonmono_edges(fam: Family, coords, values, op: str,
                   stats: dict, graph_mesh) -> None:
    """The non-monotone update path: ``op="delete"`` removes keys,
    ``op="increase"`` replaces stored values with larger ones (delete
    the old ⊕ merge the new)."""
    from repro_torch.incremental import (DeltaEntry, ensure_rule,
                                         maintain_nonmonotone)
    from repro_torch.incremental import maintenance
    fam.kernel_cache.clear()
    vf = fam.plan.strata[0].vf
    # the touched keys' *old* stored values (operator space), gathered
    # before mutating: they decide which removals carried support
    dcoords = dvals = new_delta = None
    if isinstance(fam.edges, SparseRelation):
        dh = operator_delta(fam, coords, None)
        dcoords = dh.coords[:dh.nnz]
        dvals = maintenance._gather_values(fam.edges, dcoords)
        if op == "increase":
            new_delta = operator_delta(fam, coords, values)
    if fam.edge_rel is not None:
        ent = [DeltaEntry(fam.edge_rel, coords,
                          values if op == "increase" else None, op)]
        fam.db = fam.db.apply_delta(ent)
        fam.host_db = fam.host_db.apply_delta(ent)
    if dcoords is not None:
        # in place at the same capacity: shapes, plan and every runner
        # keyed on them survive untouched
        fam.edges = fam.edges.delete_keys(dcoords)
        if new_delta is not None:
            k = new_delta.nnz
            fam.edges = fam.edges.apply_delta(new_delta.coords[:k],
                                              new_delta.values[:k])
    elif fam.edge_rel is not None:
        fam.edges = planner.materialize_edges(fam.plan, fam.db, fam.hints)
    else:
        sr = sr_mod.get(vf.semiring)
        c = torch.from_numpy(np.atleast_2d(np.asarray(coords, np.int64)))
        keys = _dense_keys(fam, c.to(fam.device))
        keep = keys >= 0
        new = (sr.zeros((int(keys.shape[0]),), fam.device) if op == "delete"
               else torch.from_numpy(np.asarray(values, np.float32)).to(
                   fam.device, sr.dtype))
        flat = fam.edges.reshape(-1).clone()
        flat[keys[keep]] = new[keep]
        fam.edges = flat.reshape(fam.edges.shape)
    if fam.sharded is not None:
        # re-partition the mutated operator
        from repro_torch.distributed.datalog import shard_relation
        fam.sharded = shard_relation(fam.edges, graph_mesh)
    if fam.init_reads_edges:
        # the update also changed the init term — memoized inits and warm
        # answers are both stale beyond what the rule repairs
        fam.init_cache.clear()
        _drop_answers(fam, stats)
        return
    if not len(fam.answers):
        return
    # non-monotone: warm answers may over-derive.  A CEGIS-verified
    # ⊖/recount rule repairs them in place; without one (no ⊖ on the
    # semiring, synthesis failed, dense or sharded operator) they are
    # dropped
    if dcoords is None or fam.sharded is not None:
        _drop_answers(fam, stats)
        return
    rule = ensure_rule(vf.signature, vf.semiring, op)
    if not rule.verified:
        _drop_answers(fam, stats)
        return
    sources = list(fam.answers.keys())
    prev = _warm_pack(fam, sources, len(sources))
    init = inits_on(fam, [family_init(fam, s) for s in sources])
    y, _ = maintain_nonmonotone(fam.edges, dcoords, dvals, prev, init,
                                rule, merge_delta=new_delta,
                                max_iters=fam.max_iters)
    for i, s in enumerate(sources):
        fam.answers.replace(s, y[i])
    stats["answers_repaired"] += len(sources)
