"""Cost-based execution planning: one ``plan → explain → execute`` pipeline.

The counterpart of ``repro/core/planner.py``.  :func:`plan_program`
chooses a physical runner and per-relation storage for every stratum,
:func:`explain` renders the choice, and :func:`execute_plan` /
:func:`compile_batched` run it.  Candidates are
priced only for the runners this package has (:data:`RUNNERS`): the
worklist ``sparse_frontier`` is a candidate for single-shot latency on
a CPU database only, as on the reference's CPU host.  Under
``objective="incremental"`` the warm-repair strategies
``delta_restart`` and ``synth_maintenance`` are priced against every
full recompute (:mod:`repro_torch.incremental` executes them).  A graph
mesh (``mesh=``: a :class:`~repro_torch.launch.mesh.GraphMesh`, or a
plain int D for planning only) offers the row-partitioned
``sparse_sharded`` runner, priced by :data:`SHARDED_COST` and rejected
with a recorded reason below its crossover, on a single-rank mesh or on
a dense operator; ``mesh=None`` plans are those of a planner without
the branch.  ``cost_model="hlo"`` re-prices each candidate from one
staged step of its own, counted op by op
(:mod:`repro_torch.launch.hlo_cost`); a kernel that fails while staging
raises instead of leaving the analytic price standing.

Where the reference asks ``jax.default_backend()``, this planner asks
the database's device type ("cuda" / "cpu"): the device decides which
candidates are offered and how the fused kernel is priced.

Storage is folded into planning through the hysteresis thresholds of
:mod:`repro_torch.sparse.adaptive`.  Staged state (materialized
operators, init vectors, storage conversions) is cached on the Program
object, keyed by :func:`db_fingerprint` — weakref tokens of the
relation tensors, never raw ``id()``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import math
import weakref
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.core import engine, ir, vectorize
from repro_torch.core import semiring as sr_mod
from repro_torch.sparse import adaptive
from repro_torch.sparse.coo import DENSIFY_LIMIT, SparseRelation

#: physical runners, in tie-break preference order (earlier wins ties).
#: "delta_restart" is the incremental-maintenance strategy: it resumes
#: the previous solution instead of recomputing, so at equal priced cost
#: it can only do less work — hence it leads the order.
#: "synth_maintenance" is its non-monotone sibling: a CEGIS-verified
#: ⊖/recount rule repairing deletes/weight-increases from the warm
#: solution; it is only *considered* under ``objective="incremental"``
#: with a non-merge ``delta_op`` and a verified rule already in the
#: maintenance cache.  Both are executed by
#: :func:`repro_torch.incremental.refresh_program`, never by
#: :func:`execute_plan` (which has no previous solution to restart from).
RUNNERS = ("synth_maintenance", "delta_restart", "sparse_sharded",
           "sparse_frontier_pallas", "sparse_jit", "sparse_frontier",
           "vector_dense", "dense_gsn", "dense_naive", "dense_host")

#: runners that execute the vector equation ``x = init ⊕ x ⊗ E``;
#: "sparse_frontier_pallas" is the staged loop with the fused B1 advance,
#: "sparse_frontier" the worklist over the CSR index
VECTOR_RUNNERS = ("sparse_jit", "sparse_frontier", "sparse_frontier_pallas",
                  "vector_dense")

#: every vector-equation runner ``compile_batched`` can batch: the
#: single-device four plus the graph-axis sharded loop
#: (:mod:`repro_torch.distributed.datalog`)
BATCHED_RUNNERS = VECTOR_RUNNERS + ("sparse_sharded",)

#: legacy ``run_program`` mode strings → forced runners.  Any other
#: string raises "unknown mode" (the reference sends it to
#: ``dense_host``, so a typo would run the host loop unnoticed)
LEGACY_MODES = {"naive": "dense_naive", "seminaive": "dense_gsn",
                "host": "dense_host"}

#: max trip-count the analytic model will predict (deep chains saturate)
_TRIP_CAP = 64

#: staged-state cache entries kept per Program object
_CACHE_MAX = 512


# --------------------------------------------------------------------------
# Stable relation fingerprints
# --------------------------------------------------------------------------

_fp_tokens: dict[int, tuple[int, object]] = {}
_fp_counter = itertools.count()


def _token(obj) -> int:
    """A process-unique token for ``obj`` that is never recycled: the id
    is only a lookup hint, and a weakref callback evicts the entry when
    the referent dies (torch tensors and SparseRelations are
    weakref-able)."""
    key = id(obj)
    ent = _fp_tokens.get(key)
    if ent is not None and ent[1]() is not obj:
        ent = None  # id recycled before the callback ran
    if ent is None:
        tok = next(_fp_counter)

        def _evict(ref, k=key):
            cur = _fp_tokens.get(k)
            if cur is not None and cur[1] is ref:
                _fp_tokens.pop(k, None)

        try:
            ref = weakref.ref(obj, _evict)
        except TypeError:
            return tok  # not weakref-able: never memoize
        _fp_tokens[key] = (tok, ref)
        return tok
    return ent[0]


def value_fingerprint(v) -> tuple:
    """Stable fingerprint of one stored relation."""
    if isinstance(v, SparseRelation):
        return ("coo", v.shape, v.semiring, _token(v.coords),
                _token(v.values))
    return (_token(v), tuple(getattr(v, "shape", ())),
            str(getattr(v, "dtype", type(v).__name__)))


def db_fingerprint(db: engine.Database, names=None) -> tuple:
    """Fingerprint of (a subset of) a database's relations, plus its sort
    domains and device."""
    if names is None:
        names = db.relations
    return (str(db.device), tuple(sorted(db.domains.items())),
            tuple((n, value_fingerprint(db.relations[n]))
                  for n in sorted(names) if n in db.relations))


# --------------------------------------------------------------------------
# Plan data model
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanHints:
    """Typed planning hints: ``sorts`` maps variable names to sort names,
    overriding ``Program.sort_hints``.  ``adaptive=True`` turns on
    mid-fixpoint re-planning in :func:`execute_plan`: chunkable vector
    strata run under :func:`repro_torch.core.runners.adaptive_fixpoint`
    and may switch runners at chunk boundaries.  ``replan`` overrides
    the default :class:`repro_torch.sparse.adaptive.ReplanPolicy`."""

    sorts: Mapping[str, str] = dataclasses.field(default_factory=dict)
    adaptive: bool = False
    replan: object | None = None

    def __post_init__(self):
        for k, v in dict(self.sorts).items():
            if not isinstance(k, str) or not isinstance(v, str):
                raise TypeError(f"PlanHints.sorts maps variable names to "
                                f"sort names, got {k!r}: {v!r}")
        if self.replan is not None and \
                not isinstance(self.replan, adaptive.ReplanPolicy):
            raise TypeError(f"PlanHints.replan must be a ReplanPolicy, "
                            f"got {type(self.replan).__name__}")

    @classmethod
    def of(cls, hints, *, defaults=None) -> "PlanHints":
        if hints is None:
            return cls(sorts=dict(defaults or {}))
        if isinstance(hints, cls):
            return hints
        raise TypeError(f"hints must be a PlanHints, got "
                        f"{type(hints).__name__}")

    def cache_key(self) -> tuple:
        return (tuple(sorted(dict(self.sorts).items())), self.adaptive,
                self.replan)


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Per-iteration work × predicted trip count for one candidate."""

    flops_per_iter: float
    bytes_per_iter: float
    trips: int
    source: str = "analytic"

    @property
    def total(self) -> float:
        return self.flops_per_iter * self.trips


@dataclasses.dataclass
class ShardedCostModel:
    """Constants behind the ``sparse_sharded`` candidate.

    Sharding pays a fixed per-round toll — D synchronizing collectives
    plus the exchanged frontier bytes — so it only wins once per-rank
    work dwarfs that toll.  Below ``min_work_per_device`` the partition
    is rejected outright; above it the candidate is priced with its sync
    and byte terms.

    The fields, defaults and arithmetic are the reference's CPU
    constants, fitted to its host-simulated devices; they are
    **uncalibrated on CUDA**, and one card cannot calibrate D > 1.
    ``sync_flops``' ``backend`` is the database's device type.  Tests
    monkeypatch the fields to pin either side of the crossover.
    """

    #: (nnz + n)/D per iteration below which sharding cannot recoup its
    #: collective overhead
    min_work_per_device: float = 2.0e4
    #: flop-equivalent cost of one synchronizing collective per device
    sync_flops_per_device: float = 1.0e4
    #: flop-equivalent cost per exchanged byte
    byte_flops: float = 0.05

    def sync_flops(self, d: int, backend: str) -> float:
        # host-simulated devices share cores: collectives serialize,
        # so the toll grows ~D per participant instead of staying flat
        scale = d if backend == "cpu" else 1
        return self.sync_flops_per_device * d * scale


#: module-level so tests and calibration sweeps can patch it in place
SHARDED_COST = ShardedCostModel()


@dataclasses.dataclass
class SpmmKernelModel:
    """Constants behind the ``sparse_frontier_pallas`` candidate: the
    fused advance is priced as the torch step scaled by a per-iteration
    speedup, offered above a crossover ``min_nnz``.

    * ``"cuda"`` — measured: the torch round's advance
      (``contract.spmm(edges, d, transpose=True)``: gather, ⊗, B3's
      scatter) over B1's, at the batched phase's shape (the 1,788,490-
      edge power-law operator, d of 81,306 × 256), on an NVIDIA H100
      80GB HBM3 at a 700 W power limit (``chip_smoke.py``'s kernels
      phase, ``torch_round_ms / ms``): 𝔹 3.224 / 0.0628 ms = 51.3
      (``words_bool``), trop 4.066 / 0.2665 ms = 15.3 (``lanes_f32``).
      maxplus runs trop's kernel and takes trop's ratio; it was not
      timed.
    * ``"cpu"`` — the reference's host entry (𝔹 only), so that on a CPU
      database the same candidates are offered as in the reference and
      the parity tests pick the same runner; the CPU runs B1's plain
      version, which is not faster.  Uncalibrated, as in the reference.

    ``min_nnz`` is the reference's crossover, not measured here.  Tests
    monkeypatch the fields to pin either side of the crossover.
    """

    min_nnz: float = 4096.0
    speedups: dict = dataclasses.field(default_factory=lambda: {
        "cuda": {"bool": 51.3, "trop": 15.3, "maxplus": 15.3},
        "cpu": {"bool": 8.0},
    })

    def speedup(self, semiring: str, device_type: str) -> float:
        """Per-iteration win on this device type; ≤ 1 ⇒ no win."""
        return float(self.speedups.get(device_type, {}).get(semiring, 0.0))


#: module-level so tests and calibration sweeps can patch it in place
SPMM_COST = SpmmKernelModel()


def spmm_exec_backend(runner: str = "sparse_frontier_pallas",
                      device="cuda") -> str:
    """The reference's planner entry point for
    :func:`repro_torch.core.runners.spmm_exec_backend`: the backend a
    runner's SpMM executes with on ``device``; the serve loops' compile
    caches key on it."""
    from repro_torch.core import runners
    return runners.spmm_exec_backend(runner, device)


@dataclasses.dataclass
class StratumPlan:
    """The physical choice for one fixpoint stratum."""

    index: int
    idbs: tuple[str, ...]
    runner: str
    reason: str
    storage: dict[str, str]        # relation → target repr (changes only)
    storage_notes: dict[str, str]  # relation → human-readable decision
    reads: tuple[str, ...]         # relation names this stratum consumes
    cost: CostEstimate | None
    considered: dict[str, CostEstimate]
    rejected: dict[str, str]
    vf: vectorize.VectorForm | None = None
    edges_override: object | None = None
    partition: str | None = None   # sparse_sharded: the graph-axis split
    #: trace of the last *adaptive* execution of this stratum (a
    #: :class:`repro_torch.core.runners.AdaptiveRun`), set by
    #: :func:`execute_plan` and rendered by :func:`explain`; ``None``
    #: until then, so static plans render as before
    switch_log: object | None = None


@dataclasses.dataclass
class ExecutionPlan:
    """A fully-decided physical plan for a Program against one database
    shape and device."""

    program: str
    objective: str
    mode: str
    strata: list[StratumPlan]
    outputs: tuple[str, ...]
    has_post: bool
    signature: str
    device: str = "cuda"
    #: the graph mesh this plan was priced against — a GraphMesh
    #: (executable) or a plain int D (planning and explain only;
    #: execution resolves a mesh of that size).  None: single-device
    mesh: object | None = None
    #: execute with mid-fixpoint re-planning (from PlanHints.adaptive)
    adaptive: bool = False
    #: the ReplanPolicy to execute under (from PlanHints.replan)
    replan: object | None = None


# --------------------------------------------------------------------------
# Planning
# --------------------------------------------------------------------------


def plan_program(prog, db: engine.Database, hints=None, *,
                 objective: str = "latency", mode: str = "auto",
                 max_iters: int = 10_000, cost_model: str = "analytic",
                 edges=None, adapt_storage: bool = True,
                 require_vector: bool = False,
                 delta_nnz: int | None = None,
                 delta_op: str = "merge",
                 mesh=None) -> ExecutionPlan:
    """Choose a physical runner + storage for every stratum of ``prog``.

    ``objective`` is "latency" (one query), "throughput" (batched
    serving: only vector runners, and the fused kernel is offered) or
    "incremental" (a warm previous solution exists and ``delta_nnz``
    tuples just changed — "delta_restart" is priced at O(nnz(Δ) ·
    affected-trip-count) against every full-recompute candidate).
    ``delta_op`` classifies the update: ``"merge"`` (monotone ⊕, the
    default) keeps delta-restart in play, while ``"delete"``/
    ``"increase"``/``"mixed"`` reject it with a recorded reason and
    consider "synth_maintenance" whenever a CEGIS-verified ⊖/recount rule
    for (program signature, semiring, op) is already cached
    (:func:`repro_torch.incremental.maintenance.cached_rule`; planning
    never synthesizes — callers run ``ensure_rule`` first).
    ``mode`` other than "auto" forces a runner on every stratum.
    ``PlanHints(adaptive=True)`` marks the plan for mid-fixpoint
    re-planning at execution; its candidates are the stratum's
    ``considered`` runners, so on a CUDA database the worklist is not
    among them.
    ``edges`` overrides the extracted linear operator of a single-stratum
    vector program.  ``adapt_storage=False`` pins every relation to its
    caller-chosen representation.  ``require_vector=True`` raises
    ``ValueError`` when stratum 0 cannot take a vector runner.
    ``mesh`` (a GraphMesh, or an int D for planning only) makes the
    row-partitioned ``sparse_sharded`` runner a candidate, priced at the
    per-shard work plus the per-round collectives and frontier bytes
    (:data:`SHARDED_COST`); a forced ``mode="sparse_sharded"`` needs
    one.
    """
    if objective not in ("latency", "throughput", "incremental"):
        raise ValueError(f"unknown objective {objective!r}")
    if cost_model not in ("analytic", "hlo"):
        raise ValueError(f"unknown cost_model {cost_model!r}; have "
                         f"'analytic' or 'hlo'")
    ph = PlanHints.of(hints, defaults=prog.sort_hints)
    hints = dict(ph.sorts)
    if mesh is not None:
        from repro_torch.distributed.datalog import mesh_size
        mesh_size(mesh)  # validate early: a GraphMesh or an int D ≥ 1
    forced = None
    if mode != "auto":
        forced = mode if mode in RUNNERS else LEGACY_MODES.get(mode)
        if forced is None:
            raise ValueError(f"unknown mode {mode!r}; have 'auto', "
                             f"{sorted(LEGACY_MODES)} or {RUNNERS}")
        if forced in ("delta_restart", "synth_maintenance"):
            raise ValueError(
                f"{forced} cannot be forced by mode= — it needs a "
                "previous solution; use objective='incremental' and "
                "repro_torch.incremental.refresh_program")
        if forced == "sparse_sharded" and mesh is None:
            raise ValueError(
                "sparse_sharded needs a graph mesh — pass mesh= "
                "(launch.mesh.make_graph_mesh) alongside the forced mode")
    plans = []
    for si, stratum in enumerate(prog.strata):
        plans.append(_plan_stratum(
            prog, stratum, si, db, hints, objective=objective,
            forced=forced, edges=edges if si == 0 else None,
            adapt_storage=adapt_storage and forced is None,
            max_iters=max_iters,
            delta_nnz=delta_nnz if si == 0 else None,
            delta_op=delta_op, mesh=mesh, cost_model=cost_model))
    plan = ExecutionPlan(
        prog.name, objective, mode, plans,
        tuple(r.head for r in prog.outputs), prog.post is not None,
        _plan_signature(prog, db, plans), device=db.device.type, mesh=mesh,
        adaptive=ph.adaptive, replan=ph.replan)
    if require_vector:
        sp = plan.strata[0] if plan.strata else None
        if sp is None or sp.runner not in BATCHED_RUNNERS:
            why = "program has no fixpoint stratum" if sp is None \
                else _vector_rejection(sp.rejected)
            raise ValueError(f"{prog.name}: {why}")
    return plan


def _vector_rejection(rejected: Mapping[str, str]) -> str:
    return (rejected.get("sparse_jit") or rejected.get("vector_dense")
            or "no vector-form runner is feasible")


def plan_for(prog, db: engine.Database, *, mode: str = "auto",
             max_iters: int = 10_000, objective: str = "latency",
             hints=None) -> ExecutionPlan:
    """Memoized :func:`plan_program`, cached on the Program object and
    keyed by the database fingerprint (device included)."""
    ph = PlanHints.of(hints, defaults=prog.sort_hints)
    cache = prog.__dict__.setdefault("_plan_cache", {})
    reads: set[str] = set()
    for stratum in prog.strata:
        reads |= _referenced(stratum)
    key = ("plan", mode, objective, max_iters, db.device.type,
           ph.cache_key(), db_fingerprint(db, reads & set(db.relations)))
    plan = _cache_get(cache, key)
    if plan is None:
        plan = cache[key] = plan_program(prog, db, ph, mode=mode,
                                         objective=objective,
                                         max_iters=max_iters)
    return plan


def _cache_get(cache: dict, key):
    """Cache lookup that refreshes recency (eviction pops the oldest)."""
    if key in cache:
        cache[key] = cache.pop(key)
        return cache[key]
    return None


def _referenced(stratum) -> set[str]:
    names: set[str] = set()
    exprs = [r.body for r in stratum.rules.values()]
    if stratum.init:
        exprs.extend(stratum.init.values())
    for e in exprs:
        for t in e.terms:
            for a in t.atoms:
                if isinstance(a, ir.RelAtom):
                    names.add(a.name)
    return names


def _edge_rel_name(vf: vectorize.VectorForm) -> str | None:
    a = vectorize.edge_atom(vf)
    return a.name if a is not None else None


def _trip_estimate(n: int, nnz: float, cap: int = _TRIP_CAP) -> int:
    """Heuristic fixpoint depth: ≈ diameter of a random graph with the
    observed average degree, clipped to [3, ``cap``]."""
    deg = nnz / max(n, 1)
    if deg <= 1.0:
        return cap
    return int(min(cap, max(
        3, math.ceil(math.log(max(n, 2)) / math.log(deg)))))


def _term_flops(term: ir.Term, sorts: Mapping[str, str],
                db: engine.Database, planned: Mapping[str, str],
                densities: Mapping[str, float], semiring: str) -> float:
    """Work of one sum-product term ≈ the broadcast join size, scaled by
    the density of any sparse-stored binary relation the engine keeps
    sparse in it.  An atom the engine densifies (a cast, a negation, a
    constant or repeated argument — ``engine._rel_factor``) costs its
    dense size; the reference discounts those too, which on the
    81k-vertex CC graph priced a dense n² join as O(nnz)."""
    size = 1.0
    for v in sorted(term.vars()):
        size *= float(db.dom(sorts.get(v, "id")))
    scale = 1.0
    for a in term.atoms:
        if (isinstance(a, ir.RelAtom) and planned.get(a.name) == "sparse"
                and a.name in densities
                and _stays_sparse(a, db.schema, semiring)):
            scale = min(scale, max(densities[a.name], 1e-12))
    return max(size * scale, 1.0)


def _stays_sparse(a: ir.RelAtom, schema, semiring: str) -> bool:
    """Whether the engine contracts a sparse-stored atom as COO (the
    ``plain`` test of ``engine._rel_factor``)."""
    args_are_vars = not any(isinstance(x, ir.C) for x in a.args)
    return (args_are_vars and len(set(a.args)) == len(a.args)
            and not a.neg and not a.cast
            and schema[a.name].semiring == semiring)


def _rel_shape(arr) -> tuple:
    return tuple(arr.shape)


def _arity(arr) -> int:
    return arr.arity if isinstance(arr, SparseRelation) else arr.dim()


def _plan_stratum(prog, stratum, si, db, hints, *, objective, forced,
                  edges, adapt_storage, max_iters, delta_nnz=None,
                  delta_op="merge", mesh=None,
                  cost_model="analytic") -> StratumPlan:
    reads = tuple(sorted(_referenced(stratum)))
    if forced is not None:
        return _forced_stratum_plan(prog, stratum, si, forced, reads, edges,
                                    mesh=mesh)
    device_type = db.device.type

    # -- storage folding (adaptive density thresholds) ----------------------
    storage: dict[str, str] = {}
    notes: dict[str, str] = {}
    densities: dict[str, float] = {}
    for name in (n for n in reads if n in db.relations):
        arr = db.relations[name]
        if _arity(arr) != 2:
            continue  # only binary relations have sparse contraction paths
        d = adaptive.density(arr, db.schema[name].semiring)
        densities[name] = d
        cur = db.storage_of(name)
        target = adaptive.decide(d, cur) if adapt_storage else cur
        if target != cur:
            storage[name] = target
            bound = (f"< {adaptive.SPARSIFY_BELOW:g}" if target == "sparse"
                     else f"> {adaptive.DENSIFY_ABOVE:g}")
            notes[name] = f"{cur}→{target} (density {d:.3g} {bound})"
    planned = {name: storage.get(name, db.storage_of(name))
               for name in reads}

    shapes = {n: tuple(db.dom(s) for s in prog.schema[n].sorts)
              for n in stratum.idbs}
    state = float(sum(float(np.prod(s)) for s in shapes.values()))
    nnz_total = sum(densities[n] *
                    float(np.prod(_rel_shape(db.relations[n])))
                    for n in densities)
    n_dom = int(max((d for s in shapes.values() for d in s), default=1))

    considered: dict[str, CostEstimate] = {}
    rejected: dict[str, str] = {}

    # -- vector-equation feasibility (also pins the trip estimate) ---------
    vf = None
    if len(prog.strata) != 1:
        why = "multi-stratum program (the vector equation covers exactly " \
              "one stratum)"
        for r in VECTOR_RUNNERS:
            rejected[r] = why
    else:
        try:
            vf = vectorize.vector_form(prog)
        except ValueError as e:
            for r in VECTOR_RUNNERS:
                rejected[r] = str(e)
    if vf is not None and sr_mod.get(vf.semiring).minus is None:
        why = (f"semiring {vf.semiring} lacks ⊖ — the vector GSN "
               f"runners need an idempotent lattice")
        for r in VECTOR_RUNNERS:
            rejected[r] = why
        vf = None
    e_nnz = None
    n_vec = n_dom
    if vf is not None:
        n_vec = db.dom(vf.out_sort)
        if edges is not None:
            if isinstance(edges, SparseRelation):
                e_nnz = float(edges.nnz)
            # a dense override keeps the vector_dense candidate below
        else:
            ename = _edge_rel_name(vf)
            if (ename is not None and ename in db.relations
                    and planned.get(ename) == "sparse"):
                arr = db.relations[ename]
                if isinstance(arr, SparseRelation):
                    e_nnz = float(arr.nnz)
                else:
                    e_nnz = densities[ename] * float(
                        np.prod(_rel_shape(arr)))

    # one trip estimate for the whole stratum: every runner executes the
    # same fixpoint
    trip_cap = int(max(1, min(_TRIP_CAP, max_iters)))
    if e_nnz is not None:
        trips = _trip_estimate(n_vec, e_nnz, trip_cap)
    else:
        trips = _trip_estimate(n_dom,
                               nnz_total if nnz_total else n_dom * 8.0,
                               trip_cap)

    # -- dense engine candidates ------------------------------------------
    naive_f = state
    gsn_f = state
    for rule in stratum.rules.values():
        sorts = engine.infer_var_sorts(rule.body, prog.schema, hints)
        for t in rule.body.terms:
            f = _term_flops(t, sorts, db, planned, densities,
                            rule.body.semiring)
            naive_f += f
            if any(isinstance(a, ir.RelAtom) and a.name in stratum.rules
                   for a in t.atoms):
                gsn_f += f
    considered["dense_naive"] = CostEstimate(naive_f, 4.0 * naive_f, trips)
    no_minus = [n for n in stratum.idbs
                if sr_mod.get(prog.schema[n].semiring).minus is None]
    if not stratum.is_linear():
        rejected["dense_gsn"] = "non-linear recursion (δF needs a linear " \
                                "program)"
    elif no_minus:
        rejected["dense_gsn"] = (
            f"semiring {prog.schema[no_minus[0]].semiring} lacks ⊖ — GSN "
            f"needs an idempotent lattice")
    else:
        considered["dense_gsn"] = CostEstimate(gsn_f, 4.0 * gsn_f, trips)

    # -- vector-equation candidates ---------------------------------------
    if vf is not None:
        n = n_vec
        if e_nnz is not None:
            # staged loop: a full O(nnz) vspm re-derivation per iteration
            considered["sparse_jit"] = CostEstimate(
                e_nnz + n, 12.0 * e_nnz + 4.0 * n, trips)
            # worklist: O(nnz) *total* edge expansions (each vertex
            # settles ~once) plus an O(n) Δ-scan per round
            considered["sparse_frontier"] = CostEstimate(
                e_nnz / trips + n, 12.0 * e_nnz / trips + 4.0 * n, trips)
            rejected["vector_dense"] = ("linear operator is sparse — the "
                                        "SpMV/SpMM runners cover it")
        else:
            considered["vector_dense"] = CostEstimate(
                float(n) * n + n, 4.0 * (float(n) * n + n), trips)
            why = "linear operator materializes dense (no sparse binary " \
                  "EDB fast path)"
            rejected["sparse_jit"] = why
            rejected["sparse_frontier"] = why

    # -- graph-axis sharded candidate ----------------------------------------
    # row-partitioned SpMM over the mesh's ranks with the Δ-sparse
    # frontier exchange: per-round critical-path work is the balanced
    # shard's frontier-proportional expansion (amortized e_nnz/trips)
    # plus its O(n/D) carry update — and every round pays D
    # synchronizing collectives and the exchanged bytes.  The mesh is an
    # offer: below the crossover the candidate is rejected, so the
    # single-device runners keep the regimes they win.
    partition = None
    if mesh is not None:
        if vf is None:
            rejected["sparse_sharded"] = _vector_rejection(rejected)
        else:
            from repro_torch.distributed.datalog import mesh_size
            d_ax = mesh_size(mesh)
            nb = -(-n_vec // d_ax)
            if d_ax < 2:
                rejected["sparse_sharded"] = (
                    "graph mesh has a single device — the single-device "
                    "runners cover it")
            elif e_nnz is None:
                rejected["sparse_sharded"] = (
                    "linear operator materializes dense (no sparse "
                    "binary EDB fast path)")
            else:
                cm = SHARDED_COST
                work_dev = (e_nnz + n_vec) / d_ax
                if work_dev < cm.min_work_per_device:
                    rejected["sparse_sharded"] = (
                        f"below the sharding crossover: "
                        f"≈{work_dev:.3g} work/device/iter < "
                        f"{cm.min_work_per_device:g} measured minimum "
                        f"(BENCH_sharded.json) — one device wins")
                else:
                    itemsize = sr_mod.get(vf.semiring).dtype.itemsize
                    dense_b = float(itemsize) * n_vec * (d_ax - 1)
                    delta_b = ((4.0 + itemsize) * (n_vec / trips)
                               * (d_ax - 1))
                    xbytes = min(dense_b, delta_b)
                    sync = cm.sync_flops(d_ax, device_type)
                    considered["sparse_sharded"] = CostEstimate(
                        e_nnz / trips + n_vec / d_ax + sync
                        + cm.byte_flops * xbytes,
                        12.0 * e_nnz / (trips * d_ax) + xbytes,
                        trips)
                    partition = (
                        f"graph axis D={d_ax} × {nb} dst rows/shard; "
                        f"nnz(E)={int(e_nnz)} "
                        f"(≈{-(-int(e_nnz) // d_ax)}/shard); "
                        f"Δ-exchange ≈{int(xbytes)} B/iter "
                        f"(dense all-gather {int(dense_b)} B)")

    # -- fused-kernel SpMM candidate (B1) ------------------------------------
    # offered for batched serving only: the fused advance amortizes its
    # per-edge index reads across the B query lanes.  When an offered
    # mesh clears the sharding crossover the partition wins outright:
    # the fused kernel is single-device and is not priced against D
    # ranks
    if vf is not None:
        if objective != "throughput":
            rejected["sparse_frontier_pallas"] = (
                "fused-kernel SpMM is a batched-serving backend "
                "(objective='throughput') — single-shot latency keeps "
                "the worklist/staged runners")
        elif e_nnz is None:
            rejected["sparse_frontier_pallas"] = (
                "linear operator materializes dense (no sparse binary "
                "EDB fast path)")
        elif "sparse_sharded" in considered:
            rejected["sparse_frontier_pallas"] = (
                "graph-axis sharding clears its crossover — the fused "
                "kernel is single-device and is not priced against a "
                "D-device mesh")
        else:
            sp_up = SPMM_COST.speedup(vf.semiring, device_type)
            if sp_up <= 1.0:
                rejected["sparse_frontier_pallas"] = (
                    f"no fused-kernel win recorded for {vf.semiring} on "
                    f"{device_type} (SPMM_COST)")
            elif e_nnz < SPMM_COST.min_nnz:
                rejected["sparse_frontier_pallas"] = (
                    f"below the fused-kernel crossover: "
                    f"nnz(E)={int(e_nnz)} < {SPMM_COST.min_nnz:g}")
            else:
                considered["sparse_frontier_pallas"] = CostEstimate(
                    (e_nnz + n_vec) / sp_up + n_vec,
                    (12.0 * e_nnz + 4.0 * n_vec) / sp_up, trips)

    # the worklist only pays off for single-shot latency and incremental
    # repair on a CPU database (the reference's CPU host); batches and
    # the card want the staged loop (measured on the card for both).  On the card it stays reachable by name
    # (mode="sparse_frontier", or fixpoint(mode="frontier"))
    frontier_ok = (objective in ("latency", "incremental")
                   and device_type == "cpu")
    if "sparse_frontier" in considered and not frontier_ok:
        rejected["sparse_frontier"] = ("host worklist loses to the staged "
                                       "while_loop off-CPU / for batches")
        del considered["sparse_frontier"]
    if objective == "throughput" and \
            any(r in considered for r in VECTOR_RUNNERS):
        for r in ("dense_naive", "dense_gsn"):
            if r in considered:
                rejected[r] = ("not batchable — throughput serving packs "
                               "sources into one vector fixpoint")
                del considered[r]
    if edges is not None:
        # only the vector runners consult an operator override
        for r in ("dense_naive", "dense_gsn"):
            if r in considered:
                rejected[r] = ("edges override requires a vector runner "
                               "(the engine paths read the stored "
                               "relations, not the override)")
                del considered[r]
        if not considered:
            raise ValueError(f"{prog.name}: edges override cannot be "
                             f"honored: {_vector_rejection(rejected)}")

    # -- incremental maintenance: delta-restart / synth_maintenance --------
    # priced at O(nnz(Δ) · affected-trip-count): the warm repair seeds
    # its frontier from the nnz(Δ) touched edges, and per round the
    # affected region grows by ~the average degree, never beyond nnz(E)
    # (full-recompute per-round work).  Only offered under
    # objective="incremental" so latency/throughput plans are unchanged.
    # Monotone ⊕-merges take "delta_restart"; deletes and weight
    # increases void its pre-fixpoint property and instead take
    # "synth_maintenance" — but only when a CEGIS-verified ⊖/recount
    # rule is already cached for (signature, semiring, op); planning has
    # no side effects, so it never synthesizes one.
    synth_rule = None
    if objective == "incremental":
        if delta_nnz is None:
            rejected["delta_restart"] = (
                "no update delta recorded — pass delta_nnz "
                "(repro_torch.incremental.refresh_program does)")
            rejected["synth_maintenance"] = rejected["delta_restart"]
        elif vf is None:
            rejected["delta_restart"] = _vector_rejection(rejected)
            rejected["synth_maintenance"] = rejected["delta_restart"]
        elif e_nnz is None:
            rejected["delta_restart"] = (
                "linear operator materializes dense — delta seeding "
                "needs the sparse fast path")
            rejected["synth_maintenance"] = rejected["delta_restart"]
        elif delta_op == "merge":
            deg = max(1.0, e_nnz / max(n_vec, 1))
            affected = min(float(e_nnz), float(delta_nnz) * deg)
            considered["delta_restart"] = CostEstimate(
                affected + 1.0, 12.0 * affected, trips)
            rejected["synth_maintenance"] = (
                "update is a monotone ⊕-merge — delta-restart needs no "
                "synthesized ⊖/recount rule")
        else:
            rejected["delta_restart"] = (
                f"{delta_op} is non-monotone (not a ⊕-merge) — the old "
                f"solution is no pre-fixpoint of the new operator and a "
                f"warm restart could over-derive (DESIGN.md §11)")
            from repro_torch.incremental import maintenance as _mt
            rule = _mt.cached_rule(vf.signature, vf.semiring, delta_op)
            if rule is None:
                rejected["synth_maintenance"] = (
                    f"no maintenance rule cached for ({vf.semiring}, "
                    f"{delta_op}) — run repro_torch.incremental."
                    f"maintenance.ensure_rule first")
            elif not rule.verified:
                rejected["synth_maintenance"] = (
                    f"rule synthesis failed: {rule.reason}")
            else:
                synth_rule = rule
                # seeds ≤ nnz(Δ); the tight cone grows by ~deg per hop
                # and its in-edge recount re-reads each cone vertex's
                # in-adjacency once — a constant factor over the
                # delta-restart frontier estimate
                deg = max(1.0, e_nnz / max(n_vec, 1))
                affected = min(float(e_nnz), float(delta_nnz) * deg)
                considered["synth_maintenance"] = CostEstimate(
                    2.0 * affected + 1.0, 16.0 * affected, trips)

    if cost_model == "hlo":
        considered = _hlo_costs(considered, rejected, stratum, db, hints,
                                vf, edges, trips, storage)

    # -- selection ---------------------------------------------------------
    pref = list(RUNNERS)
    if frontier_ok:     # where it is offered, the worklist wins a tie
        pref.remove("sparse_frontier")
        pref.insert(0, "sparse_frontier")
    # totals equal to 12 significant digits are a tie: float noise (n²
    # times a density is not exactly nnz) must not outrank the
    # preference order
    runner = min(considered,
                 key=lambda k: (float(f"{considered[k].total:.12g}"),
                                pref.index(k)))
    reason = (f"min est. total flops among "
              f"{len(considered)} feasible candidates")
    if runner == "sparse_frontier":
        reason += " (cpu host ⇒ frontier worklist)"
    if runner == "delta_restart":
        reason += (f" (warm restart: nnz(Δ)={int(delta_nnz)} seeds the "
                   f"frontier)")
    if runner == "synth_maintenance":
        reason += (f" (synthesized rule {synth_rule.name} repairs the "
                   f"{delta_op} in-place: {synth_rule.reason})")
    return StratumPlan(si, tuple(stratum.idbs), runner, reason, storage,
                       notes, reads, considered[runner], considered,
                       rejected, vf, edges,
                       partition if runner == "sparse_sharded" else None)


def _forced_stratum_plan(prog, stratum, si, forced, reads, edges, *,
                         mesh=None) -> StratumPlan:
    """Forced plans: the runner is predetermined, storage stays as the
    caller chose it, no candidates are priced."""
    vf = None
    partition = None
    if forced in BATCHED_RUNNERS:
        if len(prog.strata) != 1:
            raise ValueError(
                f"{prog.name}: cannot force runner {forced!r}: "
                f"multi-stratum program")
        try:
            vf = vectorize.vector_form(prog)
        except ValueError as e:
            raise ValueError(
                f"{prog.name}: cannot force runner {forced!r}: {e}")
        if forced == "sparse_sharded":
            from repro_torch.distributed.datalog import mesh_size
            partition = f"graph axis D={mesh_size(mesh)} (forced)"
    elif edges is not None:
        raise ValueError(
            f"{prog.name}: edges override cannot be honored by forced "
            f"runner {forced!r} — the dense engine paths read the stored "
            f"relations, not the override")
    return StratumPlan(si, tuple(stratum.idbs), forced,
                       f"forced by mode={forced!r}", {}, {}, reads,
                       None, {}, {}, vf, edges, partition)


#: candidates with no single-device step to stage: the warm repairs
#: need a previous solution, the sharded loop's step is a rank's, and
#: the fused kernel is re-derived from ``sparse_jit``'s count below
_NOT_STAGED = ("delta_restart", "synth_maintenance", "sparse_sharded",
               "sparse_frontier_pallas")


def _hlo_costs(considered, rejected, stratum, db, hints, vf, edges, trips,
               storage):
    """Re-price each candidate from one staged step of its own
    (:func:`repro_torch.launch.hlo_cost.staged_cost`): the dense
    engine's F (``dense_naive``) or δF (``dense_gsn``) on a 0̄ state,
    the staged loop's ``vspm`` (``sparse_jit``, ``sparse_frontier``) or
    ``vector_dense``'s B2 round on a 0̄ vector.  The fused kernel is
    ``sparse_jit``'s count over its measured speedup (``SPMM_COST``).
    Only the candidates of ``_NOT_STAGED`` keep their analytic price.
    A dense engine candidate whose step would densify a relation past
    ``DENSIFY_LIMIT`` cannot run on this database and is moved to
    ``rejected``; any other error while staging raises (the reference
    keeps the analytic price on any error, which here would hide a
    kernel that failed)."""
    from repro_torch.core import program as prog_mod
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import hlo_cost
    from repro_torch.sparse import contract
    out = dict(considered)
    db2 = db
    for name, target in storage.items():
        db2 = db2.with_storage(name, target)

    def price(runner):
        if runner in ("dense_naive", "dense_gsn"):
            ico = (prog_mod.make_ico(stratum, db2, hints)
                   if runner == "dense_naive"
                   else prog_mod.make_delta_ico(stratum, db2, hints))
            c = hlo_cost.staged_cost(ico, prog_mod.zero_state(stratum, db2))
        else:
            sr = sr_mod.get(vf.semiring)
            n = db2.dom(vf.out_sort)
            dense = runner == "vector_dense"
            e = _materialize_edges(vf, db2, hints, override=edges,
                                   densify=dense)
            if dense:
                c = hlo_cost.staged_cost(
                    lambda d: kops.semiring_matmul(sr, d, e),
                    sr.zeros((1, n), db2.device))
            else:
                if not isinstance(e, SparseRelation):
                    e = SparseRelation.from_dense(e, vf.semiring)
                c = hlo_cost.staged_cost(lambda d: contract.vspm(d, e),
                                         sr.zeros((n,), db2.device))
        return CostEstimate(max(c.flops, 1.0), c.bytes, trips, "hlo")

    too_big = _undensifiable(stratum, db2)
    for runner in list(out):
        if runner in ("dense_naive", "dense_gsn") and too_big:
            del out[runner]
            rejected[runner] = (
                f"its step densifies {too_big}, past the "
                f"{DENSIFY_LIMIT:,} entries a dense relation may hold — it "
                f"cannot run on this database")
        elif runner not in _NOT_STAGED:
            out[runner] = price(runner)
    base = out.get("sparse_jit")
    if "sparse_frontier_pallas" in out and base is not None:
        s = max(SPMM_COST.speedup(vf.semiring, db.device.type), 1.0)
        out["sparse_frontier_pallas"] = CostEstimate(
            base.flops_per_iter / s, base.bytes_per_iter / s, trips, "hlo")
    return out


def _undensifiable(stratum, db) -> str | None:
    """A sparse-stored relation that the dense engine's step would
    densify (an atom ``_stays_sparse`` refuses) and that holds
    ``DENSIFY_LIMIT`` entries or more, as ``"name[shape]"``; else
    None."""
    for rule in stratum.rules.values():
        for t in rule.body.terms:
            for a in t.atoms:
                arr = db.relations.get(a.name) \
                    if isinstance(a, ir.RelAtom) else None
                if not isinstance(arr, SparseRelation) or (
                        arr.arity == 2 and _stays_sparse(
                            a, db.schema, rule.body.semiring)):
                    continue
                if math.prod(arr.shape) >= DENSIFY_LIMIT:
                    return f"{a.name}{list(arr.shape)}"
    return None


def _plan_signature(prog, db, plans) -> str:
    parts = []
    for sp, stratum in zip(plans, prog.strata):
        shapes = tuple((n, prog.schema[n].semiring,
                        tuple(db.dom(s) for s in prog.schema[n].sorts))
                       for n in sp.idbs)
        core = sp.vf.signature if sp.vf is not None else \
            _stratum_hash(stratum)
        parts.append((sp.runner, shapes, core,
                      tuple(sorted(sp.storage.items()))))
    payload = repr((tuple(r.head for r in prog.outputs), parts))
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def _stratum_hash(stratum) -> str:
    payload = repr(sorted((n, repr(r.body))
                          for n, r in stratum.rules.items()))
    if stratum.init:
        payload += repr(sorted((n, repr(e))
                               for n, e in stratum.init.items()))
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


# --------------------------------------------------------------------------
# Explain
# --------------------------------------------------------------------------


def explain(plan: ExecutionPlan) -> str:
    """Stable, golden-testable rendering of an :class:`ExecutionPlan`."""
    lines = [f"plan {plan.program}  mode={plan.mode}  "
             f"objective={plan.objective}  signature={plan.signature}"]
    for sp in plan.strata:
        lines.append(f"  stratum {sp.index}  runner={sp.runner}  "
                     f"idbs={','.join(sp.idbs)}")
        lines.append(f"    reason      {sp.reason}")
        if sp.partition is not None:
            lines.append(f"    partition   {sp.partition}")
        for name in sorted(sp.storage):
            lines.append(f"    storage     {name}: {sp.storage_notes[name]}")
        if sp.cost is not None:
            c = sp.cost
            lines.append(f"    cost        {c.flops_per_iter:.3g} flops/iter"
                         f" × {c.trips} iters  [{c.source}]")
        if sp.considered:
            body = "  ".join(
                f"{k}={v.total:.3g}" for k, v in
                sorted(sp.considered.items(),
                       key=lambda kv: (kv[1].total, kv[0])))
            lines.append(f"    considered  {body}")
        for k in sorted(sp.rejected):
            lines.append(f"    rejected    {k}: {sp.rejected[k]}")
        if sp.switch_log is not None:
            # only after an adaptive execution; a plan that never ran
            # adaptively renders as the static planner's
            t = sp.switch_log
            lines.append(
                f"    adaptive    {len(t.chunks)} chunks × "
                f"{t.policy.chunk_iters} iters, {len(t.switches)} "
                f"switches, finished on {t.final_runner}")
            for ev in t.switches:
                lines.append(
                    f"    switch      chunk {ev.chunk} @ iter "
                    f"{ev.iteration}: {ev.from_runner} → {ev.to_runner}"
                    f"  (frontier nnz={ev.frontier_nnz}, density="
                    f"{ev.density:.3g}, est {ev.est_from:.3g} → "
                    f"{ev.est_to:.3g} ns/iter)")
    outs = " ← ".join(plan.outputs) if plan.outputs else "(fixpoint state)"
    post = "  + host post-epilogue" if plan.has_post else ""
    lines.append(f"  outputs    {outs}{post}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------


def execute_plan(plan: ExecutionPlan, prog, db: engine.Database, *,
                 max_iters: int = 10_000, hints=None):
    """Run ``prog`` under ``plan``; returns ``(answer, RunStats)``.

    Materialized linear operators, init vectors and storage conversions
    are cached on the Program object keyed by stable database
    fingerprints, so a repeat run skips their construction.

    Adaptive re-planning runs when the plan or ``hints`` asks for it:
    chunkable vector strata execute via
    :func:`repro_torch.core.runners.adaptive_fixpoint` over the
    stratum's ``considered`` runners, their switch history lands on
    ``StratumPlan.switch_log``, and ``explain(plan)`` renders it.
    """
    from repro_torch.core import program as prog_mod
    if plan.device != db.device.type:
        raise ValueError(f"{plan.program}: plan made for a {plan.device} "
                         f"database, executing on {db.device.type}")
    ph = PlanHints.of(hints, defaults=prog.sort_hints)
    hints = dict(ph.sorts)
    adaptive_exec = bool(plan.adaptive or ph.adaptive)
    replan = ph.replan if ph.replan is not None else plan.replan
    cache = prog.__dict__.setdefault("_plan_cache", {})
    iters_log: list[int] = []
    all_reads: set[str] = set()
    for sp in plan.strata:
        all_reads |= set(sp.reads)
    base_fp = db_fingerprint(db, all_reads)
    cur_db = db
    for sp, stratum in zip(plan.strata, prog.strata):
        cur_db = _apply_storage(sp, cur_db, cache)
        state, iters = _run_stratum(sp, stratum, prog, cur_db, hints,
                                    cache, max_iters, base_fp,
                                    mesh=plan.mesh,
                                    adaptive_exec=adaptive_exec,
                                    replan=replan)
        iters_log.append(int(iters))
        cur_db = cur_db.with_relations(state)
    out = None
    for rule in prog.outputs:
        out = engine.eval_ssp(rule.body, cur_db, hints)
        cur_db = cur_db.with_relations({rule.head: out})
    if prog.post is not None:
        out = prog.post(out, cur_db)
    while len(cache) > _CACHE_MAX:
        cache.pop(next(iter(cache)))
    return out, prog_mod.RunStats(iters_log, plan.mode, plan)


def _apply_storage(sp: StratumPlan, db: engine.Database, cache):
    """Apply the plan's per-relation storage decisions, memoizing each
    converted relation so repeat executions reuse one stable object."""
    for name, target in sp.storage.items():
        arr = db.relations.get(name)
        if arr is None or db.storage_of(name) == target:
            continue
        key = ("storage", name, target, value_fingerprint(arr))
        conv = _cache_get(cache, key)
        if conv is None:
            conv = db.with_storage(name, target).relations[name]
            cache[key] = conv
        db = db.with_relations({name: conv})
    return db


def _materialize_edges(vf, db, hints, *, override=None, densify=False):
    """The linear operator E, cast into the equation's semiring, on the
    database's device (sparse COO or a dense matrix)."""
    e = override if override is not None else \
        vectorize.edge_operator(vf, db, hints)
    if isinstance(e, SparseRelation):
        e = vectorize._sparse_into_semiring(e.to(db.device), vf.semiring)
        if densify:
            e = e.to_dense()
    return e


def _mesh_key(mesh):
    """Hashable identity of a graph mesh for the staged-runner cache (an
    int-D planning mesh resolves to a mesh of that size at execution)."""
    from repro_torch.launch.mesh import GraphMesh
    if isinstance(mesh, GraphMesh):
        return mesh.key
    return int(mesh)


def exec_mesh(plan: ExecutionPlan):
    """The GraphMesh a ``sparse_sharded`` plan executes on: the plan's
    own, or — when planning used a plain int D — the graph mesh of that
    size over the initialized process group, on the plan's device."""
    if plan.mesh is None:
        raise ValueError(f"{plan.program}: sparse_sharded plan has no "
                         f"mesh — re-plan with mesh=")
    return _resolve_mesh(plan.mesh, device=plan.device, required=True)


def _resolve_mesh(mesh, *, device: str, required: bool):
    """The GraphMesh for execution on a ``device``-type database: a
    GraphMesh passes through (and must compute on that device type), a
    plain int D resolves to a mesh of that size.  ``required=False``
    (the adaptive candidate set of a plan that did not pick the sharded
    runner) lets a D that no process group holds drop out."""
    if mesh is None:
        return None
    from repro_torch.launch.mesh import GraphMesh, make_graph_mesh
    if isinstance(mesh, GraphMesh):
        if mesh.device.type != device:
            raise ValueError(f"a graph mesh on {mesh.device} cannot run a "
                             f"plan made for a {device} database")
        return mesh
    try:
        return make_graph_mesh(int(mesh), device=device)
    except ValueError:
        if required:
            raise
        return None


def _run_stratum(sp, stratum, prog, cur_db, hints, cache, max_iters,
                 base_fp, *, mesh=None, adaptive_exec=False, replan=None):
    from repro_torch.core import runners as runners_mod

    if sp.runner in ("delta_restart", "synth_maintenance"):
        raise ValueError(
            f"{prog.name}: {sp.runner} plans carry no previous "
            f"solution to restart from — execute them via "
            f"repro_torch.incremental.refresh_program")
    runner = runners_mod.get(sp.runner)
    key = (sp.index, sp.runner, max_iters, base_fp,
           tuple(sorted(sp.storage.items())),
           None if sp.edges_override is None
           else value_fingerprint(sp.edges_override),
           None if mesh is None else _mesh_key(mesh))
    ent = _cache_get(cache, key)

    if sp.runner in BATCHED_RUNNERS:
        if ent is None:
            vf = sp.vf
            edges = _materialize_edges(
                vf, cur_db, hints, override=sp.edges_override,
                densify=sp.runner == "vector_dense")
            if sp.runner != "vector_dense" and \
                    not isinstance(edges, SparseRelation):
                edges = SparseRelation.from_dense(edges, vf.semiring)
            init = vectorize.init_vector(vf, cur_db, hints)
            m = _resolve_mesh(mesh, device=cur_db.device.type,
                              required=sp.runner == "sparse_sharded")
            ctx = runners_mod.make_context(edges, init, vf.semiring,
                                           max_iters, mesh=m)
            ent = (runner.full_fn(ctx), runner.operand(ctx), ctx)
            cache[key] = ent
        fn, operand, ctx = ent
        if adaptive_exec and runner.chunkable:
            x, iters, trace = runners_mod.adaptive_fixpoint(
                ctx, start=sp.runner, candidates=tuple(sp.considered),
                policy=replan)
            sp.switch_log = trace
        else:
            x, iters = fn(operand, ctx.init)
        return {sp.idbs[0]: x}, int(iters)

    if ent is None:
        ent = runner.stratum_fn(stratum, cur_db, hints, max_iters)
        cache[key] = ent
    fn, x0 = ent
    x, iters = fn(x0)
    return x, int(iters)


# --------------------------------------------------------------------------
# Batched serving hooks
# --------------------------------------------------------------------------


def materialize_edges(plan: ExecutionPlan, db: engine.Database,
                      hints=None, *, override=None):
    """The linear operator for stratum 0, ready for
    :func:`compile_batched` (sparse COO, or a dense matrix)."""
    sp = plan.strata[0]
    return _materialize_edges(sp.vf, db, hints,
                              override=override
                              if override is not None
                              else sp.edges_override,
                              densify=sp.runner == "vector_dense")


def source_init(plan: ExecutionPlan, prog, db: engine.Database, *,
                hints=None, backend: str = "torch"):
    """Vector-form a per-source program, verify it kept the plan's linear
    operator, and evaluate its O(n) init terms (``backend`` as in
    :func:`repro_torch.core.vectorize.init_vector`: ``"np"`` evaluates
    a CPU database on the host and returns a numpy array)."""
    vf = vectorize.vector_form(prog)
    base = plan.strata[0].vf
    if vf.signature != base.signature:
        raise ValueError(
            f"{plan.program}: source program changed the linear operator "
            f"({vf.signature} != {base.signature}) — sources must only "
            f"move the init term")
    return vectorize.init_vector(vf, db, hints, backend=backend)


def compile_batched(plan: ExecutionPlan, *,
                    max_iters: int = 10_000) -> Callable:
    """``run(edges, init)`` over a ``(B, n)`` init pack for stratum 0's
    runner — the serving unit, returning ``(x*, iters)`` with ``x*`` of
    shape ``(B, n)`` and ``iters`` a ``(B,)`` int32 tensor."""
    from repro_torch.core import runners as runners_mod

    sp = plan.strata[0]
    if sp.runner not in BATCHED_RUNNERS:
        raise ValueError(f"{plan.program}: runner {sp.runner!r} has no "
                         f"batched form")
    return runners_mod.get(sp.runner).batched_fn(plan, max_iters)
