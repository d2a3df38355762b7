"""Cost-based execution planning: one ``plan → explain → execute`` pipeline.

The counterpart of ``repro/core/planner.py`` with the analytic cost
model.  :func:`plan_program` chooses a physical runner and per-relation
storage for every stratum, :func:`explain` renders the choice, and
:func:`execute_plan` / :func:`compile_batched` run it.  Candidates are
priced only for the runners this package has (:data:`RUNNERS`); the
sharded, incremental-maintenance and ``cost_model="hlo"`` branches of
the reference are not ported yet.

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
from repro_torch.sparse.coo import SparseRelation

#: physical runners, in tie-break preference order (earlier wins ties)
RUNNERS = ("sparse_frontier_pallas", "sparse_jit", "vector_dense",
           "dense_gsn", "dense_naive")

#: runners that execute the vector equation ``x = init ⊕ x ⊗ E``;
#: "sparse_frontier_pallas" is the staged loop with the fused B1 advance
VECTOR_RUNNERS = ("sparse_jit", "sparse_frontier_pallas", "vector_dense")

#: every vector-equation runner ``compile_batched`` can batch
BATCHED_RUNNERS = VECTOR_RUNNERS

#: legacy ``run_program`` mode strings → forced runners
LEGACY_MODES = {"naive": "dense_naive", "seminaive": "dense_gsn"}

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
    overriding ``Program.sort_hints``.  (The reference's adaptive
    re-planning flags are not ported yet.)"""

    sorts: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for k, v in dict(self.sorts).items():
            if not isinstance(k, str) or not isinstance(v, str):
                raise TypeError(f"PlanHints.sorts maps variable names to "
                                f"sort names, got {k!r}: {v!r}")

    @classmethod
    def of(cls, hints, *, defaults=None) -> "PlanHints":
        if hints is None:
            return cls(sorts=dict(defaults or {}))
        if isinstance(hints, cls):
            return hints
        raise TypeError(f"hints must be a PlanHints, got "
                        f"{type(hints).__name__}")

    def cache_key(self) -> tuple:
        return (tuple(sorted(dict(self.sorts).items())),)


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
class SpmmKernelModel:
    """Constants behind the ``sparse_frontier_pallas`` candidate: the
    fused advance is priced as the torch step scaled by a per-iteration
    speedup, offered above a crossover ``min_nnz``.

    UNCALIBRATED.  Every entry is a placeholder that keeps the
    reference's structure; none is a measurement of this package:

    * ``"cuda"`` — 2.0 for every idempotent semiring, a value above 1 so
      the fused kernel B1 is offered on the card.  It waits for a
      measured B1-vs-torch round ratio on the H100 (PERF.md).
    * ``"cpu"`` — the reference's host entry (𝔹 only), so that on a CPU
      database the same candidates are offered as in the reference and
      the parity tests pick the same runner; the CPU runs B1's plain
      version, which is not faster.

    Tests monkeypatch the fields to pin either side of the crossover.
    """

    min_nnz: float = 4096.0
    speedups: dict = dataclasses.field(default_factory=lambda: {
        "cuda": {"bool": 2.0, "trop": 2.0, "maxplus": 2.0},
        "cpu": {"bool": 8.0},
    })

    def speedup(self, semiring: str, device_type: str) -> float:
        """Per-iteration win on this device type; ≤ 1 ⇒ no win."""
        return float(self.speedups.get(device_type, {}).get(semiring, 0.0))


#: module-level so tests and calibration sweeps can patch it in place
SPMM_COST = SpmmKernelModel()


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


# --------------------------------------------------------------------------
# Planning
# --------------------------------------------------------------------------


def plan_program(prog, db: engine.Database, hints=None, *,
                 objective: str = "latency", mode: str = "auto",
                 max_iters: int = 10_000, cost_model: str = "analytic",
                 edges=None, adapt_storage: bool = True,
                 require_vector: bool = False) -> ExecutionPlan:
    """Choose a physical runner + storage for every stratum of ``prog``.

    ``objective`` is "latency" (one query) or "throughput" (batched
    serving: only vector runners, and the fused kernel is offered).
    ``mode`` other than "auto" forces a runner on every stratum.
    ``edges`` overrides the extracted linear operator of a single-stratum
    vector program.  ``adapt_storage=False`` pins every relation to its
    caller-chosen representation.  ``require_vector=True`` raises
    ``ValueError`` when stratum 0 cannot take a vector runner.
    """
    if objective not in ("latency", "throughput"):
        raise ValueError(f"unknown objective {objective!r}")
    if cost_model != "analytic":
        raise ValueError(f"cost_model {cost_model!r} is not ported; only "
                         f"'analytic' is")
    ph = PlanHints.of(hints, defaults=prog.sort_hints)
    hints = dict(ph.sorts)
    forced = None
    if mode != "auto":
        forced = mode if mode in RUNNERS else LEGACY_MODES.get(mode)
        if forced is None:
            raise ValueError(f"unknown mode {mode!r}; have 'auto', "
                             f"{sorted(LEGACY_MODES)} or {RUNNERS}")
    plans = []
    for si, stratum in enumerate(prog.strata):
        plans.append(_plan_stratum(
            prog, stratum, si, db, hints, objective=objective,
            forced=forced, edges=edges if si == 0 else None,
            adapt_storage=adapt_storage and forced is None,
            max_iters=max_iters))
    plan = ExecutionPlan(
        prog.name, objective, mode, plans,
        tuple(r.head for r in prog.outputs), prog.post is not None,
        _plan_signature(prog, db, plans), device=db.device.type)
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
                  edges, adapt_storage, max_iters) -> StratumPlan:
    reads = tuple(sorted(_referenced(stratum)))
    if forced is not None:
        return _forced_stratum_plan(prog, stratum, si, forced, reads, edges)
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
            rejected["vector_dense"] = ("linear operator is sparse — the "
                                        "SpMV/SpMM runners cover it")
        else:
            considered["vector_dense"] = CostEstimate(
                float(n) * n + n, 4.0 * (float(n) * n + n), trips)
            rejected["sparse_jit"] = ("linear operator materializes dense "
                                      "(no sparse binary EDB fast path)")

    # -- fused-kernel SpMM candidate (B1) ------------------------------------
    # offered for batched serving only: the fused advance amortizes its
    # per-edge index reads across the B query lanes
    if vf is not None:
        if objective != "throughput":
            rejected["sparse_frontier_pallas"] = (
                "fused-kernel SpMM is a batched-serving backend "
                "(objective='throughput') — single-shot latency keeps "
                "the staged runner")
        elif e_nnz is None:
            rejected["sparse_frontier_pallas"] = (
                "linear operator materializes dense (no sparse binary "
                "EDB fast path)")
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

    # -- selection ---------------------------------------------------------
    pref = list(RUNNERS)
    # totals equal to 12 significant digits are a tie: float noise (n²
    # times a density is not exactly nnz) must not outrank the
    # preference order
    runner = min(considered,
                 key=lambda k: (float(f"{considered[k].total:.12g}"),
                                pref.index(k)))
    reason = (f"min est. total flops among "
              f"{len(considered)} feasible candidates")
    return StratumPlan(si, tuple(stratum.idbs), runner, reason, storage,
                       notes, reads, considered[runner], considered,
                       rejected, vf, edges)


def _forced_stratum_plan(prog, stratum, si, forced, reads,
                         edges) -> StratumPlan:
    """Forced plans: the runner is predetermined, storage stays as the
    caller chose it, no candidates are priced."""
    vf = None
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
    elif edges is not None:
        raise ValueError(
            f"{prog.name}: edges override cannot be honored by forced "
            f"runner {forced!r} — the dense engine paths read the stored "
            f"relations, not the override")
    return StratumPlan(si, tuple(stratum.idbs), forced,
                       f"forced by mode={forced!r}", {}, {}, reads,
                       None, {}, {}, vf, edges)


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
    """
    from repro_torch.core import program as prog_mod
    if plan.device != db.device.type:
        raise ValueError(f"{plan.program}: plan made for a {plan.device} "
                         f"database, executing on {db.device.type}")
    ph = PlanHints.of(hints, defaults=prog.sort_hints)
    hints = dict(ph.sorts)
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
                                    cache, max_iters, base_fp)
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


def _run_stratum(sp, stratum, prog, cur_db, hints, cache, max_iters,
                 base_fp):
    from repro_torch.core import runners as runners_mod

    runner = runners_mod.get(sp.runner)
    key = (sp.index, sp.runner, max_iters, base_fp,
           tuple(sorted(sp.storage.items())),
           None if sp.edges_override is None
           else value_fingerprint(sp.edges_override))
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
            ctx = runners_mod.make_context(edges, init, vf.semiring,
                                           max_iters)
            ent = (runner.full_fn(ctx), runner.operand(ctx), ctx)
            cache[key] = ent
        fn, operand, ctx = ent
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
                hints=None) -> torch.Tensor:
    """Vector-form a per-source program, verify it kept the plan's linear
    operator, and evaluate its O(n) init terms."""
    vf = vectorize.vector_form(prog)
    base = plan.strata[0].vf
    if vf.signature != base.signature:
        raise ValueError(
            f"{plan.program}: source program changed the linear operator "
            f"({vf.signature} != {base.signature}) — sources must only "
            f"move the init term")
    return vectorize.init_vector(vf, db, hints)


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
