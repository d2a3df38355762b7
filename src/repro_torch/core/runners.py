"""Registered physical fixpoint runners (the Runner protocol).

The counterpart of ``repro/core/runners.py``.  The planner picks a
runner per stratum by name; each registered :class:`Runner` executes
that choice:

* ``full_fn(ctx)`` — ``fn(operand, init) → (x*, iters)``, the static
  path of a vector-form stratum;
* ``stratum_fn`` — the dense engine runners' whole-stratum path;
* ``batched_fn(plan, max_iters)`` — the ``compile_batched`` body over a
  ``(B, n)`` init pack.

Ported: ``sparse_jit`` (staged loop, torch advance with B3),
``sparse_frontier_pallas`` (the same loop with the fused B1 advance —
the name is the reference's, so plans and ``explain()`` line up),
``vector_dense`` (B2 rounds), ``dense_gsn`` and ``dense_naive``.  The
frontier worklist, sharded and host runners, and the bounded-chunk
protocol of the adaptive executor (``run_chunk``/``estimate``/
``finalize``) are not ported yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import semiring as sr_mod
from repro_torch.sparse import fixpoint as fx
from repro_torch.sparse.coo import SparseRelation


@dataclasses.dataclass
class RunnerContext:
    """Everything a runner needs to execute one vector-form stratum:
    the materialized linear operator, the init vector, and a memo dict
    (``extras``) for prepared operands."""

    edges: object            # SparseRelation or dense (n, n) tensor
    init: object             # (n,) or (B, n) tensor
    semiring: str
    max_iters: int
    n: int
    e_nnz: int
    extras: dict = dataclasses.field(default_factory=dict)


def make_context(edges, init, semiring: str,
                 max_iters: int) -> RunnerContext:
    if isinstance(edges, SparseRelation):
        n, e_nnz = int(edges.shape[1]), int(edges.nnz)
    else:
        sr = sr_mod.get(semiring)
        n, e_nnz = int(edges.shape[1]), int(sr.live(edges).sum())
    return RunnerContext(edges, init, semiring, max_iters, n, e_nnz)


class Runner:
    """One physical fixpoint runner (see the module docstring)."""

    name: str = ""

    def operand(self, ctx: RunnerContext):
        """The runner-specific form of the linear operator, memoized on
        ``ctx.extras``."""
        return ctx.edges

    def full_fn(self, ctx: RunnerContext):
        raise NotImplementedError(self.name)

    def stratum_fn(self, stratum, cur_db, hints, max_iters: int):
        """Non-vector runners: ``(fn, x0)`` executing a whole stratum."""
        raise NotImplementedError(self.name)

    def batched_fn(self, plan, max_iters: int):
        raise NotImplementedError(self.name)


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
    backend = "torch"

    def full_fn(self, ctx):
        mi, be = ctx.max_iters, self.backend
        return lambda e, i: fx.fixpoint(e, i, max_iters=mi, backend=be)

    def batched_fn(self, plan, max_iters):
        be = self.backend
        return lambda e, i: fx.fixpoint(e, i, max_iters=max_iters,
                                        backend=be)


@register
class JitRunner(_SparseRunner):
    """The staged GSN loop: O(nnz(E)) per round, the advance composed of
    a torch gather/⊗ and the B3 segment-⊕."""

    name = "sparse_jit"
    backend = "torch"


@register
class PallasRunner(_SparseRunner):
    """The staged GSN loop with the fused SpMM advance, kernel B1 (the
    plain version of B1 on a CPU database)."""

    name = "sparse_frontier_pallas"
    backend = "kernel"


@register
class DenseVectorRunner(Runner):
    """Dense semiring matmul rounds (kernel B2) — wins when E is dense."""

    name = "vector_dense"

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
