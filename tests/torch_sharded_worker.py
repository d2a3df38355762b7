"""The rank side of ``tests/test_torch_sharded.py``: one function a case,
run on every rank of a spawned gloo world.

Imported by the spawned ranks, so it imports the port and numpy only
(no JAX): the test process builds every input with the reference's own
code, hands the ranks numpy buffers, and holds what each rank returns
against the reference.  :func:`run_cases` runs a whole batch in one
world, so the process start-up is paid once per D.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine, planner, runners
from repro_torch.datalog import programs
from repro_torch.distributed import datalog as dd
from repro_torch.sparse import adaptive
from repro_torch.sparse import contract
from repro_torch.sparse.coo import SparseRelation


def rel_of(buf) -> SparseRelation:
    """A port relation from the reference's ``as_np()`` buffers."""
    coords, values, nnz, shape, semiring = buf
    return SparseRelation.from_buffers(coords, values, nnz, shape, semiring,
                                       device="cpu")


def host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return x


class Favor:
    """A cost model that makes one runner permanently cheapest."""

    def __init__(self, favorite):
        self.favorite = favorite

    def round_ns(self, runner, **kw):
        return 1.0 if runner == self.favorite else 100.0


def case_fixpoint(mesh, buf, init, caps=None):
    y, it, rc = dd.sharded_seminaive_fixpoint_stats(
        rel_of(buf), init, mesh=mesh, exchange_caps=caps)
    return host(y), host(it), rc.tolist()


def case_exchange(mesh, buf, init):
    """``exchange="auto"`` and ``"dense"`` on the same input."""
    rel = rel_of(buf)
    ya, ia = dd.sharded_seminaive_fixpoint(rel, init, mesh=mesh,
                                           exchange="auto")
    yd, idn = dd.sharded_seminaive_fixpoint(rel, init, mesh=mesh,
                                            exchange="dense")
    return host(ya), host(ia), host(yd), host(idn)


def case_resume(mesh, buf, y0, d0):
    sh = dd.shard_relation(rel_of(buf), mesh)
    y, it = dd.sharded_resume_fixpoint(sh, y0, d0, mesh=mesh)
    return host(y), host(it)


def case_fallback(mesh, buf, init):
    """The fallback boundary: expansion cap 1 sends every non-empty
    frontier to the dense all-gather, roomy caps keep every round
    sparse."""
    sh = dd.shard_relation(rel_of(buf), mesh)
    yd, itd = dd.sharded_seminaive_fixpoint(sh, init, mesh=mesh,
                                            exchange="dense")
    tiny = dd.sharded_seminaive_fixpoint_stats(sh, init, mesh=mesh,
                                               exchange_caps=((1, 1),))
    roomy_caps = ((sh.row_block, sh.capacity),)
    roomy = dd.sharded_seminaive_fixpoint_stats(sh, init, mesh=mesh,
                                                exchange_caps=roomy_caps)
    report = dd.exchange_byte_report(sh, roomy[2], exchange_caps=roomy_caps)
    return dict(dense=(host(yd), itd),
                tiny=(host(tiny[0]), tiny[1], tiny[2].tolist()),
                roomy=(host(roomy[0]), roomy[1], roomy[2].tolist()),
                roomy_caps=roomy_caps, report=report,
                n_pad=sh.n_pad,
                row_bytes=dd.payload_row_bytes("bool", 1))


def case_warm(mesh, buf, init, coords, vals, d0):
    """A warm resume after ``apply_delta`` (the geometry rebuilt) under
    both exchanges, and a cold run on the mutated relation."""
    sh = dd.shard_relation(rel_of(buf), mesh)
    y0, _ = dd.sharded_seminaive_fixpoint(sh, init, mesh=mesh)
    sh2 = sh.apply_delta(coords, vals)
    ya, ia = dd.sharded_resume_fixpoint(sh2, y0, d0, mesh=mesh,
                                        exchange="auto")
    yd, idn = dd.sharded_resume_fixpoint(sh2, y0, d0, mesh=mesh,
                                         exchange="dense")
    yf, _ = dd.sharded_seminaive_fixpoint(sh2, init, mesh=mesh)
    return host(y0), host(ya), ia, host(yd), idn, host(yf)


def case_no_geometry(mesh, buf, init):
    sh = dd.shard_relation(rel_of(buf), mesh)
    bare = dataclasses.replace(sh, ssrc=None, sdst=None, sval=None,
                               usrc=None, ustart=None)
    y, it, rounds = dd.sharded_seminaive_fixpoint_stats(bare, init,
                                                        mesh=mesh)
    plain = dd.shard_relation(rel_of(buf), mesh, balance=False)
    y2, it2 = dd.sharded_seminaive_fixpoint(plain, init, mesh=mesh)
    return (bare.has_exchange_geometry, host(y), it, rounds.tolist(),
            plain.perm is None, host(y2), it2)


def case_mismatch(mesh, buf, init):
    sh = dd.shard_relation(rel_of(buf), mesh.d + 1)
    try:
        dd.sharded_seminaive_fixpoint(sh, init, mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def case_contract(mesh, buf, x):
    return host(dd.sharded_contract(rel_of(buf), x, mesh=mesh))


def case_nat_refused(mesh, buf, x):
    try:
        dd.sharded_seminaive_fixpoint(rel_of(buf), x, mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def _bm_db(buf, n):
    b = programs.bm(a=3)
    return b, engine.Database(b.original.schema, {"id": n},
                              {"E": rel_of(buf),
                               "V": torch.ones(n, dtype=torch.bool)},
                              "cpu")


def case_forced(mesh, buf, n):
    """``mode="sparse_sharded"`` on the mesh against the mesh-free auto
    plan; and an int-D plan resolved to the mesh at execution."""
    from repro_torch.core.program import run_program
    b, db = _bm_db(buf, n)
    auto, _ = run_program(b.optimized, db)
    plan = planner.plan_program(b.optimized, db, mode="sparse_sharded",
                                mesh=mesh)
    out, _ = planner.execute_plan(plan, b.optimized, db)
    plan_int = planner.plan_program(b.optimized, db, mode="sparse_sharded",
                                    mesh=mesh.d)
    out_int, _ = planner.execute_plan(plan_int, b.optimized, db)
    return (host(auto), host(out), host(out_int), plan.strata[0].runner,
            planner.explain(plan))


def _serve_stream(srv, db, updates):
    fam = srv.register("reach", lambda a: programs.bm(a=a).optimized, db)
    reqs = [srv.submit("reach", s) for s in (1, 4, 9)]
    srv.run_until_idle()
    up = srv.submit_update("reach", updates)
    last = srv.submit("reach", 1)
    srv.run_until_idle()
    return fam, reqs + [last], up


def case_serve(mesh, buf, n, updates):
    """A graph-mesh ``DatalogServer`` and ``ContinuousServer``: answers,
    ``iters`` and the warm repair across a merge, with the crossover
    floor patched away (the reference test's patch)."""
    from repro_torch.launch.datalog_serve import DatalogServer
    from repro_torch.serve import ContinuousServer
    cost = planner.SHARDED_COST
    saved = (cost.min_work_per_device, cost.sync_flops_per_device)
    cost.min_work_per_device = cost.sync_flops_per_device = 0.0
    try:
        out = {}
        _, db = _bm_db(buf, n)
        srv = DatalogServer(max_batch=4, mesh=mesh)
        fam, reqs, up = _serve_stream(srv, db, updates)
        out["fifo"] = dict(
            runner=fam.plan.strata[0].runner,
            sharded=fam.sharded is not None,
            results=[host(r.result) for r in reqs],
            iters=[r.iters for r in reqs],
            errors=[r.error for r in reqs], applied=up.applied,
            repaired=srv.stats["answers_repaired"],
            compiled_d=sorted({k[2] for k in srv._compiled}))
        _, db = _bm_db(buf, n)
        cs = ContinuousServer(max_batch=4, graph_mesh=mesh)
        fam, reqs, up = _serve_stream(cs, db, updates)
        st = cs.stats()
        out["continuous"] = dict(
            runner=fam.plan.strata[0].runner,
            results=[host(r.result) for r in reqs],
            iters=[r.iters for r in reqs], applied=up.applied,
            repaired=st["answers_repaired"],
            packed_fallback=st["packed_fallback"], admitted=st["admitted"])
        return out
    finally:
        cost.min_work_per_device, cost.sync_flops_per_device = saved


def case_handoff(mesh, buf, init, start, target):
    """The adaptive executor handing the carry between a single-device
    runner and the sharded one (``chunk_iters=3``, the target priced
    cheapest)."""
    saved = adaptive.ADAPTIVE_COST
    adaptive.ADAPTIVE_COST = Favor(target)
    try:
        ctx = runners.make_context(rel_of(buf), torch.from_numpy(init),
                                   "bool", 10_000, mesh=mesh)
        y, iters, tr = runners.adaptive_fixpoint(
            ctx, start=start, candidates=(start, target),
            policy=adaptive.ReplanPolicy(chunk_iters=3))
    finally:
        adaptive.ADAPTIVE_COST = saved
    return (host(y), iters, tr.final_runner,
            [(e.from_runner, e.to_runner) for e in tr.switches])


def case_spmv_vs_vspm(mesh, buf, x):
    """The single-device contraction on the rank, the nat probe's
    oracle."""
    return host(contract.vspm(torch.from_numpy(x), rel_of(buf)))


CASES = {f.__name__[5:]: f for f in (
    case_fixpoint, case_exchange, case_resume, case_fallback, case_warm,
    case_no_geometry, case_mismatch, case_contract, case_nat_refused,
    case_forced, case_serve, case_handoff, case_spmv_vs_vspm)}


def run_cases(mesh, cases: dict) -> dict:
    """Run ``{name: (case, args)}`` on this rank: ``{name: result}``."""
    return {name: CASES[case](mesh, *args)
            for name, (case, args) in cases.items()}
