"""Graph-analytics workload suite on the PyTorch/CUDA port: the twin of
``examples/graph_analytics.py``.

  PYTHONPATH=src python examples/graph_analytics_torch.py          # GPU
  PYTHONPATH=src python examples/graph_analytics_torch.py --device cpu \\
      --n 48 --serve-n 400 --requests 16

Optimizes (on the host) and runs SSSP, MLM (tree aggregation, with the
tree's depth) and Window-Sum — the paper's CEGIS group — shows
generalized semi-naive (GSN) execution of the optimized single-source
program, runs BC's Π₁ against its Brandes Π₂, and finishes with batched
multi-source serving: many (source, query) requests answered by one
batched fixpoint through the port's ``DatalogServer``, against the loop
of single-source fixpoints it replaces.
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core import engine, fgh, verify
from repro_torch.core.program import run_program
from repro_torch.datalog import datasets, programs


def _sync(db):
    if db.device.type == "cuda":
        torch.cuda.synchronize()


def timed_run(prog, db, mode="auto"):
    _sync(db)
    t0 = time.perf_counter()
    ans, _ = run_program(prog, db, mode=mode)
    _sync(db)
    return ans, time.perf_counter() - t0


def optimize_and_run(name, bench, edbs, db, mode="naive"):
    task = verify.task_from_program(bench.original, edbs,
                                    constraint=bench.constraint)
    rep = fgh.optimize(task, rng=np.random.default_rng(0))
    assert rep.ok, name
    if bench.original.post is not None:
        rep.program.post = bench.original.post
    a1, t1 = timed_run(bench.original, db)
    a2, t2 = timed_run(rep.program, db, mode=mode)
    ok = np.allclose(a1.cpu().numpy().astype(np.float32),
                     a2.cpu().numpy().astype(np.float32), equal_nan=True,
                     atol=1e-3)
    print(f"{name:8s} method={rep.method:5s} mode={mode:9s} "
          f"orig {t1*1e3:7.0f} ms  opt {t2*1e3:7.0f} ms  "
          f"speedup {t1/t2:6.1f}x  equal={bool(ok)}")
    assert ok, name
    return rep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128,
                    help="vertices of the SSSP, MLM and BC graphs")
    ap.add_argument("--serve-n", type=int, default=4000)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    dev, n = args.device, args.n

    print("== SSSP (weighted ER graph), naive + GSN ==")
    b = programs.sssp(a=0, wmax=4, dmax=48)
    g = datasets.erdos_renyi(n, 4.0, seed=1, weighted=True, wmax=4)
    db = b.make_db(g, device=dev)
    optimize_and_run("SSSP", b, ["E3"], db)
    optimize_and_run("SSSP", b, ["E3"], db, mode="seminaive")

    print("\n== MLM (multi-level marketing, tree constraint Γ) ==")
    b = programs.mlm()
    g = datasets.decay_tree(n, seed=2)
    print(f"   tree depth {datasets.tree_depth(g)}")
    optimize_and_run("MLM", b, ["E", "V"], b.make_db(g, device=dev))

    print("\n== WS (sliding window sum) ==")
    b = programs.ws(window=10, vmax=6)
    optimize_and_run("WS", b, ["A2"], b.make_db(
        datasets.vector_data(n + n // 4, seed=0, vmax=6), device=dev))

    print("\n== BC (betweenness centrality; Π₂ is Brandes) ==")
    m = max(16, n // 4)
    b = programs.bc(dmax=m)
    db = b.make_db(datasets.erdos_renyi(m, 2.0, seed=0), device=dev)
    a1, t1 = timed_run(b.original, db)
    a2, t2 = timed_run(b.optimized, db)
    ok = bool(torch.allclose(a1, a2, rtol=1e-4, atol=1e-4))
    print(f"BC       n={m:<5d} orig {t1*1e3:7.0f} ms  opt {t2*1e3:7.0f} ms  "
          f"speedup {t1/t2:6.1f}x  equal={ok}")
    assert ok, "BC"

    batched_queries(args.serve_n, args.requests, device=dev)


def batched_queries(n: int, requests: int, max_batch: int = 32,
                    device=None):
    """The FGH-optimized reachability program answered for many sources
    at once: the server packs queued (family, source) requests,
    evaluates only the O(n) init a request, and advances the pack in one
    batched fixpoint — compare the per-source loop it replaces."""
    from repro_torch.launch.datalog_serve import DatalogServer
    from repro_torch.sparse import fixpoint as fx

    print("\n== Batched multi-source serving (reachability) ==")
    g = datasets.powerlaw(n, 4, seed=0)
    rel = g.sparse_adjacency(device=device)
    schema = programs.bm(a=0).original.schema
    db = engine.Database(schema, {"id": n},
                         {"E": rel, "V": g.vertex_set(device=device)},
                         device)
    # no warm answers: the timed pass computes every answer again
    server = DatalogServer(max_batch=max_batch, warm_answers=0)
    server.register("reach", lambda a: programs.bm(a=a).optimized, db)

    rng = np.random.default_rng(0)
    sources = [int(s) for s in rng.integers(0, n, requests)]
    for s in sources:                  # build the batched runners first
        server.submit("reach", s)
    server.run_until_idle()
    reqs = [server.submit("reach", s) for s in sources]
    _sync(db)
    t0 = time.perf_counter()
    server.run_until_idle()
    _sync(db)
    t_batch = time.perf_counter() - t0

    loop = {}
    t0 = time.perf_counter()
    for s in dict.fromkeys(sources):
        init = torch.zeros(n, dtype=torch.bool, device=db.device)
        init[s] = True
        loop[s], _ = fx.fixpoint(rel, init)
    _sync(db)
    t_loop = time.perf_counter() - t0
    ok = all(torch.equal(r.result, loop[r.source]) for r in reqs)
    print(f"{requests} requests over {len(loop)} distinct sources, "
          f"n={n} on {db.device}: batched {requests / t_batch:7.1f} qps   "
          f"per-source loop {len(loop) / t_loop:7.1f} qps   equal={ok}")
    print(f"server stats: {server.stats}")
    assert ok, "served answers differ from the per-source loop"


if __name__ == "__main__":
    main()
