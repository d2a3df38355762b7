#!/usr/bin/env python3
"""B3 ``coo_segment`` of one checkout, timed the way ``chip_smoke.py``'s
kernels phase times it, so that two trees' kernels are measured alike.

For each payload of ``chip_smoke.b3_payloads`` (bool, trop and nat over
the 1,788,490-edge power-law operator at 5% and 100% live) and the hub
row alone, it checks every path the tree's B3 has against the plain
version (exactly) and times it: device ms with the host's enqueue
hidden, L2-flushed ms and ms with the host.  A tree whose B3 has no
``plan_segment`` has only the ``scatter`` path.  The protocol (payloads,
timers, checks) is this checkout's ``chip_smoke.py``; the kernels are
the ``--tree`` checkout's, built from its sources into its own
``build/``.  Prints one JSON line, then the card's name and power
limit.  With ``--queries N`` it first times N warm ``run_program``
queries of each latency cell (BM and CC Π₂, B3's callers) after a first
one.  Run from the root of a checkout on a machine with a GPU::

    python3 tools/b3_timing.py [--tree PATH] [--queries N]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="root of the checkout whose B3 is timed")
    ap.add_argument("--queries", type=int, default=0,
                    help="also time this many warm run_program queries of "
                         "the latency cells (BM, CC) on the checkout")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("b3_timing: needs a CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_segment, cuda_lib, ref
    import numpy as np
    from repro_torch.datalog import datasets
    cuda_lib.library()
    dev = torch.device("cuda")
    # chip_smoke's graph and generator: B3 draws from the generator first
    # there too, so both draw the same payloads
    g = datasets.powerlaw(cs.N_POWERLAW, cs.M_ATTACH, seed=0)
    data = {"g": g, "E": g.sparse_adjacency(device=dev),
            "rng": np.random.default_rng(0)}
    torch.manual_seed(0)
    latency = _latency(cs, dev, data, args.queries) if args.queries else None
    planned = hasattr(coo_segment, "plan_segment")
    plan = None
    rows = {}
    for key, name, vals, ids, n in cs.b3_payloads(dev, data):
        sr = sr_mod.get(name)
        want = ref.segment_reduce_ref(sr, vals, ids, n)
        fns = {"scatter": lambda: coo_segment.segment_reduce_cuda(
            name, vals, ids, n)}
        if planned:
            if plan is None:
                plan, rows["plan_ms"] = cs.wall(
                    lambda: coo_segment.plan_segment(ids, n))
                again = ids.clone()        # a second build, kernels loaded
                rows["plan_again_ms"] = cs.wall(
                    lambda: coo_segment.plan_segment(again, n))[1]
            sv = vals.index_select(0, plan.order).contiguous()
            fns["runs"] = lambda: coo_segment.segment_reduce_cuda(
                name, sv, ids, n, plan)
        row = {}
        for path, fn in fns.items():
            row[path] = dict(
                max_abs_err=cs._check(f"{key} {path}", "coo_segment", fn(),
                                      want),
                ms=cs.time_ms(fn, 20, hide_host=True),
                cold_ms=cs.time_cold_ms(fn, 10),
                host_ms=cs.time_ms(fn, 20))
        rows[key] = row
    # the hub row alone, scatter path (the runs path is chip_smoke's)
    rel = data["E"]
    n = rel.shape[1]
    col = rel.coords[:, 1].long()
    hub = int(torch.argmax(torch.bincount(col, minlength=n)))
    on_hub = torch.nonzero(col == hub).flatten()
    ids = torch.full((on_hub.shape[0],), hub, dtype=torch.int32, device=dev)
    for name in cs.SEMIRINGS:
        sr = sr_mod.get(name)
        x = torch.from_numpy(cs.frontier(data["rng"], (n,), name)).to(dev)
        w = cs.cast_relation(rel, name).values
        vals = sr.mul(w, x.index_select(0, rel.col(0)))[on_hub].contiguous()

        def fn():
            return coo_segment.segment_reduce_cuda(name, vals, ids, n)
        cs._check(f"{name} hub row", "coo_segment", fn(),
                  ref.segment_reduce_ref(sr, vals, ids, n))
        rows[f"{name} hub row"] = {"scatter": dict(
            ms=cs.time_ms(fn, 20, hide_host=True))}
    print(json.dumps({"tree": str(tree), "b3": rows, "latency": latency}))
    print(cs.nvidia_smi())
    return 0


def _latency(cs, dev, data, queries):
    """Wall ms of warm run_program queries of the latency cells, the way
    chip_smoke's latency phase runs them (after its first query)."""
    from repro_torch.core.program import run_program
    from repro_torch.datalog import programs
    dbs = cs._dbs(dev, data)
    out = {}
    for kind, prog in (("bm", programs.bm(a=0).optimized),
                       ("cc", programs.cc().optimized)):
        first = cs.wall(lambda: run_program(prog, dbs[kind]))[1]
        out[kind] = dict(first_ms=first, all_ms=[
            cs.wall(lambda: run_program(prog, dbs[kind]))[1]
            for _ in range(queries)])
    return out


if __name__ == "__main__":
    sys.exit(main())
