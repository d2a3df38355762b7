#!/usr/bin/env python3
"""The open loop of ``chip_smoke.py``'s ``serve`` phase, run on one
checkout, so that two trees' servers are measured alike in one call.

It imports the ``--tree`` checkout's ``chip_smoke.py`` and
``repro_torch`` (both from that tree, kernels built into its own
``build/``), builds the phase's graphs and replays its open loop
``--reps`` times: 512 requests, half BM and half SSSP, Poisson arrivals
offered at 2,000 qps, served by the FIFO ``DatalogServer`` and by the
``ContinuousServer`` after a warm-up over every bucket, with every gate
of that tree's phase (answers equal between the servers, six spot
checks against scipy).  Prints one JSON line a rep (qps, latency
percentiles, host µs a request), then the card's name and power limit.
Run from the root of a checkout on a machine with a GPU, one process a
tree, alternating trees::

    python3 tools/serve_open_ab.py [--tree PATH] [--reps 2]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="root of the checkout whose servers are run")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_open_ab: no CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke
    from repro_torch.kernels import cuda_lib
    cuda_lib.build()
    cuda_lib.library()
    dev = torch.device("cuda")
    g_bm, g_ss = chip_smoke._serve_graphs()
    for rep in range(args.reps):
        with chip_smoke._ServeTrace() as tr:
            res = chip_smoke._serve_open(dev, g_bm, g_ss, tr)
        row = {"tree": str(tree), "rep": rep, "speedup": res["speedup"]}
        for name in ("fifo", "continuous"):
            r = res[name]
            row[name] = {"qps": r["qps"],
                         **{f"{k}_p{q}_ms": r[k][f"p{q}_ms"]
                            for k in ("total", "queue", "compute")
                            for q in (50, 99)}}
        row["host_us_per_request"] = res["continuous"]["host_us_per_request"]
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
