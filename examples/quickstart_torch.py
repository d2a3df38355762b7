"""Quickstart on the PyTorch/CUDA port: FGH-optimize connected
components (paper Fig. 1) end to end.  The twin of
``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py               # GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --n 200

1. defines Π₁ — transitive closure + min-label aggregation (Fig. 1a),
2. runs the FGH optimizer (invariant inference → rule-based
   denormalization → verification) on the host to synthesize H (Fig. 1b),
3. executes both programs on a power-law graph on the device and
   compares answers and time.
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core import fgh, ir, verify
from repro_torch.core.program import run_program
from repro_torch.datalog import datasets, programs


def timed(prog, db):
    if db.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ans, st = run_program(prog, db)
    if db.device.type == "cuda":
        torch.cuda.synchronize()
    return ans, st, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=600)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    bench = programs.cc()
    print("Π₁ (original, Fig. 1a):")
    for name, rule in bench.original.strata[0].rules.items():
        print(f"  {name}{ir.ssp_str(rule.body)}")
    for out in bench.original.outputs:
        print(f"  {out.head}{ir.ssp_str(out.body)}")

    task = verify.task_from_program(bench.original, ["E", "V"])
    rep = fgh.optimize(task, rng=np.random.default_rng(0))
    assert rep.ok
    print(f"\nsynthesized H via {rep.method} in "
          f"{rep.stats['total_time_s']:.3f}s "
          f"(invariants mined: {len(rep.invariants)}):")
    print(f"  CC{ir.ssp_str(rep.h_body)}")

    g = datasets.powerlaw(args.n, m_attach=3, seed=0)
    db = bench.make_db(g, device=args.device)
    ans1, s1, t1 = timed(bench.original, db)
    ans2, s2, t2 = timed(rep.program, db)
    same = bool(torch.equal(ans1, ans2))
    print(f"\nn={g.n} on {db.device}: original {t1*1e3:.0f} ms "
          f"({s1.iterations[0]} iters, O(n²) state) vs optimized "
          f"{t2*1e3:.0f} ms ({s2.iterations[0]} iters, O(n) state)")
    print(f"answers equal: {same}   speedup: {t1/t2:.1f}x")
    assert same, "Π₁ and the synthesized Π₂ disagree"


if __name__ == "__main__":
    main()
