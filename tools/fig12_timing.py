#!/usr/bin/env python3
"""``chip_smoke.py``'s ``fig12`` phase alone, in a fresh process: the
paper's Fig. 12 (WS, BC, R, MLM; ``chip_smoke.phase_fig12``, with every
gate), BC's Brandes Π₂ at n = 4,096, B2 at Brandes' product shape,
``mode="host"`` and the ``cost_model="hlo"`` plans on the latency and
dense graphs.

It builds the kernels, makes the main path's graphs
(``chip_smoke.make_data``) and runs the phase at ``FIG12_SIZES``.
Writes the phase's record to ``fig12_timing.json`` beside
``chip_smoke.py``'s own record and prints its launches, the card's name
and power limit.  With ``--sweep`` it instead runs each series' Π₁ once
up the benchmark's doubling sequence (WS from 128, the rest from 64, to
8,192) until a run takes over 30 s or peaks over 8 GB, or the next is
predicted past 45 s or 30 GB from the last two, each answer gated
against its oracle: the measurements ``FIG12_SIZES`` is chosen from
(``fig12_sweep.json``).  Run from the root of a checkout on a machine
with a GPU (≈3 minutes; the sweep ≈5)::

    python3 tools/fig12_timing.py [--sweep]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sweep(cs, dev) -> dict:
    """Each series' Π₁ at n = 64 (WS 128), 128, … (see the module
    docstring): n, ms, peak GB, runners and rounds a run."""
    import torch
    from repro_torch.core.program import run_program
    res = {}
    for key in cs.FIG12_SIZES:
        n = 128 if key == "WS" else 64
        rows = []
        while n <= 8192:
            cs._free_cuda()
            bench, db, oracle, exact, meta = cs.fig12_instance(key, n, dev)
            torch.cuda.reset_peak_memory_stats()
            (x, st), ms = cs.wall(lambda: run_program(bench.original, db))
            peak = torch.cuda.max_memory_allocated() / 1e9
            rows.append(dict(n=n, ms=ms, peak_gb=peak, meta=meta,
                             max_abs_err=cs._fig12_gate(f"{key} n={n}", x,
                                                        oracle, exact),
                             runners=[sp.runner for sp in st.plan.strata],
                             iterations=st.iterations))
            cs.log(f"sweep {key} n={n}: Π₁ {ms:.1f} ms, peak {peak:.3f} GB, "
                   f"{rows[-1]['runners']} {st.iterations} rounds")
            del x, db
            if ms > 30000 or peak > 8:
                break
            rt, rm = (16.0, 8.0) if len(rows) < 2 else (
                ms / max(rows[-2]["ms"], 1e-3),
                peak / max(rows[-2]["peak_gb"], 1e-6))
            if ms * rt > 45000 or peak * rm > 30:
                cs.log(f"sweep {key}: n={2 * n} predicted {ms * rt:.0f} "
                       f"ms, {peak * rm:.1f} GB: stop")
                break
            n *= 2
        res[key] = rows
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fig12_timing: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    cuda_lib.build()
    cuda_lib.library()
    dev = torch.device("cuda")
    if "--sweep" in sys.argv[1:]:
        res = {"power": cs.nvidia_smi(), "sweep": sweep(cs, dev)}
        name, summary = "fig12_sweep.json", {
            k: [(r["n"], round(r["ms"], 1)) for r in rows]
            for k, rows in res["sweep"].items()}
    else:
        res = cs.phase_fig12(dev, cs.make_data(dev))
        name, summary = "fig12_timing.json", {
            "launches": res["launches"], "seconds": res["seconds"]}
    out = cs.OUT.parent / name
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1, default=str))
    print(json.dumps(summary))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
