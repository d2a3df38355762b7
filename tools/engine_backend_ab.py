#!/usr/bin/env python3
"""The engine's two host backends under the FGH optimizer.

Runs ``fgh.optimize(task, rng=default_rng(0))`` over the seven cases of
``tests/test_fgh.py`` twice in one process: as shipped, where every
micro-evaluation of the synthesizer and verifier uses the engine's
``backend="np"``, and with those evaluations routed through
``backend="torch"`` on CPU tensors (zero-copy ``torch.from_numpy`` views
in, ``.numpy()`` out).  Prints per case the method, the printed H, the
number of ``eval_ssp`` calls and the seconds of each backend, then a
JSON line with the totals.  Host only; no GPU is used::

    PYTHONPATH=src python tools/engine_backend_ab.py [--threads 1]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import engine, fgh, ir, verify
from repro_torch.datalog import programs

CASES = {"CC": (programs.cc, ["E", "V"]), "BM": (programs.bm, ["E", "V"]),
         "SSSP": (programs.sssp, ["E3"]), "WS": (programs.ws, ["A2"]),
         "MLM": (programs.mlm, ["E", "V"]),
         "R": (programs.radius, ["E", "V"]),
         "APSP100": (programs.apsp100, ["Ew"])}


def _routed(orig, calls, via_torch: bool):
    def eval_ssp(e, db, hints=None, *, backend="torch"):
        calls[0] += 1
        if backend != "np" or not via_torch:
            return orig(e, db, hints, backend=backend)
        views = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in db.relations.items()
                 if isinstance(v, np.ndarray)}
        if views:
            db = db.with_relations(views)
        return orig(e, db, hints, backend="torch").numpy()
    return eval_ssp


def run(via_torch: bool) -> dict:
    orig, calls, out = engine.eval_ssp, [0], {}
    engine.eval_ssp = _routed(orig, calls, via_torch)
    try:
        for name, (mk, edbs) in CASES.items():
            b = mk()
            task = verify.task_from_program(b.original, edbs,
                                            constraint=b.constraint)
            calls[0] = 0
            t0 = time.perf_counter()
            rep = fgh.optimize(task, rng=np.random.default_rng(0))
            out[name] = dict(ok=rep.ok, method=rep.method,
                             s=time.perf_counter() - t0, evals=calls[0],
                             h=ir.ssp_str(rep.h_body) if rep.ok else None)
    finally:
        engine.eval_ssp = orig
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=1,
                    help="torch intra-op threads (default 1)")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    np_run, torch_run = run(False), run(True)
    same = True
    for name in CASES:
        a, b = np_run[name], torch_run[name]
        agree = (a["ok"], a["method"], a["h"]) == (b["ok"], b["method"],
                                                   b["h"])
        same &= agree
        print(f"{name:>8}: {a['method']} evals {a['evals']}; np "
              f"{a['s']:.3f} s, torch {b['s']:.3f} s "
              f"({b['s'] / a['s']:.2f}×); same H {agree}: {a['h']}")
    tot = {k: sum(r[n]["s"] for n in CASES)
           for k, r in (("np_s", np_run), ("torch_s", torch_run))}
    print(json.dumps({"same_method_and_h": same, **tot,
                      "threads": args.threads}))
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
