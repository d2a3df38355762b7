#!/usr/bin/env python3
"""Where a continuous-server admission's host time goes, on the card.

Builds the two families of ``chip_smoke.py``'s ``serve`` phase (BM Π₂ on
``powerlaw(50_000, 4, seed=1)``, SSSP Π₂ on ``powerlaw(50_000, 4,
seed=2)`` with weights 1–4), fills a 64-slot ``TorchChunkStepper`` with
seeded sources and steps one chunk, so that its carry is the strided
view a running pool holds.  Then it times, per admitted request (64
admissions a sample, the median of ``--reps`` samples, the device
synchronized at the end of each):

* ``minus_us``: the seed ``init ⊖ 0̄`` and its live count, on the host;
* ``h2d_us``: one pageable host→device copy of a seed row (n values)
  into a fresh contiguous tensor;
* ``row_splice_us``: a splice written row by row into the strided carry
  — ``y[j]`` filled, ``d[j]`` copied from the host row, ``it[j]`` reset.
  ``minus_us + row_splice_us`` is an admission as it was before
  admissions were staged;
* ``staged_us``: ``TorchChunkStepper.admit`` for 64 rows (each stages
  its init) and the one ``_flush`` that writes them before the next
  chunk (one pinned copy, the seed's ⊖ on the device, ``index_copy_``/
  ``index_fill_``); ``flush_us`` is the flush alone.

Prints one JSON line, then the card's name and power limit.  Run from
the root of a checkout::

    python3 tools/serve_admit_split.py [--reps 5] [--n 50000]
    python3 tools/serve_admit_split.py --device cpu --n 2000   # dry run
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, CHUNK, SEED = 64, 4, 1


def _families(n, dev):
    import numpy as np
    from repro_torch.core import engine
    from repro_torch.datalog import datasets, programs
    from repro_torch.serve import family
    g_bm = datasets.powerlaw(n, 4, seed=SEED)
    g0 = datasets.powerlaw(n, 4, seed=SEED + 1)
    w = np.random.default_rng(SEED + 2).integers(1, 5, len(g0.edges))
    g_ss = datasets.Graph(g0.n, g0.edges, w)
    bm = programs.bm(a=0)
    db_bm = engine.Database(bm.original.schema, {"id": n},
                            {"E": g_bm.sparse_adjacency(device=dev),
                             "V": g_bm.vertex_set(device=dev)}, dev)
    ss = programs.sssp(a=0, wmax=4, dmax=64).optimized
    db_ss = engine.Database(ss.schema, {"id": n, "w": 4, "d": 64}, {}, dev)
    return {
        "bm": family.build_family(
            "bm", lambda a: programs.bm(a=a).optimized, db_bm),
        "sssp": family.build_family(
            "sssp", lambda a: programs.sssp(a=a, wmax=4, dmax=64).optimized,
            db_ss, edges=g_ss.sparse_adjacency(semiring="trop",
                                               device=dev))}


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _per_request_us(fn, dev, reps):
    """Median over ``reps`` samples of one call of ``fn`` (64
    admissions), synchronized, in µs a request."""
    fn()
    out = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t0) * 1e6 / B)
    return statistics.median(out)


def split(fam, dev, reps):
    import numpy as np
    import torch
    from repro_torch.core import runners
    from repro_torch.serve import family, slots
    chunk = runners.get(fam.plan.strata[0].runner).serve_chunk_fn(CHUNK)
    sources = np.random.default_rng(SEED + 7).choice(fam.n, 2 * B,
                                                      replace=False)
    inits = [np.asarray(family.family_init(fam, int(s))) for s in sources]
    st = slots.TorchChunkStepper(fam.edges, fam.n, B, chunk)
    for j in range(B):
        st.admit(j, inits[j])
    st.step(CHUNK)
    strided = not st.d.is_contiguous()
    srn, sr = st._srn, st._sr
    zero_row = np.full(fam.n, srn.zero, srn.dtype)
    fresh = inits[B:]
    rows = [srn.minus(v.astype(srn.dtype), zero_row) for v in fresh]

    def minus():
        for v in fresh:
            d = srn.minus(v.astype(srn.dtype), zero_row)
            int(np.count_nonzero(d != zero_row))

    def h2d():
        for r in rows:
            torch.from_numpy(r).to(dev)

    y, d, it = st.y, st.d, st.it

    def row_splice():
        for j, r in enumerate(rows):
            y[j].fill_(sr.zero)
            d[j].copy_(torch.from_numpy(r))
            it[j] = 0

    def staged():
        for j, v in enumerate(fresh):
            st.admit(j, v)
        st._flush()

    def flush_only():
        for j, r in enumerate(rows):
            st._staged[j] = r
        st._flush()

    return {"n": fam.n, "carry_strided": strided,
            "minus_us": _per_request_us(minus, dev, reps),
            "h2d_us": _per_request_us(h2d, dev, reps),
            "row_splice_us": _per_request_us(row_splice, dev, reps),
            "staged_us": _per_request_us(staged, dev, reps),
            "flush_us": _per_request_us(flush_only, dev, reps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("serve_admit_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    out = {name: split(fam, dev, args.reps)
           for name, fam in _families(args.n, dev).items()}
    print(json.dumps(out))
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
