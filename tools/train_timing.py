#!/usr/bin/env python3
"""One card's training step of one checkout, timed by
``chip_smoke._train_full`` in a fresh process, so that two trees' steps
are measured alike and the profiler's capture is the process's first.

``_train_full`` is this checkout's: ``train(arch, smoke=False, batch=8,
seq=1024, steps=..., remat=...)`` on the card (its gates: finite losses
and grad norms, the loss falling, B4 and B5 launched forward, recomputed
under remat and backward as the model's layers ask and their plain
versions never), then one warm step under ``torch.profiler``.  By
default xLSTM-125M for 30 steps without remat; ``--arch zamba2-2.7b
--remat full`` times chip_smoke's Zamba2-2.7B run (20 steps).  The
package trained is the ``--tree`` checkout's, its kernels built from
its sources into its own ``build/``.  Prints one JSON line (ms a step,
the warm steps' spread, tokens/s, peak memory, the profile: busy share,
GEMM ms, B4's and B5's forward and backward ms, the top kernels), then
the card's name and power limit.  Run from the root of a checkout on a
machine with a GPU::

    python3 tools/train_timing.py [--tree PATH] [--arch ARCH]
        [--remat none|full|selective]

To compare a parent with a change, unpack the parent with ``git
archive`` into ``build/`` and run parent, change, change, parent in one
call on the card.
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
                    help="root of the checkout whose training step is "
                         "timed")
    ap.add_argument("--arch", default="xlstm-125m",
                    help="model trained at its full size")
    ap.add_argument("--remat", choices=("none", "full", "selective"),
                    default=None, help="default: none, full for "
                                       "zamba2-2.7b (as chip_smoke.py)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_timing: needs a CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    cuda_lib.library()
    zamba = args.arch == cs.ZAMBA_ARCH
    remat = args.remat or (cs.ZAMBA_REMAT if zamba else "none")
    steps = cs.ZAMBA_STEPS if zamba else cs.TRAIN_STEPS
    res = cs._train_full(torch.device("cuda"), arch=args.arch, steps=steps,
                         remat=remat)
    keep = ("arch", "remat", "ms_per_step", "ms_spread", "tok_per_s",
            "peak_gb", "profile", "launches", "losses", "step_ms")
    print(json.dumps({"tree": str(tree), **{k: res[k] for k in keep}}))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
