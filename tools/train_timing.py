#!/usr/bin/env python3
"""One card's training step of one checkout, timed by
``chip_smoke._train_full`` in a fresh process, so that two trees' steps
are measured alike and the profiler's capture is the process's first.

``_train_full`` is this checkout's: ``train("xlstm-125m", smoke=False,
batch=8, seq=1024, steps=30)`` on the card (its gates: finite losses and
grad norms, the loss falling, B4 launched 12 forward + 12 backward a
step and its plain version never), then one warm step under
``torch.profiler``.  The package trained is the ``--tree`` checkout's,
its kernels built from its sources into its own ``build/``.  Prints one
JSON line (ms a step, the warm steps' spread, tokens/s, peak memory,
the profile: busy share, GEMM ms, B4 forward and backward ms, the top
kernels), then the card's name and power limit.  Run from the root of a
checkout on a machine with a GPU::

    python3 tools/train_timing.py [--tree PATH]

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
    res = cs._train_full(torch.device("cuda"))
    keep = ("ms_per_step", "ms_spread", "tok_per_s", "peak_gb", "profile",
            "launches", "losses", "step_ms")
    print(json.dumps({"tree": str(tree), **{k: res[k] for k in keep}}))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
