#!/usr/bin/env python3
"""B4 ``ssm_scan`` of one checkout, timed by ``chip_smoke.kernel_b4``, so
that two trees' kernels are measured alike.

``kernel_b4`` is this checkout's: at each row of ``chip_smoke.b4_rows``
(Zamba2's prefill (8, 512, 5120), xLSTM's (8, 512, 1536) and one long
prompt at xLSTM's width, (1, 8192, 1536)) it checks one launch a call
and the kernel against the plain version (``max |err| <= 1e-4 · max(1,
max |plain|)``), and times it: device ms with the host's enqueue hidden,
L2-flushed ms, ms with the host and the plain version's ms, beside the
byte bound and its share of it.  The kernel is the ``--tree``
checkout's, built from its sources into its own ``build/``.  Prints one
JSON line, then the card's name and power limit.  Run from the root of a
checkout on a machine with a GPU::

    python3 tools/b4_timing.py [--tree PATH]

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
                    help="root of the checkout whose B4 is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("b4_timing: needs a CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    cuda_lib.library()
    b4 = cs.kernel_b4(torch.device("cuda"))
    print(json.dumps({"tree": str(tree), "b4": b4["by_shape"]}))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
