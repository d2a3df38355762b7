#!/usr/bin/env python3
"""``chip_smoke.py``'s ``mesh`` phase alone, in a fresh process: the data
axis on one card (``chip_smoke.phase_mesh``, with every gate).

It builds the kernels, starts the one-rank NCCL world the sharded phase
leaves behind (``make_graph_mesh(1)``), and runs the phase: data-mesh
serving at D = 1 against one device and at D = 2 on two gloo ranks,
xLSTM-125M data parallel at W = 1 (NCCL, against the unsharded run)
and W = 2, Zamba2's smoke config at W = 2, a sharded checkpoint, GPipe
and the compressed reductions.  Writes the phase's record to
``mesh_timing.json`` beside ``chip_smoke.py``'s own record and prints
its launches, the card's name and power limit.  Run from the root of a
checkout on a machine with a GPU (≈100 s)::

    python3 tools/mesh_timing.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_timing: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import torch.distributed as dist
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import make_graph_mesh
    cuda_lib.build()
    cuda_lib.library()
    dev = torch.device("cuda")
    make_graph_mesh(1, device=dev)
    try:
        res = cs.phase_mesh(dev)
    finally:
        dist.destroy_process_group()
    out = cs.OUT.parent / "mesh_timing.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1, default=str))
    print(json.dumps({"launches": res["launches"],
                      "seconds": res["seconds"]}))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
