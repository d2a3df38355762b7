#!/usr/bin/env python3
"""``chip_smoke.py``'s ``model_axis`` phase alone, in a fresh process:
tensor parallelism over ``"model"`` on one card
(``chip_smoke.phase_model_axis``, with every gate).

It builds the kernels and runs the phase: xLSTM-125M on a one-rank NCCL
host mesh against the unsharded run (bit for bit; the mesh phase's
``_mesh_train_w1``, which ``chip_smoke.py`` runs once for both),
DeepSeekMoE-16B, MiniCPM-2B and Whisper-base served on one device
(``chip_smoke.ma_family_references``: in ``chip_smoke.py`` the
lm_families phase's runs are those references), B4 and B5 at the rank
shapes of M = 2, 8 and 16 against their plain versions, the one-rank
references, two gloo ranks on the card at ``(data 1, model 2)``
(xLSTM-125M at full size trained with AdamW and with Adafactor,
Zamba2's smoke config and DeepSeekMoE-16B at 2 layers trained,
Zamba2-2.7B and DeepSeekMoE-16B served, each rank building its blocks;
DeepSeekMoE's smoke config trained as ``(data 2, model 1)``), eight at
``(1, 8)`` (MiniCPM-2B served, StarCoder2-7B at full width and 2 layers
trained, on uneven whole heads) and sixteen at ``(1, 16)``
(Whisper-base served, each head on two ranks).
Writes the phase's record to ``model_axis_timing.json`` beside
``chip_smoke.py``'s own record and prints its launches and seconds, the
card's name and power limit.  Run from the root of a checkout on a
machine with a GPU::

    python3 tools/model_axis_timing.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("model_axis_timing: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import torch.distributed as dist
    from repro_torch.kernels import cuda_lib
    cuda_lib.build()
    cuda_lib.library()
    try:
        dev = torch.device("cuda")
        w1 = cs._mesh_train_w1(dev)
        cs._free_cuda()
        res = cs.phase_model_axis(dev, w1, cs.ma_family_references(dev))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out = cs.OUT.parent / "model_axis_timing.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1, default=str))
    print(json.dumps({"launches": res["launches"],
                      "seconds": res["seconds"]}))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
