#!/usr/bin/env python3
"""The MoE dispatch's slot computation on the card, two ways.

A routing choice's slot is how many earlier choices (token-major) picked
the same expert.  The reference computes it as a cumsum down a ``(T·k,
E)`` one-hot (``repro/models/moe.py:76-79``); ``repro_torch.models.moe.
route`` runs the same cumsum along the rows of the one-hot's transpose.
This times both, and a stable sort, at DeepSeekMoE-16B's shapes (64
experts, top-6; a prefill of 8 × 512 tokens and a decode step of 8),
checks that they give the same slots, and times one whole ``moe_apply``
at the prefill shape with the full published widths.  Device ms from CUDA events over 20 back-to-back calls
after a warm-up.  Prints one JSON line, then the card's name and power
limit.  Run from the root of a checkout on a machine with a GPU::

    python3 tools/moe_slot_timing.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_ms(fn, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("moe_slot_timing: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = configs.get("deepseek-moe-16b")
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, tokens in (("prefill", 8 * 512), ("decode", 8)):
        expert = torch.randint(0, e, (tokens * k,), generator=g, device=dev)

        def scan():
            onehot = F.one_hot(expert, e)
            return onehot.cumsum(0).gather(1, expert[:, None])[:, 0] - 1

        def scan_rows():
            onehot = F.one_hot(expert, e).T.contiguous()
            return onehot.cumsum(1)[expert, torch.arange(
                expert.numel(), device=dev)] - 1

        def sort():
            order = torch.argsort(expert, stable=True)
            counts = torch.bincount(expert, minlength=e)
            first = torch.cumsum(counts, 0) - counts
            slot = torch.empty_like(expert)
            slot[order] = torch.arange(expert.numel(), device=dev) \
                - first[expert[order]]
            return slot
        if not (torch.equal(scan(), sort())
                and torch.equal(scan(), scan_rows())):
            raise AssertionError(f"moe_slot_timing: slots differ ({name})")
        out[name] = {"choices": tokens * k, "experts": e,
                     "one_hot_cumsum_ms": time_ms(scan),
                     "one_hot_rows_cumsum_ms": time_ms(scan_rows),
                     "stable_sort_ms": time_ms(sort)}
    p = moe.moe_init(g, cfg, torch.float32)
    x = torch.randn((8, 512, cfg.d_model), generator=g, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    out["moe_apply_prefill_ms"] = time_ms(lambda: moe.moe_apply(p, x, cfg),
                                          5)
    print(json.dumps(out))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
