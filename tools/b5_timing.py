#!/usr/bin/env python3
"""B5 ``flash_attention``'s forward of one checkout, timed by
``chip_smoke.kernel_b5``, so that two trees' kernels are measured alike;
or, with ``--backward``, its backward.

``kernel_b5`` is this checkout's: at each shape of
``chip_smoke.B5_TIMED`` (Zamba2's prefill, decode and full forward,
DeepSeekMoE's prefill and decode, StarCoder2's window prefill and
decode, over the written slots of a KV cache) it checks one launch a
call on the path ``plan_attention`` picks and the kernel against the
plain version (``max |err| <= 1e-4 · max(1, max |plain|)``), and times
it: device ms with the host's enqueue hidden, L2-flushed ms, ms with the
host, the plain version's and SDPA's ms, beside the bound.  The kernel
is the ``--tree`` checkout's, built from its sources into its own
``build/``, and called as serving calls it (no lse).  With ``--outputs
DIR`` it also computes B5's output at each shape from ``kernel_b5``'s
inputs: saved into DIR where a shape's file is absent, else held bit for
bit (``torch.equal``) against the file there.  Prints one JSON line,
then the card's name and power limit.

With ``--backward`` it times the ``--tree`` checkout's backward instead,
through that tree's own ``chip_smoke._train_b5_backward`` (which also
holds dq, dk and dv against autograd through the plain forward at every
``B5_TRAIN_ROWS`` shape and two backwards bit for bit): per shape the
backward's ms (host hidden, and L2 flushed), each kernel's ms, its
bound, SDPA's backward and the plain one.  Run from the root of a
checkout on a machine with a GPU::

    python3 tools/b5_timing.py [--tree PATH] [--outputs DIR | --backward]

To compare a parent with a change, unpack the parent with ``git
archive`` into ``build/`` and run parent, change, change, parent in one
call on the card, all with one ``--outputs`` directory: the parent's
first run writes the outputs (None), and the other three are held to
them; the backward likewise, each run with ``--backward``.
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
                    help="root of the checkout whose B5 is timed")
    ap.add_argument("--outputs", type=Path, default=None,
                    help="directory of the outputs held bit for bit")
    ap.add_argument("--backward", action="store_true",
                    help="time the tree's backward (its own chip_smoke)")
    args = ap.parse_args()
    if args.backward and args.outputs:
        ap.error("--outputs holds the forward's outputs; not with "
                 "--backward")
    import torch
    if not torch.cuda.is_available():
        print("b5_timing: needs a CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(tree if args.backward else ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    cuda_lib.library()
    dev = torch.device("cuda")
    if args.backward:
        keep = ("ms", "cold_ms", "kernel_ms", "bound_ms", "bound_by",
                "bound_simt_ms", "library_ms", "plain_ms", "max_abs_err",
                "tol")
        rows = cs._train_b5_backward(dev)
        print(json.dumps({"tree": str(tree), "b5_backward": {
            name: {k: r[k] for k in keep if k in r}
            for name, r in rows.items()}}))
        print(cs.nvidia_smi())
        return 0
    res = {"tree": str(tree), "b5": cs.kernel_b5(dev)["by_shape"]}
    if args.outputs:
        res["bitwise_equal"] = same_outputs(cs, dev, args.outputs)
    print(json.dumps(res))
    print(cs.nvidia_smi())
    return 1 if False in res.get("bitwise_equal", {}).values() else 0


def same_outputs(cs, dev, folder: Path) -> dict:
    """B5's output at each ``B5_TIMED`` shape, on ``kernel_b5``'s inputs
    and mask: ``torch.equal`` to ``folder/NAME.pt`` where that file
    exists; else saved there, and None."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    folder.mkdir(parents=True, exist_ok=True)
    out = {}
    for i, (name, (arch, b, tq, tk, off, t_max)) in enumerate(
            cs.B5_TIMED.items()):
        cfg = configs.get(arch)
        q, k, v = cs.b5_inputs(dev, 5 + i, b, tq, tk, cfg.n_heads,
                               cfg.n_kv_heads, cfg.hd, t_max)
        o = fa.flash_attention_cuda(q, k, v, causal=True, window=cfg.window,
                                    chunk=cfg.chunk, q_offset=off).cpu()
        path = folder / f"{name}.pt"
        if path.exists():
            out[name] = torch.equal(o, torch.load(path))
        else:
            torch.save(o, path)
            out[name] = None
    return out


if __name__ == "__main__":
    sys.exit(main())
