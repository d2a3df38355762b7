#!/usr/bin/env python3
"""``chip_smoke.py``'s ``mesh`` phase alone, in a fresh process, or one
architecture's sharded train step alone.

Without ``--arch``: the data axis on one card (``chip_smoke.phase_mesh``,
with every gate).  It builds the kernels, starts the one-rank NCCL world
the sharded phase leaves behind (``make_graph_mesh(1)``), and runs the
phase: data-mesh serving at D = 1 against one device and at D = 2 on two
gloo ranks, xLSTM-125M and Zamba2-2.7B data parallel at W = 1 (NCCL,
against the unsharded runs) and xLSTM-125M at W = 2, Zamba2's smoke
config at W = 2, a sharded checkpoint, GPipe and the compressed
reductions.  Writes the phase's record to ``mesh_timing.json`` beside
``chip_smoke.py``'s own record and prints its launches, the card's name
and power limit (the phase takes ≈94 s on an H100, the build aside)::

    python3 tools/mesh_timing.py

With ``--w1 [--tree DIR]``: only the phase's xLSTM-125M pair at W = 1
(``chip_smoke._mesh_train_w1``: 10 steps unsharded and on a one-rank
NCCL mesh, bit for bit, ms a step and peaks) of the checkout at DIR,
its own port and ``chip_smoke.py`` (parent against change in one call,
one process a tree)::

    python3 tools/mesh_timing.py --w1 --tree build/parent

With ``--arch``: ``STEPS`` steps of ``train`` of that architecture at
its published widths and ``chip_smoke.py``'s batch (B = 8 × 1,024), with
``--remat``, on a ``"data"`` axis of ``--world`` ranks — 1: a one-rank
NCCL mesh in this process; 2: two gloo ranks on the one card — and,
with ``--unsharded`` (W = 1), the unsharded run first.  For each run
it prints ms a step (median of steps 2 on), the peak device memory, the
most gathered parameter bytes alive at once
(``collectives.STATS["gathered_peak_bytes"]``) beside their bound (the
leaves outside the stacks plus the largest layer) and the whole tree's,
and the collective and host-staged bytes a step.  With ``--snapshot``
each W = 1 run is repeated under ``torch.cuda.memory``'s allocation
history, replayed to its highest point, and the live bytes there are
broken down by what allocated them.  The record lands in
``mesh_timing_<arch>_w<W>.json`` beside ``chip_smoke.py``'s::

    python3 tools/mesh_timing.py --arch xlstm-125m --world 1 \\
        --unsharded --snapshot
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: steps of an ``--arch`` run (its median is over steps 2 on)
STEPS = 6

#: what allocated a block that no initializer did, by the innermost
#: frame of this repository's (or torch's checkpoint's) Python code on
#: its stack: "file:function" or file → category
CATEGORIES = {
    "collectives.py": "gathered parameters",
    "collectives.py:reduce_scatter": "gradients (reduce-scattered)",
    "collectives.py:all_reduce_group": "gradients (all-reduced)",
    "optimizers.py": "optimizer update temporaries",
    "checkpoint.py": "remat recompute",
    "steps.py": "sharded step (gradient sums, reductions)",
    "pipeline.py": "batches",
    **dict.fromkeys(("transformer.py", "layers.py", "attention.py",
                     "ssm.py", "moe.py", "flash_attention.py",
                     "ssm_scan.py"), "activations (forward)"),
}


def _initializer(name: str) -> bool:
    return name == "init" or name.startswith("init_") or \
        name.endswith("_init")


def category(frames) -> tuple[str, str]:
    """``(category, where)`` of an allocation from its Python frames
    (innermost first): an initializer anywhere on the stack makes it
    parameters (optimizer state under ``optimizers.py``); else the
    innermost known file decides (:data:`CATEGORIES`); one with no frames
    was made on autograd's device thread outside any Python hook: the
    backward's gradients and temporaries."""
    for f in frames:
        if _initializer(f["name"]):
            name = Path(f["filename"]).name
            return ("optimizer state" if name == "optimizers.py"
                    else "parameters"), f"{name}:{f['line']} {f['name']}"
    for f in frames:
        name = Path(f["filename"]).name
        for key in (f"{name}:{f['name']}", name):
            if key in CATEGORIES:
                return CATEGORIES[key], f"{name}:{f['line']} {f['name']}"
    if not frames:
        return "backward (autograd's device thread)", "-"
    f = frames[0]
    return "other", f"{Path(f['filename']).name}:{f['line']} {f['name']}"


def peak_breakdown(fn):
    """Run ``fn()`` under ``torch.cuda.memory``'s allocation history and
    replay the history to its highest allocated point: the bytes live
    there by category and by the ten largest allocation sites, and the
    bytes already allocated when the history started."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python",
        max_entries=4_000_000)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    live, cur, best, at = {}, base, base, {}
    for ev in trace:
        act = ev["action"]
        if act == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            cur += ev["size"]
            if cur > best:
                best, at = cur, dict(live)
        elif act == "free_requested" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[0]
    by_cat, by_site = {}, {}
    for size, frames in at.values():
        cat, where = category(frames)
        by_cat[cat] = by_cat.get(cat, 0) + size
        key = f"{cat}: {where}"
        by_site[key] = by_site.get(key, 0) + size
    top = sorted(by_site.items(), key=lambda kv: -kv[1])[:10]
    return {"peak_bytes": best, "base_bytes": base,
            "by_category": dict(sorted(by_cat.items(),
                                       key=lambda kv: -kv[1])),
            "top_sites": dict(top), "events": len(trace)}


def run_train(arch, *, remat, mesh, dev):
    """One ``train`` run at the published widths: losses, ms a step,
    peak, collectives."""
    import gc
    import numpy as np
    import torch
    import chip_smoke as cs
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.distributed import collectives
    from repro_torch.launch import train as train_mod
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = []
    collectives.reset_stats()
    t0 = time.perf_counter()
    params, losses = train_mod.train(
        arch, smoke=False, batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ,
        steps=STEPS, remat=remat, device=dev, history=hist,
        log_every=10 ** 6, mesh=mesh)
    torch.cuda.synchronize()
    coll = collectives.reset_stats()
    ms = [h["ms"] for h in hist]
    return params, {
        "losses": losses, "ms": ms, "ms_median": float(np.median(ms[1:]
                                                                 or ms)),
        "seconds": time.perf_counter() - t0,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "collectives": coll}


def _bound(arch, params, mesh):
    import chip_smoke as cs
    from repro_torch import configs
    return cs._mesh_gathered_bound(configs.get(arch), params, mesh)


def _w2_rank(mesh, arch, remat):
    """One rank of the two-rank world: its run's record."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    params, rec = run_train(arch, remat=remat, mesh=None, dev=mesh.device)
    rec["gathered_bound_bytes"], rec["whole_tree_bytes"] = _bound(
        arch, params, mesh)
    return rec


def one_arch(args, dev) -> dict:
    import torch
    from repro_torch.launch.mesh import make_host_mesh, spawn_world
    out = {"arch": args.arch, "world": args.world, "remat": args.remat,
           "steps": STEPS}
    if args.world == 2:
        out["ranks"] = spawn_world(_w2_rank, 2, args.arch, args.remat,
                                   device=dev)
        return out
    for name in ("unsharded", "mesh") if args.unsharded else ("mesh",):
        mesh = make_host_mesh(device=dev) if name == "mesh" else None
        params, rec = run_train(args.arch, remat=args.remat, mesh=mesh,
                                dev=dev)
        if name == "mesh":
            rec["gathered_bound_bytes"], rec["whole_tree_bytes"] = _bound(
                args.arch, params, mesh)
        del params
        torch.cuda.empty_cache()
        if args.snapshot:
            rec["peak_breakdown"] = peak_breakdown(
                lambda: run_train(args.arch, remat=args.remat, mesh=mesh,
                                  dev=dev))
            torch.cuda.empty_cache()
        out[name] = rec
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", help="one architecture's step alone")
    ap.add_argument("--world", type=int, default=1, choices=(1, 2))
    ap.add_argument("--remat", default="none")
    ap.add_argument("--unsharded", action="store_true",
                    help="W = 1: the unsharded run first, for its peak")
    ap.add_argument("--snapshot", action="store_true",
                    help="W = 1: each run's peak broken down")
    ap.add_argument("--w1", action="store_true",
                    help="only the phase's xLSTM-125M pair at W = 1 "
                         "(chip_smoke._mesh_train_w1)")
    ap.add_argument("--tree", default=None,
                    help="with --w1: the checkout whose chip_smoke.py and "
                         "port run (default: this one)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mesh_timing: needs a CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve() if args.tree else ROOT
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(tree))
    import chip_smoke as cs
    import torch.distributed as dist
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import make_graph_mesh
    cuda_lib.build()
    cuda_lib.library()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.arch and args.world == 2:
        res = one_arch(args, dev)
    else:
        make_graph_mesh(1, device=dev)
        try:
            res = (one_arch(args, dev) if args.arch else
                   cs._mesh_train_w1(dev) if args.w1 else cs.phase_mesh(dev))
        finally:
            dist.destroy_process_group()
    name = (f"mesh_timing_{args.arch}_w{args.world}.json" if args.arch
            else f"mesh_timing_w1_{tree.name}.json" if args.w1
            else "mesh_timing.json")
    out = ROOT / cs.OUT.parent.relative_to(cs.ROOT) / name   # beside ours
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1, default=str))
    if args.arch:
        runs = res.get("ranks") or [res[k] for k in ("unsharded", "mesh")
                                    if k in res]
        for rec in runs:
            print(json.dumps({k: rec.get(k) for k in (
                "ms_median", "peak_gb", "gathered_bound_bytes",
                "whole_tree_bytes")} | {
                    "gathered_peak_bytes":
                        rec["collectives"]["gathered_peak_bytes"],
                    "host_staged_bytes":
                        rec["collectives"]["host_staged_bytes"],
                    "collective_bytes": rec["collectives"]["bytes"]}))
            if "peak_breakdown" in rec:
                print(json.dumps(rec["peak_breakdown"]["by_category"]))
    elif args.w1:
        print(json.dumps({"tree": str(tree), **{
            k: res.get(k) for k in (
                "ms_unsharded", "ms_mesh", "peak_gb_unsharded",
                "peak_gb_mesh", "gathered_peak_bytes",
                "collective_bytes_per_step")}}))
    else:
        print(json.dumps({"launches": res["launches"],
                          "seconds": res["seconds"]}))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
