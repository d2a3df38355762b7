#!/usr/bin/env python3
"""Time a checkpoint save and restore of a full training state on the
GPU: xLSTM-125M's and Zamba2-2.7B's published sizes, f32 parameters and
AdamW's two f32 moments (12 bytes a parameter: 1.3 GB and 28.8 GB).

For each architecture the state is built on the card (random weights
from a seed, the moments filled from the weights so that no page of the
file is zeros), then ``--reps`` times: ``CheckpointManager.maybe_save``
(the ms the caller is blocked, of which the device→host snapshot; the
writer thread's seconds and GB/s), and, with the state zeroed,
``restore_latest(..., inplace=True)`` into it as ``train`` restores
(seconds, and the bytes it allocated on the card beyond the state; the
file was just written, so the read is warm in the page cache), the
restored state held to the saved one bit for bit.
First it prints the free disk under ``--dir`` and the host's available
memory; an architecture whose state does not fit twice in either (two
checkpoints on disk while rotation replaces one; the snapshot in host
memory beside the page cache) is skipped with the reason printed.  Prints one JSON line an
architecture, then the card's name and power limit; details go to
``chiprun_out/ckpt_timing.json``.  Run from the root of a checkout on a
machine with a GPU::

    python3 tools/ckpt_timing.py [--arch ARCH ...] [--reps N] [--dir DIR]

Each save writes the whole state: on a machine that caps what a run may
write to disk (45 GiB on the one measured), keep ``--reps`` × state
within the cap.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def power_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _restored_ok(cfg, tree, dev) -> bool:
    """Whether ``tree`` holds the state :func:`time_arch` saved: the
    weights of seed 0, m equal to them and v to their squares, bit for
    bit (checked leaf by leaf, so the card holds one extra leaf)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.optimizer.optimizers import tree_leaves
    want = T.init_params(cfg, 0, device=dev)
    opt = tree["opt"]
    return opt["step"] == 1000 and all(
        torch.equal(p, w) and torch.equal(m, w) and torch.equal(v, w.square())
        for p, m, v, w in zip(tree_leaves(tree["params"]),
                              tree_leaves(opt["m"]), tree_leaves(opt["v"]),
                              tree_leaves(want)))


def time_arch(arch: str, reps: int, parent: Path, dev, smoke=False) -> dict:
    """One architecture's save and restore timings (``smoke`` and a CPU
    ``dev`` rehearse the tool without a card)."""
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import transformer as T
    from repro_torch.optimizer import adamw_init
    from repro_torch.optimizer.optimizers import tree_leaves
    cfg = configs.get(arch, smoke=smoke)
    n = cfg.param_count()
    need = 12 * n
    disk = shutil.disk_usage(parent).free
    host = host_available_bytes()
    res = {"arch": arch, "params": n, "state_bytes_expected": need,
           "free_disk_bytes": disk, "host_available_bytes": host}
    if disk < 2 * need or host < 2 * need:
        res["skipped"] = (f"the state ({need / 1e9:.1f} GB) does not fit "
                          f"twice in the free disk ({disk / 1e9:.1f} GB) "
                          f"or the host's available memory "
                          f"({host / 1e9:.1f} GB)")
        return res
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    params = T.init_params(cfg, 0, device=dev)
    state = adamw_init(params)
    with torch.no_grad():
        for p, m, v in zip(tree_leaves(params), tree_leaves(state["m"]),
                           tree_leaves(state["v"])):
            m.copy_(p)
            v.copy_(p.square())
    state["step"] = 1000
    tree = {"params": params, "opt": state}
    d = Path(tempfile.mkdtemp(prefix="ckpt_timing_", dir=parent))
    try:
        saves, restores = [], []
        for rep in range(reps):
            mgr = CheckpointManager(str(d), keep=1, every=1)
            sync()
            t0 = time.perf_counter()
            pending = mgr.maybe_save(rep + 1, tree)
            blocked_ms = (time.perf_counter() - t0) * 1e3
            mgr.wait()
            save = dict(pending.stats, blocked_ms=blocked_ms)
            save["gb_per_s"] = save["bytes"] / save["write_s"] / 1e9
            save["snapshot_gb_per_s"] = (save["bytes"]
                                         / save["snapshot_ms"] / 1e6)
            saves.append(save)
            print(f"{arch} save {rep + 1}: {json.dumps(save)}", flush=True)
            with torch.no_grad():       # the restore must put it all back
                for x in tree_leaves(tree):
                    if isinstance(x, torch.Tensor):
                        x.zero_()
            state["step"] = 0
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated() if cuda else 0
            t0 = time.perf_counter()
            _, step = mgr.restore_latest(tree, inplace=True)
            sync()
            restore_s = time.perf_counter() - t0
            extra = (torch.cuda.max_memory_allocated() - before
                     if cuda else None)
            if step != rep + 1 or not _restored_ok(cfg, tree, dev):
                raise AssertionError(f"{arch}: the restored state differs")
            restores.append({"s": restore_s,
                             "gb_per_s": save["bytes"] / restore_s / 1e9,
                             "extra_device_bytes": extra})
            print(f"{arch} restore {rep + 1}: {json.dumps(restores[-1])}",
                  flush=True)
        res.update(state_bytes=saves[0]["bytes"], saves=saves,
                   restores=restores)
    finally:
        shutil.rmtree(d, ignore_errors=True)
        del params, state, tree
        if cuda:
            torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+",
                    default=["xlstm-125m", "zamba2-2.7b"])
    ap.add_argument("--reps", type=int, default=1,
                    help="saves and restores an architecture (the GPU "
                         "machine this was measured on accepts 45 GiB of "
                         "disk writes a run: one 28.8 GB save)")
    ap.add_argument("--dir", type=Path, default=ROOT / "build",
                    help="where the checkpoints are written (removed "
                         "afterwards)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ckpt_timing: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    args.dir.mkdir(parents=True, exist_ok=True)
    print(f"free disk under {args.dir}: "
          f"{shutil.disk_usage(args.dir).free / 1e9:.1f} GB; host memory "
          f"available: {host_available_bytes() / 1e9:.1f} GB", flush=True)
    results = []
    for arch in args.arch:
        res = time_arch(arch, args.reps, args.dir, torch.device("cuda"))
        results.append(res)
        print(json.dumps(res), flush=True)
    power = power_line()
    out = ROOT / "chiprun_out" / "ckpt_timing.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"power": power, "results": results},
                              indent=1))
    print(power)
    return 0


if __name__ == "__main__":
    sys.exit(main())
