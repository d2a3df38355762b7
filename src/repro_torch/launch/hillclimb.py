"""Per-cell variant ladders of the dry run, priced on H100s
(counterpart of ``repro/launch/hillclimb.py``).

Each rung is one hypothesis: the runner stages the cell with the rung's
flags (``launch.dryrun``, in this process: a meta step holds no memory)
and prices its count with :func:`terms`.

The reference's ladders keep here only the rungs whose flags the port
has (``CELLS[...]["dropped"]`` says which went and why): ``--attn`` and
``--scan`` pick XLA lowerings, and the port's attention is kernel B5 and
its scan kernel B4 (``dryrun.NO_COUNTERPART``).

:func:`terms` prices with the NVIDIA H100 SXM5 80GB data sheet at 700 W,
not the reference's TPU constants: compute at the bf16 dense tensor-core
peak, memory at HBM3's rate, and each collective at the slowest link its
group crosses (the dry run records each collective's group by the span
of its ranks), with ranks placed model axis fastest, 8 a node (an HGX
H100 8-GPU node): a group inside one node moves at NVLink 4's rate, a
group that spans nodes at one 400 Gb/s NDR InfiniBand port a GPU.  The
16-wide ``"model"`` axis spans two nodes, so its collectives price at
InfiniBand (the row's ``links`` say which bytes went where).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell llama3 \\
      --out results/
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch import dryrun

#: H100 SXM5 80GB data sheet, 700 W: dense bf16 tensor-core peak, FLOP/s
BF16_FLOPS = 989e12
#: the same data sheet: HBM3, bytes/s
HBM_BYTES = 3.35e12
#: NVLink 4 inside an HGX H100 8-GPU node: 900 GB/s a GPU, 450 GB/s a
#: direction
NVLINK_BYTES = 450e9
#: one 400 Gb/s NDR InfiniBand port a GPU across nodes: 50 GB/s
IB_BYTES = 50e9
#: GPUs a node (HGX H100 8-GPU)
NODE = 8

#: the three chosen cells and their ladders
CELLS = {
    # worst roofline fraction / memory-dominated flagship
    "llama3": {
        "arch": "llama3-405b", "shape": "train_4k", "mesh": "single",
        "variants": [
            ("baseline", []),
            ("accum8", ["--accum", "8"]),
            ("accum8+adafactor", ["--accum", "8", "--opt", "adafactor"]),
        ],
        "dropped": {"online-attn": "--attn online: the port's attention "
                                   "is B5 (no XLA lowering to pick); its "
                                   "later rungs keep their other flags"},
    },
    # most collective-bound
    "deepseek": {
        "arch": "deepseek-moe-16b", "shape": "train_4k", "mesh": "single",
        "variants": [
            ("baseline", []),
            ("embedcol", ["--embed-spec", "embedcol"]),
            ("replicate-small-8M", ["--embed-spec", "embedcol",
                                    "--replicate-small", str(8 << 20)]),
        ],
        "dropped": {"online-attn": "--attn online: B5 is the port's "
                                   "attention; the later rungs drop the "
                                   "flag"},
    },
    # most representative of the paper's technique (FGH-rewritten scan)
    "zamba2": {
        "arch": "zamba2-2.7b", "shape": "train_4k", "mesh": "single",
        "variants": [
            ("baseline", []),
            ("accum4", ["--accum", "4"]),
        ],
        "dropped": {"chunked-scan": "--scan chunked: the port's scan is "
                                    "B4", "chunked+online": "--scan and "
                                    "--attn: B4 and B5"},
    },
}


def run_cell(arch, shape, mesh, extra) -> dict:
    """The dry-run row of the cell under ``extra`` (command-line flags)."""
    rows = dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh,
                        *extra])
    return rows


def link(span: str) -> tuple[float, str]:
    """The rate and name of the slowest link a collective's group
    crosses, from its ``"size×stride"`` (``dryrun`` rows'
    ``collectives.by_group``): ranks are placed model axis fastest, 8 a
    node, so a group whose ranks span at most 8 consecutive ranks stays
    on NVLink."""
    if span == "?":
        return IB_BYTES, "infiniband"
    size, stride = (int(x) for x in span.split("×"))
    if (size - 1) * stride + 1 <= NODE:
        return NVLINK_BYTES, "nvlink"
    return IB_BYTES, "infiniband"


def terms(row: dict) -> dict:
    """A row's roofline terms on H100s: compute at the bf16 peak, memory
    at HBM3's rate, each collective's bytes at the slowest link its
    group crosses (``links``: the bytes a link carries; the 16-wide
    ``"model"`` axis, 16 ranks 1 apart, spans two 8-GPU nodes, so its
    collectives go over InfiniBand)."""
    if row.get("status", "ok") != "ok":       # a calibrate row has none
        return {"status": row.get("status"),
                "error": row.get("error") or row.get("reason")}
    by_link: dict = {}
    seconds = 0.0
    for span, nbytes in row["collectives"]["by_group"].items():
        rate, name = link(span)
        seconds += nbytes / rate
        by_link[name] = by_link.get(name, 0.0) + nbytes
    return {
        "compute_s": row["flops"] / BF16_FLOPS,
        "memory_s": row["bytes_accessed"] / HBM_BYTES,
        "collective_s": seconds,
        "temp_gib": row["memory"]["temp_bytes"] / 2 ** 30,
        "arg_gib": row["memory"]["argument_bytes"] / 2 ** 30,
        "links": by_link,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=list(CELLS))
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)
    spec = CELLS[args.cell]
    os.makedirs(args.out, exist_ok=True)
    results = []
    for name, extra in spec["variants"]:
        row = run_cell(spec["arch"], spec["shape"], spec["mesh"], extra)
        entry = {"variant": name, "flags": extra, **terms(row),
                 "raw": row}
        results.append(entry)
        printable = {k: (round(v, 3) if isinstance(v, float) else v)
                     for k, v in entry.items() if k != "raw"}
        print(json.dumps(printable), flush=True)
        with open(os.path.join(args.out,
                               f"hillclimb_{args.cell}.json"), "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
