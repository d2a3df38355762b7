#!/usr/bin/env python3
"""B4 ``ssm_scan`` at every configuration of a grid, to choose the
kernel's channel width W, ring depth NST and rows a thread group C.

It builds one library a C: a file that includes the tree's
``csrc/ssm_scan.cu`` as it is and adds an entry point that launches its
``launch<W, NST, 4, C>`` for each (W, NST) of :data:`GRID`; then, at each
row of ``chip_smoke.b4_rows``, checks every configuration against the
plain version (``max |err| <= 1e-4 · max(1, max |plain|)``) and times
it as ``chip_smoke.py`` does (device ms with the host hidden, best of
3, and L2-flushed ms), beside the byte bound.  Beside them it times
``torch.addcmul(b, a, b)``: the same 12 bytes an element with no
recurrence, a yardstick for what a streaming pass reaches on the card
(it does not compute B4's function).  Prints one JSON line, then the
card's name and power limit.  Run from the root of a checkout on a
machine with a GPU::

    python3 tools/b4_sweep.py [--tree PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: rows a thread group scans serially (the source's C)
ROWS = (16, 8)
#: (W, NST): channels a block, stages in the ring
GRID = ((32, 2), (32, 3), (32, 4), (32, 6), (16, 3), (16, 4), (16, 6),
        (16, 8), (8, 4), (8, 6), (8, 8), (4, 6), (4, 8))


def build(tree: Path) -> dict[int, ctypes.CDLL]:
    """The tree's kernel once for each C of :data:`ROWS`, with a
    ``ssm_scan_with`` entry point, built in parallel into the tree's
    ``build/``."""
    from repro_torch.kernels import cuda_lib
    src = tree / "src/repro_torch/csrc/ssm_scan.cu"
    out = tree / "build" / "b4_sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for rows in ROWS:
        cases = "".join(f"  if (w == {w} && nst == {n}) return launch<{w}, "
                        f"{n}, 4, {rows}>(fa, fb, fh, bsz, t, d, st);\n"
                        for w, n in GRID)
        entry = f"""#include "{src}"

extern "C" int ssm_scan_with(const void* a, const void* b, void* h, int bsz,
                             int t, int d, int w, int nst, void* stream) {{
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(b);
  auto* fh = static_cast<float*>(h);
  auto* st = static_cast<cudaStream_t>(stream);
{cases}  return -1;
}}
"""
        cu, so = out / f"ssm_scan_c{rows}.cu", out / f"libssm_scan_c{rows}.so"
        cu.write_text(entry)
        procs[rows] = so, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.CFLAGS, "-shared", "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for rows, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"b4_sweep: nvcc failed for C={rows}:\n{text}")
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssm_scan_with.argtypes = (p, p, p, i, i, i, i, i, p)
        libs[rows] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="root of the checkout whose B4 source is swept")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("b4_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ref
    libs = build(tree)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for name, arch, shape in cs.b4_rows():
        a, b = cs.b4_inputs(dev, shape)
        want = ref.ssm_scan_ref(a, b)
        bound, _ = cs._bound(12.0 * a.numel())
        h = torch.empty_like(a)

        def timed(fn):
            ms = min(cs.time_ms(fn, 20, hide_host=True) for _ in range(3))
            cold = cs.time_cold_ms(fn, 10)
            return dict(ms=ms, cold_ms=cold, bound_share=bound / ms,
                        cold_bound_share=bound / cold)
        row = {"bound_ms": bound, "shape": dict(zip("BTD", shape)),
               "addcmul": timed(lambda: torch.addcmul(b, a, b, out=h))}
        for c, lib in libs.items():
            for w, nst in GRID:
                def kernel(lib=lib, c=c, w=w, nst=nst):
                    err = lib.ssm_scan_with(a.data_ptr(), b.data_ptr(),
                                            h.data_ptr(), *shape, w, nst,
                                            stream)
                    if err:
                        raise RuntimeError(f"C={c} W={w} NST={nst}: "
                                           f"CUDA error {err}")
                kernel()
                err, _ = cs._check_float(f"{name} C={c} W={w} NST={nst}",
                                         "ssm_scan", h, want)
                row[f"C={c} W={w} NST={nst}"] = dict(max_abs_err=err,
                                                     **timed(kernel))
        rows[name] = row
        del a, b, h, want
    print(json.dumps({"tree": str(tree), "b4_sweep": rows}))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
