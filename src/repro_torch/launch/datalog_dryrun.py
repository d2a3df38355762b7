"""Datalog° on the production mesh: the paper's connected-components
fixpoint (Fig. 1) as an explicit SPMD step (counterpart of
``repro/launch/datalog_dryrun.py``).

The reference lowers CC's loop under pjit on the ``(16, 16)`` and
``(2, 16, 16)`` meshes and reads XLA's cost; here each rank runs its own
block of the step and :func:`run` counts rank 0 on the meta device in a
fake world (``launch.dryrun``), with the reference's row keys.  The
layout is the reference's: E's block on rank (i, j) is rows i over the
row axes (``"data"``, or ``("pod", "data")``) and columns j over
``"model"``, ``n/R × n/C``.

* **Original** (Fig. 1(a), O(n²) state): TC ← (E ∘ TC) ∨ I over 𝔹, then
  each row's least label.  SUMMA-style: E's row panel is gathered over
  ``"model"`` and TC's column panel over the row axes, and the local
  product ``(n/R × n)·(n × n/C)`` is kernel B2's ``tc_bool``; the labels
  are a local min over the block's columns, then a min all-reduce over
  ``"model"``.
* **Optimized** (Fig. 1(b), O(n) state): CC[x] ← min(x, min_y CC[y] |
  E(x, y)), a trop product.  A rank holds CC's entries of its column
  block and E's block as the trop matrix ``Wᵀ`` (``n/C × n/R``, 0 where
  an edge is, +∞ elsewhere; made once, outside the loop), and sends the
  row ``CC_j`` times ``Wᵀ`` to B2 (``m = 1``: its ``stream`` path, not
  ``tile_f32`` on an ``(n × n)·(n × 1)`` product); a min all-reduce over
  ``"model"`` finishes the row block, and an all-gather over the row
  axes hands every rank the whole vector, of which it keeps its column
  block.

A real run on a mesh of real ranks (:func:`cc_loop`) starts from TC = I
and CC = arange(n).  The reference's ``compile_s`` has no counterpart
(nothing is compiled): the row has ``wall_s``.

  PYTHONPATH=src python -m repro_torch.launch.datalog_dryrun --n 65536 \\
      --variant optimized --mesh single
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import semiring_matmul as mm
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

MODEL = "model"
INF = float("inf")


def row_axes(mesh) -> tuple:
    """The axes E's rows are split over: ``("pod", "data")`` on a
    multi-pod mesh, else ``("data",)``."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def blocks(n: int, mesh) -> tuple[slice, slice]:
    """This rank's rows and columns of an ``n × n`` relation."""
    rows, cols = sh.block_parts((n, n), sh.P(row_axes(mesh), MODEL),
                                mesh)[0]
    return rows, cols


def _gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    for a in reversed(axes):             # the outer axis major
        x = C.all_gather(x, mesh, a, dim)
    return x


def _min_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return C.all_reduce(x, mesh, axis, dist.ReduceOp.MIN)


def cc_original_step(e: torch.Tensor, tc: torch.Tensor, mesh, n: int):
    """One application of Fig. 1(a)'s ICO on this rank's blocks:
    ``(tc2, labels)``, TC's block (n/R × n/C, bool) and the least label
    of each of the block's rows (n/R, f32; +∞ for none)."""
    rows, cols = blocks(n, mesh)
    e_panel = C.all_gather(e, mesh, MODEL, 1)                   # n/R × n
    tc_panel = _gather(tc, mesh, row_axes(mesh), 0)             # n × n/C
    prod = mm.semiring_matmul("bool", e_panel, tc_panel)
    dev = e.device
    r = torch.arange(rows.start, rows.stop, device=dev)
    c = torch.arange(cols.start, cols.stop, device=dev)
    tc2 = prod | (r[:, None] == c[None, :])
    labels = torch.where(tc2, c.to(torch.float32)[None, :],
                         torch.tensor(INF, device=dev)).amin(1)
    return tc2, _min_over(labels, mesh, MODEL)


def trop_transpose(e: torch.Tensor) -> torch.Tensor:
    """E's block as the trop matrix the optimized step multiplies by,
    transposed: ``Wᵀ[y, x] = 0`` where ``E(x, y)``, else +∞."""
    zero = torch.zeros((), device=e.device)
    inf = torch.tensor(INF, device=e.device)
    return torch.where(e.t(), zero, inf).contiguous()


def cc_optimized_step(wt: torch.Tensor, cc_cols: torch.Tensor, mesh,
                      n: int):
    """One application of Fig. 1(b) on this rank's blocks: ``(cc_rows,
    cc_cols)``, the new labels of the block's rows (n/R) and of its
    columns (n/C, the next step's input), f32."""
    rows, cols = blocks(n, mesh)
    neigh = mm.semiring_matmul("trop", cc_cols[None, :], wt)[0]   # n/R
    neigh = _min_over(neigh, mesh, MODEL)
    x = torch.arange(rows.start, rows.stop, device=wt.device,
                     dtype=torch.float32)
    cc_rows = torch.minimum(x, neigh)
    whole = _gather(cc_rows, mesh, row_axes(mesh), 0)             # n
    return cc_rows, whole[cols].contiguous()


def cc_loop(e: torch.Tensor, variant: str, mesh, n: int, iters: int = 8):
    """``iters`` steps of ``variant`` from TC = I (original) or CC =
    arange(n) (optimized) on this rank's block ``e`` of E: the labels of
    the rank's rows (f32, n/R)."""
    rows, cols = blocks(n, mesh)
    dev = e.device
    if variant == "original":
        r = torch.arange(rows.start, rows.stop, device=dev)
        c = torch.arange(cols.start, cols.stop, device=dev)
        tc = r[:, None] == c[None, :]
        labels = None
        for _ in range(iters):
            tc, labels = cc_original_step(e, tc, mesh, n)
        return labels
    wt = trop_transpose(e)
    cc = torch.arange(cols.start, cols.stop, device=dev, dtype=torch.float32)
    out = None
    for _ in range(iters):
        out, cc = cc_optimized_step(wt, cc, mesh, n)
    return out


def run(n: int, variant: str, multi_pod: bool, iters: int = 8) -> dict:
    """Rank 0's ``iters`` steps of ``variant`` at ``n`` vertices on the
    production mesh, counted on the meta device: the reference's row
    (per rank; ``argument_bytes``: E's block, and for the optimized
    variant its trop form, made before the loop)."""
    t0 = time.time()
    dryrun.fake_world(512 if multi_pod else 256)
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, device="cpu")
    rows, cols = blocks(n, mesh)
    meta = torch.device("meta")
    e = torch.empty((rows.stop - rows.start, cols.stop - cols.start),
                    dtype=torch.bool, device=meta)
    if variant == "original":
        args = (e,)
    else:
        args = (e, trop_transpose(e))

    def loop(e, *wt):
        if variant == "original":
            return cc_loop(e, variant, mesh, n, iters)
        cc = torch.arange(cols.start, cols.stop, device=meta,
                          dtype=torch.float32)
        out = None
        for _ in range(iters):
            out, cc = cc_optimized_step(wt[0], cc, mesh, n)
        return out
    s = dryrun.stage(loop, args, warm=False)
    c = s.cost
    return {
        "workload": f"datalog-cc-{variant}", "n": n,
        "mesh": "multi" if multi_pod else "single", "status": "ok",
        "iters_lowered": iters,
        "flops": c.flops, "bytes_accessed": c.bytes,
        "collective_bytes": c.collective_bytes,
        "per_collective": c.per_collective,
        "temp_bytes": s.temp_bytes, "argument_bytes": s.argument_bytes,
        "kernels": c.kernels,
        "wall_s": round(time.time() - t0, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--variant", default="optimized",
                    choices=["original", "optimized"])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    row = run(args.n, args.variant, args.mesh == "multi", args.iters)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
