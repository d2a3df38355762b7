"""The rank side of ``tests/test_torch_dryrun.py``'s Datalog world: CC's
loop (``launch.datalog_dryrun.cc_loop``) on each rank of a spawned gloo
world.  Imported by the spawned ranks, so it imports the port and numpy
only (no JAX)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch import datalog_dryrun as dd


def case_cc(mesh, e: np.ndarray, variant: str, iters: int):
    """This rank's block of E, ``iters`` steps of ``variant``: the rank's
    row slice and the labels of its rows."""
    n = e.shape[0]
    rows, cols = dd.blocks(n, mesh)
    labels = dd.cc_loop(torch.from_numpy(np.ascontiguousarray(e[rows, cols])),
                        variant, mesh, n, iters)
    return (rows.start, rows.stop), labels.numpy()


def run_cases(mesh, cases: dict) -> dict:
    """``{name: (e, variant, iters)}`` on this rank: ``{name: result}``."""
    return {name: case_cc(mesh, *args) for name, args in cases.items()}
