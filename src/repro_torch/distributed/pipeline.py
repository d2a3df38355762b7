"""GPipe-style pipeline parallelism over a ``"stage"`` mesh axis
(counterpart of ``repro/distributed/pipeline.py``).

The layer stack is split into S stages, one a rank of the ``"stage"``
axis, and M micro-batches stream through: the classic fill / steady /
drain schedule of S + M − 1 ticks, bubble fraction (S − 1)/(S + M − 1).
At tick t stage 0 takes micro-batch t; every stage hands its output to
the next by point-to-point ``isend``/``irecv``; the last stage emits
micro-batch t − (S − 1); at the end its outputs are broadcast to every
stage.

The reference runs every stage on every tick inside a ``shard_map`` and
zeroes the fill's garbage; the port, multi-controller, runs a stage only
on the ticks that carry a real micro-batch (t − s in [0, M)) and sends
only what the next stage will use, which changes no output.  A CUDA
activation over gloo goes through an explicit host copy
(:mod:`repro_torch.distributed.collectives`).
"""

from __future__ import annotations

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import P, block_slices

AXIS = "stage"


def _tree_block(tree, mesh):
    """This stage's block of a tree whose leaves have a leading stage
    axis (kept, of size 1, as the reference's ``P("stage")`` leaves)."""
    if isinstance(tree, dict):
        return {k: _tree_block(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_block(v, mesh) for v in tree)
    return tree[block_slices(tuple(tree.shape), P(AXIS), mesh)]


def pipelined_forward(stage_fn, n_stages: int, n_micro: int):
    """``body(stage_params, xs, mesh) → y``, run on every rank of the
    ``"stage"`` axis: ``stage_params`` this stage's block (leading stage
    axis of size 1), ``xs`` (n_micro, micro_batch, …) the micro-batched
    input, the same on every rank; ``y`` the last stage's outputs, on
    every rank."""

    def body(params, xs, mesh):
        idx = mesh.coords[AXIS]
        ticks = n_stages + n_micro - 1
        micro_shape = xs.shape[1:]
        buf = torch.zeros(micro_shape, dtype=xs.dtype, device=xs.device)
        outs = torch.zeros((n_micro,) + tuple(micro_shape), dtype=xs.dtype,
                           device=xs.device)
        for t in range(ticks):
            m = t - idx                     # the micro-batch this tick
            live = 0 <= m < n_micro
            y = None
            if live:
                y = stage_fn(params, xs[m] if idx == 0 else buf)
                if idx == n_stages - 1:
                    outs[m] = y
            # stage idx + 1 takes micro-batch m at tick t + 1
            send = live and idx < n_stages - 1
            recv = idx > 0 and 0 <= t + 1 - idx < n_micro
            if send or recv:
                buf = collectives.send_recv(
                    y, buf, mesh, AXIS, to=idx + 1 if send else None,
                    frm=idx - 1 if recv else None)
        # only the last stage holds real outputs; broadcast them
        return collectives.broadcast(outs, mesh, AXIS, n_stages - 1)

    return body


def run_pipeline(mesh, stage_fn, stage_params, x_micro, *,
                 n_stages: int, n_micro: int):
    """Execute the pipeline on ``mesh`` (it must have a ``"stage"`` axis
    of ``n_stages`` ranks).  ``stage_params``: a tree (dict, tuple or
    list) of tensors with a leading stage axis, the same on every rank;
    each stage runs ``stage_fn`` on its own block of it.  Forward only:
    no gradient flows back through the hand-offs."""
    if mesh.shape.get(AXIS) != n_stages:
        raise ValueError(f"run_pipeline: {n_stages} stages need a "
                         f"{AXIS!r} axis of {n_stages} ranks, the mesh is "
                         f"{mesh.shape}")
    body = pipelined_forward(stage_fn, n_stages, n_micro)
    with torch.no_grad():
        return body(_tree_block(stage_params, mesh), x_micro, mesh)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_stages + n_micro - 1)
