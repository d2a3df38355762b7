"""The kernel entry points the port's modules call, dispatched by device.

The counterpart of ``repro/kernels/ops.py``.  The reference picks
Pallas-or-oracle by platform; here each kernel's wrapper picks by the
device of the tensors it is handed: a CPU tensor takes the kernel's
plain PyTorch version (the parity tests' path), a CUDA tensor launches
the hand-written kernel or raises.  There is no fallback between them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import coo_segment, coo_spmm as fused
from repro_torch.kernels import semiring_matmul as mm


def semiring_matmul(sr, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A ⊕.⊗ B over semiring ``sr`` (2-D a, b) — kernel B2."""
    return mm.semiring_matmul(sr.name, a, b)


def semiring_segment_reduce(sr, vals: torch.Tensor,
                            segment_ids: torch.Tensor,
                            num_segments: int) -> torch.Tensor:
    """``out[s] = ⊕ vals[i]`` over ``segment_ids[i] = s`` — kernel B3,
    for ``(m,)`` and ``(m, B)`` payloads alike."""
    return coo_segment.segment_reduce(sr.name, vals, segment_ids,
                                      num_segments)


def coo_spmm(rel, x: torch.Tensor, *, transpose: bool = False
             ) -> torch.Tensor:
    """Fused batched COO semiring SpMM over a relation's cached
    geometry — kernel B1."""
    return fused.spmm(fused.plan_geometry(rel, transpose=transpose), x)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel so far in this process."""
    return {"coo_segment": coo_segment.segment_reduce_cuda.launches,
            "coo_spmm": fused.spmm_cuda.launches,
            "semiring_matmul": mm.semiring_matmul_cuda.launches}


def reset_launch_counts() -> None:
    coo_segment.segment_reduce_cuda.launches = 0
    fused.spmm_cuda.launches = 0
    mm.semiring_matmul_cuda.launches = 0
