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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import semiring_matmul as mm
from repro_torch.kernels import ssm_scan as scan


def semiring_matmul(sr, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A ⊕.⊗ B over semiring ``sr`` (2-D a, b) — kernel B2."""
    return mm.semiring_matmul(sr.name, a, b)


def semiring_segment_reduce(sr, vals: torch.Tensor,
                            segment_ids: torch.Tensor, num_segments: int,
                            *, plan=None) -> torch.Tensor:
    """``out[s] = ⊕ vals[i]`` over ``segment_ids[i] = s`` — kernel B3,
    for ``(m,)`` and ``(m, B)`` payloads alike; with the ids' segment
    ``plan`` (``coo_segment.plan_segment``), ``vals`` in plan order."""
    return coo_segment.segment_reduce(sr.name, vals, segment_ids,
                                      num_segments, plan=plan)


def coo_spmm(rel, x: torch.Tensor, *, transpose: bool = False
             ) -> torch.Tensor:
    """Fused batched COO semiring SpMM over a relation's cached
    geometry — kernel B1."""
    return fused.spmm(fused.plan_geometry(rel, transpose=transpose), x)


def ssm_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Diagonal linear recurrence ``h_t = a_t ⊙ h_{t-1} + b_t`` over
    axis 1 of ``(B, T, D)`` — kernel B4.  When autograd records (grad
    mode on and ``a`` or ``b`` requiring grad) it goes through
    ``ScanFn``, whose backward is B4 again; otherwise one call, as
    serving makes it."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return scan.ScanFn.apply(a, b)
    return scan.ssm_scan(a, b)


def flash_attention(q, k, v, *, causal=True, window=None, chunk=None,
                    q_offset=0) -> torch.Tensor:
    """GQA attention; see ``ref.attention_ref`` — kernel B5.  When
    autograd records (grad mode on and q, k or v requiring grad) it goes
    through ``AttnFn``, whose backward is B5's backward kernels;
    otherwise one call, as serving makes it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return fa.AttnFn.apply(q, k, v, causal, window, chunk, q_offset)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              chunk=chunk, q_offset=q_offset)


#: every CUDA kernel's launch counter, by kernel name (B5's backward, its
#: three kernels, counted once a call)
_LAUNCHERS = {"coo_segment": coo_segment.segment_reduce_cuda,
              "coo_spmm": fused.spmm_cuda,
              "semiring_matmul": mm.semiring_matmul_cuda,
              "ssm_scan": scan.ssm_scan_cuda,
              "flash_attention": fa.flash_attention_cuda,
              "flash_attention_backward": fa.attention_backward_cuda}


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel so far in this process."""
    return {name: fn.launches for name, fn in _LAUNCHERS.items()}


def reset_launch_counts() -> None:
    for fn in _LAUNCHERS.values():
        fn.launches = 0
    for fn in (coo_segment.segment_reduce_cuda, fused.spmm_cuda,
               mm.semiring_matmul_cuda, fa.flash_attention_cuda):
        fn.by_path.update(dict.fromkeys(fn.by_path, 0))
    fa.attention_backward_cuda.by_kernel.update(
        dict.fromkeys(fa.BWD_KERNELS, 0))
    fa.attention_backward_cuda.by_path.update(dict.fromkeys(fa.BWD_PATHS, 0))
