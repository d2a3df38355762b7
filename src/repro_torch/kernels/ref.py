"""Plain PyTorch versions of the three main-path kernels (B1–B3).

Each function defines the semantics its hand-written CUDA kernel must
match.  The kernel wrappers take these only for tensors on the CPU (the
parity tests' path); ``chip_smoke.py`` calls them directly on the card
to hold each kernel against them.  They are not a fallback: a CUDA
tensor passed to a wrapper launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core import semiring as sr_mod

#: max elements one broadcast (min,+)/(max,+) piece may materialize
_CHUNK_ELEMS = 1 << 24


def semiring_matmul_ref(sr, a: torch.Tensor, b: torch.Tensor
                        ) -> torch.Tensor:
    """B2: ``C[i,j] = ⊕_k A[i,k] ⊗ B[k,j]`` for an arbitrary semiring.

    (∨,∧) and (+,×) are f32 matrix products — with TF32 switched off
    (set here, ``torch.backends.cuda.matmul.allow_tf32 = False``): TF32
    keeps 10 mantissa bits, and counting fixpoints pass 2¹¹.
    (min,+)/(max,+) are a row-chunked broadcast-reduce, so the
    materialized (rows, K, N) intermediate stays bounded.
    """
    name = sr.name
    if name in ("bool", "nat", "real"):
        torch.backends.cuda.matmul.allow_tf32 = False
        out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
        return out > 0.5 if name == "bool" else out
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {a.shape} @ {b.shape}")
    reduce_fn = torch.amin if name == "trop" else torch.amax
    chunk = int(max(1, min(m, _CHUNK_ELEMS // max(1, k * n))))
    pieces = [reduce_fn(a[s:s + chunk, :, None] + b[None, :, :], dim=1)
              for s in range(0, m, chunk)]
    if not pieces:
        return a.new_full((0, n), sr.zero)
    return torch.cat(pieces, dim=0)


def segment_reduce_ref(sr, vals: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """B3: ``out[s] = ⊕_{i: ids[i]=s} vals[i]``; out-of-range ids (the
    COO padding sentinel) are dropped.  ``vals`` is ``(m,)`` or carries
    a trailing payload axis ``(m, B)``; each segment row then
    ⊕-combines whole payload rows."""
    base = sr.zeros((num_segments,) + tuple(vals.shape[1:]), vals.device)
    return sr_mod.scatter_op(sr.name, base, segment_ids, vals)


def coo_spmm_ref(sr, src: torch.Tensor, w: torch.Tensor,
                 dst: torch.Tensor, x: torch.Tensor,
                 n_out: int) -> torch.Tensor:
    """B1: ``out[d, b] = ⊕_{e: dst_e = d} w_e ⊗ x[src_e, b]`` over
    (dst-sorted) edge lists; ``x`` is ``(n_in, B)`` or ``(n_in,)``.
    Rows no edge reaches hold 0̄."""
    wx = w.reshape((-1,) + (1,) * (x.dim() - 1))
    prod = sr.mul(wx, x.index_select(0, src.long()))
    return segment_reduce_ref(sr, prod, dst, n_out)
