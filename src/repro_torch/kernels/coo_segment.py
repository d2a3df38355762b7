"""B3: semiring segment ⊕-reduce over COO ids (``csrc/coo_segment.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/coo_segment.py:38``
(``_kernel`` via ``segment_reduce_pallas`` :64): the scatter half of
sparse contraction, ``out[s] = ⊕ vals[i]`` over ``ids[i] = s``, with
out-of-range ids (COO sentinels) dropped.  The reference routes only
``(m,)`` payloads to its kernel; here ``(m, B)`` payloads — the batched
SpMM rows of ``contract.spmm`` — take the same kernel.

Bound on the card: bytes (ids, values, the written rows); the kernel is
a plain atomic scatter, one thread per (edge, lane) — see the source
note in the ``.cu`` file for how each ⊕ is done.

:func:`segment_reduce` dispatches on the tensor's device: CPU tensors
take the plain version (:func:`repro_torch.kernels.ref.
segment_reduce_ref`), CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.kernels import cuda_lib, ref

#: the plain PyTorch version of this kernel
segment_reduce_plain = ref.segment_reduce_ref

_MODE = {"bool": 0, "trop": 1, "maxplus": 2, "nat": 3, "real": 3}


def segment_reduce(sr_name: str, vals: torch.Tensor,
                   segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """⊕-reduce ``vals`` ``(m,)`` / ``(m, B)`` by ``segment_ids`` into
    ``num_segments`` rows."""
    if vals.device.type == "cpu":
        return segment_reduce_plain(sr_mod.get(sr_name), vals, segment_ids,
                                    num_segments)
    return segment_reduce_cuda(sr_name, vals, segment_ids, num_segments)


def segment_reduce_cuda(sr_name: str, vals: torch.Tensor,
                        segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Launch the CUDA kernel; counts launches in ``.launches``."""
    sr = sr_mod.get(sr_name)
    m = int(vals.shape[0])
    if vals.dim() not in (1, 2):
        raise ValueError(f"segment_reduce: payload must be (m,) or (m, B), "
                         f"got {tuple(vals.shape)}")
    cuda_lib.require(vals, "vals", dtype=sr.dtype)
    cuda_lib.require(segment_ids, "segment_ids", dtype=torch.int32,
                     shape=(m,))
    if segment_ids.device != vals.device:
        raise ValueError("segment_reduce: vals and ids on different devices")
    lanes = int(vals.shape[1]) if vals.dim() == 2 else 1
    out = torch.empty((num_segments,) + tuple(vals.shape[1:]),
                      dtype=sr.dtype, device=vals.device)
    lib = cuda_lib.library()
    err = lib.coo_segment_reduce(
        _MODE[sr_name], vals.data_ptr(), segment_ids.data_ptr(),
        out.data_ptr(), m, lanes, int(num_segments),
        cuda_lib.stream_of(vals))
    cuda_lib.check(err, "coo_segment_reduce")
    segment_reduce_cuda.launches += 1
    return out


segment_reduce_cuda.launches = 0
