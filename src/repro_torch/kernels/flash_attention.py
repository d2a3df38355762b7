"""B5: GQA flash attention, forward (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:32``
(``_flash_kernel`` via ``flash_attention_pallas`` :82): online-softmax
attention with causal, sliding-window and chunked masks and a
``q_offset`` for decode; semantics as
:func:`repro_torch.kernels.ref.attention_ref`.  The reference's model
code never calls its kernel (its ``attn_apply`` uses XLA einsums); the
port's :func:`repro_torch.models.attention.attn_apply` routes every
self-attention through this one.

Bound on the card: operations at prefill, bytes at decode (see the
source note in the ``.cu`` file).  k and v may be strided views — the
written prefix of a KV cache — as long as the head dimension is
contiguous; q must be contiguous.

:func:`flash_attention` dispatches on the tensors' device: CPU tensors
take the plain version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib, ref

#: the plain PyTorch version of this kernel
flash_attention_plain = ref.attention_ref

#: the kernel keeps up to 128 head channels in registers per row
MAX_HEAD_DIM = 128


def flash_attention(q, k, v, *, causal=True, window=None, chunk=None,
                    q_offset=0) -> torch.Tensor:
    """q: (B, Tq, Hq, D); k/v: (B, Tk, Hkv, D) → (B, Tq, Hq, D)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     chunk=chunk, q_offset=q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                chunk=chunk, q_offset=q_offset)


def flash_attention_cuda(q, k, v, *, causal=True, window=None, chunk=None,
                         q_offset=0) -> torch.Tensor:
    """Launch the CUDA kernel; counts launches in ``.launches``."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: expected 4-D q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    cuda_lib.require(q, "q", dtype=torch.float32)
    bsz, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):   # strided cache views
        cuda_lib.require(t, name, dtype=torch.float32,
                         shape=(bsz, tk, hkv, d), strided=True)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"1..{MAX_HEAD_DIM}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} q heads not a multiple of "
                         f"{hkv} kv heads")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be > 0")
    if chunk is not None and chunk <= 0:
        raise ValueError(f"flash_attention: chunk {chunk} must be > 0")
    o = torch.empty_like(q)
    err = cuda_lib.library().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        bsz, tq, tk, hq, hkv, d, *k.stride()[:3], *v.stride()[:3],
        int(causal), window or 0, chunk or 0, int(q_offset),
        1.0 / math.sqrt(d), cuda_lib.stream_of(q))
    cuda_lib.check(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
