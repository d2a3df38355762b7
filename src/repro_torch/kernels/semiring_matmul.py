"""B2: dense semiring matmul ``C = A ⊕.⊗ B`` (``csrc/semiring_matmul.cu``).

Replaces the Pallas TPU kernels ``repro/kernels/semiring_matmul.py:35``
(``_dot_kernel``) and ``:52`` (``_trop_kernel``), launched by
``semiring_matmul_pallas`` :81 — the engine's dense rule-body joins and
the ``vector_dense`` runner's rounds.

Bound on the card: FP32 SIMT operations (2·m·n·k).  The kernel is a
shared-memory tiled SIMT product templated on (⊕, ⊗), without tensor
cores or TF32 (exact integer counts to 2²⁴); bool runs as the f32 dot of
0/1, thresholded ``> 0.5`` here on exit.

:func:`semiring_matmul` dispatches on the tensors' device: CPU tensors
take the plain version (:func:`repro_torch.kernels.ref.
semiring_matmul_ref`), CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.kernels import cuda_lib, ref

#: the plain PyTorch version of this kernel
semiring_matmul_plain = ref.semiring_matmul_ref

_MODE = {"bool": 0, "nat": 0, "real": 0, "trop": 1, "maxplus": 2}
#: grid.y limit (65535) × the 64-row tile
_MAX_ROWS = 65535 * 64


def semiring_matmul(sr_name: str, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """C[i,j] = ⊕_k A[i,k] ⊗ B[k,j] for 2-D ``a``, ``b``."""
    if a.device.type == "cpu":
        return semiring_matmul_plain(sr_mod.get(sr_name), a, b)
    # the kernel takes contiguous f32 (bool as 0/1)
    a32 = a.to(torch.float32).contiguous()
    b32 = b.to(torch.float32).contiguous()
    out = semiring_matmul_cuda(sr_name, a32, b32)
    return out > 0.5 if sr_name == "bool" else out


def semiring_matmul_cuda(sr_name: str, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on f32 operands; counts launches in
    ``.launches``.  Returns the raw f32 product (bool not thresholded)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"semiring_matmul: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = (int(s) for s in a.shape)
    n = int(b.shape[1])
    if m > _MAX_ROWS:
        raise ValueError(f"semiring_matmul: {m} rows exceed the grid limit")
    cuda_lib.require(a, "a", dtype=torch.float32)
    cuda_lib.require(b, "b", dtype=torch.float32)
    if a.device != b.device:
        raise ValueError("semiring_matmul: operands on different devices")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    err = cuda_lib.library().semiring_matmul(
        _MODE[sr_name], a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        cuda_lib.stream_of(a))
    cuda_lib.check(err, "semiring_matmul")
    semiring_matmul_cuda.launches += 1
    return out


semiring_matmul_cuda.launches = 0
