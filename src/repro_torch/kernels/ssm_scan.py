"""B4: diagonal linear recurrence ``h_t = a_t ⊙ h_{t-1} + b_t``
(``csrc/ssm_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py:29``
(``_scan_kernel`` via ``ssm_scan_pallas`` :51): the prefill scan of the
Mamba2 / mLSTM blocks (``models/ssm.py``), over ``(B, T, D)`` f32 with
``h₋₁ = 0``.

Bound on the card: bytes (a and b read once, h written once).  The
kernel gives each (b, d) channel to one thread, which walks T with the
carry in a register — the card's blocks run in no order, so the TPU's
cross-grid-step carry in VMEM has no counterpart.  Any T is taken; the
TPU wrapper needs T divisible by its time block.

:func:`ssm_scan` dispatches on the tensors' device: CPU tensors take the
plain version (:func:`repro_torch.kernels.ref.ssm_scan_ref`), CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib, ref

#: the plain PyTorch version of this kernel
ssm_scan_plain = ref.ssm_scan_ref


def ssm_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, D) → h: (B, T, D)."""
    if a.device.type == "cpu":
        return ssm_scan_plain(a, b)
    return ssm_scan_cuda(a, b)


def ssm_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; counts launches in ``.launches``."""
    if a.dim() != 3:
        raise ValueError(f"ssm_scan: expected (B, T, D), got "
                         f"{tuple(a.shape)}")
    cuda_lib.require(a, "a", dtype=torch.float32)
    cuda_lib.require(b, "b", dtype=torch.float32, shape=a.shape)
    if b.device != a.device:
        raise ValueError("ssm_scan: a and b on different devices")
    bsz, t, d = a.shape
    h = torch.empty_like(a)
    err = cuda_lib.library().ssm_scan(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, t, d,
        cuda_lib.stream_of(a))
    cuda_lib.check(err, "ssm_scan")
    ssm_scan_cuda.launches += 1
    return h


ssm_scan_cuda.launches = 0
