"""B4: diagonal linear recurrence ``h_t = a_t ⊙ h_{t-1} + b_t``
(``csrc/ssm_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py:29``
(``_scan_kernel`` via ``ssm_scan_pallas`` :51): the prefill scan of the
Mamba2 / mLSTM blocks (``models/ssm.py``), over ``(B, T, D)`` f32 with
``h₋₁ = 0``.

Bound on the card: bytes (a and b read once, h written once: 12 B an
element), so the kernel has to keep enough bytes in flight at every
B·D it is given, down to 1,536 channels.  One launch, one pass: a block
owns W consecutive channels of one batch row and walks T in time tiles
of :data:`TILE` rows with the carry in a register (the TPU kernel's
cross-grid-step VMEM carry, kept inside the block); within a tile
:data:`GROUPS` threads a channel each scan a sub-chunk serially, their
aggregates meet in warp shuffles, and the carry is injected as
``h = h_local + ∏a · carry``.  The tiles arrive by ``cp.async`` into a
ring of shared-memory stages ahead of the scan, and h leaves by
coalesced stores.  The C entry point picks W (32 where that gives
every SM two blocks, else 16) and the ring's depth with it;
the order of the arithmetic, :func:`repro_torch.kernels.ref.
ssm_scan_blocked` with ``tile=TILE, groups=GROUPS``, is the same at
every W.  Any B, T and D are taken; the TPU wrapper needs T divisible
by its time block.  (The first design, one thread a channel walking
all of T, ran at 40% of the bound at xLSTM's 12,288 channels.)

:func:`ssm_scan` dispatches on the tensors' device: CPU tensors take the
plain version (:func:`repro_torch.kernels.ref.ssm_scan_ref`), CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib, ref

#: the plain PyTorch version of this kernel
ssm_scan_plain = ref.ssm_scan_ref
#: the kernel's time tile (rows) and thread groups a channel, for the
#: CPU's :func:`ref.ssm_scan_blocked`; the built kernel reports its own
#: (:func:`blocking`), and the GPU tests hold the two equal
TILE, GROUPS = 128, 8


def blocking() -> tuple[int, int]:
    """The built kernel's (time tile, thread groups a channel): ``L`` and
    ``S`` of ``csrc/ssm_scan.cu``."""
    lib = cuda_lib.library()
    return lib.ssm_scan_tile(), lib.ssm_scan_groups()


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
