"""B4: diagonal linear recurrence ``h_t = a_t ⊙ h_{t-1} + b_t``
(``csrc/ssm_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py:29``
(``_scan_kernel`` via ``ssm_scan_pallas`` :51): the prefill scan of the
Mamba2 / mLSTM blocks (``models/ssm.py``), over ``(B, T, D)`` f32 with
``h₋₁ = 0``.  bf16 and f16 inputs are cast to f32 at the entry and the
output back to their type (:func:`cuda_lib.f32_entry`), as the TPU
kernel keeps its carry in f32 and stores in ``a.dtype``.

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

Gradient: :class:`ScanFn`.  The adjoint of a linear recurrence is a
linear recurrence run backwards in time, ``λ_t = g_t + a_{t+1} ⊙
λ_{t+1}``, so the backward is one more :func:`ssm_scan` over the
time-flipped, one-step-shifted decays (:func:`scan_backward`): B4 on
the card in both directions, the plain version on the CPU.  The TPU
kernel has no backward (JAX has no transpose rule for ``pallas_call``;
the reference trains through its plain scan), so none is replaced.
Bound: bytes (a, g and h read, da and db written: 20 B an element),
plus the three flip copies this layout costs (a ``reverse`` mode in the
kernel would save them).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import costing, cuda_lib, ref

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


def scan_cost(a: torch.Tensor, b: torch.Tensor) -> tuple[str, float, float]:
    """``(path, operations, bytes)`` of one scan as its bound reckons
    them: a multiply and an add an element; a and b read once, h written
    once."""
    n = a.numel()
    return "scan", 2.0 * n, float(3 * n * a.element_size())


def backward_cost(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor
                  ) -> tuple[str, float, float]:
    """``(path, operations, bytes)`` of :func:`scan_backward`: the
    reverse scan's two operations and da's product an element; a, h and
    g read once, da and db written once (20 B an f32 element)."""
    n = a.numel()
    return "backward", 3.0 * n, float(5 * n * a.element_size())


@costing.counted("ssm_scan", scan_cost)
def ssm_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, D) → h: (B, T, D), in a's dtype (half types computed
    in f32 on either device).  On meta tensors (a dry run's count) an
    empty h."""
    if a.device.type == "meta":
        return torch.empty_like(a)
    if a.device.type == "cpu":
        (a, b), back = cuda_lib.f32_entry("ssm_scan", a, b)
        return back(ssm_scan_plain(a, b))
    return ssm_scan_cuda(a, b)


def ssm_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on f32, or on bf16/f16 cast to f32 (the
    output cast back); counts launches in ``.launches``."""
    if a.dim() != 3:
        raise ValueError(f"ssm_scan: expected (B, T, D), got "
                         f"{tuple(a.shape)}")
    (a, b), back = cuda_lib.f32_entry("ssm_scan", a, b)
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
    return back(h)


ssm_scan_cuda.launches = 0


@costing.counted("ssm_scan", backward_cost)
def scan_backward(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """``(da, db)`` of ``h = ssm_scan(a, b)`` given ``g = ∂L/∂h``.

    ``λ = flip_T(ssm_scan(a′, flip_T(g)))`` with ``a′ = [0,
    flip_T(a[:, 1:])]`` (``λ_{T-1} = g_{T-1}``); ``db = λ`` and
    ``da = λ ⊙ [0, h[:, :-1]]`` (``h₋₁ = 0``).  On meta tensors two empty
    gradients."""
    if a.device.type == "meta":
        return torch.empty_like(a), torch.empty_like(a)
    zero = a.new_zeros((a.shape[0], 1, a.shape[2]))
    a_rev = torch.cat([zero, a[:, 1:].flip(1)], 1)
    lam = ssm_scan(a_rev, g.flip(1).contiguous()).flip(1)
    return lam * torch.cat([zero, h[:, :-1]], 1), lam


class ScanFn(torch.autograd.Function):
    """:func:`ssm_scan` with a gradient: forward and backward are both
    :func:`ssm_scan` (B4 on CUDA tensors, the plain version on CPU
    ones); see :func:`scan_backward`.  Saves ``a`` and ``h``."""

    @staticmethod
    def forward(ctx, a, b):
        h = ssm_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return scan_backward(a, h, g)
