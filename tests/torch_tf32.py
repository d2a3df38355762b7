"""TF32 tensor-core products emulated on the CPU, for the tests that
justify B5's 3xTF32 arithmetic (``src/repro_torch/csrc/tf32_mma.cuh``):
the forward's ``prefill_tc`` (``tests/test_torch_kernels.py``) and the
backward's ``dkdv`` and ``dq`` (``tests/test_torch_attention_grad.py``).
"""

import numpy as np


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: round f32 to nearest (ties away from 0) on
    its low 13 mantissa bits."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x):
    """TF32 toward zero: the low 13 mantissa bits cleared, as the kernels
    make their hi part and as the tensor core reads an f32 register."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


#: how a 3-pass product splits an operand: the kernels' (hi toward zero,
#: lo = x − hi read to TF32 by the tensor core) and round-to-nearest
#: (``cvt.rna`` for both parts)
SPLITS = {"kernel": (tf32_trunc, tf32_trunc), "rna": (tf32_rna, tf32_rna)}


def tf32_product(a, b, passes, split="kernel"):
    """a @ b as the tensor cores compute it from TF32 operands: one pass
    hi·hi, or three, hi·hi + hi·lo + lo·hi.  The products of TF32 values
    are exact; they are summed in float64 here, so the only error left
    is the split's."""
    to_hi, to_lo = SPLITS[split]
    ah, bh = to_hi(a), to_hi(b)
    f64 = np.float64
    out = ah.astype(f64) @ bh.astype(f64)
    if passes == 3:
        al, bl = to_lo(a - ah), to_lo(b - bh)
        out += ah.astype(f64) @ bl.astype(f64) + al.astype(f64) @ bh.astype(f64)
    return out
