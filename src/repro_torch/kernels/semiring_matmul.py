"""B2: dense semiring matmul ``C = A ⊕.⊗ B`` (``csrc/semiring_matmul.cu``).

Replaces the Pallas TPU kernels ``repro/kernels/semiring_matmul.py:35``
(``_dot_kernel``) and ``:52`` (``_trop_kernel``), launched by
``semiring_matmul_pallas`` :81 — the engine's dense rule-body joins and
the ``vector_dense`` runner's rounds.

Three kernels under one dispatch, :func:`plan_matmul`:

* ``stream`` — ``m ≤ M_STREAM`` rows, any semiring (Π₂'s one-row
  rounds).  Bound: bytes (B read once).  Column strips × K splits,
  partials folded in a fixed order by a second kernel.
* ``tc_bool`` — 𝔹 above that, on tensor cores (``mma.sync`` u8·u8→s32,
  exact).  Bound: operations at the int8 tensor-core rate.  Reads the
  ``torch.bool`` bytes in place and writes bool bytes; B is read
  K-major (a ``.t()`` view as it is, else transposed into scratch by
  the kernel's own byte transpose).
* ``tile_f32`` — nat, real, trop, maxplus above that: a 128×128 SIMT
  tile in f32 FMA without TF32 (nat counts exact to 2²⁴).  Bound:
  operations at the FP32 SIMT rate.

Operands may be any 2-D strided views (the engine hands ``.t()``
views): the wrapper makes them contiguous, which copies only what is
not.  :func:`semiring_matmul` dispatches on the tensors' device: CPU
tensors take the plain version (:func:`repro_torch.kernels.ref.
semiring_matmul_ref`), CUDA tensors launch a kernel or raise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.kernels import cuda_lib, ref

#: the plain PyTorch version of this kernel
semiring_matmul_plain = ref.semiring_matmul_ref

#: kernel mode per semiring (csrc: 0 dot, 1 min-plus, 2 max-plus, 3 𝔹)
_MODE = {"nat": 0, "real": 0, "trop": 1, "maxplus": 2, "bool": 3}
#: rows up to which a product streams B once.  The tile paths run
#: 128-row tiles, so at m ≤ 16 they would spend ≥ 7/8 of their work on
#: padding; the stream path stays at one read of B while its per-byte
#: work (2·m operations per 4-byte f32 element) is under the card's
#: FP32-SIMT-to-HBM ratio (67e12 / 3.35e12 = 20 per byte, so m ≤ 40),
#: and its accumulators (m × 4 registers a thread) stay at 64 for
#: m = 16.  The kernel instantiates m ∈ {1, 2, 4, 8, 16}.
M_STREAM = 16
#: streaming multiprocessors of an H100 SXM; the stream grid is sized to
#: at least two waves of them
SMS = 132
#: threads per block of every B2 kernel (csrc: THREADS).  The plan below
#: owns the launch geometry; the C entries refuse one that does not match
#: their compiled tile or does not cover the output.
THREADS = 256
#: block tile (rows and columns) of the tile paths
TILE = 128
#: grid.y limit (65535) × the 128-row tile
_MAX_ROWS = 65535 * TILE


class Geometry(NamedTuple):
    """Launch geometry of one product."""

    grid: tuple[int, int]          # (x, y) of the main kernel
    tile: tuple[int, int] | None   # block tile (rows, cols); None: stream
    splits: int                    # K splits (stream), else 1
    k_per_split: int               # K rows per split (stream), else k
    width: int                     # padded partial row width (stream)


def plan_matmul(sr_name: str, m: int, k: int, n: int
                ) -> tuple[str, Geometry]:
    """The path (``stream``, ``tc_bool`` or ``tile_f32``) and launch
    geometry of an ``(m, k) @ (k, n)`` product in ``sr_name``."""
    if sr_name not in _MODE:
        raise ValueError(f"semiring_matmul: unknown semiring {sr_name!r}")
    if min(m, k, n) < 0:
        raise ValueError(f"semiring_matmul: negative shape {(m, k, n)}")
    if m <= M_STREAM:
        vec = 16 if sr_name == "bool" else 4   # one 16-byte load a thread
        strip = THREADS * vec
        strips = max(1, math.ceil(n / strip))
        want = math.ceil(2 * SMS / strips)
        kps = max(1, k // want, math.ceil(k / 65535))
        splits = max(1, math.ceil(k / kps))
        return "stream", Geometry((strips, splits), None, splits, kps,
                                  strips * strip)
    if m > _MAX_ROWS:
        raise ValueError(f"semiring_matmul: {m} rows exceed the grid limit "
                         f"({_MAX_ROWS})")
    path = "tc_bool" if sr_name == "bool" else "tile_f32"
    grid = (max(1, math.ceil(n / TILE)), math.ceil(m / TILE))
    return path, Geometry(grid, (TILE, TILE), 1, k, 0)


def semiring_matmul(sr_name: str, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """C[i,j] = ⊕_k A[i,k] ⊗ B[k,j] for 2-D ``a``, ``b``."""
    if a.device.type == "cpu":
        return semiring_matmul_plain(sr_mod.get(sr_name), a, b)
    return semiring_matmul_cuda(sr_name, a, b)


def semiring_matmul_cuda(sr_name: str, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Launch the path :func:`plan_matmul` picks on CUDA operands of the
    semiring's type (``torch.bool`` for 𝔹, float32 otherwise).  Counts
    one launch per product in ``.launches`` and by path in
    ``.by_path``."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"semiring_matmul: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = (int(s) for s in a.shape)
    n = int(b.shape[1])
    path, geo = plan_matmul(sr_name, m, k, n)
    dtype = torch.bool if sr_name == "bool" else torch.float32
    a = a.contiguous()
    # tc_bool reads B K-major: a .t() view already is (Bᵀ contiguous)
    k_major = path == "tc_bool" and b.t().is_contiguous()
    b = b.t() if k_major else b.contiguous()
    cuda_lib.require(a, "a", dtype=dtype)
    cuda_lib.require(b, "b", dtype=dtype)
    if a.device != b.device:
        raise ValueError("semiring_matmul: operands on different devices")
    out = torch.empty((m, n), dtype=dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    lib, stream = cuda_lib.library(), cuda_lib.stream_of(a)
    if path == "tc_bool":
        # Bᵀ: b itself, or scratch the kernel's transpose fills first
        bt = b if k_major else torch.empty((n, k), dtype=dtype,
                                           device=a.device)
        err = lib.semiring_matmul_tc_bool(
            a.data_ptr(), b.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n,
            k, int(not k_major), *geo.tile, *geo.grid, stream)
    elif path == "tile_f32":
        err = lib.semiring_matmul_tile_f32(
            _MODE[sr_name], a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n,
            k, *geo.tile, *geo.grid, stream)
    else:
        part = torch.empty((geo.splits, m, geo.width), dtype=dtype,
                           device=a.device)
        err = lib.semiring_matmul_stream(
            _MODE[sr_name], a.data_ptr(), b.data_ptr(), part.data_ptr(),
            out.data_ptr(), m, n, k, geo.k_per_split, geo.splits, geo.width,
            stream)
    cuda_lib.check(err, f"semiring_matmul ({path})")
    semiring_matmul_cuda.launches += 1
    semiring_matmul_cuda.by_path[path] += 1
    return out


semiring_matmul_cuda.launches = 0
semiring_matmul_cuda.by_path = dict.fromkeys(
    ("stream", "tc_bool", "tile_f32"), 0)
