"""B5: GQA flash attention, forward (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:32``
(``_flash_kernel`` via ``flash_attention_pallas`` :82): online-softmax
attention with causal, sliding-window and chunked masks and a
``q_offset`` for decode; semantics as
:func:`repro_torch.kernels.ref.attention_ref`.  The reference's model
code never calls its kernel (its ``attn_apply`` uses XLA einsums); the
port's :func:`repro_torch.models.attention.attn_apply` routes every
self-attention through this one.

Two kernels under one dispatch, :func:`plan_attention`:

* ``prefill_tc`` — more than ``DECODE_ROWS`` query rows per kv head:
  QKᵀ and PV on tensor cores in three TF32 passes (hi·hi + hi·lo +
  lo·hi), 64-row q tiles of 4 warps.  Bound: operations at the TF32
  tensor-core rate, three passes.
* ``decode_split`` — ``tq · group ≤ DECODE_ROWS`` (every decode step):
  one block per (KV split, kv head, batch) holding all query rows of
  the kv head, partials folded by a second kernel in a fixed split
  order.  Bound: bytes (K and V read once).

k and v may be strided views — the written prefix of a KV cache — as
long as the head dimension is contiguous; q must be contiguous.
:func:`flash_attention` dispatches on the tensors' device: CPU tensors
take the plain version, CUDA tensors launch a kernel or raise.

Forward only: the kernels write through ``ctypes`` into a fresh tensor
with no autograd node, and B5's backward is not written yet (ROADMAP A,
the slice after A7a).  So on a CUDA tensor that autograd would record
(grad mode on, q, k or v requiring grad) :func:`flash_attention`
raises rather than return an output the gradient would silently skip.
CPU tensors keep the plain version, which autograd differentiates.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_lib, ref

#: the plain PyTorch version of this kernel
flash_attention_plain = ref.attention_ref

#: the kernels keep up to 128 head channels per row
MAX_HEAD_DIM = 128
#: query rows of a prefill_tc block: 4 warps of 16 (csrc: PF_BQ).  The C
#: entry refuses any other tile.
PREFILL_Q_TILE = 64
#: most query rows (tq · group) one decode_split block holds (csrc:
#: DC_ROWS); above it a block would spend its registers on rows that a
#: q tile of the tensor-core path serves better
DECODE_ROWS = 16
#: streaming multiprocessors of an H100 SXM
SMS = 132
#: decode_split grid target: about four blocks per SM (three resident,
#: so the last of two waves is nearly full at the serving shape)
DECODE_BLOCKS = 4 * SMS
#: keys per split come in multiples of one warp's share of a tile
#: (csrc: DC_BK / 4 warps)
SPLIT_KEYS = 8
#: grid.y / grid.z limit
_GRID_YZ = 65535

PATHS = ("prefill_tc", "decode_split")


class Geometry(NamedTuple):
    """Launch geometry of one attention call."""

    q_tile: int                  # query rows a block (decode: tq · group)
    grid: tuple[int, int, int]   # (x, y, z) of the main kernel
    splits: int                  # KV splits (decode), else 1
    keys_per_split: int          # keys a split (decode), else all visible
    scratch: int                 # floats of split partials (decode), else 0


def visible_keys(tq: int, tk: int, *, causal: bool = True,
                 window: int | None = None, chunk: int | None = None,
                 q_offset: int = 0) -> tuple[int, int]:
    """The keys ``[lo, hi)`` that some query at positions ``q_offset …
    q_offset + tq - 1`` can see (``lo == hi``: none)."""
    pos_lo, pos_hi = q_offset, q_offset + tq - 1
    lo, hi = 0, tk
    if causal:
        hi = min(hi, pos_hi + 1)
    if window:
        lo = max(lo, pos_lo - window + 1)
    if chunk:
        lo = max(lo, pos_lo // chunk * chunk)
        hi = min(hi, (pos_hi // chunk + 1) * chunk)
    return lo, max(lo, hi)


def plan_attention(b: int, tq: int, tk: int, hq: int, hkv: int, d: int, *,
                   causal: bool = True, window: int | None = None,
                   chunk: int | None = None, q_offset: int = 0
                   ) -> tuple[str, Geometry]:
    """The path (``prefill_tc`` or ``decode_split``) and launch geometry
    of attention of ``(b, tq, hq, d)`` queries over ``(b, tk, hkv, d)``
    keys."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"1..{MAX_HEAD_DIM}")
    if hkv <= 0 or hq <= 0 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} q heads not a multiple of "
                         f"{hkv} kv heads")
    if min(b, tq, tk) < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: negative size or offset "
                         f"{(b, tq, tk, q_offset)}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be > 0")
    if chunk is not None and chunk <= 0:
        raise ValueError(f"flash_attention: chunk {chunk} must be > 0")
    if max(b, hq) > _GRID_YZ:
        raise ValueError(f"flash_attention: batch {b} or heads {hq} exceed "
                         f"the grid limit ({_GRID_YZ})")
    lo, hi = visible_keys(tq, tk, causal=causal, window=window, chunk=chunk,
                          q_offset=q_offset)
    rows = tq * (hq // hkv)
    if rows <= DECODE_ROWS:
        want = math.ceil(DECODE_BLOCKS / max(1, b * hkv))
        kps = SPLIT_KEYS * max(1, math.ceil((hi - lo) / want / SPLIT_KEYS))
        splits = max(1, math.ceil((hi - lo) / kps))
        return "decode_split", Geometry(rows, (splits, hkv, b), splits, kps,
                                        splits * b * hkv * rows * (2 + d))
    grid = (math.ceil(tq / PREFILL_Q_TILE), hq, b)
    return "prefill_tc", Geometry(PREFILL_Q_TILE, grid, 1, hi - lo, 0)


def flash_attention(q, k, v, *, causal=True, window=None, chunk=None,
                    q_offset=0) -> torch.Tensor:
    """q: (B, Tq, Hq, D); k/v: (B, Tk, Hkv, D) → (B, Tq, Hq, D)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     chunk=chunk, q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention: B5 has no backward kernel yet (ROADMAP A, "
            "B5's backward); on the card attention runs under "
            "torch.no_grad() or with frozen inputs, or train on the CPU")
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                chunk=chunk, q_offset=q_offset)


def flash_attention_cuda(q, k, v, *, causal=True, window=None, chunk=None,
                         q_offset=0) -> torch.Tensor:
    """Launch the path :func:`plan_attention` picks.  Counts one launch
    per call in ``.launches`` and by path in ``.by_path``."""
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
    path, geo = plan_attention(bsz, tq, tk, hq, hkv, d, causal=causal,
                               window=window, chunk=chunk,
                               q_offset=q_offset)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib, stream = cuda_lib.library(), cuda_lib.stream_of(q)
    args = (bsz, tq, tk, hq, hkv, d, *k.stride()[:3], *v.stride()[:3],
            int(causal), window or 0, chunk or 0, int(q_offset),
            1.0 / math.sqrt(d))
    if path == "prefill_tc":
        err = lib.flash_attention_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *args,
            geo.q_tile, *geo.grid, stream)
    else:
        part = torch.empty(geo.scratch, dtype=torch.float32, device=q.device)
        err = lib.flash_attention_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            part.data_ptr(), *args, geo.q_tile, geo.splits,
            geo.keys_per_split, *geo.grid, geo.scratch, stream)
    cuda_lib.check(err, f"flash_attention ({path})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.by_path[path] += 1
    return o


flash_attention_cuda.launches = 0
flash_attention_cuda.by_path = dict.fromkeys(PATHS, 0)
