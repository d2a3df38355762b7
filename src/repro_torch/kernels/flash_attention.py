"""B5: GQA flash attention, forward (``csrc/flash_attention.cu``) and
backward (``csrc/flash_attention_bwd.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:32``
(``_flash_kernel`` via ``flash_attention_pallas`` :82): online-softmax
attention with causal, sliding-window and chunked masks and a
``q_offset`` for decode; semantics as
:func:`repro_torch.kernels.ref.attention_ref`.  The reference's model
code never calls its kernel (its ``attn_apply`` uses XLA einsums); the
port's :func:`repro_torch.models.attention.attn_apply` routes every
self-attention through this one.

Three kernels under one dispatch, :func:`plan_attention`:

* ``prefill_tc`` — more than ``DECODE_ROWS`` query rows per kv head:
  QKᵀ and PV on tensor cores in three TF32 passes (hi·hi + hi·lo +
  lo·hi), 64-row q tiles of 4 warps.  Bound: operations at the TF32
  tensor-core rate, three passes.
* ``decode_split`` — ``tq · group ≤ DECODE_ROWS`` (every decode step):
  one block per (KV split, kv head, batch) holding all query rows of
  the kv head, partials folded by a second kernel in a fixed split
  order.  Bound: bytes (K and V read once).
* ``wide_simt`` — ``TC_HEAD_DIM`` < D ≤ ``WIDE_HEAD_DIM`` (128 < D ≤
  256, Gemma 2's 256-channel heads), prefill and decode alike: f32 FMA,
  one warp a query row (16 rows of one kv head's group a block), a lane
  a key of each 32-key K/V tile.  The first two hold a row's columns in
  registers sized for D ≤ 128; this one is the plain design that is
  right, not yet a fast one.  Bound: operations at the FP32 SIMT rate.
* ``wide_chunk`` — D > ``WIDE_HEAD_DIM``, any D (the reference's
  kernel takes any): ``wide_simt``'s rows and lanes with nothing staged
  in shared memory, D walked for the scores, each block writing one
  ``CHUNK_COLS``-column chunk of its rows (a grid over the chunks, each
  recomputing the scores).  Right first, slow; same bound.

k and v may be strided views — the written prefix of a KV cache — as
long as the head dimension is contiguous; q must be contiguous.
:func:`flash_attention` dispatches on the tensors' device: CPU tensors
take the plain version, CUDA tensors launch a kernel or raise.
The kernels compute in f32.  bf16 and f16 inputs are cast to f32 at the
entry, forward and backward, on either device, and the outputs (not
the log-sum-exp, always f32) cast back to the input's type
(:func:`cuda_lib.f32_entry`), as the TPU kernel casts q, k and v to f32
and stores in ``q.dtype``.

Gradient: :class:`AttnFn`.  The kernels write through ``ctypes`` into
fresh tensors with no autograd node, so B5's gradient is an autograd
function: its forward is B5 writing each row's log-sum-exp beside the
output (:func:`flash_attention_lse`), its backward three more kernels
(:func:`attention_backward`): ``rowdot`` (D = rowsum(dO ∘ O)), ``dkdv``
(one block a key tile and kv head, walking the query tiles of every q
head of the kv head, so GQA's sum stays inside the block) and ``dq``
(one block a query tile and q head, walking its visible key tiles),
every product a 3xTF32 ``mma.sync`` on tensor cores as ``prefill_tc``'s,
no atomics, so a backward repeats bit for bit; at D > 128 ``dkdv`` and
``dq`` are the ``wide_simt`` route's f32 SIMT kernels, still no atomics
(:func:`backward_path`).  Bound: operations, the
five T²·D products over the visible pairs at three TF32 tensor-core
passes (the kernels do seven: ``dq`` recomputes S and dP).
On CPU tensors the forward is the plain version plus
:func:`ref.attention_lse_ref` and the backward
:func:`ref.attention_backward_ref`.  The TPU kernel has no backward (JAX
cannot transpose a ``pallas_call``; the reference trains through XLA's
einsums), so none is replaced.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

import numpy as np

from repro_torch.kernels import costing, cuda_lib, ref

#: the plain PyTorch versions of the forward, its log-sum-exp and the
#: backward
flash_attention_plain = ref.attention_ref
attention_lse_plain = ref.attention_lse_ref
attention_backward_plain = ref.attention_backward_ref

#: prefill_tc, decode_split and the tensor-core backward keep up to 128
#: head channels per row
TC_HEAD_DIM = 128
#: wide_simt takes the rest up to 256 (csrc: wide_simt::DMAX), wide_chunk
#: any D past it
WIDE_HEAD_DIM = 256
#: output columns a wide_chunk block writes (csrc: CW)
CHUNK_COLS = 256
#: query rows of a wide_simt block: 4 warps of 4 (csrc: WD_ROWS)
WIDE_ROWS = 16
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

PATHS = ("prefill_tc", "decode_split", "wide_simt", "wide_chunk")
#: the backward's kernels, in launch order
BWD_KERNELS = ("rowdot", "dkdv", "dq")
#: the backward's routes: tensor cores (D ≤ 128), f32 SIMT staged (D ≤
#: 256) or chunked (past it)
BWD_PATHS = ("tc", "wide_simt", "wide_chunk")


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
    """The path (``prefill_tc``, ``decode_split``, ``wide_simt`` or
    ``wide_chunk``) and launch geometry of attention of ``(b, tq, hq,
    d)`` queries over ``(b, tk, hkv, d)`` keys.  Raises ``ValueError`` on
    what no kernel takes."""
    if d <= 0:
        raise ValueError(f"flash_attention: head dim {d} must be > 0")
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
    if d > WIDE_HEAD_DIM:
        chunks = math.ceil(d / CHUNK_COLS)
        grid = (math.ceil(rows / WIDE_ROWS) * chunks, hkv, b)
        return "wide_chunk", Geometry(WIDE_ROWS, grid, 1, hi - lo, 0)
    if d > TC_HEAD_DIM:
        grid = (math.ceil(rows / WIDE_ROWS), hkv, b)
        return "wide_simt", Geometry(WIDE_ROWS, grid, 1, hi - lo, 0)
    if rows <= DECODE_ROWS:
        want = math.ceil(DECODE_BLOCKS / max(1, b * hkv))
        kps = SPLIT_KEYS * max(1, math.ceil((hi - lo) / want / SPLIT_KEYS))
        splits = max(1, math.ceil((hi - lo) / kps))
        return "decode_split", Geometry(rows, (splits, hkv, b), splits, kps,
                                        splits * b * hkv * rows * (2 + d))
    grid = (math.ceil(tq / PREFILL_Q_TILE), hq, b)
    return "prefill_tc", Geometry(PREFILL_Q_TILE, grid, 1, hi - lo, 0)


def _masked_rows(tq: int, tk: int, causal, window, chunk, q_offset):
    """Each query row's visible keys ``[lo, hi)`` (numpy, ``lo == hi``:
    none), the mask of :func:`visible_keys` row by row."""
    pos = q_offset + np.arange(tq, dtype=np.int64)
    lo, hi = np.zeros(tq, np.int64), np.full(tq, tk, np.int64)
    if causal:
        hi = np.minimum(hi, pos + 1)
    if window:
        lo = np.maximum(lo, pos - window + 1)
    if chunk:
        lo = np.maximum(lo, pos // chunk * chunk)
        hi = np.minimum(hi, (pos // chunk + 1) * chunk)
    return lo, np.maximum(lo, hi)


def visible_counts(tq: int, tk: int, *, causal=True, window=None,
                   chunk=None, q_offset=0) -> tuple[int, int]:
    """``(pairs, keys)``: the (query, key) pairs the masks leave visible
    (the work B5 must do) and the keys some query sees (the keys and
    values it must read)."""
    if tq == 0 or tk == 0:
        return 0, 0
    lo, hi = _masked_rows(tq, tk, causal, window, chunk, q_offset)
    seen = np.zeros(tk + 1, np.int64)
    np.add.at(seen, lo, 1)
    np.add.at(seen, hi, -1)
    return int((hi - lo).sum()), int((np.cumsum(seen[:tk]) > 0).sum())


def attention_cost(q, k, v, *, causal=True, window=None, chunk=None,
                   q_offset=0, lse: bool = False) -> tuple[str, float, float]:
    """``(path, operations, bytes)`` of one forward as its bound reckons
    them: the two dot products over the visible pairs (4·B·Hq·D a pair);
    q read and o written once, k and v read once over the keys some query
    sees (and lse written, with ``lse``)."""
    b, tq, hq, d = (int(s) for s in q.shape)
    tk, hkv = int(k.shape[1]), int(k.shape[2])
    pairs, keys = visible_counts(tq, tk, causal=causal, window=window,
                                 chunk=chunk, q_offset=q_offset)
    es = q.element_size()
    nbytes = es * d * (2 * b * tq * hq + 2 * b * keys * hkv)
    if lse:
        nbytes += 4 * b * hq * tq
    path = plan_attention(b, tq, tk, hq, hkv, d, causal=causal,
                          window=window, chunk=chunk, q_offset=q_offset)[0]
    return path, 4.0 * b * hq * d * pairs, float(nbytes)


def backward_cost(q, k, v, o, lse, do, *, causal=True, window=None,
                  chunk=None, q_offset=0) -> tuple[str, float, float]:
    """``(path, operations, bytes)`` of one backward as its bound reckons
    them: five T²·D products over the visible pairs (10·B·Hq·D a pair);
    q, o and dO read and dq written, k and v read and dk and dv written,
    lse read, once each."""
    b, tq, hq, d = (int(s) for s in q.shape)
    tk, hkv = int(k.shape[1]), int(k.shape[2])
    pairs, _ = visible_counts(tq, tk, causal=causal, window=window,
                              chunk=chunk, q_offset=q_offset)
    es = q.element_size()
    nbytes = es * (4 * b * tq * hq * d + 4 * b * tk * hkv * d) \
        + 4 * b * hq * tq
    return backward_path(d), 10.0 * b * hq * d * pairs, float(nbytes)


@costing.counted("flash_attention", attention_cost)
def flash_attention(q, k, v, *, causal=True, window=None, chunk=None,
                    q_offset=0) -> torch.Tensor:
    """q: (B, Tq, Hq, D); k/v: (B, Tk, Hkv, D) → (B, Tq, Hq, D).  No
    autograd node on CUDA tensors: to differentiate, use
    :class:`AttnFn` (``ops.flash_attention`` does when autograd
    records).  On meta tensors (a dry run's count) an empty output."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        (q, k, v), back = cuda_lib.f32_entry("flash_attention", q, k, v)
        # contiguous, as the kernel writes it (a count sees one layout)
        return back(flash_attention_plain(q, k, v, causal=causal,
                                          window=window, chunk=chunk,
                                          q_offset=q_offset).contiguous())
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                chunk=chunk, q_offset=q_offset)


@costing.counted("flash_attention", functools.partial(attention_cost,
                                                     lse=True))
def flash_attention_lse(q, k, v, *, causal=True, window=None, chunk=None,
                        q_offset=0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: the output and each row's log-sum-exp, (B, Hq, Tq)
    in natural-log units (-inf for a row that sees no key), as the
    backward reads it.  CUDA tensors: one B5 launch writing both; meta
    tensors: empty ones."""
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_offset)
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty(
            (q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
            device="meta")
    if q.device.type == "cpu":
        (q, k, v), back = cuda_lib.f32_entry("flash_attention", q, k, v)
        return (back(flash_attention_plain(q, k, v, **kw).contiguous()),
                attention_lse_plain(q, k, **kw).contiguous())
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    return flash_attention_cuda(q, k, v, lse=lse, **kw), lse


def flash_attention_cuda(q, k, v, *, causal=True, window=None, chunk=None,
                         q_offset=0, lse=None) -> torch.Tensor:
    """Launch the path :func:`plan_attention` picks; with ``lse`` (a
    contiguous f32 (B, Hq, Tq) tensor on q's device) the kernel also
    writes each row's log-sum-exp there, the output unchanged.  Takes
    f32, or bf16/f16 cast to f32 (the output cast back).  Counts one
    launch per call in ``.launches`` and by path in ``.by_path``."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: expected 4-D q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    (q, k, v), back = cuda_lib.f32_entry("flash_attention", q, k, v)
    cuda_lib.require(q, "q", dtype=torch.float32)
    bsz, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):   # strided cache views
        cuda_lib.require(t, name, dtype=torch.float32,
                         shape=(bsz, tk, hkv, d), strided=True)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if lse is not None:
        cuda_lib.require(lse, "lse", dtype=torch.float32,
                         shape=(bsz, hq, tq))
        if lse.device != q.device:
            raise ValueError("flash_attention: lse on another device")
    path, geo = plan_attention(bsz, tq, tk, hq, hkv, d, causal=causal,
                               window=window, chunk=chunk,
                               q_offset=q_offset)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return back(o)
    lib, stream = cuda_lib.library(), cuda_lib.stream_of(q)
    args = (bsz, tq, tk, hq, hkv, d, *k.stride()[:3], *v.stride()[:3],
            int(causal), window or 0, chunk or 0, int(q_offset),
            1.0 / math.sqrt(d))
    lse_ptr = None if lse is None else lse.data_ptr()
    if path == "prefill_tc":
        err = lib.flash_attention_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse_ptr,
            *args, geo.q_tile, *geo.grid, stream)
    elif path in ("wide_simt", "wide_chunk"):
        entry = (lib.flash_attention_wide if path == "wide_simt" else
                 lib.flash_attention_wide_chunk)
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse_ptr,
            *args, geo.q_tile, *geo.grid, stream)
    else:
        part = torch.empty(geo.scratch, dtype=torch.float32, device=q.device)
        err = lib.flash_attention_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse_ptr,
            part.data_ptr(), *args, geo.q_tile, geo.splits,
            geo.keys_per_split, *geo.grid, geo.scratch, stream)
    cuda_lib.check(err, f"flash_attention ({path})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.by_path[path] += 1
    return back(o)


flash_attention_cuda.launches = 0
flash_attention_cuda.by_path = dict.fromkeys(PATHS, 0)


@costing.counted("flash_attention_backward", backward_cost)
def attention_backward(q, k, v, o, lse, do, *, causal=True, window=None,
                       chunk=None, q_offset=0):
    """``(dq, dk, dv)`` of ``o = flash_attention(q, k, v)`` given ``do =
    ∂L/∂o`` and the forward's ``lse``: the plain version on CPU tensors,
    the three backward kernels on CUDA tensors (half types in f32 on
    either device, the gradients in the input's type), empty gradients
    on meta tensors (a dry run's count)."""
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_offset)
    if q.device.type == "meta":
        return tuple(torch.empty_like(x) for x in (q, k, v))
    if q.device.type == "cpu":
        (q, k, v, o, do), back = cuda_lib.f32_entry(
            "attention_backward", q, k, v, o, do)
        return tuple(back(g.contiguous()) for g in attention_backward_plain(
            q, k, v, o, lse, do, **kw))
    return attention_backward_cuda(q, k, v, o, lse, do, **kw)


def backward_launchers(q, k, v, o, lse, do, *, causal=True, window=None,
                       chunk=None, q_offset=0):
    """The checked arguments of a backward on the card: ``((dq, dk, dv),
    {name: launch})``, one zero-argument launcher per kernel of
    :data:`BWD_KERNELS`, to be called in that order (each returns its
    ``cudaError_t``).  Raises on anything the kernels do not take: CUDA
    f32 tensors, all contiguous, q, o and do (B, Tq, Hq, D), k and v
    (B, Tk, Hkv, D), lse (B, Hq, Tq).  The route is
    :func:`backward_path`'s."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"attention_backward: expected 4-D q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    bsz, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    for name, t, shape in (("q", q, q.shape), ("k", k, k.shape),
                           ("v", v, k.shape), ("o", o, q.shape),
                           ("do", do, q.shape), ("lse", lse, (bsz, hq, tq))):
        cuda_lib.require(t, name, dtype=torch.float32, shape=shape)
        if t.device != q.device:
            raise ValueError(f"attention_backward: {name} on {t.device}, "
                             f"q on {q.device}")
    plan_attention(bsz, tq, tk, hq, hkv, d, causal=causal, window=window,
                   chunk=chunk, q_offset=q_offset)       # the shape checks
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty_like(lse)
    lib, stream = cuda_lib.library(), cuda_lib.stream_of(q)
    mask = (bsz, tq, tk, hq, hkv, d, int(causal), window or 0, chunk or 0,
            int(q_offset), 1.0 / math.sqrt(d), stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    route = backward_path(d)
    dkdv, dq_fn = {
        "tc": (lib.flash_attention_bwd_dkdv, lib.flash_attention_bwd_dq),
        "wide_simt": (lib.flash_attention_bwd_dkdv_wide,
                      lib.flash_attention_bwd_dq_wide),
        "wide_chunk": (lib.flash_attention_bwd_dkdv_chunk,
                       lib.flash_attention_bwd_dq_chunk)}[route]
    return (dq, dk, dv), {
        "rowdot": lambda: lib.flash_attention_bwd_rowdot(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), bsz, tq, hq, d,
            stream),
        "dkdv": lambda: dkdv(*ins, dk.data_ptr(), dv.data_ptr(), *mask),
        "dq": lambda: dq_fn(*ins, dq.data_ptr(), *mask)}


def backward_path(d: int) -> str:
    """The backward's route for head dim ``d``: ``"tc"`` (3xTF32 on
    tensor cores) up to ``TC_HEAD_DIM``, ``"wide_simt"`` up to
    ``WIDE_HEAD_DIM``, ``"wide_chunk"`` past it."""
    if d <= TC_HEAD_DIM:
        return "tc"
    return "wide_simt" if d <= WIDE_HEAD_DIM else "wide_chunk"


def attention_backward_cuda(q, k, v, o, lse, do, *, causal=True,
                            window=None, chunk=None, q_offset=0):
    """Launch :data:`BWD_KERNELS` in order (:func:`backward_launchers`) on
    f32, or on bf16/f16 cast to f32 (the gradients cast back; lse is
    f32 either way).  Counts one backward per call in ``.launches``, by
    route in ``.by_path`` and each kernel's launches in ``.by_kernel``."""
    (q, k, v, o, do), back = cuda_lib.f32_entry("attention_backward",
                                                q, k, v, o, do)
    grads, launchers = backward_launchers(
        q, k, v, o, lse, do, causal=causal, window=window, chunk=chunk,
        q_offset=q_offset)
    for name in BWD_KERNELS:
        cuda_lib.check(launchers[name](), f"flash_attention backward "
                                          f"({name})")
        attention_backward_cuda.by_kernel[name] += 1
    attention_backward_cuda.launches += 1
    attention_backward_cuda.by_path[backward_path(q.shape[-1])] += 1
    return tuple(map(back, grads))


attention_backward_cuda.launches = 0
attention_backward_cuda.by_kernel = dict.fromkeys(BWD_KERNELS, 0)
attention_backward_cuda.by_path = dict.fromkeys(BWD_PATHS, 0)


class AttnFn(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward is B5 writing
    the log-sum-exp (:func:`flash_attention_lse`), the backward
    :func:`attention_backward` (the backward kernels on CUDA tensors,
    the plain version on CPU ones).  Saves q, k, v, o and lse; the mask
    arguments ride on ``ctx``.  ``apply(q, k, v, causal, window, chunk,
    q_offset)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, chunk=None,
                q_offset=0):
        ctx.mask = dict(causal=causal, window=window, chunk=chunk,
                        q_offset=q_offset)
        o, lse = flash_attention_lse(q, k, v, **ctx.mask)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(
            q.contiguous(), k.contiguous(), v.contiguous(), o, lse,
            do.contiguous(), **ctx.mask)
        return dq, dk, dv, None, None, None, None
