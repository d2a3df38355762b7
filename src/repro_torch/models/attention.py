"""GQA self-attention with a KV cache (counterpart of
``repro/models/attention.py``).

Every self-attention goes through kernel B5 (``ops.flash_attention``):
the queries sit at positions ``pos … pos+t-1`` and the keys are the
cache slots ``0 … pos+t-1``, so the causal mask with ``q_offset = pos``
is exactly the reference's position mask, including its sentinel for
the slots not written yet (``attention.py:187-190``), which causal
masking already removes.  The kernel tiles the queries itself, so the
reference's q-chunking (``Q_CHUNK``) has no counterpart.

Cross-attention (Whisper's decoder) passes ``kv_override=(k, v)``: keys
and values projected once from the encoder output, at positions ``0 …
Tk-1`` (the reference's ``kpos`` is always ``arange(Te)``).  Neither q
nor k is rotated then, as in the reference, and no cache is written.
Llama 4's global layers pass ``layer_global=True``, which drops the
chunk mask for that layer.

On a mesh whose ``"model"`` axis spans M ranks (``sharding.
model_mesh``) each rank holds whole heads, laid out by ``sharding.
head_split``: ``wq``'s columns of its query heads, ``wk``/``wv``'s of
the kv heads they use (a GQA group stays on one rank, so B5 sees an
integral group), and ``wo``'s matching rows.  Where M is at most the kv
heads a rank holds a run of whole groups, the first ranks one more
where M does not divide them.  Where M is a larger multiple of the kv
heads a rank holds the one kv head its query heads use, replicated on
the ``M / n_kv_heads`` ranks of that head, whose query heads are split
over them (⌈g/rep⌉ or ⌊g/rep⌋ a rank); where that group is narrower
than the head's ranks each query head is replicated on its ``q_rep``
ranks too, and ``wo``'s rows of the head are split over them: each
rank multiplies its ``hd / q_rep`` columns of the head's output.  A
replicated ``wk``/``wv``/``wq`` passes ``copy_to_group`` over its
ranks, so each replica's gradient is the sum of every replica's share.
B5 runs on the rank's heads (the reference's ``heads_act``
constraints), the KV cache and a cross-attention's ``kv_override`` hold
them, and ``wo``'s partial products are summed over ranks, so each head
counts once in the output.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import _init, rope


def attn_init(gen: torch.Generator, cfg, dtype) -> dict:
    d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(d)
    return {"wq": _init(gen, (d, hq * hd), s, dtype),
            "wk": _init(gen, (d, hk * hd), s, dtype),
            "wv": _init(gen, (d, hk * hd), s, dtype),
            "wo": _init(gen, (hq * hd, d), 1.0 / math.sqrt(hq * hd), dtype)}


def attn_specs(cfg) -> dict:
    """The logical axes of :func:`attn_init`'s leaves, each head
    dimension marked with its heads (``sharding.Heads``: ``wq``'s
    columns and ``wo``'s rows ``cfg.n_heads`` query heads, ``wk``'s and
    ``wv``'s ``cfg.n_kv_heads`` kv heads)."""
    hq, hk = cfg.n_heads, cfg.n_kv_heads
    kv = sh.Heads(("embed", "kv"), hk)
    return {"wq": sh.Heads(("embed", "heads"), hk, hq), "wk": kv, "wv": kv,
            "wo": sh.Heads(("heads", "embed"), hk, hq, rows=True)}


def replica_group(mesh, cfg) -> tuple:
    """``(q_group, kv_group)``: the process groups of the ranks that hold
    this rank's query head and kv head where either is replicated over
    the model axis (``sharding.head_split``'s ``q_rep``, ``kv_rep``),
    else None."""
    _, m = sh.model_coords(mesh)
    split = sh.head_split(cfg.n_heads, cfg.n_kv_heads, m)
    return tuple(sh.kv_groups(mesh, rep)[1] if rep > 1 else None
                 for rep in (split.q_rep, split.kv_rep))


def kv_weights(p: dict, cfg, mesh) -> tuple:
    """``(wk, wv)`` of ``p``; on a model axis that replicates the kv
    heads, passed through ``copy_to_group`` over each head's ranks."""
    group = replica_group(mesh, cfg)[1]
    return C.copy_to_group(p["wk"], group), C.copy_to_group(p["wv"], group)


def _project_out(out: torch.Tensor, wo: torch.Tensor, cfg, mesh):
    """The rank's share of the output projection of its heads' attention
    ``out`` (B, T, heads, hd), summed over the model axis: where a query
    head is replicated on ``q_rep`` ranks, this rank multiplies its
    ``hd / q_rep`` of the head's columns by its rows of ``wo``."""
    b, t = out.shape[:2]
    out = out.reshape(b, t, -1)
    if wo.shape[0] != out.shape[-1]:
        r, m = sh.model_coords(mesh)
        j = r % sh.head_split(cfg.n_heads, cfg.n_kv_heads, m).q_rep
        w = wo.shape[0]
        out = out[..., j * w:(j + 1) * w]
    return C.reduce_from_model(out @ wo, mesh)


def attn_apply(p: dict, x: torch.Tensor, cfg, *, cache: dict | None = None,
               layer_global: bool = False, kv_override=None,
               causal: bool = True, pos: int | None = None):
    """Full-sequence attention (prefill, no cache), cached decode, or
    cross-attention over ``kv_override``.

    x: (B, T, D) at positions ``pos … pos+T-1``; ``pos`` defaults to
    ``cache["pos"]`` (0 without a cache).  ``cache``: ``{"k", "v":
    (B, Tmax, Hkv, hd), "pos": int}``.  The reference updates the cache
    functionally; here the new keys and values are written into the
    cache's tensors in place (no copy of the whole cache per token) and
    the returned cache shares them, with ``pos`` advanced.
    ``kv_override``: ``(k, v)``, each (B, Tk, Hkv, hd), attended as
    they are (no rope, no cache).

    Returns ``(y, new_cache)``."""
    b, t, _ = x.shape
    hd = cfg.hd
    mesh = sh.model_mesh()
    x = C.copy_to_model(x, mesh)
    if pos is None:
        pos = 0 if cache is None else int(cache["pos"])
    wq = C.copy_to_group(p["wq"], replica_group(mesh, cfg)[0])
    q = (x @ wq).reshape(b, t, -1, hd)   # this rank's query heads
    chunk = None if layer_global else (cfg.chunk or None)
    if kv_override is not None:
        k, v = kv_override
        out = kops.flash_attention(q, k, v, causal=causal,
                                   window=cfg.window, chunk=chunk,
                                   q_offset=pos)
        return _project_out(out, p["wo"], cfg, mesh), None
    positions = pos + torch.arange(t, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    wk, wv = kv_weights(p, cfg, mesh)
    k = rope((x @ wk).reshape(b, t, -1, hd), positions, cfg.rope_theta)
    v = (x @ wv).reshape(b, t, -1, hd)

    new_cache = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        if pos + t > ck.shape[1]:  # the reference would clamp the write
            raise ValueError(f"KV cache full: {pos} + {t} tokens > "
                             f"{ck.shape[1]} slots")
        ck[:, pos:pos + t] = k.to(ck.dtype)
        cv[:, pos:pos + t] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "pos": pos + t}
        k, v = ck[:, :pos + t], cv[:, :pos + t]

    out = kops.flash_attention(q, k, v, causal=causal, window=cfg.window,
                               chunk=chunk, q_offset=pos)
    return _project_out(out, p["wo"], cfg, mesh), new_cache
