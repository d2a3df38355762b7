"""GQA self-attention with a KV cache (counterpart of
``repro/models/attention.py``).

Every self-attention goes through kernel B5 (``ops.flash_attention``):
the queries sit at positions ``pos … pos+t-1`` and the keys are the
cache slots ``0 … pos+t-1``, so the causal mask with ``q_offset = pos``
is exactly the reference's position mask, including its sentinel for
the slots not written yet (``attention.py:187-190``), which causal
masking already removes.  The kernel tiles the queries itself, so the
reference's q-chunking (``Q_CHUNK``) has no counterpart.

Cross-attention (``kv_override``) and Llama-4's per-layer global flag
(``layer_global``) belong to model families the port does not run yet
(ROADMAP A7).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import _init, rope


def attn_init(gen: torch.Generator, cfg, dtype) -> dict:
    d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(d)
    return {"wq": _init(gen, (d, hq * hd), s, dtype),
            "wk": _init(gen, (d, hk * hd), s, dtype),
            "wv": _init(gen, (d, hk * hd), s, dtype),
            "wo": _init(gen, (hq * hd, d), 1.0 / math.sqrt(hq * hd), dtype)}


def attn_apply(p: dict, x: torch.Tensor, cfg, *, cache: dict | None = None,
               layer_global: bool = False, kv_override=None,
               causal: bool = True):
    """Full-sequence attention (prefill, no cache) or cached decode.

    x: (B, T, D) at positions ``pos … pos+T-1``, where ``pos`` is
    ``cache["pos"]`` (0 without a cache).  ``cache``: ``{"k", "v":
    (B, Tmax, Hkv, hd), "pos": int}``.  The reference updates the cache
    functionally; here the new keys and values are written into the
    cache's tensors in place (no copy of the whole cache per token) and
    the returned cache shares them, with ``pos`` advanced.

    Returns ``(y, new_cache)``."""
    if kv_override is not None or layer_global:
        raise NotImplementedError(
            "cross-attention and per-layer global attention come with the "
            "enc-dec and Llama 4 families (ROADMAP A7)")
    b, t, _ = x.shape
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = 0 if cache is None else int(cache["pos"])
    positions = pos + torch.arange(t, device=x.device)
    q = rope((x @ p["wq"]).reshape(b, t, hq, hd), positions, cfg.rope_theta)
    k = rope((x @ p["wk"]).reshape(b, t, hk, hd), positions, cfg.rope_theta)
    v = (x @ p["wv"]).reshape(b, t, hk, hd)

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
                               chunk=cfg.chunk or None, q_offset=pos)
    y = out.reshape(b, t, hq * hd) @ p["wo"]
    return y, new_cache
