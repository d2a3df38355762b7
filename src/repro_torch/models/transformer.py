"""Model assembly: init / forward / cache / decode (counterpart of
``repro/models/transformer.py``), for the ``hybrid`` family (Zamba2).

Zamba2 is a stack of Mamba2 layers cut into segments of
``hybrid_attn_every`` layers; after each segment one *shared*
attention + MLP block (one parameter set) is applied, with a KV cache of
its own per segment.  Parameters are a dict of tensors whose keys are
the reference's parameter tree paths, the layer stack kept stacked on a
leading ``L`` axis (``params["stack"]["rec"]["w_in"]`` is ``(L, d,
2·d_inner)``), so :func:`params_from_reference` carries the reference's
weights across leaf by leaf.  The reference scans the stack; here a
Python loop slices one layer at a time (a view, no copy).

The other families (dense, moe, ssm/xLSTM, encdec, vlm) are not ported
yet (ROADMAP A7).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_mod


def _require_hybrid(cfg: ModelConfig) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port runs the "
            f"hybrid family (Zamba2) only (ROADMAP A7)")
    if not cfg.hybrid_attn_every or cfg.n_layers % cfg.hybrid_attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into segments of {cfg.hybrid_attn_every}")


def _dense_layer_init(gen, cfg, dtype) -> dict:
    return {"attn": attn_mod.attn_init(gen, cfg, dtype),
            "ffn": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                              dtype),
            "norm1": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
            "norm2": L.rmsnorm_init(cfg.d_model, dtype, gen.device)}


def _recurrent_layer_init(gen, cfg, dtype) -> dict:
    return {"rec": ssm_mod.recurrent_init(gen, cfg, dtype),
            "norm1": L.rmsnorm_init(cfg.d_model, dtype, gen.device)}


def _stack(layers: list[dict]) -> dict:
    """Stack per-layer parameter dicts on a leading axis."""
    return {k: _stack([lay[k] for lay in layers]) if isinstance(v, dict)
            else torch.stack([lay[k] for lay in layers])
            for k, v in layers[0].items()}


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``
    (the reference's distributions; not its numbers)."""
    _require_hybrid(cfg)
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {"embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                    dtype),
              "out_norm": L.rmsnorm_init(cfg.d_model, dtype, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                         dtype)
    params["stack"] = _stack([_recurrent_layer_init(gen, cfg, dtype)
                              for _ in range(cfg.n_layers)])
    params["shared_attn"] = _dense_layer_init(gen, cfg, dtype)
    return params


def params_from_reference(tree: dict, cfg: ModelConfig, device=None
                          ) -> dict:
    """The reference's ``init_params`` tree, as nested numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's parameters on
    ``device``.  Both keep the layer axis stacked, so this is a leafwise
    copy; the tree is checked against the config first."""
    _require_hybrid(cfg)
    dev = resolve(device)
    missing = {"embed", "out_norm", "stack", "shared_attn"} - set(tree)
    if missing:
        raise ValueError(f"not a {cfg.family} parameter tree: missing "
                         f"{sorted(missing)}")
    w_in = np.shape(tree["stack"]["rec"]["w_in"])
    di = cfg.d_inner_mult * cfg.d_model
    if w_in != (cfg.n_layers, cfg.d_model, 2 * di):
        raise ValueError(f"stack w_in {w_in} does not fit {cfg.name}")

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).to(dev)

    return convert(tree)


def _dense_block(p, x, cfg, *, cache=None):
    h, new_cache = attn_mod.attn_apply(
        p["attn"], L.rmsnorm(x, p["norm1"], cfg.norm_eps), cfg, cache=cache)
    x = x + h
    z = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + L.mlp_apply(p["ffn"], z, cfg.mlp_gated), new_cache


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: dict | None = None):
    """tokens (B, T) → ``(logits (B, T, padded_vocab), new_cache)``.

    Without a cache: the full sequence from position 0 (prefill or a
    teacher-forced pass).  With one: the tokens continue at
    ``cache["pos"]``; the cache's tensors are updated in place and the
    returned cache shares them with ``pos`` advanced."""
    _require_hybrid(cfg)
    x = params["embed"][tokens]
    t = x.shape[1]
    k = cfg.hybrid_attn_every
    stack = params["stack"]
    for s in range(cfg.n_layers // k):
        for li in range(s * k, (s + 1) * k):
            p_l = _layer(stack, li)
            st = None if cache is None else cache["state"][li]
            y, new_st = ssm_mod.recurrent_apply(
                p_l["rec"], L.rmsnorm(x, p_l["norm1"], cfg.norm_eps), cfg,
                slstm_flag=False, state=st)
            x = x + y
            if cache is not None:
                st.copy_(new_st)
        sc = None if cache is None else {
            "k": cache["shared"]["k"][s], "v": cache["shared"]["v"][s],
            "pos": cache["pos"]}
        x, _ = _dense_block(params["shared_attn"], x, cfg, cache=sc)

    x = L.rmsnorm(x, params["out_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.T
    new_cache = None if cache is None else {**cache,
                                            "pos": cache["pos"] + t}
    return logits, new_cache


def init_cache(cfg: ModelConfig, batch: int, t_max: int,
               dtype=torch.float32, device=None) -> dict:
    """Per-layer recurrent state (f32) and one KV cache per shared-block
    application (segment); ``pos`` is a Python int."""
    _require_hybrid(cfg)
    dev = resolve(device)
    n_seg = cfg.n_layers // cfg.hybrid_attn_every
    kv = (n_seg, batch, t_max, cfg.n_kv_heads, cfg.hd)
    return {"pos": 0,
            "state": torch.zeros((cfg.n_layers, batch,
                                  cfg.d_inner_mult * cfg.d_model),
                                 dtype=torch.float32, device=dev),
            "shared": {"k": torch.zeros(kv, dtype=dtype, device=dev),
                       "v": torch.zeros(kv, dtype=dtype, device=dev)}}


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """One-token decode: tokens (B, 1) → ``(logits, new_cache)``."""
    return forward(params, cfg, tokens, cache=cache)
