"""Mixture-of-Experts FFN with capacity-based dispatch (counterpart of
``repro/models/moe.py``).

Routing as the reference: the router in f32 → softmax → ``top_k`` with
the gates renormalised → each (token, choice)'s position in its expert
among the token-major ``(T·k)`` choices (the reference's cumsum) →
choices beyond the expert's capacity dropped → the kept tokens
scattered into an ``(E, C, D)`` buffer → the expert FFN as three
batched products over the expert axis → the gate-weighted outputs
summed back per token.
Shared experts (DeepSeekMoE, Llama 4) run densely on every token.

The dispatch and the expert products are plain PyTorch (``cumsum``,
``index_add_``, ``bmm``): the reference computes them in XLA, outside
any Pallas kernel.  Its ``BUF_SHARD`` / ``set_buf_shard`` choose how the
expert buffer is sharded over a mesh; on one card there is no mesh and
no counterpart.

Capacity makes a layer's answer depend on the batch it sees: a decode
step routes ``T = B`` tokens into ``cap = max(⌈T·k/E·cf⌉, 4)`` slots an
expert, a full forward ``T = B·S`` tokens into proportionally more, so
different choices drop.  With ``capacity_factor ≥ E/k`` every expert
holds ``cap ≥ T`` slots and nothing drops.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init


class Routing(NamedTuple):
    """One MoE layer's routing of ``T`` tokens (flat over ``T·k``
    choices, token-major)."""

    probs: torch.Tensor      # (T, E) f32 router softmax
    gate: torch.Tensor       # (T, k) renormalised gates
    expert: torch.Tensor     # (T·k,) chosen expert of each choice
    slot: torch.Tensor       # (T·k,) position in its expert
    keep: torch.Tensor       # (T·k,) bool: slot < cap
    cap: int                 # slots an expert
    counts: torch.Tensor     # (E,) choices of each expert


def moe_init(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    m = cfg.moe
    fe = m.d_ff_expert
    s = 1.0 / math.sqrt(d)
    p = {"router": _init(gen, (d, m.n_experts), s, torch.float32),
         "wi": _init(gen, (m.n_experts, d, fe), s, dtype),
         "wg": _init(gen, (m.n_experts, d, fe), s, dtype),
         "wo": _init(gen, (m.n_experts, fe, d), 1.0 / math.sqrt(fe), dtype)}
    if m.n_shared:
        p["shared_wi"] = _init(gen, (d, m.n_shared * fe), s, dtype)
        p["shared_wg"] = _init(gen, (d, m.n_shared * fe), s, dtype)
        p["shared_wo"] = _init(gen, (m.n_shared * fe, d),
                               1.0 / math.sqrt(fe), dtype)
    return p


def moe_specs(cfg) -> dict:
    """The logical axes of :func:`moe_init`'s leaves."""
    s = {"router": ("embed", "expert"),
         "wi": ("expert", "embed", "mlp"),
         "wg": ("expert", "embed", "mlp"),
         "wo": ("expert", "mlp", "embed")}
    if cfg.moe.n_shared:
        s["shared_wi"] = ("embed", "mlp")
        s["shared_wg"] = ("embed", "mlp")
        s["shared_wo"] = ("mlp", "embed")
    return s


def capacity(tokens: int, cfg) -> int:
    """Slots an expert holds for ``tokens`` tokens."""
    m = cfg.moe
    cap = int(math.ceil(tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(cap, 4)


def route(p: dict, xf: torch.Tensor, cfg) -> Routing:
    """Route ``xf`` (T, D): top-k over the router's softmax, each
    choice's slot in its expert, and which choices fit."""
    m = cfg.moe
    logits = (xf @ p["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, m.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = capacity(xf.shape[0], cfg)
    expert = idx.reshape(-1)
    # a choice's slot is how many earlier choices (token-major) picked
    # its expert: the reference's cumsum over the (T·k, E) one-hot, run
    # along the rows of its transpose (a scan down the long axis is ≈50×
    # slower on the card at a prefill's 24,576 choices:
    # tools/moe_slot_timing.py)
    seen = F.one_hot(expert, m.n_experts).T.contiguous().cumsum(1)
    slot = seen[expert, torch.arange(expert.numel(), device=xf.device)] - 1
    return Routing(probs, gate, expert, slot, slot < cap, cap, seen[:, -1])


def moe_apply(p: dict, x: torch.Tensor, cfg, *,
              dropped: list | None = None):
    """x: (B, S, D) → ``(y (B, S, D), aux)``; ``aux`` is the
    Switch-style load-balance term (f32 scalar).  ``dropped``, when
    given, gets this layer's ``(B, S, k)`` bool mask of the choices its
    capacity dropped appended (a device tensor: read it after the
    forward)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    r = route(p, xf, cfg)
    if dropped is not None:
        dropped.append(~r.keep.view(b, s, m.top_k))

    # dispatch: kept choices into their (expert, slot); a dropped one
    # adds a zero row, as the reference's masked scatter does
    flat = r.expert * r.cap + torch.where(r.keep, r.slot, r.cap - 1)
    keep = r.keep[:, None]
    contrib = torch.where(keep, xf.repeat_interleave(m.top_k, 0), 0)
    buf = xf.new_zeros((m.n_experts * r.cap, d)).index_add_(0, flat,
                                                            contrib)
    buf = buf.view(m.n_experts, r.cap, d)

    # the expert FFN, batched over the expert axis
    h = torch.bmm(buf, p["wi"])
    g = torch.bmm(buf, p["wg"])
    out_e = torch.bmm(F.silu(g) * h, p["wo"]).view(m.n_experts * r.cap, d)

    # combine: each kept choice's expert output, gate-weighted, summed
    # over the token's k choices (adjacent rows, token-major)
    picked = torch.where(keep, out_e[flat], 0)
    weighted = picked * r.gate.reshape(-1)[:, None].to(picked.dtype)
    combined = weighted.view(t, m.top_k, d).sum(1)

    if m.n_shared:
        hs = F.silu(xf @ p["shared_wg"]) * (xf @ p["shared_wi"])
        combined = combined + hs @ p["shared_wo"]

    # Switch-style load balance: mean router probability times the
    # share of choices, per expert
    share = r.counts.float() / max(r.expert.numel(), 1)
    aux = (r.probs.mean(0) * share).sum() * m.n_experts
    return combined.reshape(b, s, d), aux
