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
any Pallas kernel.

Across ranks (the reference's ``moe_apply`` under GSPMD, whose
``"expert"`` axis maps to ``"model"``):

* On a ``"model"`` axis of M ranks a rank holds ``E / M`` experts (its
  block of ``wi``, ``wg``, ``wo``), its ``E / M`` router columns and its
  columns of the shared experts.  It computes its columns' logits and
  gathers them whole (``collectives.gather_from_model``), so every rank
  of the group routes, drops and reckons ``aux`` alike; it runs its own
  experts on the kept choices routed to them, the shared experts column-
  then row-parallel, and one ``reduce_from_model`` sums the partial
  combines.  Activations are whole on every rank, so no token moves
  between ranks and no expert's weights are gathered.  The reference's
  ``BUF_SHARD`` ("expert" or "expert_data") only lays the expert
  buffer out over a mesh; here the buffer is the rank's own, so it has
  no counterpart.
* With the batch split over ``"data"`` (``sharding.data_mesh``; over
  ``("pod", "data")`` on a multi-pod mesh, ``sharding.batch_axes``; the
  sharded train step) a rank holds its rows of the global batch, and
  the answer is still the global batch's: capacity is reckoned over the
  global token count, a choice's slot counts the earlier ranks' choices
  of its expert (an all-gather of each rank's ``E`` counts), and ``aux``
  is this rank's share of the global term (its tokens' probabilities
  against the global counts; the ranks' shares sum to it).

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

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as sh
from repro_torch.models.layers import _init


class Routing(NamedTuple):
    """One MoE layer's routing of this rank's ``T`` tokens (flat over
    ``T·k`` choices, token-major)."""

    probs: torch.Tensor      # (T, E) f32 router softmax
    gate: torch.Tensor       # (T, k) renormalised gates
    expert: torch.Tensor     # (T·k,) chosen expert of each choice
    slot: torch.Tensor       # (T·k,) position among this rank's choices
    keep: torch.Tensor       # (T·k,) bool: its global slot < cap
    cap: int                 # slots an expert
    counts: torch.Tensor     # (E,) choices of each expert, global batch
    tokens: int              # tokens of the global batch


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
    choice's slot in its expert, and which choices fit (on a mesh, as
    the module's docstring says)."""
    m = cfg.moe
    logits = (xf @ p["router"].to(xf.dtype)).float()
    logits = C.gather_from_model(logits, sh.model_mesh())
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, m.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    expert = idx.reshape(-1)
    # a choice's slot is how many earlier choices (token-major) picked
    # its expert: the reference's cumsum over the (T·k, E) one-hot, run
    # along the rows of its transpose (a scan down the long axis is ≈50×
    # slower on the card at a prefill's 24,576 choices:
    # tools/moe_slot_timing.py)
    # (the one-hot as a comparison: F.one_hot checks its ids on the host
    # on some devices, so a step's op count would depend on the device)
    experts = torch.arange(m.n_experts, device=expert.device)
    seen = (experts[:, None] == expert[None, :]).long().cumsum(1)
    slot = seen[expert, torch.arange(expert.numel(), device=xf.device)] - 1
    counts, tokens, before = seen[:, -1], xf.shape[0], slot
    mesh = sh.data_mesh()
    if mesh is not None:        # the earlier ranks' rows come first
        axes = sh.batch_axes()
        every = counts[None]
        for a in reversed(axes):          # (W, E), the outer axis major
            every = C.all_gather(every, mesh, a)
        j = sh.block_index(axes, mesh)
        before = slot + every[:j].sum(0)[expert]
        counts, tokens = every.sum(0), tokens * every.shape[0]
    cap = capacity(tokens, cfg)
    return Routing(probs, gate, expert, slot, before < cap, cap, counts,
                   tokens)


def moe_apply(p: dict, x: torch.Tensor, cfg, *,
              dropped: list | None = None, chosen: list | None = None):
    """x: (B, S, D) → ``(y (B, S, D), aux)``; ``aux`` is the
    Switch-style load-balance term (f32 scalar; with the batch split
    over ``"data"``, this rank's share of it).  ``dropped``, when given,
    gets this layer's ``(B, S, k)`` bool mask of the choices its
    capacity dropped appended, ``chosen`` its ``(B, S, k)`` chosen
    experts (device tensors: read them after the forward)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    mesh = sh.model_mesh()
    xf = C.copy_to_model(x.reshape(t, d), mesh)
    r = route(p, xf, cfg)
    if dropped is not None:
        dropped.append(~r.keep.view(b, s, m.top_k))
    if chosen is not None:
        chosen.append(r.expert.view(b, s, m.top_k))

    # dispatch: the kept choices of this rank's experts into their
    # (expert, slot); any other choice adds a zero row, as the
    # reference's masked scatter does for a dropped one
    j, n_m = sh.model_coords(mesh)
    n_e = m.n_experts // n_m
    local = r.expert - j * n_e
    mine = r.keep & (local >= 0) & (local < n_e)
    flat = torch.where(mine, local * r.cap + r.slot, 0)
    keep = mine[:, None]
    contrib = torch.where(keep, xf.repeat_interleave(m.top_k, 0), 0)
    buf = xf.new_zeros((n_e * r.cap, d)).index_add_(0, flat, contrib)
    buf = buf.view(n_e, r.cap, d)

    # the expert FFN, batched over the rank's experts
    h = torch.bmm(buf, p["wi"])
    g = torch.bmm(buf, p["wg"])
    out_e = torch.bmm(F.silu(g) * h, p["wo"]).view(n_e * r.cap, d)

    # combine: each kept choice's expert output, gate-weighted, summed
    # over the token's k choices (adjacent rows, token-major); the gate
    # is whole on every rank and its gradient sums the ranks' experts'
    gate = C.copy_to_model(r.gate, mesh)
    picked = torch.where(keep, out_e[flat], 0)
    weighted = picked * gate.reshape(-1)[:, None].to(picked.dtype)
    combined = weighted.view(t, m.top_k, d).sum(1)

    if m.n_shared:
        hs = F.silu(xf @ p["shared_wg"]) * (xf @ p["shared_wi"])
        combined = combined + hs @ p["shared_wo"]
    combined = C.reduce_from_model(combined, mesh)

    # Switch-style load balance: mean router probability times the
    # share of choices, per expert, over the global batch
    share = r.counts.float() / max(r.tokens * m.top_k, 1)
    aux = (r.probs.sum(0) / r.tokens * share).sum() * m.n_experts
    return combined.reshape(b, s, d), aux
