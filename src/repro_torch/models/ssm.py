"""Recurrent blocks: Mamba2-style SSD and mLSTM/sLSTM
(counterpart of ``repro/models/ssm.py``).

Both reduce to the diagonal linear recurrence ``h_t = a_t ⊙ h_{t-1} +
b_t``.  Prefill runs it through kernel B4 (``ops.ssm_scan``); decode
keeps O(1) state and takes one elementwise step per token, with no
kernel.

* Mamba2/Zamba2 (``hybrid``): in_proj (value + gate) → gated recurrence
  over ``d_inner`` channels with per-head learned decay; ``q = k = 1``.
* mLSTM (``ssm``): adds the q/k readout projections ``w_qk``; an sLSTM
  layer (``slstm_flag``) switches the gates to exponential gating.

On a mesh whose ``"model"`` axis spans M ranks (``sharding.model_mesh``)
each rank runs ``d_inner / M`` channels: its blocks of the fused
``w_in`` and ``w_qk`` are ``[v_r | og_r]`` and ``[q_r | k_r]``
(``sharding.Fused``), B4 scans its channels, the decode state holds
them, and ``w_out``'s partial products are summed over ranks.  The
gates (``gate_proj``, ``decay_bias``: replicated) are computed whole
and cut to the rank's channels after ``repeat_interleave``; both weights
pass ``copy_to_model``, so their gradient sums every rank's share.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import _init


def recurrent_init(gen: torch.Generator, cfg, dtype) -> dict:
    """Parameter budget as the reference: Mamba2 ≈ 3·d·d_inner, mLSTM
    adds the q,k projections (≈ 5·d·d_inner)."""
    d = cfg.d_model
    di = cfg.d_inner_mult * d
    nh = max(cfg.n_heads, 1)
    s = 1.0 / math.sqrt(d)
    p = {"w_in": _init(gen, (d, 2 * di), s, dtype),       # value + gate
         "gate_proj": _init(gen, (d, 2 * nh), s, torch.float32),
         "w_out": _init(gen, (di, d), 1.0 / math.sqrt(di), dtype),
         "decay_bias": torch.full((nh,), 2.0, dtype=torch.float32,
                                  device=gen.device)}
    if cfg.family == "ssm":  # mLSTM q,k readout projections
        p["w_qk"] = _init(gen, (d, 2 * di), s, dtype)
    return p


def recurrent_specs(cfg) -> dict:
    """The logical axes of :func:`recurrent_init`'s leaves."""
    s = {"w_in": sh.Fused(("embed", "mlp")), "gate_proj": ("embed", None),
         "w_out": ("mlp", "embed"), "decay_bias": ("norm",)}
    if cfg.family == "ssm":
        s["w_qk"] = sh.Fused(("embed", "mlp"))
    return s


def recurrent_apply(p: dict, x: torch.Tensor, cfg, *,
                    slstm_flag: bool | None = None,
                    state: torch.Tensor | None = None):
    """x: (B, T, D); state: (B, d_inner) carried across decode steps.

    Returns ``(y, new_state)``.  With ``T == 1`` and a state this is one
    recurrence step; otherwise the scan from a zero state (prefill)."""
    b, t, d = x.shape
    di = cfg.d_inner_mult * d
    nh = max(cfg.n_heads, 1)
    mesh = sh.model_mesh()
    x = C.copy_to_model(x, mesh)

    v, og = (x @ p["w_in"]).chunk(2, dim=-1)          # value, output gate
    if "w_qk" in p:
        q, k = (x @ p["w_qk"]).chunk(2, dim=-1)
    else:  # Mamba2-style: no matrix-memory readout projections
        q = k = None
    # per-head (SSD); an f32 weight, so a bf16 x is promoted as JAX does
    gates = x.float() @ C.copy_to_model(p["gate_proj"], mesh)
    ig, fg = gates.chunk(2, dim=-1)                     # (B, T, nh)
    fg = fg + C.copy_to_model(p["decay_bias"], mesh)
    # each head's gate over its channels: jnp.repeat is repeat_interleave
    rep = di // nh
    ig = ig.repeat_interleave(rep, dim=-1)
    fg = fg.repeat_interleave(rep, dim=-1)
    if mesh is not None:        # this rank's channels
        r, n = sh.model_coords(mesh)
        ig, fg = (g.narrow(-1, r * di // n, di // n) for g in (ig, fg))

    if slstm_flag:  # exponential gating, stabilized
        a = torch.exp(-torch.exp(-fg))
        i = torch.exp(torch.clamp(ig, max=0.0))
    else:           # sigmoid forget / input gates
        a, i = torch.sigmoid(fg), torch.sigmoid(ig)

    kv = v.float() if k is None else k.float() * v.float()
    bterm = (i * kv).contiguous()
    a = a.contiguous()

    if t == 1 and state is not None:
        h = a[:, 0] * state + bterm[:, 0]
        new_state = h
        h = h[:, None]
    else:
        h = kops.ssm_scan(a, bterm)
        new_state = h[:, -1]

    y = h * F.silu(og.float())
    if q is not None:
        y = y * q.float()
    return C.reduce_from_model(y.to(x.dtype) @ p["w_out"], mesh), new_state


def init_recurrent_state(cfg, batch: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """One layer's zero state, ``(batch, d_inner)``; on a model axis of
    M ranks this rank's ``d_inner / M`` channels."""
    _, n = sh.model_coords(sh.model_mesh())
    return torch.zeros((batch, cfg.d_inner_mult * cfg.d_model // n),
                       dtype=dtype, device=device)
