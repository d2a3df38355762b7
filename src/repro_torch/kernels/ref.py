"""Plain PyTorch versions of the port's kernels (B1–B5).

Each function defines the semantics its hand-written CUDA kernel must
match.  The kernel wrappers take these only for tensors on the CPU (the
parity tests' path); ``chip_smoke.py`` calls them directly on the card
to hold each kernel against them.  They are not a fallback: a CUDA
tensor passed to a wrapper launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import semiring as sr_mod

#: max elements one broadcast (min,+)/(max,+) piece may materialize
_CHUNK_ELEMS = 1 << 24


def semiring_matmul_ref(sr, a: torch.Tensor, b: torch.Tensor
                        ) -> torch.Tensor:
    """B2: ``C[i,j] = ⊕_k A[i,k] ⊗ B[k,j]`` for an arbitrary semiring.

    (∨,∧) and (+,×) are f32 matrix products — with TF32 switched off
    (set here, ``torch.backends.cuda.matmul.allow_tf32 = False``): TF32
    keeps 10 mantissa bits, and counting fixpoints pass 2¹¹.
    (min,+)/(max,+) are a row-chunked broadcast-reduce, so the
    materialized (rows, K, N) intermediate stays bounded.
    """
    name = sr.name
    if name in ("bool", "nat", "real"):
        torch.backends.cuda.matmul.allow_tf32 = False
        out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
        return out > 0.5 if name == "bool" else out
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {a.shape} @ {b.shape}")
    reduce_fn = torch.amin if name == "trop" else torch.amax
    chunk = int(max(1, min(m, _CHUNK_ELEMS // max(1, k * n))))
    pieces = [reduce_fn(a[s:s + chunk, :, None] + b[None, :, :], dim=1)
              for s in range(0, m, chunk)]
    if not pieces:
        return a.new_full((0, n), sr.zero)
    return torch.cat(pieces, dim=0)


def segment_reduce_ref(sr, vals: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """B3: ``out[s] = ⊕_{i: ids[i]=s} vals[i]``; out-of-range ids (the
    COO padding sentinel) are dropped.  ``vals`` is ``(m,)`` or carries
    a trailing payload axis ``(m, B)``; each segment row then
    ⊕-combines whole payload rows."""
    base = sr.zeros((num_segments,) + tuple(vals.shape[1:]), vals.device)
    return sr_mod.scatter_op(sr.name, base, segment_ids, vals)


def coo_spmm_ref(sr, src: torch.Tensor, w: torch.Tensor,
                 dst: torch.Tensor, x: torch.Tensor,
                 n_out: int) -> torch.Tensor:
    """B1: ``out[d, b] = ⊕_{e: dst_e = d} w_e ⊗ x[src_e, b]`` over
    (dst-sorted) edge lists; ``x`` is ``(n_in, B)`` or ``(n_in,)``.
    Rows no edge reaches hold 0̄."""
    wx = w.reshape((-1,) + (1,) * (x.dim() - 1))
    prod = sr.mul(wx, x.index_select(0, src.long()))
    return segment_reduce_ref(sr, prod, dst, n_out)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  chunk: int | None = None, q_offset: int = 0
                  ) -> torch.Tensor:
    """B5: GQA attention, ``softmax(q·kᵀ/√D + mask)·v``.

    q: (B, Tq, Hq, D); k/v: (B, Tk, Hkv, D) with Hq % Hkv == 0 (kv head
    = q head // group).  Query ``i`` sits at position ``q_offset + i``,
    key ``j`` at ``j``.  ``window``: sliding window; ``chunk``: attend
    within aligned chunks only.  A row with no visible key is 0.
    """
    group = q.shape[2] // k.shape[2]
    vr = v.repeat_interleave(group, dim=2)
    logits = _masked_logits(q, k, causal=causal, window=window, chunk=chunk,
                            q_offset=q_offset)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)        # fully masked rows
    return torch.einsum("bhqk,bkhd->bqhd", probs, vr)


def attention_mask(tq: int, tk: int, *, causal: bool = True,
                   window: int | None = None, chunk: int | None = None,
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """B5's mask, (Tq, Tk) bool: query ``i`` at position ``q_offset + i``
    sees key ``j`` where true (``csrc/attention_mask.cuh``)."""
    qpos = torch.arange(tq, device=device)[:, None] + q_offset
    kpos = torch.arange(tk, device=device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if chunk is not None:
        mask &= (kpos // chunk) == (qpos // chunk)
    return mask


def _masked_logits(q, k, **mask_kw):
    """``q·kᵀ/√D`` as (B, Hq, Tq, Tk), -inf where the mask hides a key."""
    d = q.shape[3]
    kr = k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kr) / math.sqrt(d)
    mask = attention_mask(q.shape[1], k.shape[1], device=q.device, **mask_kw)
    return logits.masked_fill(~mask, float("-inf"))


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      chunk: int | None = None, q_offset: int = 0
                      ) -> torch.Tensor:
    """B5's log-sum-exp, (B, Hq, Tq), in natural-log units: ``ln Σ_j
    exp(q_i·k_j/√D)`` over the keys row ``i`` sees; -inf for a row that
    sees none.  The forward kernel writes it on request and the backward
    reads it."""
    return torch.logsumexp(_masked_logits(q, k, causal=causal, window=window,
                                          chunk=chunk, q_offset=q_offset),
                           dim=-1)


def attention_backward_ref(q, k, v, o, lse, do, *, causal: bool = True,
                           window: int | None = None,
                           chunk: int | None = None, q_offset: int = 0):
    """B5's backward: ``(dq, dk, dv)`` of ``o = attention_ref(q, k, v)``
    given ``do = ∂L/∂o``, from the forward's ``o`` and ``lse``, the
    algorithm of ``csrc/flash_attention_bwd.cu`` step by step:
    ``P = exp(S − lse)`` on visible entries (else 0), ``D = rowsum(dO ∘
    O)``, ``dV = Pᵀ dO``, ``dS = P ∘ (dO·Vᵀ − D)``, ``dQ = dS·K/√D``,
    ``dK = dSᵀ Q/√D``, with dK and dV summed over each kv head's
    ``group`` query heads.  A row with no visible key (lse = -inf)
    contributes nothing."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    kr = k.repeat_interleave(group, dim=2)
    vr = v.repeat_interleave(group, dim=2)
    mask = attention_mask(tq, tk, causal=causal, window=window, chunk=chunk,
                          q_offset=q_offset, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / math.sqrt(d)
    finite = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.where(mask, torch.exp(s - finite[..., None]),
                    torch.zeros_like(s))
    delta = (do * o).sum(-1).transpose(1, 2)                 # (B, Hq, Tq)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vr) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) / math.sqrt(d)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) / math.sqrt(d)
    return (dq, dk.reshape(b, tk, hkv, group, d).sum(3),
            dv.reshape(b, tk, hkv, group, d).sum(3))


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B4: ``h_t = a_t ⊙ h_{t-1} + b_t`` along axis 1 (h₋₁ = 0); a, b:
    (B, T, D).  The associative scan of the monoid
    ``(a₁,b₁)∘(a₂,b₂) = (a₁a₂, a₂b₁+b₂)`` in log₂ T doubling steps
    (Hillis–Steele), the counterpart of the reference's
    ``jax.lax.associative_scan`` oracle."""
    av, bv = a, b
    off = 1
    while off < a.shape[1]:
        bv = torch.cat([bv[:, :off], av[:, off:] * bv[:, :-off]
                        + bv[:, off:]], 1)
        av = torch.cat([av[:, :off], av[:, off:] * av[:, :-off]], 1)
        off *= 2
    return bv


def ssm_scan_sequential(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B4 as the literal per-token loop, one step after another (the
    reference's ``ssm_scan_sequential``; the CUDA kernel's order is
    :func:`ssm_scan_blocked`)."""
    h = torch.zeros_like(b[:, 0])
    out = torch.empty_like(b)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def ssm_scan_blocked(a: torch.Tensor, b: torch.Tensor, *, tile: int,
                     groups: int) -> torch.Tensor:
    """B4 in the CUDA kernel's order (``csrc/ssm_scan.cu``): T in time
    tiles of ``tile`` rows, taken in order with the carry between them;
    within a tile, ``groups`` sub-chunks of ``tile // groups`` rows, each
    scanned serially from 0 beside its running product ∏a; the
    sub-chunks' aggregates combined with the monoid
    ``(a₁,b₁)∘(a₂,b₂) = (a₁a₂, a₂b₁+b₂)`` in the kernel's doubling
    rounds; then each row's ``h = h_local + ∏a · carry_in``.  Rows past
    T enter as a = b = 0, as the kernel's zero-filled copies do."""
    if tile % groups:
        raise ValueError(f"ssm_scan_blocked: tile {tile} is not a "
                         f"multiple of groups {groups}")
    bsz, t_len, d = a.shape
    c = tile // groups
    n = -(-t_len // tile)
    pad = n * tile - t_len
    av = torch.nn.functional.pad(a, (0, 0, 0, pad)).reshape(
        bsz, n, groups, c, d)
    bv = torch.nn.functional.pad(b, (0, 0, 0, pad)).reshape(
        bsz, n, groups, c, d)
    # each sub-chunk's own scan from 0, and its running products
    hl, pa = torch.empty_like(bv), torch.empty_like(av)
    x = torch.zeros_like(bv[:, :, :, 0])
    p = torch.ones_like(x)
    for i in range(c):
        x = av[:, :, :, i] * x + bv[:, :, :, i]
        p = p * av[:, :, :, i]
        hl[:, :, :, i], pa[:, :, :, i] = x, p
    # inclusive scan of the aggregates over the groups (shuffle rounds)
    off = 1
    while off < groups:
        x = torch.cat([x[:, :, :off],
                       p[:, :, off:] * x[:, :, :-off] + x[:, :, off:]], 2)
        p = torch.cat([p[:, :, :off], p[:, :, off:] * p[:, :, :-off]], 2)
        off *= 2
    pe = torch.cat([torch.ones_like(p[:, :, :1]), p[:, :, :-1]], 2)
    xe = torch.cat([torch.zeros_like(x[:, :, :1]), x[:, :, :-1]], 2)
    out = torch.empty_like(bv)
    carry = torch.zeros_like(x[:, 0, 0])
    for k in range(n):
        h_in = pe[:, k] * carry[:, None] + xe[:, k]
        out[:, k] = hl[:, k] + pa[:, k] * h_in[:, :, None]
        carry = p[:, k, -1] * carry + x[:, k, -1]
    return out.reshape(bsz, n * tile, d)[:, :t_len]
