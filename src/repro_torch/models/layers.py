"""Shared building blocks: norms, MLPs, rotary embeddings, the loss
(counterpart of ``repro/models/layers.py``).

Parameters are plain dicts of tensors whose keys follow the reference's
parameter tree.  Initialisers draw from a ``torch.Generator``; the two
frameworks give different numbers from one seed, so the parity tests
carry the reference's weights across instead
(:func:`repro_torch.models.transformer.params_from_reference`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _init(gen: torch.Generator, shape, scale, dtype) -> torch.Tensor:
    """``N(0, 1)·scale`` drawn in f32 on the generator's device."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(scale).to(dtype)


def rmsnorm_init(d, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm_specs() -> tuple:
    """The logical axes of :func:`rmsnorm_init`'s scale."""
    return ("norm",)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """f32 math, cast back to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def mlp_init(gen, d, f, gated, dtype) -> dict:
    scale = 1.0 / math.sqrt(d)
    p = {"wi": _init(gen, (d, f), scale, dtype),
         "wo": _init(gen, (f, d), 1.0 / math.sqrt(f), dtype)}
    if gated:
        p["wg"] = _init(gen, (d, f), scale, dtype)
    return p


def mlp_specs(gated: bool) -> dict:
    """The logical axes of :func:`mlp_init`'s leaves."""
    s = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if gated:
        s["wg"] = ("embed", "mlp")
    return s


def mlp_apply(p: dict, x: torch.Tensor, gated: bool) -> torch.Tensor:
    """SwiGLU (``wg`` present) or GELU; JAX's ``gelu`` is the tanh
    approximation."""
    h = x @ p["wi"]
    if gated:
        h = F.silu(x @ p["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"]


def embed_init(gen, vocab, d, dtype) -> torch.Tensor:
    return _init(gen, (vocab, d), 1.0, dtype)


def embed_specs() -> tuple:
    """The logical axes of :func:`embed_init`'s table."""
    return ("vocab", "embed")


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Half-split rotary embedding.  x: (..., T, H, hd); positions:
    (..., T)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs          # (..., T, half)
    ang = ang[..., None, :]                             # over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int
                  ) -> torch.Tensor:
    """Mean cross-entropy over the valid labels (``0 <= label < vocab``;
    ``-1`` and padded ids are masked); ``logits`` (..., Vp) may be
    vocab-padded, and the logsumexp runs over all Vp columns, as the
    reference's does.  f32."""
    nll_sum, count = cross_entropy_sums(logits, labels, vocab)
    return nll_sum / count.clamp(min=1)


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor,
                       vocab: int):
    """:func:`cross_entropy`'s sum over the valid labels and their count
    (int64), apart."""
    logits = logits.float()
    mask = (labels >= 0) & (labels < vocab)
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, safe[..., None])[..., 0]
    nll = (logz - ll) * mask
    return nll.sum(), mask.sum()
