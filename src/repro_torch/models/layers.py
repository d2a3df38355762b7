"""Shared building blocks: norms, MLPs, rotary embeddings, the loss
(counterpart of ``repro/models/layers.py``).

Parameters are plain dicts of tensors whose keys follow the reference's
parameter tree.  On a mesh whose ``"model"`` axis spans M ranks
(``distributed.sharding.model_mesh``, installed by ``use_rules``) each
function computes on this rank's blocks of its leaves: the MLP's
``wi``/``wg`` columns and ``wo`` rows, the embedding table's and the
head's vocabulary rows; :func:`embed_lookup`, :func:`cross_entropy_sums`
and :func:`vocab_argmax` then combine the vocabulary shards.  Without
such a mesh the arithmetic is the unsharded one.  Initialisers draw from a ``torch.Generator``; the two
frameworks give different numbers from one seed, so the parity tests
carry the reference's weights across instead
(:func:`repro_torch.models.transformer.params_from_reference`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as sh


class MetaGenerator:
    """The stand-in for a generator on the meta device (a dry run's
    weights: shapes and dtypes, nothing drawn)."""

    device = torch.device("meta")


def _init(gen: torch.Generator, shape, scale, dtype) -> torch.Tensor:
    """``N(0, 1)·scale`` drawn in f32 on the generator's device (an
    empty tensor of ``dtype`` on the meta device)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
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
    approximation.  On a model axis ``wi``/``wg`` are column blocks and
    ``wo`` a row block: the hidden units are the rank's (the reference's
    ``mlp_act`` constraint), and the output is summed over ranks."""
    mesh = sh.model_mesh()
    x = C.copy_to_model(x, mesh)
    h = x @ p["wi"]
    if gated:
        h = F.silu(x @ p["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return C.reduce_from_model(h @ p["wo"], mesh)


def embed_init(gen, vocab, d, dtype) -> torch.Tensor:
    return _init(gen, (vocab, d), 1.0, dtype)


def embed_specs() -> tuple:
    """The logical axes of :func:`embed_init`'s table."""
    return ("vocab", "embed")


def vocab_mesh():
    """The model mesh (``sharding.model_mesh``) when the active rules
    split the vocabulary over ``"model"`` (the reference's ``"vocab"``
    rule), else None: under ``--embed-spec embedcol`` or ``replicated``
    (``launch.dryrun``) the table and the head are whole on every
    ``"model"`` rank, and so are the logits."""
    mesh = sh.model_mesh()
    if mesh is None:
        return None
    opts = (sh.current_rules() or {}).get("vocab")
    opts = opts if isinstance(opts, list) else [opts]
    return mesh if "model" in opts else None


def _vocab_block(n: int, mesh) -> int:
    """The first global vocabulary id of this rank's block of ``n``
    rows (or logit columns)."""
    r, _ = sh.model_coords(mesh)
    return r * n


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """``table[tokens]``.  On a model axis ``table`` is this rank's block
    of vocabulary rows: each rank looks up the ids it holds, zeros the
    others, and the rows are summed over ranks (each id has one
    owner, so the sum is exact)."""
    mesh = vocab_mesh()
    if mesh is None:
        return table[tokens]
    n = table.shape[0]
    local = tokens - _vocab_block(n, mesh)
    inside = (local >= 0) & (local < n)
    rows = table[torch.where(inside, local, 0)]
    rows = rows.masked_fill(~inside[..., None], 0)
    return C.reduce_from_model(rows, mesh)


def head_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``x @ head.T``; on a model axis this rank's vocabulary columns
    (``head`` its block of rows), left split (the reference's
    ``vocab_act`` constraint)."""
    return C.copy_to_model(x, vocab_mesh()) @ head.T


def vocab_argmax(logits: torch.Tensor) -> torch.Tensor:
    """``logits.argmax(-1)`` over the whole vocabulary; on a model axis
    ``logits`` holds this rank's columns, and the global argmax is the
    largest of the ranks' maxima, a tie going to the lowest global id,
    as ``argmax`` does."""
    mesh = vocab_mesh()
    idx = logits.argmax(-1)
    if mesh is None:
        return idx
    val = logits.gather(-1, idx[..., None])
    idx = idx[..., None] + _vocab_block(logits.shape[-1], mesh)
    vals = C.all_gather(val, mesh, "model", dim=-1)
    ids = C.all_gather(idx, mesh, "model", dim=-1)
    return ids.gather(-1, vals.argmax(-1, keepdim=True))[..., 0]


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """The whole vocabulary's logits from this rank's columns (the
    logits themselves without a model axis)."""
    mesh = vocab_mesh()
    if mesh is None:
        return logits
    return C.all_gather(logits.contiguous(), mesh, "model", dim=-1)


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
    (int64), apart.  On a model axis ``logits`` holds this rank's
    vocabulary columns: the logsumexp shifts by the max over every
    rank's columns and sums ``exp`` over ranks, and a label's logit
    comes from the rank that holds its column."""
    logits = logits.float()
    mask = (labels >= 0) & (labels < vocab)
    safe = torch.where(mask, labels, 0).long()
    mesh = vocab_mesh()
    if mesh is None:
        logz = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, safe[..., None])[..., 0]
    else:
        n = logits.shape[-1]
        m = C.max_over_model(logits.detach().amax(-1), mesh)
        sumexp = torch.exp(logits - m[..., None]).sum(-1)
        logz = torch.log(C.reduce_from_model(sumexp, mesh)) + m
        local = safe - _vocab_block(n, mesh)
        own = (local >= 0) & (local < n)
        mine = logits.gather(-1, torch.where(own, local, 0)[..., None])
        ll = C.reduce_from_model(mine[..., 0] * own, mesh)
    nll = (logz - ll) * mask
    return nll.sum(), mask.sum()
