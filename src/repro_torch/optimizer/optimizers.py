"""AdamW and Adafactor with f32 state over (possibly bf16) parameters
(counterpart of ``repro/optimizer/optimizers.py``).

* AdamW: f32 first and second moments, the default.
* Adafactor: a factored second moment (row and column statistics of
  each matrix, per layer of a stacked leaf), no first moment.
* Gradient clipping by global norm.  On a mesh each rank holds blocks
  of the parameters, gradients and moments, split over ``"data"``,
  ``"model"``, both or neither: the squared sum of a leaf's block is
  summed over the groups of the axes it is split over, so the norm is
  the full gradient's and counts every leaf once; AdamW then runs on
  the blocks unchanged.  Adafactor's row and column means, the mean of
  its row statistic and its update's RMS each reduce dimensions of a
  leaf: on a block, each sum is all-reduced over the groups that split
  the dimensions it reduces and divided by the full leaf's count (a
  dimension cut into blocks of different sizes, whole heads, carries
  its whole extent: :class:`Uneven`), so the statistics and the update
  are the whole leaf's.

Parameters, gradients and state are nested dicts of tensors with the
same keys (a model's parameter tree).  The arithmetic is the
reference's, in its order: clip, the moments, bias correction, ``+ wd ·
p``, then ``p − lr · δ``.  Unlike the reference's pure functions the
updates happen in place under ``torch.no_grad()``: the parameters, the
moments and the clipped gradients are written where they are, so no
step copies them.  ``state["step"]`` is a Python int and the learning
rate a Python float (the schedule evaluated on the host), so a step
reads nothing back from the device.  ``torch.optim.AdamW`` is not used:
its arithmetic rounds differently, and Adafactor has no counterpart
there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _lr_at(cfg: OptConfig, step: int) -> float:
    return float(cfg.lr(step)) if callable(cfg.lr) else float(cfg.lr)


def tree_paths(tree: dict, prefix: tuple = ()) -> Iterator[tuple]:
    """``(path, leaf)`` of a nested dict, in key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_leaves(tree: dict) -> list:
    return [v for _, v in tree_paths(tree)]


def tree_at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def tree_like(tree: dict, leaves) -> dict:
    """A tree of ``tree``'s keys holding ``leaves`` in
    :func:`tree_paths` order."""
    return _fill(tree, iter(leaves))


def _fill(node: dict, it) -> dict:
    # module level: a recursive closure would reference itself, a cycle
    # that keeps ``leaves`` (a whole tree of tensors: a step's gradients)
    # alive until the garbage collector next runs
    return {k: _fill(v, it) if isinstance(v, dict) else next(it)
            for k, v in node.items()}


def _zeros_tree(tree: dict, shape_of) -> dict:
    return tree_like(tree, [
        torch.zeros(shape_of(p), dtype=torch.float32, device=p.device)
        for p in tree_leaves(tree)])


def _leaf_groups(dims) -> tuple:
    """The groups that split any dimension of a leaf, each once, in
    dimension order."""
    return tuple(dict.fromkeys(g for gs in dims for g in gs))


class Uneven(tuple):
    """The groups that split a dimension into blocks of different sizes
    (whole heads, ``sharding.head_split``), and ``full``, the dimension's
    whole extent: what a mean over it divides by."""

    def __new__(cls, groups, full: int):
        out = super().__new__(cls, groups)
        out.full = full
        return out


def _extent(n: int, groups) -> int:
    """The whole extent of a dimension of which a block holds ``n``
    entries, split over ``groups``."""
    full = getattr(groups, "full", None)
    if full is not None:
        return full
    for g in groups:
        n *= dist.get_world_size(g)
    return n


def _sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    from repro_torch.distributed import collectives
    for g in groups:
        x = collectives.all_reduce_group(x, g)
    return x


def _mean(x: torch.Tensor, dim, groups, keepdim: bool = False
          ) -> torch.Tensor:
    """The mean over dimension ``dim`` of the full tensor of which ``x``
    is a block split over ``groups`` along it (``x.mean`` when none
    splits it); with ``dim`` None, the mean of every entry, ``groups``
    then one entry a dimension of ``x``."""
    if dim is None:
        flat = _leaf_groups(groups)
        if not flat:
            return x.mean()
        n = 1
        for size, gs in zip(x.shape, groups):
            n *= _extent(size, gs)
        return _sum_over(x.reshape(-1).sum(0), flat) / n
    if not groups:
        return x.mean(dim, keepdim=keepdim)
    return _sum_over(x.sum(dim, keepdim=keepdim), groups) / _extent(
        x.shape[dim], groups)


def global_norm(tree: dict, groups=None) -> torch.Tensor:
    """√(Σ x²) over every leaf, in f32 (a device scalar).

    With ``groups`` the leaves are blocks: one entry a leaf (in
    :func:`tree_leaves` order), a tuple with one entry a dimension, the
    process groups of the mesh axes that split it (``()`` where it is
    whole).  A leaf's squared sum is all-reduced over each group that
    splits it, the leaves split alike stacked into one call a group; a
    whole leaf's is taken once.  The sum then runs in leaf order, so on
    groups of one rank the norm is the unsharded one bit for bit."""
    sq = [x.float().square().sum() for x in tree_leaves(tree)]
    if groups is not None:
        split: dict = {}
        for i, dims in enumerate(groups):
            gs = _leaf_groups(dims)
            if gs:
                split.setdefault(gs, []).append(i)
        for gs, idx in split.items():
            summed = _sum_over(torch.stack([sq[i] for i in idx]), gs)
            for j, i in enumerate(idx):
                sq[i] = summed[j]
    return torch.sqrt(sum(sq))


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float, groups=None):
    """Scale ``grads`` in place by ``min(1, max_norm / max(norm, 1e-9))``;
    returns ``(grads, norm)``, the norm before clipping (of the full
    gradient, over ``groups`` as in :func:`global_norm`)."""
    norm = global_norm(grads, groups)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, norm


def _apply(p: torch.Tensor, delta: torch.Tensor, lr: float) -> None:
    """``p ← p − lr · δ`` in f32, stored in ``p``'s dtype."""
    if p.dtype == torch.float32:
        p.sub_(delta, alpha=lr)
    else:
        p.copy_(p.float().sub_(delta, alpha=lr))


# -- AdamW ------------------------------------------------------------------


def adamw_init(params: dict) -> dict:
    return {"m": _zeros_tree(params, lambda p: p.shape),
            "v": _zeros_tree(params, lambda p: p.shape),
            "step": 0}


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: dict, grads: dict, state: dict,
                 groups=None):
    """One AdamW step in place; returns ``(params, state, grad_norm)``.
    On blocks, ``groups`` makes the clipping norm the full gradient's
    (:func:`global_norm`)."""
    step = state["step"] + 1
    lr = _lr_at(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, groups)
    bc1, bc2 = 1 - cfg.b1 ** step, 1 - cfg.b2 ** step
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g32 = g.float()
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        delta.add_(p.float(), alpha=cfg.weight_decay)
        _apply(p, delta, lr)
    state["step"] = step
    return params, state, gnorm


# -- Adafactor --------------------------------------------------------------


def adafactor_init(params: dict) -> dict:
    def one(p):
        dev = p.device
        if p.dim() >= 2:
            return {"r": torch.zeros(p.shape[:-1], device=dev),
                    "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                     device=dev)}
        return {"v": torch.zeros(p.shape, device=dev)}
    return {"f": tree_like(params, [one(p) for p in tree_leaves(params)]),
            "step": 0}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, params: dict, grads: dict,
                     state: dict, groups=None):
    """One Adafactor step in place (factored second moment of every
    matrix, per layer of a stacked leaf; relative update clipping, d =
    1); returns ``(params, state, grad_norm)``.  On blocks, ``groups``
    (as in :func:`global_norm`) makes each mean the whole leaf's."""
    step = state["step"] + 1
    lr = _lr_at(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, groups)
    decay = 1.0 - step ** -0.8
    for i, (path, p) in enumerate(tree_paths(params)):
        dims = ((),) * p.dim() if groups is None else groups[i]
        g32 = tree_at(grads, path).float()
        f = tree_at(state["f"], path)
        g2 = g32.square().add_(1e-30)
        if p.dim() >= 2:
            r = f["r"].mul_(decay).add_(_mean(g2, -1, dims[-1]),
                                        alpha=1 - decay)
            c = f["c"].mul_(decay).add_(_mean(g2, -2, dims[-2]),
                                        alpha=1 - decay)
            v = (r[..., None] * c[..., None, :]
                 / torch.clamp(_mean(r, -1, dims[-2],
                                     keepdim=True)[..., None], min=1e-30))
        else:
            v = f["v"].mul_(decay).add_(g2, alpha=1 - decay)
        delta = g32 / torch.sqrt(v + 1e-30)
        rms = torch.sqrt(_mean(delta.square(), None, dims))
        delta = delta / torch.clamp(rms, min=1.0)
        delta.add_(p.float(), alpha=cfg.weight_decay)
        _apply(p, delta, lr)
    state["step"] = step
    return params, state, gnorm


def make_optimizer(cfg: OptConfig, groups=None):
    """``(init(params) → state, update(params, grads, state) → (params,
    state, grad_norm))`` for ``cfg.kind``; ``groups``, for blocks, as in
    :func:`global_norm`."""
    if cfg.kind == "adamw":
        return adamw_init, lambda p, g, s: adamw_update(cfg, p, g, s,
                                                        groups)
    if cfg.kind == "adafactor":
        return adafactor_init, lambda p, g, s: adafactor_update(
            cfg, p, g, s, groups)
    raise KeyError(cfg.kind)
