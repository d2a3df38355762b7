"""The train, prefill and serve step factories (counterpart of
``repro/launch/steps.py``).

``train_step`` differentiates :func:`repro_torch.models.transformer.
loss_fn` with ``torch.autograd.grad`` over the parameter leaves (each a
tensor with ``requires_grad``) and hands the gradients to the optimizer,
which updates parameters and state in place.  With ``accum_steps`` > 1
the batch is cut into that many contiguous micro-batches along its
first axis (the reference's reshape), their gradients summed in f32 in
micro-batch order and divided once; ``metrics["loss"]`` is then the
*last* micro-batch's loss, not their mean — the reference's scan carry
keeps only the last one, and the port keeps that for parity.

:func:`make_sharded_train_step` is the sharded form on a ``(data,
model)`` mesh: ZeRO-3 on ``"data"`` (each rank holds blocks of the
parameters and the optimizer state, gathers each layer's ``"data"``
dimensions just before the layer runs, runs forward and backward on its
own rows of the global batch, reduce-scatters each layer's gradient back
to blocks as the backward leaves the layer and updates its blocks) and
tensor parallelism on ``"model"`` (the ``"model"`` dimensions stay split
through the step: the model code computes on the rank's blocks,
``models.transformer``'s docstring).  On a multi-pod mesh (the
reference's ``(2, 16, 16)``) the batch is split over ``("pod", "data")``
and the parameters are replicated across ``"pod"``, as the reference's
rules lay them out: the loss, the MoE capacity and every gradient are
summed over the pods too.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch.rules import make_rules
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optimizer import OptConfig, make_optimizer
from repro_torch.optimizer.optimizers import (Uneven, tree_at, tree_leaves,
                                            tree_like, tree_paths)

#: the mesh axis the batch and the ZeRO-3 blocks are split over
DATA = "data"
#: the mesh axis of tensor-parallel compute
MODEL = "model"
#: a multi-pod mesh's outer axis: the batch is split over it and
#: ``"data"``, the parameters replicated across it (the reference's rules)
POD = "pod"


def batch_axis(mesh):
    """The axis (or axes, outermost first) the sharded step splits the
    global batch over: ``"data"``, or ``("pod", "data")`` where a pod
    axis spans more than one rank."""
    return (POD, DATA) if mesh.shape.get(POD, 1) > 1 else DATA


def _over_batch(x, mesh):
    """The sum of ``x`` over every rank that holds other rows of the
    global batch."""
    for a in sh.entry_axes(batch_axis(mesh)):
        x = collectives.all_reduce(x, mesh, a)
    return x


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *,
                    remat: str = "full", accum_steps: int = 1):
    """``(train_step, opt_init)``; ``train_step(params, opt_state,
    batch) → (params, opt_state, {"loss", "grad_norm"})`` (device
    scalars), ``params`` and ``opt_state`` updated in place.  Every leaf
    of ``params`` must require grad; a leaf the loss does not reach gets
    a zero gradient, as in the reference."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps {accum_steps} < 1")
    opt_init, opt_update = make_optimizer(opt_cfg)

    def grads_of(leaves, params, batch):
        loss, _ = T.loss_fn(params, cfg, batch, remat=remat)
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        if accum_steps == 1:
            loss, grads = grads_of(leaves, params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % accum_steps:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{accum_steps} micro-batches")
            mb = n // accum_steps
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, g = grads_of(leaves, params, micro)
                for acc, x in zip(grads, g):
                    acc.add_(x.float())
            for acc in grads:
                acc.div_(accum_steps)
        params, opt_state, gnorm = opt_update(
            params, tree_like(params, grads), opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt_init


def axis_dim(spec: P, axis: str):
    """The dimension a spec splits over ``axis``, or None."""
    for i, e in enumerate(spec):
        if axis in sh.entry_axes(e):
            return i
    return None


def data_dim(spec: P):
    """The dimension a spec splits over the data axis, or None."""
    return axis_dim(spec, DATA)


def _check_parallel(cfg: ModelConfig, mesh) -> None:
    """The refusals of the sharded step: what it would compute
    differently from the reference."""
    other = {a: n for a, n in mesh.shape.items()
             if a not in (POD, DATA, MODEL) and n > 1}
    if other:
        raise NotImplementedError(
            f"sharded train step: only {POD!r}, {DATA!r} and {MODEL!r} "
            f"may span more than one rank ({mesh.shape})")
    T.check_model_axis(cfg, mesh.shape.get(MODEL, 1))


def _split_groups(mesh, spec: P) -> tuple:
    """One tuple a dimension of a leaf laid out by ``spec``: the process
    groups of the mesh axes of more than one rank that split it (for a
    replicated head's ``"model"`` dimension, the ranks of distinct
    heads, ``sharding.kv_groups``).  A dimension cut by a head table
    (``P.table``) carries its whole extent (``optimizers.Uneven``), so
    Adafactor's means over it divide by that and count each head once."""
    def group(a):
        if a == MODEL and spec.rep > 1:
            return sh.kv_groups(mesh, spec.rep)[0]
        return collectives.group_of(mesh, a)

    def dim(e):
        gs = tuple(group(a) for a in sh.entry_axes(e)
                   if sh.block_count(a, mesh, spec.rep) > 1)
        if spec.table is not None and MODEL in sh.entry_axes(e):
            return Uneven(gs, sh.table_extent(spec.table))
        return gs
    return tuple(dim(e) for e in spec)


def micro_batches(mesh, batch: dict, accum_steps: int) -> list[dict]:
    """This rank's ``accum_steps`` micro-batches: its contiguous share of
    each of the reference's global micro-batches.  The rank holds global
    rows ``[r·B/W, (r+1)·B/W)`` of a batch of B rows over W ``"data"``
    ranks; micro-batch i of the global batch is rows ``[i·B/a,
    (i+1)·B/a)``, and the rank's share of it rows ``[i·B/a + r·B/(aW),
    i·B/a + (r+1)·B/(aW))``, taken from the batch gathered over
    ``"data"`` (the tokens and labels, a few hundred KB).  With W = 1 it
    is the local batch cut in order, with a = 1 the batch itself."""
    axes = sh.entry_axes(batch_axis(mesh))
    w = math.prod(mesh.shape[a] for a in axes)
    n = next(iter(batch.values())).shape[0]
    if n % accum_steps:
        raise ValueError(f"a global batch of {n * w} rows does not split "
                         f"into {accum_steps} micro-batches over {w} data "
                         f"ranks")
    if accum_steps == 1:
        return [batch]
    for a in reversed(axes):                 # the outer axis major
        if mesh.shape[a] > 1:
            batch = {k: collectives.all_gather(v, mesh, a, 0)
                     for k, v in batch.items()}
    share = n // accum_steps
    first = sh.block_index(axes, mesh) * share
    mb = share * w
    return [{k: v[i * mb + first:i * mb + first + share]
             for k, v in batch.items()} for i in range(accum_steps)]


def layer_gatherer(cfg: ModelConfig, mesh, specs: dict):
    """The sharded step's ``sharding.LayerGatherer`` over ``"data"`` for
    ``cfg``'s parameters laid out by ``specs``: each stacked leaf one
    layer at a time, the rest resident.  Its ``bound(blocks)`` is what
    ``collectives.STATS["gathered_peak_bytes"]`` stays within."""
    return sh.LayerGatherer(mesh, specs, T.param_specs(cfg), DATA)


def make_sharded_grads(cfg: ModelConfig, mesh, specs: dict, *,
                       remat: str = "full", accum_steps: int = 1):
    """``grads(blocks, batch) → (loss, aux, grads)``: steps 1 to 3 of
    :func:`make_sharded_train_step` — the global batch's loss and MoE
    load-balance term (device scalars) and the gradient of the loss
    with respect to this rank's ``blocks``, in blocks (a list in
    ``tree_leaves`` order).

    The gradient is taken with respect to the blocks themselves: the
    model gathers each layer where it runs (``sharding.LayerGatherer``),
    and each gather's backward reduce-scatters that layer's gradient as
    the backward leaves it.  A leaf not split over ``"data"`` (a norm) is
    all-reduced once, after the backward (after the last micro-batch's,
    with ``accum_steps`` > 1: the micro-batches' gradients are added in
    f32 in micro-batch order, each already reduce-scattered, and divided
    once)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps {accum_steps} < 1")
    _check_parallel(cfg, mesh)
    rules = make_rules(mesh, "train")
    dims = [data_dim(s) for s in tree_leaves(specs)]
    gatherer = layer_gatherer(cfg, mesh, specs)
    bax = batch_axis(mesh)
    pods = mesh.shape.get(POD, 1) > 1
    # an MoE layer's aux is each batch rank's share of the global term
    aux_shared = cfg.family == "moe" and (mesh.shape[DATA] > 1 or pods)

    def grads_of(leaves, params, batch):
        with sh.use_rules(mesh, rules, batch_axis=bax), \
                sh.use_gatherer(gatherer), \
                collectives.reshard_after_forward():
            nll_sum, count, aux = T.loss_sums(params, cfg, batch,
                                              remat=remat)
        count = _over_batch(count, mesh).clamp(min=1)
        loss = nll_sum / count + 0.01 * aux
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        total = _over_batch(nll_sum.detach(), mesh)
        aux = aux.detach()
        if aux_shared:
            aux = _over_batch(aux, mesh)
        return total / count + 0.01 * aux, aux, grads

    def sharded_grads(blocks, batch):
        micros = micro_batches(mesh, batch, accum_steps)
        leaves = [b.detach().requires_grad_(True)
                  for b in tree_leaves(blocks)]
        params = tree_like(blocks, leaves)
        if accum_steps == 1:
            loss, aux, grads = grads_of(leaves, params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            for micro in micros:
                loss, aux, g = grads_of(leaves, params, micro)
                for acc, x in zip(grads, g):
                    acc.add_(x.float())
            for acc in grads:
                acc.div_(accum_steps)
        del params, leaves
        out = [collectives.all_reduce(g, mesh, DATA) if d is None else g
               for g, d in zip(grads, dims)]
        if pods:        # every pod holds the whole of each block
            out = [collectives.all_reduce(g, mesh, POD) for g in out]
        return loss, aux, out

    return sharded_grads


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: OptConfig, mesh,
                            specs: dict, *, remat: str = "full",
                            accum_steps: int = 1):
    """``(train_step, opt_init)`` on a ``(data, model)`` mesh.

    ``specs`` is the parameters' tree of :class:`P` (``tree_specs`` of
    :func:`~repro_torch.models.transformer.param_specs` under the
    ``"train"`` rules); ``train_step(blocks, opt_state, batch) →
    (blocks, opt_state, {"loss", "grad_norm"})`` takes this rank's
    blocks (:func:`param_blocks`; ``opt_init(blocks)`` makes the
    state's) and this rank's rows of the global batch (every rank of a
    ``"model"`` group reads the same rows), and updates blocks and state
    in place:

    1. each layer's leaves have their ``"data"`` dimension all-gathered
       just before the layer runs, inside the callable its remat wrapper
       runs (``remat="full"`` and ``"selective"`` gather again in the
       recompute; with ``"none"`` the gathered weights are dropped after
       the layer's forward and gathered again in its backward,
       ``collectives.reshard_after_forward``); the leaves outside the
       stacks once a forward (``models.transformer``'s docstring); the
       ``"model"`` dimension stays this rank's block;
    2. forward and backward on the rank's rows under the ``"train"``
       rules, the model code computing tensor parallel over ``"model"``
       (every rank of a ``"model"`` group computes the same loss); the
       loss is divided by the count of valid labels of the *global*
       batch (the sums and the counts are reduced over ``"data"``
       apart, so ranks holding different numbers of labels — a VLM's
       ``-1`` padding — weigh as in one batch); an MoE layer reckons
       capacity, slots and its load-balance term over the global batch
       (``models/moe.py``), each rank's loss holding its share of the
       term;
    3. each gradient reduce-scattered over ``"data"`` back to its block
       by its gather's backward, as the backward leaves the layer
       (all-reduced once after the backward for a leaf not split over
       ``"data"``).  Over
       ``"model"`` no step is needed: a split leaf's gradient is its
       block's, a replicated leaf used on the replicated residual
       stream (the norms) gets the whole gradient on every rank, and a
       replicated leaf whose use is split (``gate_proj``,
       ``decay_bias``) passes ``copy_to_model`` in the model, whose
       backward sums the ranks' shares;
    4. clipping by the full gradient's norm (each leaf's squared sum
       summed over the axes it is split over) and the optimizer, on the
       blocks: AdamW's moments are elementwise; Adafactor's row and
       column statistics and its update's RMS are summed over the axes
       that split the dimensions they reduce
       (``optimizer.make_optimizer``'s ``groups``).

    ``metrics["loss"]`` is the global batch's.  The collectives run on
    a one-rank mesh too, as copies, and the step is then the unsharded
    one bit for bit.  The most gathered bytes alive at once
    (``collectives.STATS["gathered_peak_bytes"]``) are at most the
    entries outside the stacks plus one layer's
    (``layer_gatherer(cfg, mesh, specs).bound(blocks)``).  With
    ``accum_steps`` = a > 1 each rank's micro-batch i is its share of the
    reference's global micro-batch i (:func:`micro_batches`), so an MoE
    layer's capacity and slots are those of the reference's micro-batch;
    each micro-batch's loss divides by its own global label count, the
    gradients are averaged over a and ``metrics["loss"]`` is the last
    micro-batch's."""
    grads_fn = make_sharded_grads(cfg, mesh, specs, remat=remat,
                                  accum_steps=accum_steps)
    opt_init, opt_update = make_optimizer(
        opt_cfg, [_split_groups(mesh, s) for s in tree_leaves(specs)])

    def train_step(blocks, opt_state, batch):
        loss, _, grads = grads_fn(blocks, batch)
        blocks, opt_state, gnorm = opt_update(
            blocks, tree_like(blocks, grads), opt_state)
        return blocks, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt_init


def param_blocks(params: dict, specs: dict, mesh) -> dict:
    """This rank's compute blocks of a full parameter tree laid out by
    ``specs`` (copies, so the full tree can go; a fused leaf's block is
    its parts' blocks side by side, ``sharding.block_parts``).  Leaves
    are matched by path and the blocks come in ``specs``' key order, so
    a tree in another order (the reference's, sorted) lines up with the
    step's specs."""
    return tree_like(specs, [
        sh.take_block(tree_at(params, path), s, mesh).clone()
        for path, s in tree_paths(specs)])


def gather_params(blocks: dict, specs: dict, mesh) -> dict:
    """The full parameter tree, in the reference's layout, from every
    rank's blocks (detached; in ``specs``' key order)."""
    return tree_like(specs, [
        sh.gather_block(tree_at(blocks, path).detach(), s, mesh)
        for path, s in tree_paths(specs)])


def state_specs(opt_state: dict, specs: dict) -> dict:
    """A :class:`P` tree for an optimizer state over blocks laid out by
    ``specs``: AdamW's moments as their parameters; Adafactor's row
    statistic ``r`` as its parameter without the last dimension, its
    column statistic ``c`` without the second-to-last, an unfactored
    ``v`` as the parameter; the step replicated."""
    def factored(f, spec):
        if "v" in f:
            return {"v": spec}
        return {"r": spec.like(spec[:-1]),
                "c": spec.like((*spec[:-2], spec[-1]), spec.fused)}

    def entry(k):
        if k in ("m", "v"):
            return specs
        if k == "f":
            return tree_like(specs, [
                factored(tree_at(opt_state["f"], path), s)
                for path, s in tree_paths(specs)])
        return P()
    return {k: entry(k) for k in opt_state}


def make_prefill_step(cfg: ModelConfig, remat: str = "none"):
    """``prefill(params, batch) → (logits[:, -1:], cache)``; ``batch``
    holds ``cache`` and ``tokens`` / ``embeds`` / ``enc_embeds``."""
    def prefill(params, batch):
        logits, cache = T.forward(
            params, cfg, batch.get("tokens"), embeds=batch.get("embeds"),
            enc_embeds=batch.get("enc_embeds"), cache=batch["cache"],
            remat=remat)
        return logits[:, -1:], cache
    return prefill


def make_serve_step(cfg: ModelConfig):
    """``serve(params, batch) → (next_tok (B,), cache)``: one decode step
    of ``batch["tokens"]`` (B, 1), greedy (sampling lives in the serving
    loop); the token ids are int64, torch's index type (the reference's
    int32).  On a model axis the argmax runs over every rank's
    vocabulary columns (``layers.vocab_argmax``)."""
    def serve(params, batch):
        logits, cache = T.decode_step(params, cfg, batch["tokens"],
                                      batch["cache"])
        return L.vocab_argmax(logits[:, -1]), cache
    return serve
