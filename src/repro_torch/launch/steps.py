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
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optimizer import OptConfig, make_optimizer
from repro_torch.optimizer.optimizers import tree_leaves, tree_like


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
    int32)."""
    def serve(params, batch):
        logits, cache = T.decode_step(params, cfg, batch["tokens"],
                                      batch["cache"])
        return logits[:, -1].argmax(-1), cache
    return serve
