"""The rank side of ``tests/test_torch_model_axis.py`` and
``tests/test_torch_moe_axis.py``: one function a case, run on every
rank of a spawned gloo world whose mesh has a ``"data"`` and a
``"model"`` axis (``make_host_mesh(M)``: ``(W / M, M)``).

Imported by the spawned ranks, so it imports the port and numpy only
(no JAX): the test process builds every input with the reference's own
code (its weights as numpy trees, carried across with
``params_from_reference`` and cut into the rank's blocks with
``steps.param_blocks``), and holds what each rank returns against the
reference.  :func:`run_cases` runs a whole batch in one world.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager, save_checkpoint
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.launch import serve
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.rules import make_rules
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optimizer import OptConfig, cosine_schedule
from repro_torch.optimizer.optimizers import (tree_at, tree_leaves,
                                            tree_like, tree_paths)



def np_tree(tree, copy=False):
    if isinstance(tree, dict):
        return {k: np_tree(v, copy) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        out = tree.detach().cpu().numpy()
        return out.copy() if copy else out
    return tree


def _cfg(arch):
    """``arch``'s smoke config, or ``arch`` itself (a ``ModelConfig``)."""
    return configs.get(arch, smoke=True) if isinstance(arch, str) else arch


def _blocks(mesh, arch, tree, kind="train"):
    """The smoke config of ``arch`` (or the config ``arch``), the rules
    of ``kind``, the specs, and this rank's blocks of the reference's
    weights ``tree``."""
    cfg = _cfg(arch)
    full = T.params_from_reference(tree, cfg, "cpu")
    rules = make_rules(mesh, "train" if kind == "model_only" else kind)
    if kind in ("decode", "model_only"):
        rules["embed"] = None         # as serve_batch: split over "model"
    specs = sh.tree_specs(T.param_specs(cfg), full, mesh, rules)
    return cfg, rules, specs, steps.param_blocks(full, specs, mesh)


def case_grad(mesh, arch, tree, batch):
    """The loss and every gradient leaf (gathered to the reference's
    layout) of one batch, with ``remat="full"`` (the checkpointed layers
    replay their collectives in the backward); each leaf's block size,
    spec and, for a recurrent model, the block of ``w_in``."""
    cfg, rules, specs, blocks = _blocks(mesh, arch, tree)
    leaves = tree_leaves(blocks)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with sh.use_rules(mesh, rules):
        loss, (ce, aux) = T.loss_fn(blocks, cfg, tb, remat="full")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    out = {"loss": float(loss.detach()),
           "grads": np_tree(steps.gather_params(tree_like(blocks, grads),
                                                specs, mesh)),
           "blocks": {path: (p.numel(), repr(s)) for (path, p), s in zip(
               tree_paths(blocks), tree_leaves(specs))}}
    if "rec" in blocks["stack"]:
        out["w_in"] = blocks["stack"]["rec"]["w_in"].detach().numpy()
    return out


def case_logits(mesh, arch, tree, toks, emitted, t_max):
    """Teacher forced under the ``"decode"`` rules: the last position's
    logits (every rank's columns) after a prefill of ``toks`` and after
    each decode step fed ``emitted``'s columns; the cache's block
    shapes."""
    cfg, rules, _, blocks = _blocks(mesh, arch, tree, "decode")
    b = toks.shape[0]
    with sh.use_rules(mesh, rules):
        cache = T.init_cache(cfg, b, t_max, torch.float32, "cpu")
        shapes = {k: tuple(v.get("a", v)["k"].shape) if isinstance(v, dict)
                  else tuple(v.shape) for k, v in cache.items()
                  if k in ("layers", "shared", "state")}
        enc = (torch.zeros((b, toks.shape[1], cfg.d_model))
               if cfg.family == "encdec" else None)
        logits, cache = T.forward(blocks, cfg, torch.from_numpy(toks).long(),
                                  enc_embeds=enc, cache=cache)
        out = [L.gather_vocab(logits[:, -1]).numpy()]
        for i in range(emitted.shape[1]):
            logits, cache = T.decode_step(
                blocks, cfg, torch.from_numpy(emitted[:, i:i + 1]).long(),
                cache)
            out.append(L.gather_vocab(logits[:, -1]).numpy())
    return out, shapes


def case_serve(mesh, arch, tree, prompts, max_new, t_max):
    """``serve_batch`` on the world's mesh with the reference's weights:
    the tokens and the last step's logits."""
    cfg = _cfg(arch)
    reqs = [serve.Request(p, max_new=max_new) for p in prompts]
    stats = serve.serve_batch(cfg, reqs, t_max=t_max, device="cpu",
                              params=T.params_from_reference(tree, cfg,
                                                             "cpu"),
                              mesh=mesh)
    return np.array([r.out for r in reqs]), stats["last_logits"].numpy()


def case_steps(mesh, arch, tree, batches, lr, warmup, total,
               kind="adamw", accum_steps=1):
    """``make_sharded_train_step`` (the optimizer ``kind``, cosine
    schedule, ``accum_steps`` micro-batches) fed this rank's rows of each
    global batch: each step's loss, grad norm and full parameters."""
    cfg, rules, specs, blocks = _blocks(mesh, arch, tree)
    step_fn, init = steps.make_sharded_train_step(
        cfg, OptConfig(kind=kind, lr=cosine_schedule(lr, warmup, total)),
        mesh, specs, remat="none", accum_steps=accum_steps)
    state = init(blocks)
    out = []
    for b in batches:
        with sh.use_rules(mesh, rules):
            rows = {k: sh.put(torch.from_numpy(v), ("batch",))
                    for k, v in b.items()}
        blocks, state, m = step_fn(blocks, state, rows)
        # copies: a leaf held whole comes back as the live block
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    np_tree(steps.gather_params(blocks, specs, mesh),
                            copy=True)))
    return out


def case_train(mesh, arch, kw):
    """``train(model_parallel=…)`` on the world: the losses and the
    gathered parameters."""
    params, losses = train_mod.train(arch, device="cpu", log_every=100,
                                     **kw)
    return losses, np_tree(params)


def case_ckpt(mesh, arch, tree, save_dir, whole_dir):
    """Every rank saves its blocks of the reference's weights (and their
    AdamW moments, filled with the weights) as a sharded checkpoint at
    step 1 in ``save_dir``; then restores, in place, the checkpoint a
    one-rank run saved whole in ``whole_dir`` into fresh blocks.
    Returns the restored tree gathered and its step."""
    cfg, _, specs, blocks = _blocks(mesh, arch, tree)
    state = {"m": tree_like(blocks, [p.clone() for p in
                                     tree_leaves(blocks)]),
             "v": tree_like(blocks, [p.clone() for p in
                                     tree_leaves(blocks)]),
             "step": 1}
    shardings = {"params": specs, "opt": steps.state_specs(state, specs)}
    save_checkpoint(save_dir, 1, {"params": blocks, "opt": state},
                    shardings=shardings, mesh=mesh)
    target = {"params": tree_like(blocks, [torch.zeros_like(p) for p in
                                           tree_leaves(blocks)]),
              "opt": {"m": tree_like(blocks, [torch.zeros_like(p) for p in
                                              tree_leaves(blocks)]),
                      "v": tree_like(blocks, [torch.zeros_like(p) for p in
                                              tree_leaves(blocks)]),
                      "step": 0}}
    leaves = tree_leaves(target["params"])
    got, step = CheckpointManager(whole_dir, mesh=mesh).restore_latest(
        target, shardings, inplace=True)
    assert got is target and all(a is b for a, b in zip(
        leaves, tree_leaves(got["params"])))
    return step, np_tree(steps.gather_params(got["params"], specs, mesh)), \
        np_tree(steps.gather_params(got["opt"]["m"], specs, mesh))


def case_collectives(mesh, x, logits):
    """The model-axis operators on this rank's ``x[rank]``: the forward
    values and the gradients they pass back; the global argmax of
    ``logits`` from this rank's columns."""
    r = mesh.coords["model"]
    cols = logits.shape[-1] // mesh.shape["model"]
    with sh.use_rules(mesh, make_rules(mesh, "decode")):
        argmax = L.vocab_argmax(torch.from_numpy(
            logits[:, r * cols:(r + 1) * cols])).numpy()
    mine = torch.from_numpy(x[r]).requires_grad_(True)
    copied = collectives.copy_to_model(mine, mesh)
    (g_copy,) = torch.autograd.grad((copied * (r + 1)).sum(), mine)
    reduced = collectives.reduce_from_model(mine, mesh)
    (g_red,) = torch.autograd.grad((reduced * (r + 1)).sum(), mine)
    return {"copy": copied.detach().numpy(), "g_copy": g_copy.numpy(),
            "reduce": reduced.detach().numpy(), "g_reduce": g_red.numpy(),
            "max": collectives.max_over_model(mine, mesh).numpy(),
            "argmax": argmax}


def case_moe_grad(mesh, arch, tree, batch, accum_steps=1):
    """An MoE model on this rank's rows of ``batch``: the global loss,
    ``aux`` and gradient of ``steps.make_sharded_grads`` (every leaf
    gathered to the reference's layout; with ``accum_steps`` > 1 the
    micro-batches' mean, and nothing more), and a forward's dropped
    masks, chosen experts and ``aux`` share, gathered over ``"data"``
    into the global batch's (the step's rules with ``"embed"`` whole, so
    the blocks are split over ``"model"`` only)."""
    cfg, rules, specs, blocks = _blocks(mesh, arch, tree)
    with sh.use_rules(mesh, rules):
        rows = {k: sh.put(torch.from_numpy(v), ("batch",))
                for k, v in batch.items()}
    loss, aux, grads = steps.make_sharded_grads(
        cfg, mesh, specs, remat="full", accum_steps=accum_steps)(blocks, rows)
    out = {"loss": float(loss), "aux": float(aux),
           "grads": np_tree(steps.gather_params(tree_like(blocks, grads),
                                                specs, mesh))}
    if accum_steps > 1:
        return out
    cfg, rules, _, blocks = _blocks(mesh, arch, tree, "model_only")
    with sh.use_rules(mesh, rules, batch_axis="data"), torch.no_grad():
        _, got, _ = T.forward(blocks, cfg, rows["tokens"], return_aux=True)
    share = collectives.all_reduce(got.total, mesh, "data")
    out.update(aux_forward=float(share), **{
        k: [collectives.all_gather(m, mesh, "data").numpy()
            for m in getattr(got, k)] for k in ("dropped", "chosen")})
    return out


def case_adafactor_ckpt(mesh, arch, tree, state, save_dir, whole_dir):
    """Every rank saves its blocks of the reference's weights and of the
    full Adafactor state ``state`` (``{"f": …, "step": n}``, numpy) as a
    sharded checkpoint in ``save_dir`` (``steps.state_specs``: ``r``
    without the leaf's last dimension, ``c`` without its second-to-last);
    then restores the checkpoint a one-rank run saved whole in
    ``whole_dir`` into fresh blocks.  Returns the restored state
    gathered whole and its step."""
    cfg, _, specs, blocks = _blocks(mesh, arch, tree)
    from repro_torch.optimizer.optimizers import adafactor_init
    shapes = adafactor_init(blocks)
    sspecs = steps.state_specs(shapes, specs)
    full = {"f": _torch_tree(state["f"]), "step": state["step"]}
    mine = {"f": steps.param_blocks(full["f"], sspecs["f"], mesh),
            "step": state["step"]}
    for a, b in zip(tree_leaves(mine["f"]), tree_leaves(shapes["f"])):
        assert a.shape == b.shape
    shardings = {"params": specs, "opt": sspecs}
    save_checkpoint(save_dir, state["step"], {"params": blocks,
                                              "opt": mine},
                    shardings=shardings, mesh=mesh)
    target = {"params": tree_like(blocks, [torch.zeros_like(p) for p in
                                           tree_leaves(blocks)]),
              "opt": adafactor_init(blocks)}
    got, step = CheckpointManager(whole_dir, mesh=mesh).restore_latest(
        target, shardings, inplace=True)
    return step, np_tree(steps.gather_params(got["opt"]["f"], sspecs["f"],
                                             mesh))


def case_gather_steps(mesh, arch, tree, batches, lr, remat="none",
                      accum_steps=1):
    """``make_sharded_train_step`` (AdamW, the cosine schedule of ``lr``,
    a ``(base, warmup, total)`` triple, ``remat``, ``accum_steps``) fed
    this rank's rows of each global batch: each
    step's loss, grad norm, full parameters and the most gathered
    parameter bytes alive at once during it (``collectives.STATS``); and
    the bound of the rank's blocks (``steps.layer_gatherer``)."""
    cfg, rules, specs, blocks = _blocks(mesh, arch, tree)
    step_fn, init = steps.make_sharded_train_step(
        cfg, OptConfig(lr=cosine_schedule(*lr)), mesh, specs, remat=remat,
        accum_steps=accum_steps)
    state = init(blocks)
    out = []
    for b in batches:
        with sh.use_rules(mesh, rules):
            rows = {k: sh.put(torch.from_numpy(v), ("batch",))
                    for k, v in b.items()}
        collectives.reset_stats()
        blocks, state, m = step_fn(blocks, state, rows)
        peak = collectives.reset_stats()["gathered_peak_bytes"]
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    np_tree(steps.gather_params(blocks, specs, mesh),
                            copy=True), peak))
    return out, steps.layer_gatherer(cfg, mesh, specs).bound(blocks)


def case_gather(mesh, arch, tree):
    """Every leaf cut into this rank's block and gathered back
    (``steps.param_blocks``, ``steps.gather_params``): the gathered tree;
    the same for a full Adafactor state of distinct values (``r`` and
    ``c`` laid out by ``steps.state_specs``, each leaf ``arange`` of its
    size), with its largest gap to the state it was cut from; and each
    leaf's block shape and spec."""
    from repro_torch.optimizer.optimizers import adafactor_init
    cfg, _, specs, blocks = _blocks(mesh, arch, tree)
    full = adafactor_init(T.params_from_reference(tree, cfg, "cpu"))
    full["f"] = tree_like(full["f"], [
        torch.arange(x.numel(), dtype=torch.float32).reshape(x.shape)
        for x in tree_leaves(full["f"])])
    sspecs = steps.state_specs(full, specs)
    mine = steps.param_blocks(full["f"], sspecs["f"], mesh)
    back = steps.gather_params(mine, sspecs["f"], mesh)
    gap = max(float((x - tree_at(full["f"], path)).abs().max())
              for path, x in tree_paths(back))
    return (np_tree(steps.gather_params(blocks, specs, mesh)), gap,
            {path: (tuple(p.shape), repr(s)) for (path, p), s in zip(
                tree_paths(blocks), tree_leaves(specs))})


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


CASES = {"grad": case_grad, "moe_grad": case_moe_grad, "gather": case_gather,
         "gather_steps": case_gather_steps,
         "adafactor_ckpt": case_adafactor_ckpt, "logits": case_logits,
         "serve": case_serve, "steps": case_steps, "train": case_train,
         "ckpt": case_ckpt, "collectives": case_collectives}


def run_cases(mesh, cases: dict) -> dict:
    """Run ``{name: (case, args)}`` on this rank: ``{name: result}``."""
    return {name: CASES[case](mesh, *args)
            for name, (case, args) in cases.items()}


# -- on the card (tests/test_torch_gpu.py) ------------------------------------


def case_card(mesh, archs, batch, seq, prompts, max_new, model_parallel=2):
    """The model axis on CUDA tensors over gloo (``model_parallel`` ranks
    on one card): for each smoke config (a name or a ``ModelConfig``), 3
    AdamW steps of ``train(model_parallel=…)`` and
    ``serve_batch(model_parallel=…)``; the losses, the tokens and the
    B4/B5 launches (forward and backward) of the rank, by name (a
    config's ``name``)."""
    from repro_torch.kernels import ops
    dev = mesh.device
    out = {}
    for arch in archs:
        ops.reset_launch_counts()
        _, losses = train_mod.train(arch, steps=3, batch=batch, seq=seq,
                                    lr=3e-3, device=dev, log_every=100,
                                    model_parallel=model_parallel)
        reqs = [serve.Request(p, max_new=max_new) for p in prompts]
        serve.serve_batch(arch, reqs, t_max=64, device=dev,
                          model_parallel=model_parallel)
        out[getattr(arch, "name", arch)] = (
            losses, [r.out for r in reqs], ops.launch_counts())
    return out


CASES["card"] = case_card
