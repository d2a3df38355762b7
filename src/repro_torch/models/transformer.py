"""Model assembly: init / forward / cache / decode for every family
(counterpart of ``repro/models/transformer.py``).

Parameters are a dict of tensors whose keys are the reference's
parameter tree paths, each layer stack kept stacked on a leading ``L``
axis (``params["stack"]["attn"]["wq"]`` is ``(L, d, hq·hd)``), so
:func:`params_from_reference` carries the reference's weights across
leaf by leaf.  The reference scans each stack; here a Python loop
takes the layers one at a time (views, no copy).  The families:

* ``dense`` / ``vlm``: one stack of attention + MLP layers; a VLM's
  frontend-stub ``embeds`` are prepended to the token embeddings.
* ``moe``, DeepSeek layout (``every == 1``): ``first_dense`` leading
  dense layers (``head_dense``, with a KV cache ``"head"`` of their
  own), then a stack of attention + MoE layers.
* ``moe``, Llama 4 layout (``every == 2``): a stack of pair-blocks
  ``{"a": dense layer, "b": MoE layer}``; a pair's global flag drops the
  chunk mask in both of its layers.
* ``ssm`` (xLSTM): a stack of mLSTM layers, the ``slstm_layers``
  positions with exponential gating; O(1) recurrent state.
* ``hybrid`` (Zamba2): Mamba2 layers cut into segments of
  ``hybrid_attn_every``; after each segment one *shared* attention + MLP
  block (one parameter set) with a KV cache of its own per segment.
* ``encdec`` (Whisper): a non-causal encoder stack over ``enc_embeds``,
  ``enc_norm``, then a decoder stack whose layers add cross-attention
  over K/V projected once from the encoder output (at prefill, kept in
  ``cache["cross"]``).

Training: :func:`loss_fn` is the reference's (cross-entropy over the
padded vocab plus 0.01 × the MoE load-balance term).  ``remat=`` wraps
each layer (a pair-block in the Llama 4 layout) as the reference's
``_maybe_remat`` wraps its scan body: ``"full"`` recomputes the layer in
the backward (``torch.utils.checkpoint``), ``"selective"`` keeps the
outputs of its plain 2-D matrix products and recomputes the rest.  The
layers' gradients are stacked into each stacked leaf once (the stack
is ``unbind``-ed into its layers, :func:`_layers`).

Tensor parallelism: under ``sharding.use_rules`` with a mesh whose
``"model"`` axis spans M ranks, ``params`` holds this rank's compute
blocks (``launch.steps.param_blocks`` of a full tree, e.g. of
:func:`params_from_reference`, or :func:`init_param_blocks` without the
whole tree; :func:`check_model_axis` says which configs split) and
every layer computes on them (``layers``, ``attention``, ``ssm``,
``moe``): the embedding table and the head
hold a block of vocabulary rows, so :func:`forward`'s logits are this
rank's vocabulary columns; :func:`loss_sums` combines them over ranks,
:func:`init_cache` makes the rank's block of the cache (its kv heads,
its recurrent channels), and :func:`decode_step` continues it.  A
rematerialized layer replays its collectives in the backward, on
whatever thread autograd runs it, under the rules it ran under.

ZeRO-3 (the sharded train step, ``launch.steps``): with a
``sharding.LayerGatherer`` installed, ``params`` holds blocks split over
``"data"`` too, and the model gathers them where it computes with them
(``sharding.gather_layer``).  Each layer of a stack gathers its view of
the stacked blocks inside the callable its remat wrapper runs, so
``remat="full"`` and ``"selective"`` gather again in the recompute, and
with ``remat="none"`` the step's saved-tensor hooks drop the gathered
weights after the layer's forward and gather them again in its backward
(``collectives.reshard_after_forward``); Whisper's cross-attention K/V
projections gather one layer's ``wk`` and ``wv`` at a time.  The entries
outside the stacks are gathered whole and kept until the backward's
last use of them (the gatherer tells the two apart by the specs: a leaf
led by ``"layers"`` is a stack's).  One used once is gathered where it is
used: the embedding at the lookup (freed after it: the lookup saves only
the ids), the head at the logits (kept until the backward's first
step); ``out_norm`` and ``enc_norm`` are never split, so never gathered.
One used more than once is gathered once a forward (:func:`_gather_reused`):
Zamba2's ``shared_attn`` (n_layers / k uses) and a tied embedding (the
lookup and the head).  So the most gathered bytes alive at once are the
shared block, the embedding or the head, and one layer: Zamba2-2.7B
0.42 + 0.33 + 0.16 ≈ 0.91 GB; xLSTM-125M 0.15 + 0.02 GB.  Without a
gatherer every gather is the identity.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve, resolve_or_meta
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as sh
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.optimizer.optimizers import tree_at, tree_like, tree_paths

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
REMAT = ("none", "full", "selective")


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.family == "hybrid" and (not cfg.hybrid_attn_every or
                                   cfg.n_layers % cfg.hybrid_attn_every):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into segments of {cfg.hybrid_attn_every}")
    if cfg.family == "moe":
        m = cfg.moe
        if m is None or m.every not in (1, 2):
            raise ValueError(f"{cfg.name}: the moe family takes MoE layers "
                             f"every 1 or 2 layers, got {m}")
        if m.every == 2 and cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not "
                             f"form pair-blocks")


def _pair_layout(cfg: ModelConfig) -> bool:
    return cfg.family == "moe" and cfg.moe.every == 2


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _dense_layer_init(gen, cfg, dtype, moe_layer=False) -> dict:
    attn = attn_mod.attn_init(gen, cfg, dtype)
    ffn = (moe_mod.moe_init(gen, cfg, dtype) if moe_layer else
           L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype))
    return {"attn": attn, "ffn": ffn,
            "norm1": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
            "norm2": L.rmsnorm_init(cfg.d_model, dtype, gen.device)}


def _cross_layer_init(gen, cfg, dtype) -> dict:
    base = _dense_layer_init(gen, cfg, dtype)
    base["cross"] = attn_mod.attn_init(gen, cfg, dtype)
    base["norm3"] = L.rmsnorm_init(cfg.d_model, dtype, gen.device)
    return base


def _pair_init(gen, cfg, dtype) -> dict:
    return {"a": _dense_layer_init(gen, cfg, dtype),
            "b": _dense_layer_init(gen, cfg, dtype, moe_layer=True)}


def _recurrent_layer_init(gen, cfg, dtype) -> dict:
    return {"rec": ssm_mod.recurrent_init(gen, cfg, dtype),
            "norm1": L.rmsnorm_init(cfg.d_model, dtype, gen.device)}


def _stack_init(n: int, layer_init, cut=None) -> dict:
    """``n`` layers of ``layer_init()`` stacked on a leading axis, each
    layer first passed through ``cut(layer, n)`` when given (a rank's
    blocks: :func:`init_param_blocks`).

    Each stacked leaf is allocated once at ``(n, …)`` and filled layer by
    layer, so the peak is the stack plus one layer (stacking a list of
    layers would hold the stack twice).  The layers draw from the
    generator in order, as a list of ``layer_init()`` calls would."""
    if cut is not None:
        return _stack_init(n, lambda: cut(layer_init(), n))
    first = layer_init()

    def alloc(node):
        if isinstance(node, dict):
            return {k: alloc(v) for k, v in node.items()}
        return node.new_empty((n, *node.shape))

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    stack = alloc(first)
    put(stack, first, 0)
    del first
    for i in range(1, n):
        put(stack, layer_init(), i)
    return stack


def _layers(tree: dict) -> list[dict]:
    """The layers of a stacked tree, as views: one ``unbind`` a leaf, so
    a backward stacks the layers' gradients into each leaf once (a
    per-layer index would add a full-size gradient per layer)."""
    parts = {k: _layers(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``
    (the reference's distributions; not its numbers); on ``"meta"``
    empty leaves of the same shapes and dtypes (a dry run)."""
    return _draw(cfg, seed, dtype, resolve_or_meta(device))


def _draw(cfg, seed, dtype, dev, cut=None) -> dict:
    """:func:`init_params`' tree, each top-level entry (a leaf, a layer
    or a stack) passed through ``cut(key, node, n)`` (``n`` a stack's
    depth, else None) as soon as it is drawn, when ``cut`` is given."""
    _check_cfg(cfg)
    gen = (L.MetaGenerator() if dev.type == "meta" else
           torch.Generator(device=dev).manual_seed(seed))
    params = {}

    def put(key, node):
        params[key] = node if cut is None else cut(key, node, None)

    def stack(key, n, layer_init):
        params[key] = _stack_init(n, layer_init, None if cut is None else
                                  functools.partial(cut, key))

    put("embed", L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype))
    put("out_norm", L.rmsnorm_init(cfg.d_model, dtype, dev))
    if not cfg.tie_embeddings:
        put("lm_head", L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                    dtype))
    fam, n = cfg.family, cfg.n_layers
    if fam in ("dense", "vlm"):
        stack("stack", n, lambda: _dense_layer_init(gen, cfg, dtype))
    elif _pair_layout(cfg):
        stack("stack", n // 2, lambda: _pair_init(gen, cfg, dtype))
    elif fam == "moe":
        nd = cfg.moe.first_dense
        if nd:
            stack("head_dense", nd,
                  lambda: _dense_layer_init(gen, cfg, dtype))
        stack("stack", n - nd,
              lambda: _dense_layer_init(gen, cfg, dtype, True))
    elif fam in ("ssm", "hybrid"):
        stack("stack", n, lambda: _recurrent_layer_init(gen, cfg, dtype))
        if fam == "hybrid":
            put("shared_attn", _dense_layer_init(gen, cfg, dtype))
    else:  # encdec
        stack("encoder", cfg.encoder_layers,
              lambda: _dense_layer_init(gen, cfg, dtype))
        put("enc_norm", L.rmsnorm_init(cfg.d_model, dtype, dev))
        stack("stack", n, lambda: _cross_layer_init(gen, cfg, dtype))
    return params


def init_param_blocks(cfg: ModelConfig, mesh, rules: dict, seed: int = 0,
                      dtype=torch.float32, device=None):
    """This rank's compute blocks of :func:`init_params`' tree and the
    tree's specs under ``rules`` on ``mesh``: ``(blocks, specs)``, equal
    bit for bit to ``steps.param_blocks(init_params(cfg, seed, dtype,
    device), specs, mesh)`` and to ``sharding.tree_specs`` of
    :func:`param_specs` over it (in its key order), without the whole
    tree: every leaf is drawn from the same generator in the same order,
    layer by layer, and only its block is kept, so the peak is the
    blocks plus one full layer (or the embedding table)."""
    logical = param_specs(cfg)
    specs = {}

    def cut(key, node, n):
        lead = () if n is None else (n,)

        def walk(node, spec):
            if isinstance(node, dict):
                pairs = {k: walk(v, spec[k]) for k, v in node.items()}
                return ({k: b for k, (b, _) in pairs.items()},
                        {k: p for k, (_, p) in pairs.items()})
            full = sh.spec_for(spec, lead + tuple(node.shape), mesh, rules)
            block = sh.take_block(node, full.like(full[len(lead):],
                                                  full.fused), mesh)
            return (block if n is not None else block.clone()), full
        block, specs[key] = walk(node, logical[key])
        return block

    blocks = _draw(cfg, seed, dtype, resolve_or_meta(device), cut)
    order = [path for path, _ in tree_paths(logical)]
    return (tree_like(logical, [tree_at(blocks, q) for q in order]),
            tree_like(logical, [tree_at(specs, q) for q in order]))


def _dense_layer_specs(cfg, moe_layer=False) -> dict:
    return {"attn": attn_mod.attn_specs(cfg),
            "ffn": (moe_mod.moe_specs(cfg) if moe_layer else
                    L.mlp_specs(cfg.mlp_gated)),
            "norm1": L.rmsnorm_specs(), "norm2": L.rmsnorm_specs()}


def _stacked(spec):
    if isinstance(spec, dict):
        return {k: _stacked(v) for k, v in spec.items()}
    if isinstance(spec, (sh.Fused, sh.Heads)):
        return spec.prefixed("layers")
    return ("layers",) + tuple(spec)


def param_specs(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of :func:`init_params`'s tree (the
    tree the reference's ``init_params`` returns beside the params): a
    dict of the same keys, each leaf a tuple of logical names, a stacked
    leaf's led by ``"layers"``."""
    _check_cfg(cfg)
    specs = {"embed": L.embed_specs(), "out_norm": L.rmsnorm_specs()}
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.embed_specs()
    fam = cfg.family
    if fam in ("dense", "vlm"):
        specs["stack"] = _stacked(_dense_layer_specs(cfg))
    elif _pair_layout(cfg):
        specs["stack"] = _stacked({"a": _dense_layer_specs(cfg),
                                   "b": _dense_layer_specs(cfg, True)})
    elif fam == "moe":
        if cfg.moe.first_dense:
            specs["head_dense"] = _stacked(_dense_layer_specs(cfg))
        specs["stack"] = _stacked(_dense_layer_specs(cfg, True))
    elif fam in ("ssm", "hybrid"):
        specs["stack"] = _stacked({"rec": ssm_mod.recurrent_specs(cfg),
                                   "norm1": L.rmsnorm_specs()})
        if fam == "hybrid":
            specs["shared_attn"] = _dense_layer_specs(cfg)
    else:  # encdec
        specs["encoder"] = _stacked(_dense_layer_specs(cfg))
        specs["enc_norm"] = L.rmsnorm_specs()
        cross = _dense_layer_specs(cfg)
        cross["cross"] = attn_mod.attn_specs(cfg)
        cross["norm3"] = L.rmsnorm_specs()
        specs["stack"] = _stacked(cross)
    return specs


def check_model_axis(cfg: ModelConfig, m: int) -> None:
    """Refuse what a model axis of ``m`` ranks does not split.  Each
    rank computes on whole heads, channels, experts and vocabulary rows,
    so ``m`` must divide the MLP width, the recurrent channels, the
    routed experts, the shared experts' width and the padded vocabulary,
    and lay the heads out whole (``sharding.head_split``): ``m`` at most
    the kv heads (a run of whole GQA groups a rank, the first ranks one
    more where ``m`` does not divide them), or a multiple of them whose
    share of a kv head's ranks either holds whole query heads (⌈g/rep⌉
    or ⌊g/rep⌋ a rank) or divides into the group's ranks (each query
    head replicated on its ranks) — ``ValueError`` naming the counts.
    The reference's GSPMD would cut a head's columns instead (or, with
    experts that do not divide, each expert's hidden units); a Megatron
    split cannot."""
    if m == 1:
        return
    counts = {"padded vocabulary": cfg.padded_vocab}
    heads = None
    if cfg.family != "ssm":
        counts["MLP width"] = cfg.d_ff
        try:
            sh.head_split(cfg.n_heads, cfg.n_kv_heads, m)
        except ValueError:
            heads = (f"query heads ({cfg.n_heads}) over its kv heads "
                     f"({cfg.n_kv_heads}) in whole heads")
    if cfg.family in ("ssm", "hybrid"):
        counts["recurrent channels"] = cfg.d_inner_mult * cfg.d_model
    if cfg.family == "moe":
        counts["routed experts"] = cfg.moe.n_experts
        if cfg.moe.n_shared:
            counts["shared experts' width"] = (cfg.moe.n_shared
                                               * cfg.moe.d_ff_expert)
    bad = [f"divide its {k} ({v})" for k, v in counts.items() if v % m]
    if heads:
        bad.insert(0, f"split its {heads}")
    if bad:
        raise ValueError(f"{cfg.name}: a model axis of {m} ranks does not "
                         + ", nor ".join(bad))


def _expected_top(cfg: ModelConfig) -> set:
    keys = {"embed", "out_norm", "stack"}
    if not cfg.tie_embeddings:
        keys.add("lm_head")
    if cfg.family == "hybrid":
        keys.add("shared_attn")
    if cfg.family == "encdec":
        keys |= {"encoder", "enc_norm"}
    if cfg.family == "moe" and not _pair_layout(cfg) and \
            cfg.moe.first_dense:
        keys.add("head_dense")
    return keys


def params_from_reference(tree: dict, cfg: ModelConfig, device=None
                          ) -> dict:
    """The reference's ``init_params`` tree, as nested numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's parameters on
    ``device``.  Both keep the layer axes stacked, so this is a leafwise
    copy; the tree's top-level keys and its stack depth are checked
    against the config first."""
    _check_cfg(cfg)
    dev = resolve(device)
    want = _expected_top(cfg)
    if set(tree) != want:
        raise ValueError(f"not a {cfg.name} parameter tree: keys "
                         f"{sorted(tree)}, expected {sorted(want)}")
    stack = tree["stack"]
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.d_inner_mult * cfg.d_model
        got, exp = np.shape(stack["rec"]["w_in"]), (cfg.n_layers,
                                                    cfg.d_model, 2 * di)
    else:
        layer = stack["a"] if _pair_layout(cfg) else stack
        n = cfg.n_layers
        if _pair_layout(cfg):
            n //= 2
        elif cfg.family == "moe":
            n -= cfg.moe.first_dense
        got = np.shape(layer["attn"]["wq"])
        exp = (n, cfg.d_model, cfg.n_heads * cfg.hd)
    if got != exp:
        raise ValueError(f"stack {got} does not fit {cfg.name} ({exp})")

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).to(dev)

    return convert(tree)


# --------------------------------------------------------------------------
# stack runners
# --------------------------------------------------------------------------


class MoEAux(NamedTuple):
    """What ``forward(..., return_aux=True)`` reports of its MoE layers."""

    total: torch.Tensor      # summed load-balance term, f32 scalar
    dropped: list            # each MoE layer's (B, T, k) bool dropped mask
    chosen: list             # each MoE layer's (B, T, k) chosen experts


class _Run:
    """What one forward threads through its layers: the position of the
    first token and, when the caller asks for them, the MoE layers'
    summed ``aux`` and dropped masks (a Python 0 until an MoE layer
    adds to it, so no other family pays a launch for it)."""

    def __init__(self, pos: int, want_aux: bool):
        self.pos = pos
        self.aux = 0.0
        self.dropped = [] if want_aux else None
        self.chosen = [] if want_aux else None


def _kv(cache: dict | None, key, i: int, pos: int):
    """Layer ``i``'s slice of a stacked KV cache."""
    if cache is None:
        return None
    kv = cache[key] if isinstance(key, str) else cache[key[0]][key[1]]
    return {"k": kv["k"][i], "v": kv["v"][i], "pos": pos}


def _dense_block(p, x, cfg, run: _Run, *, cache=None, is_global=False,
                 moe_layer=False, causal=True, cross=None):
    h, _ = attn_mod.attn_apply(
        p["attn"], L.rmsnorm(x, p["norm1"], cfg.norm_eps), cfg,
        cache=cache, layer_global=is_global, causal=causal, pos=run.pos)
    x = x + h
    if cross is not None:
        h, _ = attn_mod.attn_apply(
            p["cross"], L.rmsnorm(x, p["norm3"], cfg.norm_eps), cfg,
            kv_override=cross, causal=False, pos=run.pos)
        x = x + h
    z = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    if moe_layer:
        f, aux = moe_mod.moe_apply(p["ffn"], z, cfg, dropped=run.dropped,
                                   chosen=run.chosen)
        run.aux = run.aux + aux
    else:
        f = L.mlp_apply(p["ffn"], z, cfg.mlp_gated)
    return x + f


def _save_plain_matmuls(ctx, op, *args, **kwargs):
    """``remat="selective"``'s policy, the counterpart of the reference's
    ``dots_with_no_batch_dims_saveable``: keep the output of every plain
    2-D matrix product (``x @ W`` with x (B, T, D) runs as one ``mm``),
    recompute everything else."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(block, x, run: _Run, remat: str):
    """``block(x, run)``, one layer of a stack, under ``remat``.

    With a rematerialized block the layer's MoE ``aux``, dropped masks
    and choices go to a run of its own and are added to ``run``
    afterwards, so the recompute in the backward adds nothing twice.
    Without grad mode there is nothing to recompute and the block runs
    as it is."""
    if remat == "none" or not torch.is_grad_enabled():
        return block(x, run)
    want = run.dropped is not None
    # the recompute may run on autograd's device thread, which does not
    # see this thread's rules or gatherer: it runs under the ones the
    # layer ran under (a gatherer missing there would silently leave the
    # recompute on blocks)
    scope = sh.current_mesh(), sh.current_rules(), sh.current_batch_axis()
    gatherer = sh.current_gatherer()

    def fn(x):
        sub = _Run(run.pos, want)
        with sh.use_rules(*scope), sh.use_gatherer(gatherer):
            return block(x, sub), sub.aux, sub.dropped, sub.chosen

    kw = {}
    if remat == "selective":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_plain_matmuls)
    out, aux, dropped, chosen = ckpt.checkpoint(fn, x, use_reentrant=False,
                                                **kw)
    run.aux = run.aux + aux
    if want:
        run.dropped.extend(dropped)
        run.chosen.extend(chosen)
    return out


def _attn_layer(x, run, p_l, cfg, *, name, flag, pair, cache, key, i,
                moe_layer, causal, cross_l):
    """Layer (pair-block with ``pair``) ``i`` of the attention stack
    ``params[name]``, its blocks gathered first."""
    p_l = sh.gather_layer(name, p_l)
    if pair:
        x = _dense_block(p_l["a"], x, cfg, run, is_global=flag,
                         cache=_kv(cache, (key, "a"), i, run.pos),
                         causal=causal)
        return _dense_block(p_l["b"], x, cfg, run, is_global=flag,
                            cache=_kv(cache, (key, "b"), i, run.pos),
                            moe_layer=True, causal=causal)
    return _dense_block(p_l, x, cfg, run, is_global=flag,
                        cache=_kv(cache, key, i, run.pos),
                        moe_layer=moe_layer, causal=causal, cross=cross_l)


def _run_attn_stack(stack, x, cfg, run: _Run, *, name="stack", cache=None,
                    key="layers", flags=None, pair=False, moe_layer=False,
                    causal=True, cross=None, remat="none"):
    """The layers of the attention stack ``stack`` (``params[name]``) in
    order; layer ``i`` writes its keys and values into ``cache[key]``'s
    slice ``i``."""
    cross_kv = None if cross is None else list(zip(cross["k"].unbind(0),
                                                    cross["v"].unbind(0)))
    for i, p_l in enumerate(_layers(stack)):
        block = functools.partial(
            _attn_layer, p_l=p_l, cfg=cfg, name=name,
            flag=bool(flags[i]) if flags is not None else False, pair=pair,
            cache=cache, key=key, i=i, moe_layer=moe_layer, causal=causal,
            cross_l=None if cross is None else cross_kv[i])
        x = _remat_block(block, x, run, remat)
    return x


def _recurrent_layer(x, run, p_l, cfg, *, flag, st):
    p_l = sh.gather_layer("stack", p_l)
    y, new_st = ssm_mod.recurrent_apply(
        p_l["rec"], L.rmsnorm(x, p_l["norm1"], cfg.norm_eps), cfg,
        slstm_flag=flag, state=st)
    return x + y, new_st


def _run_recurrent_stack(stack: list, x, cfg, run: _Run, layers, *,
                         state=None, flags=None, remat="none"):
    """Recurrent layers ``layers`` of ``stack`` (:func:`_layers` of the
    stacked tree); layer ``li``'s state is ``state[li]``, updated in
    place."""
    for li in layers:
        st = None if state is None else state[li]
        block = functools.partial(
            _recurrent_layer, p_l=stack[li], cfg=cfg,
            flag=bool(flags[li]) if flags is not None else False, st=st)
        x, new_st = _remat_block(block, x, run, remat)
        if state is not None:
            st.copy_(new_st)
    return x


def _global_flags(cfg: ModelConfig, n: int, pair: bool = False
                  ) -> list[bool]:
    """Which of ``n`` layers (pair-blocks with ``pair``) attend
    globally: every ``global_every``-th absolute layer; a pair-block's
    flag is its second layer's and covers both."""
    if not cfg.global_every:
        return [False] * n
    g = cfg.global_every
    if pair:
        return [(2 * i + 1) % g == g - 1 for i in range(n)]
    return [i % g == g - 1 for i in range(n)]


def _slstm_flags(cfg: ModelConfig, n: int) -> list[bool]:
    return [i in cfg.slstm_layers for i in range(n)]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _encode(params, cfg, enc_embeds, b, remat="none"):
    """The encoder over ``enc_embeds`` and each decoder layer's cross
    K/V: ``{"k", "v": (L, B, Te, Hkv, hd)}`` (this rank's kv heads on a
    model axis)."""
    e = enc_embeds.to(params["embed"].dtype)   # the dtype only
    e = _run_attn_stack(params["encoder"], e, cfg, _Run(0, False),
                        name="encoder", causal=False, remat=remat)
    e = C.copy_to_model(L.rmsnorm(e, _gathered(params, "enc_norm"),
                                  cfg.norm_eps), sh.model_mesh())
    te = e.shape[1]
    cross = params["stack"]["cross"]
    shape = (b, te, -1, cfg.hd)     # this rank's kv heads
    group = attn_mod.replica_group(sh.model_mesh(), cfg)[1]

    def proj(leaf):
        return torch.stack([
            (e @ C.copy_to_group(sh.gather_layer(("stack", "cross", leaf), w),
                                 group)).reshape(shape)
            for w in cross[leaf]])
    return {"k": proj("wk"), "v": proj("wv")}


def _gathered(params: dict, key: str):
    """``params[key]``, an entry outside the stacks, gathered whole by the
    installed gatherer where it is used (itself without one)."""
    return sh.gather_layer(key, params[key])


def _gather_reused(params: dict, cfg: ModelConfig) -> dict:
    """``params`` with the entries outside the stacks that a forward uses
    more than once — Zamba2's shared block, a tied embedding — gathered
    once for the forward (``params`` itself without a gatherer)."""
    if sh.current_gatherer() is None:
        return params
    keys = ["shared_attn"] + (["embed"] if cfg.tie_embeddings else [])
    return {**params, **{k: _gathered(params, k) for k in keys
                         if k in params}}


def forward(params: dict, cfg: ModelConfig,
            tokens: torch.Tensor | None = None, *,
            embeds: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None,
            cache: dict | None = None, return_aux: bool = False,
            remat: str = "none"):
    """tokens (B, T) → ``(logits (B, T', padded_vocab), new_cache)``,
    or ``(logits, aux, new_cache)`` with ``return_aux``, ``aux`` a
    :class:`MoEAux`.  On a model axis of M ranks the logits are this
    rank's ``padded_vocab / M`` columns (``layers.vocab_argmax`` and
    ``layers.gather_vocab`` read them whole).

    ``embeds`` (B, Tp, D): frontend-stub embeddings prepended to the
    token embeddings (VLM; T' = Tp + T).  ``enc_embeds`` (B, Te, D): the
    encoder's input (enc-dec), needed unless ``cache["cross"]`` holds
    the projected encoder output already.  ``aux.total``: the MoE
    layers' summed load-balance term (0 for other families; with the
    batch split over ``"data"``, this rank's share of it);
    ``aux.dropped``: each MoE layer's mask of the choices its capacity
    dropped; ``aux.chosen``: each MoE layer's chosen experts.

    ``remat``: ``"none"``, ``"full"`` or ``"selective"``, how each
    layer's activations are kept for the backward (the module's
    docstring); it changes no value.

    Without a cache: the full sequence from position 0 (prefill or a
    teacher-forced pass).  With one: the tokens continue at
    ``cache["pos"]``; the cache's tensors are updated in place and the
    returned cache shares them with ``pos`` advanced."""
    _check_cfg(cfg)
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} is not one of {REMAT}")
    params = _gather_reused(params, cfg)
    parts = []
    if embeds is not None:
        parts.append(embeds.to(params["embed"].dtype))
    if tokens is not None:      # a gathered table goes after the lookup
        parts.append(L.embed_lookup(
            params["embed"] if cfg.tie_embeddings else
            _gathered(params, "embed"), tokens))
    if not parts:
        raise ValueError("forward needs tokens or embeds")
    x = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
    b, t, _ = x.shape
    pos = 0 if cache is None else int(cache["pos"])
    run = _Run(pos, return_aux)
    new_cache = None if cache is None else {**cache, "pos": pos + t}
    fam = cfg.family

    if fam in ("dense", "vlm"):
        x = _run_attn_stack(params["stack"], x, cfg, run, cache=cache,
                            flags=_global_flags(cfg, cfg.n_layers),
                            remat=remat)
    elif _pair_layout(cfg):
        x = _run_attn_stack(params["stack"], x, cfg, run, cache=cache,
                            flags=_global_flags(cfg, cfg.n_layers // 2,
                                                pair=True), pair=True,
                            remat=remat)
    elif fam == "moe":
        if cfg.moe.first_dense:
            x = _run_attn_stack(params["head_dense"], x, cfg, run,
                                name="head_dense", cache=cache, key="head",
                                remat=remat)
        x = _run_attn_stack(params["stack"], x, cfg, run, cache=cache,
                            moe_layer=True, remat=remat)
    elif fam == "ssm":
        x = _run_recurrent_stack(
            _layers(params["stack"]), x, cfg, run, range(cfg.n_layers),
            state=None if cache is None else cache["state"],
            flags=_slstm_flags(cfg, cfg.n_layers), remat=remat)
    elif fam == "hybrid":
        k = cfg.hybrid_attn_every
        layers = _layers(params["stack"])
        for s in range(cfg.n_layers // k):
            x = _run_recurrent_stack(
                layers, x, cfg, run, range(s * k, (s + 1) * k),
                state=None if cache is None else cache["state"],
                remat=remat)
            x = _dense_block(params["shared_attn"], x, cfg, run,
                             cache=_kv(cache, "shared", s, pos))
    else:  # encdec
        cross = None if cache is None else cache["cross"]
        if cross is None:
            if enc_embeds is None:
                raise ValueError(f"{cfg.name}: the encoder needs "
                                 f"enc_embeds")
            cross = _encode(params, cfg, enc_embeds, b, remat)
            if cache is not None:
                new_cache["cross"] = cross
        x = _run_attn_stack(params["stack"], x, cfg, run, cache=cache,
                            cross=cross, remat=remat)

    x = L.rmsnorm(x, _gathered(params, "out_norm"), cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else \
        _gathered(params, "lm_head")
    logits = L.head_logits(x, head)
    if return_aux:
        total = torch.as_tensor(run.aux, dtype=torch.float32,
                                device=logits.device)
        return logits, MoEAux(total, run.dropped, run.chosen), new_cache
    return logits, new_cache


def loss_sums(params: dict, cfg: ModelConfig, batch: dict, *,
              remat: str = "none"):
    """The pieces of one batch's loss: ``(nll_sum, count, aux)``, the
    summed cross-entropy of the valid labels, their count (an int64
    device scalar) and the MoE load-balance term (0 for the other
    families).  A data-parallel step divides the sum by the count of
    the whole global batch; :func:`loss_fn` by the batch's own."""
    logits, aux, _ = forward(params, cfg, batch.get("tokens"),
                             embeds=batch.get("embeds"),
                             enc_embeds=batch.get("enc_embeds"),
                             return_aux=True, remat=remat)
    labels = batch["labels"]
    pad = logits.shape[1] - labels.shape[1]
    if pad:
        labels = torch.cat([labels.new_full((labels.shape[0], pad), -1),
                            labels], 1)
    nll_sum, count = L.cross_entropy_sums(logits, labels, cfg.vocab)
    return nll_sum, count, aux.total


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: str = "none"):
    """The training loss of one batch (``tokens``, ``labels`` and, by
    family, ``embeds`` or ``enc_embeds``): ``(ce + 0.01 · aux, (ce,
    aux))``, ``aux`` the MoE load-balance term (``MoEAux.total``, 0 for
    the other families) kept in the graph.  A VLM's patch positions
    carry no label: ``labels`` is padded with -1 in front of them."""
    nll_sum, count, aux = loss_sums(params, cfg, batch, remat=remat)
    ce = nll_sum / count.clamp(min=1)
    return ce + 0.01 * aux, (ce, aux)


def recurrent_stage(stack: dict, x: torch.Tensor, cfg: ModelConfig,
                    first: int) -> torch.Tensor:
    """Layers ``first…first + n − 1`` of an ``ssm`` model over ``x``
    (B, T, D), no cache: ``stack`` holds those ``n`` layers stacked (a
    pipeline stage's block of ``params["stack"]``)."""
    layers = _layers(stack)
    flags = _slstm_flags(cfg, cfg.n_layers)[first:first + len(layers)]
    return _run_recurrent_stack(layers, x, cfg, _Run(0, False),
                                range(len(layers)), flags=flags)


# --------------------------------------------------------------------------
# caches / decode
# --------------------------------------------------------------------------


def local_kv_heads(cfg: ModelConfig, m: int, rank: int = 0) -> int:
    """The kv heads rank ``rank`` of a model axis of ``m`` holds
    (``sharding.head_split``): its run of ⌈n_kv/m⌉ or ⌊n_kv/m⌋, or one
    (replicated) where ``m`` is a larger multiple of ``n_kv``."""
    return sh.head_split(cfg.n_heads, cfg.n_kv_heads, m).kv[rank][1]


def _kv_cache(cfg, n, batch, t_max, dtype, dev) -> dict:
    r, m = sh.model_coords(sh.model_mesh())
    shape = (n, batch, t_max, local_kv_heads(cfg, m, r), cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def init_cache(cfg: ModelConfig, batch: int, t_max: int,
               dtype=torch.float32, device=None) -> dict:
    """The decode cache: stacked KV caches (``"layers"``; DeepSeek's
    leading dense layers ``"head"``; Llama 4's ``{"a", "b"}`` per
    pair-block; Zamba2's ``"shared"``, one per segment), recurrent state
    (f32, ``"state"``) and Whisper's cross K/V (``"cross"``, filled at
    prefill); ``pos`` is a Python int.  On a model axis of M ranks the
    rank's block: its kv heads (:func:`local_kv_heads`: ⌈n_kv/M⌉ or
    ⌊n_kv/M⌋, or one where M is a larger multiple of the kv heads, the
    head its query heads use), ``d_inner / M`` channels
    (``cache_spec_tree``'s ``"cache_kv"`` and ``"mlp"``)."""
    _check_cfg(cfg)
    dev = resolve_or_meta(device)
    fam, n = cfg.family, cfg.n_layers
    cache: dict = {"pos": 0}
    if fam in ("dense", "vlm"):
        cache["layers"] = _kv_cache(cfg, n, batch, t_max, dtype, dev)
    elif _pair_layout(cfg):
        cache["layers"] = {
            half: _kv_cache(cfg, n // 2, batch, t_max, dtype, dev)
            for half in ("a", "b")}
    elif fam == "moe":
        nd = cfg.moe.first_dense
        if nd:
            cache["head"] = _kv_cache(cfg, nd, batch, t_max, dtype, dev)
        cache["layers"] = _kv_cache(cfg, n - nd, batch, t_max, dtype, dev)
    elif fam in ("ssm", "hybrid"):
        cache["state"] = ssm_mod.init_recurrent_state(
            cfg, batch, device=dev).expand(n, -1, -1).contiguous()
        if fam == "hybrid":
            cache["shared"] = _kv_cache(cfg, n // cfg.hybrid_attn_every,
                                        batch, t_max, dtype, dev)
    else:  # encdec
        cache["layers"] = _kv_cache(cfg, n, batch, t_max, dtype, dev)
        cache["cross"] = None
    return cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """One-token decode: tokens (B, 1) → ``(logits, new_cache)``."""
    return forward(params, cfg, tokens, cache=cache)
