"""Port parity for the attention-stack families: ``dense`` (MiniCPM-2B,
Llama 3 405B, Mistral Large 123B, StarCoder2-7B) and ``vlm``
(LLaVA-NeXT), cross-attention and Llama 4's per-layer global flag in
``models/attention.py``, and the configs and parameter trees of every
family.

The same numpy inputs, made from a seed, go through the JAX package and
the port on the CPU, with the reference's weights carried across: each
model's full forward, its greedy serving (prefill + 8 decode steps)
against the reference's ``serve_batch`` loop without a mesh, and decode
against a full forward; LLaVA also through ``forward(embeds=)``.
StarCoder2's smoke window (64) binds: prompts and decode run past it.
Tolerance: ``atol = rtol = 1e-4``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.models import attention
from repro_torch.models import transformer as T
from torch_lm_pairs import (TOL, Model, check_decode_matches_forward,
                            check_serving, close, leaves, port_cfg, ported,
                            smoke_jcfg, t)

DENSE = ("minicpm-2b", "llama3-405b", "mistral-large-123b", "starcoder2-7b",
         "llava-next-mistral-7b")
NEW = ("deepseek-moe-16b", "llama3-405b", "llama4-maverick-400b-a17b",
       "llava-next-mistral-7b", "minicpm-2b", "mistral-large-123b",
       "starcoder2-7b", "whisper-base", "xlstm-125m")


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    return Model.build(request.param)


# --------------------------------------------------------------------------
# attention: cross-attention and global layers
# --------------------------------------------------------------------------


#: (arch, config changes, tq, tk, pos): Whisper's decoder over its
#: encoder (prefill and a decode step), and a window on the cross keys
CROSS_CASES = {"prefill": ("whisper-base", {}, 7, 11, 0),
               "decode": ("whisper-base", {}, 1, 11, 9),
               "window": ("whisper-base", {"window": 4}, 3, 10, 5)}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_attn_apply_kv_override_matches_reference(case):
    """Precomputed K/V at positions 0…Tk-1, no rope on q, no cache."""
    arch, changes, tq, tk, pos = CROSS_CASES[case]
    jcfg = smoke_jcfg(arch, **changes)
    cfg = port_cfg(jcfg)
    p, _ = jattn.attn_init(jax.random.PRNGKey(4), jcfg, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, tq, jcfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((2, tk, jcfg.n_kv_heads, jcfg.hd))
          .astype(np.float32) for _ in range(2)]
    jy, _ = jattn.attn_apply(
        p, jnp.asarray(x), jcfg, positions=pos + jnp.arange(tq),
        kv_override=(*map(jnp.asarray, kv), jnp.arange(tk)), causal=False)
    y, none = attention.attn_apply(ported(p), t(x), cfg,
                                   kv_override=tuple(map(t, kv)),
                                   causal=False, pos=pos)
    assert none is None
    close(y, jy)


@pytest.mark.parametrize("is_global", [False, True])
def test_attn_apply_layer_global_matches_reference(is_global):
    """Llama 4's chunk (64 in the smoke config) binds at 100 tokens; a
    global layer drops it, with and without a cache."""
    jcfg = smoke_jcfg("llama4-maverick-400b-a17b")
    cfg = port_cfg(jcfg)
    p, _ = jattn.attn_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = ported(p)
    x = np.random.default_rng(3).standard_normal(
        (2, 100, jcfg.d_model)).astype(np.float32)
    jy, _ = jattn.attn_apply(p, jnp.asarray(x), jcfg,
                             positions=jnp.arange(100),
                             layer_global=is_global)
    y, _ = attention.attn_apply(tp, t(x), cfg, layer_global=is_global)
    close(y, jy)
    shape = (2, 128, jcfg.n_kv_heads, jcfg.hd)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
          "pos": jnp.asarray(0, jnp.int32)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape), "pos": 0}
    for lo, hi in ((0, 90), (90, 99), (99, 100)):
        jy, jc = jattn.attn_apply(p, jnp.asarray(x[:, lo:hi]), jcfg,
                                  positions=lo + jnp.arange(hi - lo),
                                  cache=jc, layer_global=is_global)
        y, tc = attention.attn_apply(tp, t(x[:, lo:hi]), cfg, cache=tc,
                                     layer_global=is_global)
        close(y, jy)
    local, _ = attention.attn_apply(tp, t(x), cfg)
    wide, _ = attention.attn_apply(tp, t(x), cfg, layer_global=True)
    assert not torch.allclose(local, wide, **TOL)   # the chunk binds


# --------------------------------------------------------------------------
# the dense and VLM models
# --------------------------------------------------------------------------


def test_full_forward_matches_reference(model):
    toks = np.random.default_rng(8).integers(0, model.cfg.vocab, (2, 80))
    jl, jaux = model.jax_forward(toks)
    tl, aux, none = T.forward(model.params, model.cfg, t(toks),
                              return_aux=True)
    assert none is None and tl.shape == (2, 80, model.cfg.padded_vocab)
    close(tl, jl)
    assert float(aux.total) == jaux == 0.0 and aux.dropped == []


def test_serve_batch_matches_reference_greedy_serving(model):
    """Prompts of 5–80 tokens: StarCoder2's window of 64 binds in
    prefill and decode."""
    check_serving(model, [5, 80, 41])


def test_decode_matches_full_forward(model):
    check_decode_matches_forward(model, n=76, split=70)


@pytest.fixture(scope="module")
def llava():
    return Model.build("llava-next-mistral-7b")


def test_vlm_embeds_forward_and_decode_match_reference(llava):
    """Patch embeddings prepended to the prompt's tokens: the full
    forward against the reference's, then a cached prefill of the same
    and 4 decode steps against the full forward over everything."""
    m = llava
    rng = np.random.default_rng(11)
    patches = rng.standard_normal((2, 12, m.cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, m.cfg.vocab, (2, 10))
    jl, _ = m.jax_forward(toks, embeds=patches)
    tl, _ = T.forward(m.params, m.cfg, t(toks), embeds=t(patches))
    assert tl.shape == (2, 22, m.cfg.padded_vocab)
    close(tl, jl)
    more = rng.integers(0, m.cfg.vocab, (2, 4))
    full, _ = T.forward(m.params, m.cfg,
                        t(np.concatenate([toks, more], 1)),
                        embeds=t(patches))
    cache = T.init_cache(m.cfg, 2, 32, torch.float32, "cpu")
    _, cache = T.forward(m.params, m.cfg, t(toks), embeds=t(patches),
                         cache=cache)
    assert cache["pos"] == 22
    for i in range(4):
        step, cache = T.decode_step(m.params, m.cfg,
                                    t(more[:, i:i + 1]), cache)
        close(step[:, 0], full[:, 22 + i].numpy())
    patches_only, _ = T.forward(m.params, m.cfg, embeds=t(patches))
    close(patches_only, m.jax_forward(None, embeds=patches)[0])


def test_forward_needs_tokens_or_embeds(llava):
    with pytest.raises(ValueError, match="tokens or embeds"):
        T.forward(llava.params, llava.cfg)


# --------------------------------------------------------------------------
# configs and parameter trees of every family
# --------------------------------------------------------------------------


def test_the_port_registers_the_reference_architectures():
    assert configs.list_archs() == jconfigs.list_archs()


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_and_param_count_match_reference(arch, smoke):
    got = configs.get(arch, smoke=smoke)
    want = jconfigs.get(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.padded_vocab == want.padded_vocab


@pytest.mark.parametrize("arch", NEW)
def test_params_from_reference_keeps_the_tree(arch):
    m = Model.build(arch)
    flat = jax.tree_util.tree_flatten_with_path(m.jparams)[0]
    assert len(flat) == sum(1 for _ in leaves(m.params))
    for path, leaf in flat:
        node = m.params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert torch.equal(node, torch.from_numpy(np.array(leaf)))
    tree = jax.tree.map(np.asarray, m.jparams)
    with pytest.raises(ValueError, match="not a"):
        T.params_from_reference({**tree, "extra": tree["embed"]}, m.cfg,
                                "cpu")
    deeper = dataclasses.replace(m.cfg, n_layers=m.cfg.n_layers + 2)
    with pytest.raises(ValueError, match="does not fit"):
        T.params_from_reference(tree, deeper, "cpu")


@pytest.mark.parametrize("arch", NEW)
def test_init_params_and_cache_follow_the_reference_trees(arch):
    jcfg = jconfigs.get(arch, smoke=True)
    cfg = configs.get(arch, smoke=True)
    shapes, _ = JT.shape_init(jcfg, jnp.float32)
    tp = T.init_params(cfg, seed=0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(flat) == sum(1 for _ in leaves(tp))
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
    again = T.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(tp),
                                                  leaves(again)))
    jc = JT.init_cache(jcfg, 2, 16, jnp.float32)
    tc = T.init_cache(cfg, 2, 16, device="cpu")
    assert set(tc) == set(jc)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        keys = [k.key for k in path]
        if keys[-1] == "pos":    # one Python int in the port
            continue
        got = tc
        for k in keys:
            got = got[k]
        assert tuple(got.shape) == leaf.shape, keys
    assert tc["pos"] == 0
