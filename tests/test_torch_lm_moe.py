"""Port parity for the MoE families: ``models/moe.py`` and the two
``moe`` layouts of ``models/transformer.py``, DeepSeekMoE (a leading
dense layer, then attention + MoE layers) and Llama 4 (dense + MoE
pair-blocks, chunked attention with a global layer every fourth).

The same numpy inputs, made from a seed, go through the JAX package and
the port on the CPU, with the reference's weights carried across:
``moe_apply``'s output, ``aux`` and set of dropped choices with and
without drops; each model's full forward (logits and summed ``aux``),
its greedy serving (prefill + 8 decode steps) against the reference's
``serve_batch`` loop without a mesh, and decode against a full forward.

Capacity: the smoke configs' ``capacity_factor`` 8.0 is at least
``E / k`` (DeepSeek 8 / 2, Llama 4 4 / 1), so no choice drops and a
decode step routes as the full forward does.  The ``drops`` cases set
it to 0.5, where every layer drops choices in prefill and decode alike.
Tolerance: ``atol = rtol = 1e-4``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch.models import moe
from repro_torch.models import transformer as T
from torch_lm_pairs import (Model, check_decode_matches_forward,
                            check_serving, close, port_cfg, ported,
                            smoke_jcfg, t)

DEEPSEEK, LLAMA4 = "deepseek-moe-16b", "llama4-maverick-400b-a17b"

#: (arch, config changes): Llama 4 at 4 layers has a global pair-block
#: (pair 1: layers 2, 3); the smoke config's one pair has none
MODELS = {"deepseek": (DEEPSEEK, {}),
          "deepseek-drops": (DEEPSEEK, {"capacity_factor": 0.5}),
          "llama4": (LLAMA4, {"n_layers": 4}),
          "llama4-drops": (LLAMA4, {"n_layers": 4,
                                    "capacity_factor": 0.5})}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    arch, changes = MODELS[request.param]
    return request.param, Model.build(arch, **changes)


# --------------------------------------------------------------------------
# moe_apply
# --------------------------------------------------------------------------


def _jax_keep(p, x, jcfg):
    """The reference's kept choices (its routing lines,
    ``repro/models/moe.py:67-80``)."""
    m = jcfg.moe
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xf @ p["router"]).astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    cap = max(int(np.ceil(xf.shape[0] * m.top_k / m.n_experts
                          * m.capacity_factor)), 4)
    onehot = jax.nn.one_hot(idx.reshape(-1), m.n_experts, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    return np.asarray(pos < cap)


#: (arch, capacity factor, tokens (B, S)); 0.5 drops choices
MOE_CASES = {"deepseek-keep-all": (DEEPSEEK, 8.0, (2, 24)),
             "deepseek-drops": (DEEPSEEK, 0.5, (2, 24)),
             "deepseek-decode-drops": (DEEPSEEK, 0.5, (8, 1)),
             "llama4-keep-all": (LLAMA4, 8.0, (1, 40)),
             "llama4-drops": (LLAMA4, 0.5, (1, 40))}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case):
    arch, cf, (b, s) = MOE_CASES[case]
    jcfg = smoke_jcfg(arch, capacity_factor=cf)
    cfg = port_cfg(jcfg)
    p, _ = jmoe.moe_init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    x = np.random.default_rng(5).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
    tp = ported(p)
    dropped = []
    y, aux = moe.moe_apply(tp, t(x), cfg, dropped=dropped)
    close(y, jy)
    close(aux, jaux)
    keep = moe.route(tp, t(x).reshape(b * s, -1), cfg).keep
    want = _jax_keep(p, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(keep.numpy(), want)
    np.testing.assert_array_equal(dropped[0].numpy(),
                                  ~want.reshape(b, s, cfg.moe.top_k))
    assert bool(dropped[0].any()) == (cf < 1.0)


def test_moe_capacity_is_the_reference_formula():
    for arch in (DEEPSEEK, LLAMA4):
        for cf in (0.5, 1.25, 8.0):
            cfg = port_cfg(smoke_jcfg(arch, capacity_factor=cf))
            m = cfg.moe
            for tokens in (1, 3, 8, 24, 545, 4096):
                want = max(int(np.ceil(tokens * m.top_k / m.n_experts
                                       * cf)), 4)
                assert moe.capacity(tokens, cfg) == want


def test_moe_keeps_every_choice_at_capacity_factor_e_over_k():
    """``capacity_factor = E / k`` gives every expert ``cap ≥ T``
    slots, so nothing can drop, whatever the routing."""
    jcfg = smoke_jcfg(DEEPSEEK, capacity_factor=8 / 2)
    cfg = port_cfg(jcfg)
    p = ported(jmoe.moe_init(jax.random.PRNGKey(6), jcfg, jnp.float32)[0])
    p["router"] = torch.zeros_like(p["router"])    # every token ties:
    p["router"][:, 0] = 10.0                       # expert 0 wins
    x = torch.randn(3, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6)).abs()
    r = moe.route(p, x.reshape(15, -1), cfg)
    assert r.cap >= 15 and bool(r.keep.all())


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------


def test_global_flags_match_reference():
    for every in (0, 2, 4):
        cfg = dataclasses.replace(port_cfg(smoke_jcfg(LLAMA4)),
                                  global_every=every)
        for n in (1, 2, 3, 6):
            for pair in (False, True):
                want = np.asarray(JT._global_flags(cfg, n, pair=pair))
                assert T._global_flags(cfg, n, pair=pair) == want.tolist()
    cfg = port_cfg(smoke_jcfg(LLAMA4, n_layers=4))
    assert T._global_flags(cfg, 2, pair=True) == [False, True]


def test_full_forward_matches_reference(model):
    name, m = model
    toks = np.random.default_rng(8).integers(0, m.cfg.vocab, (2, 70))
    jl, jaux = m.jax_forward(toks)
    tl, aux, none = T.forward(m.params, m.cfg, t(toks), return_aux=True)
    assert none is None and tl.shape == (2, 70, m.cfg.padded_vocab)
    close(tl, jl)
    close(aux.total, jaux)
    assert aux.total > 0
    n_moe = (m.cfg.n_layers // 2 if m.cfg.moe.every == 2 else
             m.cfg.n_layers - m.cfg.moe.first_dense)
    assert len(aux.dropped) == n_moe
    assert all(d.shape == (2, 70, m.cfg.moe.top_k) for d in aux.dropped)
    dropped = [int(d.sum()) for d in aux.dropped]
    assert all(d > 0 for d in dropped) if "drops" in name else \
        not any(dropped)
    logits, none = T.forward(m.params, m.cfg, t(toks))
    assert none is None and torch.equal(logits, tl)


def test_serve_batch_matches_reference_greedy_serving(model):
    """Prompts of 5–70 tokens; Llama 4's chunk of 64 binds, and its
    second pair-block attends globally."""
    _, m = model
    check_serving(m, [5, 70, 33])


def test_decode_matches_full_forward(model):
    """At ``capacity_factor`` 0.5 a decode step and the full forward
    drop different choices by design, so the drops cases hold the same
    weights at ``E / k``, as the chip's check does."""
    name, m = model
    if "drops" in name:
        moe_cfg = m.cfg.moe
        cf = moe_cfg.n_experts / moe_cfg.top_k
        m = dataclasses.replace(m, cfg=dataclasses.replace(
            m.cfg, moe=dataclasses.replace(moe_cfg, capacity_factor=cf)))
    check_decode_matches_forward(m, n=72, split=66)


def test_deepseek_tree_has_its_leading_dense_stack():
    m = Model.build(DEEPSEEK)
    assert set(m.params) == {"embed", "out_norm", "lm_head", "head_dense",
                             "stack"}
    assert m.params["head_dense"]["ffn"]["wi"].shape == (1, 128, 320)
    assert m.params["stack"]["ffn"]["wi"].shape == (2, 8, 128, 64)
    cache = T.init_cache(m.cfg, 2, 16, device="cpu")
    assert cache["head"]["k"].shape[0] == 1
    assert cache["layers"]["k"].shape[0] == 2
    jc = JT.init_cache(m.jcfg, 2, 16, jnp.float32)
    for key in ("head", "layers"):
        for kv in ("k", "v"):
            assert tuple(cache[key][kv].shape) == jc[key][kv].shape


def test_llama4_cache_is_per_pair_half():
    m = Model.build(LLAMA4, n_layers=4)
    assert set(m.params["stack"]) == {"a", "b"}
    cache = T.init_cache(m.cfg, 1, 16, device="cpu")
    jc = JT.init_cache(m.jcfg, 1, 16, jnp.float32)
    for half in ("a", "b"):
        for kv in ("k", "v"):
            assert tuple(cache["layers"][half][kv].shape) == \
                jc["layers"][half][kv].shape
