"""B5's gradient, ``AttnFn``, against the JAX package and torch autograd.

The reference has no backward kernel (JAX has no transpose rule for
``pallas_call``): it trains through XLA's einsums, so ``jax.vjp`` of its
``_sdpa`` (``repro/models/attention.py:69``, mask ``:55``) is the
reference gradient.  ``AttnFn``'s forward is B5 writing each row's
log-sum-exp, its backward the three backward kernels; on the CPU they
are the plain versions (``ref.attention_lse_ref``,
``ref.attention_backward_ref``), on the card the CUDA kernels
(``tests/test_torch_gpu.py``).  The same numpy inputs, made from a seed,
go through ``jax.vjp``, ``attention_backward_ref``, ``AttnFn`` and torch
autograd through ``ref.attention_ref``.

Tolerance: f32 ``atol = rtol = 1e-4`` (the packages sum in other
orders); against autograd in float64, ``1e-12``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as T
from repro_torch.optimizer.optimizers import tree_leaves
from torch_tf32 import tf32_product

TOL = dict(atol=1e-4, rtol=1e-4)

#: name → (B, Tq, Tk, Hq, Hkv, D, mask keywords).  Every mask B5 takes,
#: with window and chunk edges inside the sequence, a q_offset, Tq != Tk
#: (cross-attention) and groups 1, 4 and 9; no row is fully masked (the
#: reference's -1e30 would average such a row's values, the port's mask
#: gives it 0)
CASES = {
    "causal": (2, 24, 24, 4, 4, 16, {}),
    "non_causal": (2, 20, 20, 4, 4, 16, {"causal": False}),
    "window": (1, 40, 40, 4, 2, 16, {"window": 7}),
    "chunk": (1, 40, 40, 4, 1, 16, {"chunk": 16}),
    "global": (1, 40, 40, 4, 1, 16, {"chunk": None}),
    "q_offset": (2, 6, 30, 4, 4, 16, {"q_offset": 24}),
    "tq_ne_tk": (2, 12, 30, 4, 4, 16, {"causal": False}),
    "group1": (1, 20, 20, 4, 4, 8, {}),
    "group4": (1, 20, 20, 8, 2, 8, {}),
    "group9": (1, 20, 20, 9, 1, 8, {"window": 5}),
}


def _mask_kw(kw):
    return {"causal": kw.get("causal", True), "window": kw.get("window"),
            "chunk": kw.get("chunk"), "q_offset": kw.get("q_offset", 0)}


def _inputs(name, seed=0):
    b, tq, tk, hq, hkv, d, _ = CASES[name]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d),
                  (b, tq, hq, d)))


def _jax_vjp(name, q, k, v, do):
    """``(o, dq, dk, dv)`` of the reference's ``_sdpa``; the global case
    passes the chunk with ``is_global`` set, as a Llama 4 global layer
    does."""
    kw = _mask_kw(CASES[name][-1])
    is_global = name == "global"
    qpos = kw["q_offset"] + jnp.arange(q.shape[1])
    kpos = jnp.arange(k.shape[1])

    def f(q, k, v):
        return jattn._sdpa(q, k, v, qpos, kpos, causal=kw["causal"],
                           window=kw["window"],
                           chunk=16 if is_global else kw["chunk"],
                           is_global=is_global)
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(o), *map(np.asarray, vjp(jnp.asarray(do))))


def _leaf(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype).requires_grad_(True)


@pytest.mark.parametrize("name", CASES)
def test_backward_ref_matches_jax_vjp_of_the_reference(name):
    q, k, v, do = _inputs(name)
    jo, jdq, jdk, jdv = _jax_vjp(name, q, k, v, do)
    kw = _mask_kw(CASES[name][-1])
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = ref.attention_ref(tq, tk, tv, **kw)
    lse = ref.attention_lse_ref(tq, tk, **kw)
    np.testing.assert_allclose(o.numpy(), jo, **TOL)
    got = ref.attention_backward_ref(tq, tk, tv, o, lse, tdo, **kw)
    for g, want in zip(got, (jdq, jdk, jdv)):
        np.testing.assert_allclose(g.numpy(), want, **TOL)


@pytest.mark.parametrize("name", CASES)
def test_attn_fn_matches_jax_vjp_of_the_reference(name):
    q, k, v, do = _inputs(name, seed=1)
    _, jdq, jdk, jdv = _jax_vjp(name, q, k, v, do)
    leaves = [_leaf(x) for x in (q, k, v)]
    o = ops.flash_attention(*leaves, **_mask_kw(CASES[name][-1]))
    assert type(o.grad_fn).__name__ == "AttnFnBackward"
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    for g, want in zip(got, (jdq, jdk, jdv)):
        np.testing.assert_allclose(g.numpy(), want, **TOL)


@pytest.mark.parametrize("name", CASES)
def test_attn_fn_matches_autograd_through_the_plain_forward(name):
    q, k, v, do = _inputs(name, seed=2)
    kw = _mask_kw(CASES[name][-1])
    leaves = [_leaf(x, torch.float64) for x in (q, k, v)]
    g = torch.from_numpy(do).double()
    got = torch.autograd.grad(fa.AttnFn.apply(*leaves, *kw.values()),
                              leaves, g)
    want = torch.autograd.grad(ref.attention_ref(*leaves, **kw), leaves, g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("kw", [{}, {"window": 3, "q_offset": 2},
                                {"chunk": 4, "causal": False}])
def test_attn_fn_gradcheck(kw):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((1, 5, 4, 3), (1, 7, 2, 3), (1, 7, 2, 3)))
    args = tuple(_mask_kw(kw).values())
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.AttnFn.apply(q, k, v, *args), (q, k, v))


@pytest.mark.parametrize("name", ["causal", "window", "chunk", "q_offset",
                                  "group9"])
def test_lse_ref_is_logsumexp_over_the_visible_keys(name):
    q, k, _, _ = _inputs(name)
    b, tq, tk, hq, hkv, d, kw = CASES[name]
    kw = _mask_kw(kw)
    tq_, tk_ = torch.from_numpy(q), torch.from_numpy(k)
    kr = tk_.repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", tq_, kr) / d ** 0.5
    mask = ref.attention_mask(tq, tk, **kw)
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    got = ref.attention_lse_ref(tq_, tk_, **kw)
    assert got.shape == (b, hq, tq)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    o, lse = fa.flash_attention_lse(tq_, tk_, tk_, **kw)
    assert torch.equal(lse, got)
    assert torch.equal(o, fa.flash_attention(tq_, tk_, tk_, **kw))


def test_rows_with_no_visible_key_get_zero_gradients():
    """Queries past the keys' end beyond the window see nothing: lse is
    -inf, their output 0, and every gradient they feed is 0, not NaN."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 3, 2, 8), (1, 12, 2, 8), (1, 12, 2, 8)))
    kw = dict(causal=True, window=2, chunk=None, q_offset=20)
    lse = ref.attention_lse_ref(q, k, **kw)
    assert torch.isinf(lse).all() and (lse < 0).all()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = ops.flash_attention(*leaves, **kw)
    assert not o.detach().any()
    grads = torch.autograd.grad(o, leaves, torch.ones_like(o))
    for g in grads:
        assert torch.isfinite(g).all() and not g.any()
    # mixed: the first query sees the last key, the other two nothing
    kw["q_offset"] = 12
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    dq, dk, dv = torch.autograd.grad(ops.flash_attention(*leaves, **kw),
                                     leaves, torch.ones((1, 3, 2, 8)))
    assert torch.isfinite(dq).all() and not dq[:, 1:].any()
    assert not dk[:, :11].any() and dv[:, 11].any() and not dv[:, :11].any()


def test_ops_attention_records_a_graph_only_when_autograd_would():
    """Without grad mode, or with no input requiring grad,
    ops.flash_attention is the one plain call serving makes: no
    autograd node, no lse."""
    q, k, v, _ = _inputs("causal")
    leaves = [_leaf(x) for x in (q, k, v)]
    with torch.no_grad():
        assert ops.flash_attention(*leaves).grad_fn is None
    frozen = ops.flash_attention(*(x.detach() for x in leaves))
    assert frozen.grad_fn is None and not frozen.requires_grad
    torch.testing.assert_close(frozen, fa.AttnFn.apply(*leaves).detach(),
                               atol=0, rtol=0)
    one = [leaves[0].detach(), leaves[1], leaves[2].detach()]   # k only
    (dk,) = torch.autograd.grad(ops.flash_attention(*one), (leaves[1],),
                                torch.ones(leaves[0].shape))
    assert dk.shape == leaves[1].shape


class _CountLse:
    """Counts ``flash_attention_lse`` calls (``AttnFn`` forwards) and
    ``attention_backward`` calls."""

    def __init__(self, monkeypatch):
        self.forward = self.backward = 0
        orig_f, orig_b = fa.flash_attention_lse, fa.attention_backward

        def fwd(*a, **kw):
            self.forward += 1
            return orig_f(*a, **kw)

        def bwd(*a, **kw):
            self.backward += 1
            return orig_b(*a, **kw)
        monkeypatch.setattr(fa, "flash_attention_lse", fwd)
        monkeypatch.setattr(fa, "attention_backward", bwd)


@pytest.mark.parametrize("remat", T.REMAT)
def test_remat_recomputes_attention_through_attn_fn(monkeypatch, remat):
    """Under ``remat="full"`` and ``"selective"`` each layer's attention
    runs through ``AttnFn`` again in the backward (torch.utils.
    checkpoint recomputes the layer); the gradients equal those without
    remat."""
    cfg = configs.get("minicpm-2b", smoke=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)))
    batch = {"tokens": toks, "labels": toks}
    count = _CountLse(monkeypatch)
    loss, _ = T.loss_fn(params, cfg, batch, remat=remat)
    assert count.forward == cfg.n_layers
    grads = torch.autograd.grad(loss, tree_leaves(params))
    redo = remat != "none"
    assert count.forward == cfg.n_layers * (2 if redo else 1)
    assert count.backward == cfg.n_layers
    monkeypatch.undo()
    loss, _ = T.loss_fn(params, cfg, batch)
    for x, y in zip(grads, torch.autograd.grad(loss, tree_leaves(params))):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


def test_cross_attention_differentiates():
    """Whisper's cross-attention (``kv_override``: keys and values of the
    encoder, Tq != Tk, non-causal) goes through ``AttnFn``, and its
    gradients reach the encoder side's k and v."""
    cfg = configs.get("whisper-base", smoke=True)
    gen = torch.Generator().manual_seed(0)
    p = attn_mod.attn_init(gen, cfg, torch.float32)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 5, cfg.d_model))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal(
        (2, 9, cfg.n_kv_heads, cfg.hd)).astype(np.float32))
        .requires_grad_(True) for _ in range(2))
    y, cache = attn_mod.attn_apply(p, x, cfg, kv_override=(k, v),
                                   causal=False)
    assert cache is None
    dk, dv = torch.autograd.grad(y.square().sum(), (k, v))
    k2, v2 = (t.detach().requires_grad_(True) for t in (k, v))
    q = (x @ p["wq"]).reshape(2, 5, cfg.n_heads, cfg.hd)
    out = ref.attention_ref(q, k2, v2, causal=False)
    y2 = out.reshape(2, 5, -1) @ p["wo"]
    want = torch.autograd.grad(y2.square().sum(), (k2, v2))
    for got, w in zip((dk, dv), want):
        torch.testing.assert_close(got, w, **TOL)
        assert got.abs().max() > 0


def test_kv_cache_path_records_no_graph_under_no_grad(monkeypatch):
    """Serving's cached decode runs under ``torch.no_grad()``: B5's
    forward alone, no ``AttnFn`` and no lse, even with weights that
    require grad."""
    cfg = configs.get("minicpm-2b", smoke=True)
    gen = torch.Generator().manual_seed(1)
    p = {k: w.requires_grad_(True) for k, w in
         attn_mod.attn_init(gen, cfg, torch.float32).items()}
    cache = {"k": torch.zeros(1, 16, cfg.n_kv_heads, cfg.hd),
             "v": torch.zeros(1, 16, cfg.n_kv_heads, cfg.hd), "pos": 0}
    count = _CountLse(monkeypatch)
    x = torch.randn(1, 4, cfg.d_model, generator=gen)
    with torch.no_grad():
        y, cache = attn_mod.attn_apply(p, x, cfg, cache=cache)
        y1, cache = attn_mod.attn_apply(p, x[:, :1], cfg, cache=cache)
    assert y.grad_fn is None and y1.grad_fn is None and cache["pos"] == 5
    assert count.forward == 0 and count.backward == 0


def _tf32_backward(q, k, v, o, lse, do, passes):
    """Causal ``(dq, dk, dv)`` with the five T²·D products as TF32
    products (``tf32_product``, the kernels' split), as ``dkdv`` and
    ``dq`` compute them: S and dP raw, P = exp2(S·log2(e)/√D −
    lse·log2(e)) and dS = P ∘ (dP − D) held in f32, dV = Pᵀ·dO, dK =
    dSᵀ·Q/√D, dQ = dS·K/√D (the tensor core's own sums in float64 here,
    so only the split's error is left)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = np.float32(1.0 / np.sqrt(d))
    log2e = np.float32(np.log2(np.e))
    mask = np.arange(tk)[None, :] <= np.arange(tq)[:, None]
    dq, dk, dv = (np.empty_like(x) for x in (q, k, v))
    for bi in range(b):
        for hi in range(h):
            qh, kh, vh, oh, gh = (x[bi, :, hi] for x in (q, k, v, o, do))
            s = tf32_product(qh, kh.T, passes).astype(np.float32)
            l2 = lse[bi, hi] * log2e
            p = np.where(mask, np.exp2(s * (scale * log2e) - l2[:, None]),
                         0).astype(np.float32)
            dp = tf32_product(gh, vh.T, passes).astype(np.float32)
            ds = p * (dp - (gh * oh).sum(1)[:, None])
            dv[bi, :, hi] = tf32_product(p.T, gh, passes)
            dk[bi, :, hi] = tf32_product(ds.T, qh, passes) * scale
            dq[bi, :, hi] = tf32_product(ds, kh, passes) * scale
    return dq, dk, dv


@pytest.mark.parametrize("d", [80, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_backward_needs_three_tf32_passes_for_float_tol(d, seed):
    """At D = 80 and 128, Tq = Tk = 512, causal: with the backward's five
    products split in three TF32 passes, as the ``dkdv`` and ``dq``
    kernels compute them, dq, dk and dv each come within a tenth of the
    card's tolerance, 1e-4 · max |plain| (``tests/test_torch_gpu.py``,
    ``chip_smoke.py``); with one pass each misses it."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((1, 512, 2, d)).astype(np.float32)
                   for _ in range(4))
    tq_, tk_, tv_, tdo = map(torch.from_numpy, (q, k, v, do))
    o = ref.attention_ref(tq_, tk_, tv_)
    lse = ref.attention_lse_ref(tq_, tk_)
    want = ref.attention_backward_ref(tq_, tk_, tv_, o, lse, tdo)
    tols = [1e-4 * float(w.abs().max()) for w in want]
    for passes, ok in ((3, lambda err, tol: err <= tol / 10),
                       (1, lambda err, tol: err > tol)):
        got = _tf32_backward(q, k, v, o.numpy(), lse.numpy(), do, passes)
        for name, g, w, tol in zip(("dq", "dk", "dv"), got, want, tols):
            err = float(np.abs(g - w.numpy()).max())
            assert ok(err, tol), (passes, name, err, tol)
