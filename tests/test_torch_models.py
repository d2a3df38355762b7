"""Port parity for the language-model serving slice (Zamba2, hybrid).

The same numpy inputs, made from a seed, go through the JAX package and
the port on the CPU:

* B4 ``ssm_scan``: the plain versions against ``ssm_scan_pallas(...,
  interpret=True)``, ``ref.ssm_scan_ref`` and ``ref.ssm_scan_sequential``;
* B5 ``flash_attention``: the plain version against
  ``flash_attention_pallas(..., interpret=True)`` and
  ``ref.attention_ref`` (causal / full, window, chunk, decode offsets,
  GQA groups, a fully masked row);
* the modules (``rmsnorm``, ``mlp_apply``, ``rope``,
  ``recurrent_apply``, ``attn_apply``) against their JAX functions, with
  the reference's weights carried across;
* the slice as a whole: Zamba2 smoke serving (prefill + greedy decode)
  against the JAX model driven without a mesh, as ``serve_batch`` would
  drive it, logits step by step and the emitted tokens.

Tolerance: float32, ``atol = rtol = 1e-4`` (summation orders differ
between the packages).  The CUDA kernels are held against these plain
versions on the card by ``tests/test_torch_gpu.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as scan
from repro_torch.launch import serve
from repro_torch.models import attention, layers, ssm
from repro_torch.models import transformer as T
from torch_lm_pairs import close, leaves, port_cfg, ported, t

ARCH = "zamba2-2.7b"


# --------------------------------------------------------------------------
# B4: ssm_scan
# --------------------------------------------------------------------------


def _pow2_block(t: int, cap: int = 64) -> int:
    bt = 1
    while t % (bt * 2) == 0 and bt * 2 <= cap:
        bt *= 2
    return bt


@pytest.mark.parametrize("t_len", [1, 16, 96, 256])
@pytest.mark.parametrize("d", [8, 160])
def test_ssm_scan_plain_matches_reference(t_len, d):
    rng = np.random.default_rng(t_len * 1000 + d)
    a = rng.uniform(0.5, 1.0, (2, t_len, d)).astype(np.float32)
    b = rng.standard_normal((2, t_len, d)).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pallas = ssm_scan_pallas(ja, jb, bt=_pow2_block(t_len), interpret=True)
    got = scan.ssm_scan(t(a), t(b))
    seq = ref.ssm_scan_sequential(t(a), t(b))
    assert got.shape == (2, t_len, d) and got.dtype == torch.float32
    for want in (pallas, jref.ssm_scan_ref(ja, jb),
                 jref.ssm_scan_sequential(ja, jb)):
        close(got, want)
        close(seq, want)


def test_ssm_scan_plain_is_the_recurrence():
    """Small exact case: h_t = a_t h_{t-1} + b_t from h = 0."""
    a = torch.tensor([[[0.5], [2.0], [0.0], [1.0]]])
    b = torch.tensor([[[1.0], [1.0], [3.0], [-1.0]]])
    want = torch.tensor([[[1.0], [3.0], [3.0], [2.0]]])
    assert torch.equal(scan.ssm_scan(a, b), want)
    assert torch.equal(ref.ssm_scan_sequential(a, b), want)


# --------------------------------------------------------------------------
# B5: flash_attention
# --------------------------------------------------------------------------

#: (b, tq, tk, hq, hkv, d, causal, window, chunk, q_offset, bq, bkv)
ATTN_CASES = {
    "causal-g1-d32": (2, 64, 64, 4, 4, 32, True, None, None, 0, 32, 32),
    "full-g2-d80": (2, 64, 64, 4, 2, 80, False, None, None, 0, 32, 32),
    "window-g4-d32": (1, 64, 64, 4, 1, 32, True, 16, None, 0, 32, 16),
    "chunk-g1-d80": (1, 64, 64, 4, 4, 80, True, None, 16, 0, 16, 32),
    "chunk-full-g2-d32": (1, 32, 32, 4, 2, 32, False, None, 8, 0, 16, 16),
    "decode-g2-d80": (2, 1, 48, 4, 2, 80, True, None, None, 47, 1, 16),
    "decode-window-g4-d32": (2, 1, 48, 8, 2, 32, True, 8, None, 47, 1, 16),
    "prefill-offset-g1-d80": (1, 16, 48, 4, 4, 80, True, None, None, 32,
                              16, 16),
    "masked-row-d32": (1, 1, 32, 4, 4, 32, True, 8, None, 47, 1, 32),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_plain_matches_reference(case):
    b, tq, tk, hq, hkv, d, causal, window, chunk, q_off, bq, bkv = \
        ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((b, tq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_off)
    got = fa.flash_attention(t(q), t(k), t(v), **kw)
    assert got.shape == (b, tq, hq, d)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), bq=bq, bkv=bkv,
                                    interpret=True, **kw)
    close(got, pallas)
    close(got, jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw))
    if case == "masked-row-d32":      # no key visible: the row is 0
        assert torch.equal(got, torch.zeros_like(got))


def test_flash_attention_plain_takes_strided_cache_views():
    """The serving path hands B5 the written prefix of a KV cache."""
    rng = np.random.default_rng(5)
    cache = t(rng.standard_normal((2, 40, 4, 32)).astype(np.float32))
    q = t(rng.standard_normal((2, 1, 4, 32)).astype(np.float32))
    view = cache[:, :21]
    assert not view.is_contiguous()
    got = fa.flash_attention(q, view, view, q_offset=20)
    want = fa.flash_attention(q, view.contiguous(), view.contiguous(),
                              q_offset=20)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["ssm_scan", "flash_attention"])
def test_wrappers_take_plain_version_only_on_cpu(monkeypatch, kernel):
    """A CPU tensor goes to the plain version; a CUDA tensor (here a fake
    one: this machine has no card) to the CUDA launcher, never to the
    plain version; a meta tensor (a dry run's) to neither: an empty
    output of its shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mod = scan if kernel == "ssm_scan" else fa
    seen = []
    monkeypatch.setattr(mod, f"{kernel}_cuda",
                        lambda *a, **k: seen.append("cuda") or a[0])
    monkeypatch.setattr(mod, f"{kernel}_plain",
                        lambda *a, **k: seen.append("plain") or a[0])
    shape = (1, 2, 1, 4) if kernel == "flash_attention" else (1, 2, 4)
    n = 3 if kernel == "flash_attention" else 2
    getattr(mod, kernel)(*(torch.ones(shape),) * n)
    with FakeTensorMode():
        getattr(mod, kernel)(*(torch.ones(shape, device="cuda"),) * n)
    out = getattr(mod, kernel)(*(torch.ones(shape, device="meta"),) * n)
    assert seen == ["plain", "cuda"]
    assert out.device.type == "meta" and out.shape == shape


def test_launch_counts_cover_all_five_kernels():
    """One counter a kernel, and one for B5's backward (its three
    kernels, a call); the reset clears B5's per-kernel counts too."""
    counts = ops.launch_counts()
    assert set(counts) == {"coo_segment", "coo_spmm", "semiring_matmul",
                           "ssm_scan", "flash_attention",
                           "flash_attention_backward"}
    scan.ssm_scan_cuda.launches = 3
    fa.attention_backward_cuda.by_kernel["dkdv"] = 2
    ops.reset_launch_counts()
    assert all(v == 0 for v in ops.launch_counts().values())
    assert not any(fa.attention_backward_cuda.by_kernel.values())


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    close(layers.rmsnorm(t(x), t(s), 1e-5),
          jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_reference(gated):
    p, _ = jlayers.mlp_init(jax.random.PRNGKey(1), 32, 96, gated,
                            jnp.float32)
    x = np.random.default_rng(1).standard_normal((2, 7, 32)).astype(
        np.float32)
    close(layers.mlp_apply(ported(p), t(x), gated),
          jlayers.mlp_apply(p, jnp.asarray(x), gated))


@pytest.mark.parametrize("offset", [0, 37])
def test_rope_matches_reference(offset):
    x = np.random.default_rng(2).standard_normal((2, 9, 3, 16)).astype(
        np.float32)
    pos = np.arange(9) + offset
    close(layers.rope(t(x), t(pos), 1e4),
          jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


#: (reference config, sLSTM gating flag) for the two recurrent branches
REC_CASES = {"mamba2": ("zamba2-2.7b", None),
             "mlstm": ("xlstm-125m", False),
             "slstm": ("xlstm-125m", True)}


@pytest.mark.parametrize("case", list(REC_CASES))
def test_recurrent_apply_prefill_and_decode_match_reference(case):
    arch, flag = REC_CASES[case]
    jcfg = jconfigs.get(arch, smoke=True)
    cfg = port_cfg(jcfg)
    p, _ = jssm.recurrent_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = ported(p)
    assert ("w_qk" in tp) == (case != "mamba2")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    jflag = None if flag is None else jnp.asarray(flag)
    jy, jst = jssm.recurrent_apply(p, jnp.asarray(x[:, :11]), jcfg,
                                   slstm_flag=jflag)
    y, st = ssm.recurrent_apply(tp, t(x[:, :11]), cfg, slstm_flag=flag)
    close(y, jy)
    close(st, jst)
    jy1, jst1 = jssm.recurrent_apply(p, jnp.asarray(x[:, 11:]), jcfg,
                                     slstm_flag=jflag, state=jst)
    y1, st1 = ssm.recurrent_apply(tp, t(x[:, 11:]), cfg, slstm_flag=flag,
                                  state=st)
    close(y1, jy1)
    close(st1, jst1)


def test_attn_apply_without_and_with_cache_matches_reference():
    jcfg = jconfigs.get(ARCH, smoke=True)
    cfg = configs.get(ARCH, smoke=True)
    p, _ = jattn.attn_init(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = ported(p)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 14, jcfg.d_model)).astype(np.float32)
    jy, _ = jattn.attn_apply(p, jnp.asarray(x), jcfg,
                             positions=jnp.arange(14))
    y, none = attention.attn_apply(tp, t(x), cfg)
    assert none is None
    close(y, jy)
    # a cache filled at 0..9, then 3 tokens and 1 token at pos > 0
    shape = (2, 24, jcfg.n_kv_heads, jcfg.hd)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
          "pos": jnp.asarray(0, jnp.int32)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape), "pos": 0}
    for lo, hi in ((0, 10), (10, 13), (13, 14)):
        jy, jc = jattn.attn_apply(p, jnp.asarray(x[:, lo:hi]), jcfg,
                                  positions=lo + jnp.arange(hi - lo),
                                  cache=jc)
        y, tc = attention.attn_apply(tp, t(x[:, lo:hi]), cfg, cache=tc)
        close(y, jy)
        assert tc["pos"] == int(jc["pos"]) == hi
        close(tc["k"], jc["k"])
        close(tc["v"], jc["v"])


def test_attn_apply_refuses_a_full_cache():
    cfg = configs.get(ARCH, smoke=True)
    gen = torch.Generator().manual_seed(0)
    p = attention.attn_init(gen, cfg, torch.float32)
    x = torch.zeros(1, 2, cfg.d_model)
    cache = {"k": torch.zeros(1, 3, cfg.n_kv_heads, cfg.hd),
             "v": torch.zeros(1, 3, cfg.n_kv_heads, cfg.hd), "pos": 2}
    with pytest.raises(ValueError, match="cache full"):
        attention.attn_apply(p, x, cfg, cache=cache)


# --------------------------------------------------------------------------
# the slice as a whole: Zamba2 smoke serving
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zamba():
    jcfg = jconfigs.get(ARCH, smoke=True)
    params, _ = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    cfg = configs.get(ARCH, smoke=True)
    tp = T.params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                 "cpu")
    return jcfg, params, cfg, tp


def _prompts(vocab, lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n) for n in lengths]


def _jax_greedy(jcfg, params, prompts, max_new, t_max):
    """The reference's ``serve_batch`` loop, without its mesh."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    cache = JT.init_cache(jcfg, len(prompts), t_max, jnp.float32)
    logits, _, cache = JT.forward(params, jcfg, jnp.asarray(toks),
                                  cache=cache)
    steps = [np.asarray(logits[:, -1])]
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    out = []
    for _ in range(max_new):
        out.append(np.asarray(tok))
        logits, cache = JT.decode_step(params, jcfg, tok[:, None], cache)
        steps.append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    return toks, np.stack(out, 1), steps


def test_params_from_reference_keeps_the_tree(zamba):
    jcfg, params, cfg, tp = zamba
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat_j) == sum(1 for _ in leaves(tp))
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert torch.equal(node, torch.from_numpy(np.array(leaf)))
    with pytest.raises(ValueError):
        T.params_from_reference({"embed": 0}, cfg, "cpu")
    with pytest.raises(ValueError, match="not a"):
        T.params_from_reference(jax.tree.map(np.asarray, params),
                                dataclasses.replace(cfg, family="dense"),
                                "cpu")


def test_serve_batch_matches_reference_greedy_serving(zamba):
    """Port ``serve_batch`` on the CPU against the JAX model's prefill +
    8 greedy decode steps: the same tokens, and the same logits at every
    step when both are teacher-forced on the reference's tokens."""
    jcfg, params, cfg, tp = zamba
    prompts = _prompts(cfg.vocab, [5, 16, 9])
    toks, jout, jsteps = _jax_greedy(jcfg, params, prompts, 8, 32)
    reqs = [serve.Request(p, max_new=8) for p in prompts]
    stats = serve.serve_batch(ARCH, reqs, t_max=32, device="cpu", params=tp)
    assert np.array_equal(np.array([r.out for r in reqs]), jout)
    assert stats["decode_steps"] == 8 and stats["tok_per_s"] > 0
    close(stats["last_logits"], jsteps[-1])
    # teacher-forced on the reference's tokens, step by step
    cache = T.init_cache(cfg, len(prompts), 32, torch.float32, "cpu")
    logits, cache = T.forward(tp, cfg, t(toks).long(), cache=cache)
    close(logits[:, -1], jsteps[0])
    for i in range(8):
        logits, cache = T.decode_step(tp, cfg, t(jout[:, i:i + 1]).long(),
                                      cache)
        close(logits[:, -1], jsteps[i + 1])


def test_full_forward_matches_reference(zamba):
    jcfg, params, cfg, tp = zamba
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 20))
    jl, _, _ = JT.forward(params, jcfg, jnp.asarray(toks, jnp.int32))
    tl, none = T.forward(tp, cfg, t(toks))
    assert none is None and tl.shape == (2, 20, cfg.padded_vocab)
    close(tl, jl)


def test_decode_matches_full_forward(zamba):
    """The port's own invariant (cf. ``tests/test_models.py``): prefill
    + decode logits equal the full-sequence forward's."""
    _, _, cfg, tp = zamba
    toks = t(np.random.default_rng(9).integers(0, cfg.vocab, (2, 12)))
    full, _ = T.forward(tp, cfg, toks)
    cache = T.init_cache(cfg, 2, 16, torch.float32, "cpu")
    _, cache = T.forward(tp, cfg, toks[:, :10], cache=cache)
    for i in (10, 11):
        step, cache = T.decode_step(tp, cfg, toks[:, i:i + 1], cache)
        close(step[:, 0], full[:, i].numpy())
    assert cache["pos"] == 12


def test_init_params_shapes_follow_the_reference_tree():
    jcfg = jconfigs.get(ARCH, smoke=True)
    cfg = configs.get(ARCH, smoke=True)
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
    assert torch.equal(again["stack"]["rec"]["w_in"],
                       tp["stack"]["rec"]["w_in"])


@pytest.mark.parametrize("smoke", [True, False])
def test_param_count_matches_reference(smoke):
    got = configs.get(ARCH, smoke=smoke)
    want = jconfigs.get(ARCH, smoke=smoke)
    assert got.param_count() == want.param_count()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if not smoke:  # the published widths: 2.40 B parameters
        assert (got.n_layers, got.d_model, got.n_heads, got.hd,
                got.vocab) == (54, 2560, 32, 80, 32000)
        assert round(got.param_count() / 1e9, 2) == 2.40


def test_init_params_draws_the_layers_in_their_old_order():
    """The stack is filled layer by layer; the numbers are those of
    drawing every layer into a list and stacking it, with the shared
    block drawn after the stack (the hybrid slice's init before the
    stack was allocated once)."""
    cfg = configs.get(ARCH, smoke=True)
    tp = T.init_params(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    want = {"embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       torch.float32),
            "lm_head": layers.embed_init(gen, cfg.padded_vocab,
                                         cfg.d_model, torch.float32)}
    stack = [T._recurrent_layer_init(gen, cfg, torch.float32)
             for _ in range(cfg.n_layers)]
    want["shared_attn"] = T._dense_layer_init(gen, cfg, torch.float32)
    for key in ("embed", "lm_head"):
        assert torch.equal(tp[key], want[key])
    for i, lay in enumerate(stack):
        for key, v in lay["rec"].items():
            assert torch.equal(tp["stack"]["rec"][key][i], v), (i, key)
    for part in ("attn", "ffn"):
        for key, v in want["shared_attn"][part].items():
            assert torch.equal(tp["shared_attn"][part][key], v), key


@pytest.mark.parametrize("family", ["retnet", "moe"])
def test_unknown_family_or_layout_is_refused(family):
    cfg = dataclasses.replace(port_cfg(jconfigs.get("deepseek-moe-16b",
                                                    smoke=True)),
                              family=family)
    if family == "moe":
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, every=3))
    with pytest.raises(ValueError):
        T.init_params(cfg, device="cpu")
    with pytest.raises(ValueError):
        T.init_cache(cfg, 1, 8, device="cpu")


def test_serve_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_batch(ARCH, [serve.Request(np.arange(1, 4), 2)])
    with pytest.raises(ValueError, match="t_max"):
        serve.serve_batch(ARCH, [serve.Request(np.arange(1, 4), 2)],
                          t_max=4, device="cpu")


def test_serve_main_runs_on_cpu(capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "6",
                "--max-new", "3", "--t-max", "16"])
    out = capsys.readouterr().out
    assert "prefill" in out and "sample:" in out
