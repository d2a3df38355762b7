"""B5 at head dims past 128: the ``wide_simt`` and ``wide_chunk``
routes against the JAX package.

The reference's kernel (``repro/kernels/flash_attention.py:32``) takes
any D; the port's ``plan_attention`` sends 128 < D ≤ 256 to its
``wide_simt`` kernels (forward, and the backward's ``dkdv`` and ``dq``)
and any D past 256 to its ``wide_chunk`` kernels.  On the CPU the route
is the plain version, so these tests hold it against the reference's
Pallas kernel in interpret mode (forward) and ``jax.vjp`` of its
``_sdpa`` (backward) at D = 136, 200, 256 and, past 256, 320, 512 and
576, for every mask, GQA and a decode step that reads the written
prefix of a KV cache as a strided view; the kernels themselves run on
the card (``tests/test_torch_gpu.py -k wide``).

Tolerance: f32 ``atol = rtol = 1e-4`` (the packages sum in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

TOL = dict(atol=1e-4, rtol=1e-4)
#: the wide_simt route's head dims, then wide_chunk's
SIMT_DIMS = (136, 200, 256)
CHUNK_DIMS = (320, 512, 576)
DIMS = SIMT_DIMS + CHUNK_DIMS

#: name → (B, Tq, Tk, Hq, Hkv, mask keywords): causal, a window and a
#: chunk edge inside the sequence, no mask, GQA groups 1, 2 and 4, and a
#: decode step (one query at position Tk - 1); no row is fully masked
CASES = {
    "causal_gqa2": (2, 24, 24, 4, 2, {}),
    "window_gqa4": (1, 40, 40, 8, 2, {"window": 9}),
    "chunk": (1, 40, 40, 2, 2, {"chunk": 16}),
    "non_causal": (2, 16, 16, 2, 1, {"causal": False}),
    "q_offset": (1, 6, 30, 4, 2, {"q_offset": 24}),
    "decode": (3, 1, 37, 4, 2, {"q_offset": 36}),
}


def _kw(extra):
    return {"causal": extra.get("causal", True),
            "window": extra.get("window"), "chunk": extra.get("chunk"),
            "q_offset": extra.get("q_offset", 0)}


def _inputs(name, d, seed=0, slots=None):
    """q, k, v, dO (numpy f32); k and v the first Tk of ``slots`` rows
    when given (a cache's written prefix)."""
    b, tq, tk, hq, hkv, _ = CASES[name]
    rng = np.random.default_rng([seed, d])
    n = slots or tk
    q = rng.standard_normal((b, tq, hq, d)).astype(np.float32)
    ck = rng.standard_normal((b, n, hkv, d)).astype(np.float32)
    cv = rng.standard_normal((b, n, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, tq, hq, d)).astype(np.float32)
    return q, ck, cv, do


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", CASES)
def test_forward_matches_the_reference_kernel(name, d):
    """The port's B5 on CPU tensors against the reference's Pallas
    kernel in interpret mode."""
    q, k, v, _ = _inputs(name, d)
    kw = _kw(CASES[name][-1])
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
        **kw))
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("d", DIMS)
def test_decode_reads_a_strided_cache_view(d):
    """A decode step over the written prefix of a 64-slot cache, handed
    in as a view: the reference's kernel on the prefix copied out."""
    q, ck, cv, _ = _inputs("decode", d, seed=1, slots=64)
    tk = CASES["decode"][2]
    kw = _kw(CASES["decode"][-1])
    k, v = torch.from_numpy(ck)[:, :tk], torch.from_numpy(cv)[:, :tk]
    assert not k.is_contiguous()
    got = fa.flash_attention(torch.from_numpy(q), k, v, **kw)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(ck[:, :tk]), jnp.asarray(cv[:, :tk]),
        interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _jax_vjp(name, q, k, v, do):
    kw = _kw(CASES[name][-1])
    qpos = kw["q_offset"] + jnp.arange(q.shape[1])
    kpos = jnp.arange(k.shape[1])

    def f(q, k, v):
        return jattn._sdpa(q, k, v, qpos, kpos, causal=kw["causal"],
                           window=kw["window"], chunk=kw["chunk"],
                           is_global=False)
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(o), *map(np.asarray, vjp(jnp.asarray(do))))


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", ["causal_gqa2", "window_gqa4", "chunk",
                                  "q_offset"])
def test_attn_fn_gradient_matches_the_reference(name, d):
    """``AttnFn`` (B5 writing lse, then its backward) against ``jax.vjp``
    of the reference's ``_sdpa``."""
    q, k, v, do = _inputs(name, d, seed=2)
    jo, jdq, jdk, jdv = _jax_vjp(name, q, k, v, do)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = ops.flash_attention(*leaves, **_kw(CASES[name][-1]))
    assert type(o.grad_fn).__name__ == "AttnFnBackward"
    np.testing.assert_allclose(o.detach().numpy(), jo, **TOL)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    for g, want in zip(got, (jdq, jdk, jdv)):
        np.testing.assert_allclose(g.numpy(), want, **TOL)


@pytest.mark.parametrize("d", [129, *SIMT_DIMS])
@pytest.mark.parametrize("tq, hq, hkv", [(1, 16, 8), (37, 6, 3),
                                         (1024, 16, 8)])
def test_plan_sends_wide_heads_to_wide_simt(d, tq, hq, hkv):
    """128 < D ≤ 256: one block a 16-row tile of a kv head's group
    (rows r = i·g + gi), every row covered; the backward's route too."""
    path, geo = fa.plan_attention(2, tq, tq, hq, hkv, d)
    assert path == "wide_simt" and geo.q_tile == fa.WIDE_ROWS == 16
    rows = tq * (hq // hkv)
    assert geo.grid == (-(-rows // 16), hkv, 2)
    assert (geo.grid[0] - 1) * 16 < rows <= geo.grid[0] * 16
    assert fa.backward_path(d) == "wide_simt"


@pytest.mark.parametrize("d", [8, 80, 128])
def test_plan_keeps_the_tensor_core_paths_up_to_128(d):
    assert fa.plan_attention(2, 100, 100, 4, 4, d)[0] == "prefill_tc"
    assert fa.plan_attention(2, 1, 100, 4, 4, d)[0] == "decode_split"
    assert fa.backward_path(d) == "tc"


@pytest.mark.parametrize("d", [257, 512])
def test_plan_refuses_heads_past_256(d):
    """Heads past 256 are no longer refused: ``wide_chunk`` takes them,
    a grid over 16-row tiles times 256-column chunks, and the backward
    goes the same route; a head dim of 0 is still refused."""
    path, geo = fa.plan_attention(1, 4, 4, 2, 2, d)
    assert path == "wide_chunk" and geo.q_tile == fa.WIDE_ROWS
    assert geo.grid == (-(-d // fa.CHUNK_COLS), 2, 1)
    assert fa.backward_path(d) == "wide_chunk"
    with pytest.raises(ValueError, match="head dim 0"):
        fa.plan_attention(1, 4, 4, 2, 2, 0)
