"""B4 and B5 on bf16 and f16 inputs, on the CPU, against the JAX package.

The port computes both kernels in f32: bf16 and f16 inputs are cast to
f32 at the entry, forward and backward, and the outputs cast back to
the input's type (``cuda_lib.f32_entry``), the same on either device.
So on the CPU a half-type call equals the f32 call on the upcast inputs,
cast down, bit for bit.  The reference's Pallas kernels, in interpret
mode, are held to it within one unit in the last place of the type at
the output's largest entry (``eps · max(1, max |reference|)``: both
round an f32 result, summed in other orders, to the half type):

* B5 (``flash_attention_pallas``) casts q, k and v to f32 and stores in
  ``q.dtype``: it takes the same half-type inputs.
* B4 (``ssm_scan_pallas``) scans a time block in the input's type and
  keeps only its carry in f32, so it runs on the upcast inputs and its
  f32 output is cast down.

The gradients (``ScanFn``, ``AttnFn``) come back in the input's type,
within two units of the f32 gradient cast down (the backward's last
products round in the half type).  bf16 training runs on the CPU for a
recurrent, a hybrid and a dense family.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro_torch.kernels import cuda_lib, ops, ref
from repro_torch.launch import train as train_mod
from repro_torch.optimizer.optimizers import tree_leaves

HALF = {"bf16": (torch.bfloat16, jnp.bfloat16),
        "f16": (torch.float16, jnp.float16)}


def _within(got, want, units=1):
    """``got`` within ``units`` ulps of its type at ``want``'s largest
    entry (both compared in f32)."""
    eps = torch.finfo(got.dtype).eps
    want = torch.from_numpy(np.array(want, np.float32))
    err = float((got.float() - want).abs().max())
    assert err <= units * eps * max(1.0, float(want.abs().max())), err


def _scan_inputs(dtype, shape=(2, 64, 24)):
    rng = np.random.default_rng(3)
    a = 1.0 / (1.0 + np.exp(-(rng.standard_normal(shape) + 2.0)))
    b = rng.standard_normal(shape)
    return (torch.from_numpy(a.astype(np.float32)).to(dtype),
            torch.from_numpy(b.astype(np.float32)).to(dtype))


@pytest.mark.parametrize("half", list(HALF))
def test_scan_on_half_types(half):
    dtype, _ = HALF[half]
    a, b = _scan_inputs(dtype)
    got = ops.ssm_scan(a, b)
    assert got.dtype == dtype
    f32 = ref.ssm_scan_ref(a.float(), b.float())
    assert torch.equal(got, f32.to(dtype))
    pallas = ssm_scan_pallas(jnp.asarray(a.float().numpy()),
                             jnp.asarray(b.float().numpy()), bt=32,
                             interpret=True)
    _within(got, np.asarray(pallas))


@pytest.mark.parametrize("half", list(HALF))
def test_scan_gradient_on_half_types(half):
    dtype, _ = HALF[half]
    a, b = _scan_inputs(dtype)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        a.shape).astype(np.float32))
    leaves = [x.clone().requires_grad_(True) for x in (a, b)]
    h = ops.ssm_scan(*leaves)
    grads = torch.autograd.grad(h, leaves, g.to(dtype))
    f32 = [x.float().requires_grad_(True) for x in (a, b)]
    want = torch.autograd.grad(ref.ssm_scan_ref(*f32), f32, g)
    for got, w in zip(grads, want):
        assert got.dtype == dtype
        _within(got, w.to(dtype).float(), units=2)


def _attn_inputs(dtype, b=2, t=32, hq=4, hkv=2, d=16):
    rng = np.random.default_rng(5)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in ((b, t, hq, d), (b, t, hkv, d),
                                 (b, t, hkv, d), (b, t, hq, d))]


@pytest.mark.parametrize("kw", [{}, {"window": 8}, {"chunk": 16},
                                {"causal": False}])
@pytest.mark.parametrize("half", list(HALF))
def test_attention_on_half_types(half, kw):
    dtype, jdtype = HALF[half]
    q, k, v, _ = _attn_inputs(dtype)
    got = ops.flash_attention(q, k, v, **kw)
    assert got.dtype == dtype
    f32 = ref.attention_ref(q.float(), k.float(), v.float(), **kw)
    assert torch.equal(got, f32.to(dtype))
    pallas = flash_attention_pallas(
        *(jnp.asarray(x.float().numpy(), jdtype) for x in (q, k, v)),
        bq=16, bkv=16, interpret=True, **kw)
    assert pallas.dtype == jdtype
    _within(got, np.asarray(pallas.astype(jnp.float32)))


@pytest.mark.parametrize("half", list(HALF))
def test_attention_gradient_on_half_types(half):
    dtype, _ = HALF[half]
    q, k, v, do = _attn_inputs(dtype)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = ops.flash_attention(*leaves, window=12)
    assert type(o.grad_fn).__name__ == "AttnFnBackward"
    grads = torch.autograd.grad(o, leaves, do)
    f32 = [x.float().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*f32, window=12), f32,
                               do.float())
    for got, w in zip(grads, want):
        assert got.dtype == dtype
        _within(got, w.to(dtype).float(), units=2)


def test_f32_entry_casts_only_one_half_type():
    x = torch.ones(2, dtype=torch.bfloat16)
    (y,), back = cuda_lib.f32_entry("t", x)
    assert y.dtype == torch.float32 and back(y).dtype == torch.bfloat16
    d = torch.ones(2, dtype=torch.float64)
    (z,), back = cuda_lib.f32_entry("t", d)      # left to require()
    assert z is d and back(z) is z
    with pytest.raises(TypeError, match="mixed"):
        cuda_lib.f32_entry("t", x, x.half())


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b",
                                  "minicpm-2b"])
def test_bf16_training_on_the_cpu(arch):
    params, losses = train_mod.train(arch, steps=2, batch=2, seq=16,
                                     device="cpu", dtype=torch.bfloat16,
                                     log_every=100)
    assert np.isfinite(losses).all()
    assert torch.bfloat16 in {p.dtype for p in tree_leaves(params)}
