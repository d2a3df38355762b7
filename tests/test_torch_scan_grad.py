"""B4's gradient, ``ScanFn``, against the JAX package and torch autograd.

The reference has no backward kernel (JAX has no transpose rule for
``pallas_call``): it trains through its plain scan, so ``jax.grad`` of
``repro.kernels.ref.ssm_scan_ref`` is the reference gradient.
``ScanFn``'s backward is one more scan run backwards in time
(``ssm_scan.scan_backward``); on the CPU both of its scans are the plain
version, on the card B4 (``tests/test_torch_gpu.py``).  The same numpy
inputs, made from a seed, go through ``jax.grad``, ``ScanFn`` and torch
autograd through ``ssm_scan_plain``.

Tolerance: f32 ``atol = rtol = 1e-4`` (the scans sum in other orders);
against autograd in float64, ``1e-12``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as scan

#: name → (B, T, D): T = 1, an odd T, B = 1, a T that crosses the
#: kernel's 128-row tile
SHAPES = {"t1": (3, 1, 8), "odd_t": (2, 37, 5), "b1": (1, 64, 16),
          "cross_tile": (2, 200, 6)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-(rng.standard_normal(shape) + 2.0))))
    return (a.astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _leaf(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype).requires_grad_(True)


@pytest.mark.parametrize("name", SHAPES)
def test_scan_grad_matches_jax_grad_of_the_reference(name):
    a, b, g = _inputs(SHAPES[name])

    def loss(a, b):
        return jnp.sum(jref.ssm_scan_ref(a, b) * g)

    ja, jb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = _leaf(a), _leaf(b)
    h = ops.ssm_scan(ta, tb)
    assert h.grad_fn is not None and "ScanFn" in type(h.grad_fn).__name__
    da, db = torch.autograd.grad(h, (ta, tb), torch.from_numpy(g))
    np.testing.assert_allclose(da.numpy(), np.asarray(ja), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(jb), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("name", SHAPES)
def test_scan_grad_matches_autograd_through_the_plain_scan(name):
    a, b, g = _inputs(SHAPES[name], seed=1)
    ta, tb = _leaf(a, torch.float64), _leaf(b, torch.float64)
    gt = torch.from_numpy(g).double()
    got = torch.autograd.grad(scan.ScanFn.apply(ta, tb), (ta, tb), gt)
    want = torch.autograd.grad(scan.ssm_scan_plain(ta, tb), (ta, tb), gt,
                               allow_unused=True, materialize_grads=True)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("shape", [(2, 9, 3), (1, 1, 2), (1, 130, 2)])
def test_scan_fn_gradcheck(shape):
    a, b, _ = _inputs(shape, seed=2)
    assert torch.autograd.gradcheck(
        scan.ScanFn.apply,
        (_leaf(a, torch.float64), _leaf(b, torch.float64)))


def test_scan_grad_reaches_b_with_a_frozen():
    a, b, g = _inputs((2, 11, 4), seed=3)
    ta = torch.from_numpy(a)                       # a frozen
    tb = _leaf(b)
    (db,) = torch.autograd.grad(ops.ssm_scan(ta, tb), (tb,),
                                torch.from_numpy(g))
    h = scan.ssm_scan(ta, tb.detach())
    _, lam = scan.scan_backward(ta, h, torch.from_numpy(g))
    torch.testing.assert_close(db, lam)


def test_ops_scan_records_a_graph_only_when_autograd_would():
    """Without grad mode, or with no input requiring grad, ops.ssm_scan
    is the one plain call serving makes: no autograd node."""
    a, b, _ = _inputs((2, 7, 3))
    ta, tb = _leaf(a), _leaf(b)
    with torch.no_grad():
        assert ops.ssm_scan(ta, tb).grad_fn is None
    frozen = ops.ssm_scan(ta.detach(), tb.detach())
    assert frozen.grad_fn is None and not frozen.requires_grad
    torch.testing.assert_close(frozen, scan.ScanFn.apply(ta, tb).detach())
