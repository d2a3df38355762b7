"""Port parity: semirings of ``repro_torch`` against ``repro``.

Every operation over every pair drawn from ``np_value_pool`` must come
out bit-identical in both packages (same dtype, same values), and so
must the ⊕-combining drop-mode scatter behind COO materialization.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsr
from repro_torch.core import semiring as tsr

NAMES = ("bool", "trop", "maxplus", "nat", "real")
BINARY = ("add", "mul", "leq", "minus")


def _pairs(name):
    pool = jsr.np_value_pool(jsr.get(name))
    a, b = zip(*itertools.product(pool, pool))
    return np.asarray(a, pool.dtype), np.asarray(b, pool.dtype)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want, equal_nan=True), (got, want)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("op", BINARY)
def test_binary_ops_bit_exact(name, op):
    js, ts = jsr.get(name), tsr.get(name)
    if getattr(js, op) is None:
        assert getattr(ts, op) is None
        return
    a, b = _pairs(name)
    want = getattr(js, op)(jnp.asarray(a), jnp.asarray(b))
    _same(getattr(ts, op)(torch.from_numpy(a), torch.from_numpy(b)), want)


@pytest.mark.parametrize("name", NAMES)
def test_constants_dtypes_and_cast(name):
    js, ts = jsr.get(name), tsr.get(name)
    assert (ts.zero, ts.one, ts.idempotent) == (js.zero, js.one,
                                                js.idempotent)
    bits = np.array([False, True, True, False])
    _same(ts.from_bool(torch.from_numpy(bits)),
          js.from_bool(jnp.asarray(bits)))
    _same(ts.zeros((3,)), js.zeros((3,)))
    _same(ts.ones((2, 2)), js.ones((2, 2)))
    assert np.array_equal(tsr.np_value_pool(ts),
                          jsr.np_value_pool(js), equal_nan=True)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
def test_add_reduce(name, axis):
    a, b = _pairs(name)
    x = np.stack([a, b]).reshape(2, 4, -1)
    want = jsr.get(name).add_reduce(jnp.asarray(x), axis=axis)
    _same(tsr.get(name).add_reduce(torch.from_numpy(x), axis=axis), want)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("payload", [(), (3,)])
def test_scatter_op_drop_mode(name, payload):
    """⊕-scatter with out-of-range (sentinel) ids dropped, as the
    reference's ``x.at[idx].max/min/add(mode="drop")``."""
    rng = np.random.default_rng(len(name) * 7 + len(payload))
    js = jsr.get(name)
    n, m = 9, 40
    ids = rng.integers(0, n + 3, m)
    pool = jsr.np_value_pool(js)
    vals = pool[rng.integers(0, len(pool), (m,) + payload)]
    base = np.full((n,) + payload, js.zero, pool.dtype)
    want = jsr.scatter_op(name, jnp.asarray(base).at[jnp.asarray(ids)])(
        jnp.asarray(vals), mode="drop")
    got = tsr.scatter_op(name, torch.from_numpy(base),
                         torch.from_numpy(ids), torch.from_numpy(vals))
    _same(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_numpy_twins_match(name):
    a, b = _pairs(name)
    jn, tn = jsr.get(name, lib="np"), tsr.get(name, lib="np")
    for op in BINARY:
        if getattr(jn, op) is None:
            assert getattr(tn, op) is None
            continue
        assert np.array_equal(getattr(tn, op)(a, b), getattr(jn, op)(a, b),
                              equal_nan=True)
    assert tsr.NP_COMBINE[name] is jsr.NP_COMBINE[name]
