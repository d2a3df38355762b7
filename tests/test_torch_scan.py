"""B4 ``ssm_scan`` in the CUDA kernel's order, against the JAX package.

``ref.ssm_scan_blocked`` computes what ``csrc/ssm_scan.cu`` computes, in
its order (time tiles with a carry, sub-chunk aggregates combined in
doubling rounds, the carry injected); ``ref.ssm_scan_ref`` is the plain
version the wrapper takes on the CPU.  The same numpy inputs, made from
a seed, go through both and through the reference's
``ssm_scan_sequential`` and ``ssm_scan_chunked``
(``repro/kernels/ref.py``), at the stress cases the kernel must take: T
of 1, T not a multiple of the tile, T = 4096 at B·D = 24, a
near-integrator (a ∈ [0.999, 1)) over that T, exact zeros in a
(resets), and D = 33.

Tolerance: ``max |err| <= 1e-4 · max(1, max |reference|)``, the kernel's
own on the card (float sums in another association than the
reference's serial loop).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as scan

#: name → (B, T, D, kind of a)
CASES = {
    "t1": (3, 1, 40, "decay"),
    "ragged_t": (2, 300, 48, "decay"),
    "long_t": (2, 4096, 12, "decay"),
    "integrator": (2, 4096, 12, "near1"),
    "resets": (2, 517, 20, "zeros"),
    "d33": (2, 260, 33, "decay"),
}

#: (tile, groups): the kernel's, and other blockings of the same order
BLOCKINGS = [(scan.TILE, scan.GROUPS), (64, 4), (32, 32), (128, 1)]


@functools.lru_cache(maxsize=None)
def _case(name):
    bsz, t_len, d, kind = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    shape = (bsz, t_len, d)
    if kind == "near1":
        a = rng.uniform(0.999, 1.0, shape)
    else:   # the sigmoid decay the models feed B4
        a = 1.0 / (1.0 + np.exp(-(rng.standard_normal(shape) + 2.0)))
    if kind == "zeros":
        a[rng.random(shape) < 0.1] = 0.0
    # in f32, below 1 (a draw near 1 would round up to it)
    a = np.minimum(a.astype(np.float32), np.nextafter(np.float32(1), 0))
    b = rng.standard_normal(shape).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = {"sequential": np.asarray(jref.ssm_scan_sequential(ja, jb)),
            "chunked": np.asarray(jref.ssm_scan_chunked(ja, jb))}
    return torch.from_numpy(a), torch.from_numpy(b), want


def _close(got, want):
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-4 * scale, (err, scale)


def test_cases_are_what_they_claim():
    a, _, _ = _case("integrator")
    assert float(a.min()) >= 0.999 and float(a.max()) < 1.0
    a, _, _ = _case("resets")
    assert int((a == 0).sum()) > 0
    a, _, _ = _case("long_t")
    assert a.shape[1] == 4096 and a.shape[0] * a.shape[2] == 24
    assert _case("ragged_t")[0].shape[1] % scan.TILE != 0
    assert _case("d33")[0].shape[2] == 33
    assert _case("t1")[0].shape[1] == 1


@pytest.mark.parametrize("reference", ["sequential", "chunked"])
@pytest.mark.parametrize("tile,groups", BLOCKINGS)
@pytest.mark.parametrize("case", list(CASES))
def test_blocked_matches_reference(case, tile, groups, reference):
    a, b, want = _case(case)
    _close(ref.ssm_scan_blocked(a, b, tile=tile, groups=groups),
           want[reference])


@pytest.mark.parametrize("reference", ["sequential", "chunked"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_reference(case, reference):
    a, b, want = _case(case)
    _close(ref.ssm_scan_ref(a, b), want[reference])
    _close(scan.ssm_scan(a, b), want[reference])


@pytest.mark.parametrize("case", list(CASES))
def test_blocked_one_group_one_tile_is_the_serial_loop(case):
    """With one group and one tile the blocked order is the literal
    loop, bit for bit: the carry-in is 0 and nothing is combined."""
    a, b, _ = _case(case)
    got = ref.ssm_scan_blocked(a, b, tile=a.shape[1], groups=1)
    assert torch.equal(got, ref.ssm_scan_sequential(a, b))


def test_blocked_is_the_recurrence_across_tiles_and_groups():
    """Small exact case crossing a group and a tile boundary, a reset
    (a = 0) inside it: tile 4, 2 groups of 2 rows, T = 6."""
    a = torch.tensor([[[0.5], [2.0], [0.0], [1.0], [0.5], [2.0]]])
    b = torch.tensor([[[1.0], [1.0], [3.0], [-1.0], [2.0], [0.5]]])
    want = torch.tensor([[[1.0], [3.0], [3.0], [2.0], [3.0], [6.5]]])
    assert torch.equal(ref.ssm_scan_blocked(a, b, tile=4, groups=2), want)


def test_blocked_rejects_a_tile_the_groups_do_not_divide():
    x = torch.ones(1, 8, 4)
    with pytest.raises(ValueError, match="multiple"):
        ref.ssm_scan_blocked(x, x, tile=12, groups=8)
