"""The port's Barabási–Albert graphs are the reference's, seed for seed:
``powerlaw`` (networkx's edges where networkx is installed, drawn by
``_nx_ba_edges`` without its ``Graph``), networkx's own edges, and the
native generator both packages fall back on."""

import numpy as np
import pytest

from repro.datalog import datasets as jdata
from repro_torch.datalog import datasets

nx = pytest.importorskip("networkx")

#: (n, m, seed): the smallest graphs, a star of m + 1 nodes and one
#: more, and the sizes and attachment counts the tests and phases use
CASES = [(2, 1, 0), (5, 4, 3), (300, 3, 0), (3000, 4, 1), (5000, 11, 2)]


@pytest.mark.parametrize("n,m,seed", CASES)
def test_the_draws_are_networkx_edges(n, m, seed):
    want = np.array(nx.barabasi_albert_graph(n, m, seed=seed).edges(),
                    np.int64)
    assert np.array_equal(datasets._nx_ba_edges(n, m, seed), want)


@pytest.mark.parametrize("n,m,seed", CASES)
def test_powerlaw_is_the_reference_graph(n, m, seed):
    got, want = datasets.powerlaw(n, m, seed), jdata.powerlaw(n, m, seed)
    assert got.n == want.n
    assert np.array_equal(got.edges, want.edges)


@pytest.mark.parametrize("n,m,seed", CASES)
def test_the_native_generator_is_the_reference_one(n, m, seed):
    got = datasets._ba_edges(n, m, np.random.default_rng(seed))
    want = jdata._ba_edges(n, m, np.random.default_rng(seed))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,m", [(4, 0), (4, 4), (1, 1)])
def test_an_attachment_count_outside_one_to_n_raises(n, m):
    with pytest.raises(ValueError, match="need 1 <= m < n"):
        datasets._nx_ba_edges(n, m, 0)
