"""Dataset generators for the paper's benchmarks (Sec. 8.1).

The counterpart of ``repro/datalog/datasets.py``.  The generators are
the reference's numpy code, so the same seed gives the same edges in
both packages: power-law stand-ins for the SNAP social graphs
(Barabási–Albert), Erdős–Rényi graphs, random recursive and
exponential-decay trees, and plain vectors (WS).  The adjacency
builders return tensors (dense boolean, or a COO
:class:`~repro_torch.sparse.coo.SparseRelation`) on a given device,
``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_mod


@dataclasses.dataclass
class Graph:
    n: int
    edges: np.ndarray  # (m, 2) int array
    weights: np.ndarray | None = None  # (m,) ints ≥ 1

    def adjacency(self, symmetric: bool = False, *,
                  device=None) -> torch.Tensor:
        a = np.zeros((self.n, self.n), bool)
        a[self.edges[:, 0], self.edges[:, 1]] = True
        if symmetric:
            a |= a.T
        return torch.from_numpy(a).to(device_mod.resolve(device))

    def sparse_adjacency(self, symmetric: bool = False, *,
                         semiring: str = "bool",
                         capacity: int | None = None, device=None):
        """E as a COO SparseRelation — never materializes n × n.

        ``semiring="bool"`` stores 1̄ per edge; ``"trop"``/``"maxplus"``
        store the edge weight (1 when unweighted) as the value.
        """
        from repro_torch.sparse.coo import SparseRelation
        edges = self.edges
        if symmetric:
            edges = np.concatenate([edges, edges[:, ::-1]])
        if semiring == "bool":
            vals = np.ones(len(edges), bool)
        else:
            w = (self.weights if self.weights is not None
                 else np.ones(len(self.edges), np.int64))
            vals = np.asarray(np.concatenate([w, w]) if symmetric else w,
                              np.float32)
        return SparseRelation.from_coo(edges, vals, (self.n, self.n),
                                       semiring, capacity=capacity,
                                       device=device)

    def weighted_adjacency(self, wmax: int, *, device=None) -> torch.Tensor:
        """E(x, y, w) as a dense boolean (n, n, wmax) tensor."""
        w = self.weights if self.weights is not None else \
            np.ones(len(self.edges), np.int64)
        t = np.zeros((self.n, self.n, wmax), bool)
        t[self.edges[:, 0], self.edges[:, 1], np.minimum(w, wmax - 1)] = True
        return torch.from_numpy(t).to(device_mod.resolve(device))

    def vertex_set(self, *, device=None) -> torch.Tensor:
        return torch.ones((self.n,), dtype=torch.bool,
                          device=device_mod.resolve(device))


def erdos_renyi(n: int, avg_deg: float, seed: int = 0,
                weighted: bool = False, wmax: int = 8) -> Graph:
    rng = np.random.default_rng(seed)
    p = min(1.0, avg_deg / max(1, n - 1))
    mask = rng.random((n, n)) < p
    np.fill_diagonal(mask, False)
    edges = np.argwhere(mask)
    weights = rng.integers(1, wmax, len(edges)) if weighted else None
    return Graph(n, edges, weights)


def powerlaw(n: int, m_attach: int = 4, seed: int = 0) -> Graph:
    """Barabási–Albert stand-in for the SNAP social graphs (networkx
    when available, else the native generator — the reference's rule,
    so both packages draw the same edges)."""
    try:
        import networkx as nx
    except ImportError:
        edges = _ba_edges(n, m_attach, np.random.default_rng(seed))
    else:
        g = nx.barabasi_albert_graph(n, m_attach, seed=seed)
        edges = np.array(g.edges(), np.int64)
    edges = np.concatenate([edges, edges[:, ::-1]])  # directed both ways
    return Graph(n, edges)


def _ba_edges(n: int, m: int, rng: np.random.Generator) -> np.ndarray:
    """Preferential attachment via the repeated-nodes trick: each new
    vertex draws ``m`` distinct targets ∝ degree from the flat endpoint
    list.  O(n·m)."""
    if not 1 <= m < n:
        raise ValueError(f"need 1 <= m < n, got m={m}, n={n}")
    src, dst = [], []
    repeated: list[int] = []
    targets = list(range(m))
    for v in range(m, n):
        src.extend([v] * len(targets))
        dst.extend(targets)
        repeated.extend(targets)
        repeated.extend([v] * m)
        picks: set[int] = set()
        while len(picks) < m:
            take = rng.integers(0, len(repeated),
                                size=2 * (m - len(picks)))
            picks.update(repeated[t] for t in take)
            while len(picks) > m:
                picks.pop()
        targets = list(picks)
    return np.stack([np.asarray(src, np.int64),
                     np.asarray(dst, np.int64)], axis=1)


def erdos_renyi_sparse(n: int, avg_deg: float, seed: int = 0,
                       weighted: bool = False, wmax: int = 8) -> Graph:
    """G(n, p) by direct edge sampling — O(m) memory."""
    rng = np.random.default_rng(seed)
    p = min(1.0, avg_deg / max(1, n - 1))
    m = int(rng.binomial(n * (n - 1), p))
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    edges = np.unique(np.stack([src[keep], dst[keep]], axis=1), axis=0)
    weights = rng.integers(1, wmax, len(edges)) if weighted else None
    return Graph(n, edges, weights)


def random_recursive_tree(n: int, seed: int = 0) -> Graph:
    """Node i attaches uniformly to j<i: expected depth O(log n)."""
    rng = np.random.default_rng(seed)
    parents = np.array([rng.integers(0, i) for i in range(1, n)])
    edges = np.stack([parents, np.arange(1, n)], axis=1)  # parent -> child
    return Graph(n, edges)


def decay_tree(n: int, tau: float = 1.5, seed: int = 0) -> Graph:
    """Exponential-decay attachment: node i attaches to j<i with
    P ∝ exp(-(i-j)/τ); small τ yields expected depth O(n)."""
    rng = np.random.default_rng(seed)
    parents = []
    for i in range(1, n):
        w = np.exp(-np.arange(i, 0, -1) / tau)
        parents.append(rng.choice(i, p=w / w.sum()))
    edges = np.stack([np.array(parents), np.arange(1, n)], axis=1)
    return Graph(n, edges)


def path_graph(n: int) -> Graph:
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return Graph(n, edges)


def vector_data(n: int, seed: int = 0, vmax: int = 8) -> np.ndarray:
    """A(j, w) for WS: small random ints so the value domain stays
    bounded."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, vmax, n)
