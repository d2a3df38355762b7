"""Global constraints Γ and Γ-constrained database sampling (Sec. 3.3).

The paper checks the FGH identity only over databases satisfying Γ (e.g.
"the graph is a tree").  Offline (no SMT solver), our verifier evaluates
both sides on *sampled* databases; Γ therefore becomes a constrained
generator: ``tree`` yields random parent trees, ``dag`` topologically
ordered DAGs, ``none`` unconstrained relations.  Samplers mask binary
relations to V×V so instances are well-formed.

The counterpart of ``repro/core/constraints.py``: the same draws from
the same generator, so one seed gives the same databases in both
packages.  The databases are tiny and live on the CPU (the engine's np
backend reads them as zero-copy views).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.core import engine, ir


def sample_database(schema: ir.Schema, edbs: list[str],
                    domains: Mapping[str, int], rng: np.random.Generator, *,
                    constraint: str | None = None,
                    density: float = 0.4) -> engine.Database:
    rels: dict[str, np.ndarray] = {}
    n = domains.get("id", 3)

    v = None
    if "V" in edbs:
        v = rng.random(n) < 0.8
        if not v.any():
            v[rng.integers(0, n)] = True
        rels["V"] = v

    for name in edbs:
        if name == "V" or name in rels:
            continue
        rs = schema[name]
        shape = tuple(domains[s] for s in rs.sorts)
        if name == "E" and constraint == "tree":
            e = _random_tree(n, rng)
            if v is not None:
                rels["V"] = np.ones(n, bool)  # tree constraint: all nodes
                v = np.ones(n, bool)
            rels[name] = e
            continue
        if name == "E" and constraint == "dag":
            e = np.triu(rng.random((n, n)) < density, 1)
            rels[name] = _mask_v(e, v)
            continue
        if rs.semiring == "bool":
            t = rng.random(shape) < density
            if rs.sorts[:2] == ("id", "id"):
                t = _mask_v(t, v)
                if len(shape) == 2:
                    np.fill_diagonal(t, False)
            rels[name] = t
        elif rs.semiring == "trop":
            t = rng.integers(0, 3, shape).astype(np.float32)
            t[rng.random(shape) > density] = np.inf
            rels[name] = t
        elif rs.semiring == "maxplus":
            t = rng.integers(0, 3, shape).astype(np.float32)
            t[rng.random(shape) > density] = -np.inf
            rels[name] = t
        else:  # nat / real: small non-negative values
            t = rng.integers(0, 3, shape).astype(np.float32)
            rels[name] = t
    return engine.Database(schema, dict(domains), rels, "cpu")


def _mask_v(e: np.ndarray, v: np.ndarray | None) -> np.ndarray:
    if v is None:
        return e
    m = e.copy()
    m[~v, ...] = False
    if m.ndim >= 2:
        m[:, ~v, ...] = False
    return m


def _random_tree(n: int, rng: np.random.Generator) -> np.ndarray:
    e = np.zeros((n, n), bool)
    for i in range(1, n):
        e[rng.integers(0, i), i] = True  # parent -> child
    return e


def exhaustive_databases(schema: ir.Schema, edbs: list[str],
                         domains: Mapping[str, int], *,
                         constraint: str | None = None, limit: int = 64):
    """Exhaust tiny boolean EDB spaces (n=2) for the bounded-model check.

    Only enumerates when the total boolean EDB bit-count is small; yields
    at most ``limit`` databases (all of them when the space is ≤ limit).
    """
    import itertools

    bool_edbs = [e for e in edbs if schema[e].semiring == "bool"]
    if len(bool_edbs) != len(edbs):
        return  # mixed-semiring EDBs: sampling only
    shapes = {e: tuple(domains[s] for s in schema[e].sorts) for e in bool_edbs}
    bits = sum(int(np.prod(shapes[e])) for e in bool_edbs)
    if bits > 16:
        return
    total = 1 << bits
    step = max(1, total // limit)
    for idx in range(0, total, step):
        rels = {}
        rest = idx
        ok = True
        for e in bool_edbs:
            size = int(np.prod(shapes[e]))
            val = rest & ((1 << size) - 1)
            rest >>= size
            arr = np.array([(val >> i) & 1 for i in range(size)],
                           bool).reshape(shapes[e])
            if e == "E" and constraint == "tree" and not _is_forest(arr):
                ok = False
                break
            rels[e] = arr
        if ok:
            yield engine.Database(schema, dict(domains), rels, "cpu")


def _is_forest(e: np.ndarray) -> bool:
    n = e.shape[0]
    if e.ndim != 2:
        return True
    indeg = e.sum(axis=0)
    if (indeg > 1).any() or np.trace(e) > 0:
        return False
    # acyclic check via repeated leaf removal
    e = e.copy()
    alive = np.ones(n, bool)
    for _ in range(n):
        leaves = alive & (e.sum(axis=1) == 0)
        if not leaves.any():
            break
        e[:, leaves] = False
        alive &= ~leaves
    return not alive.any() or e[alive][:, alive].sum() == 0
