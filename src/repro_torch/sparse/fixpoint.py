"""Semi-naive fixpoint over sparse S-relations: staged loop and worklist.

The counterpart of ``repro/sparse/fixpoint.py``.  It solves the linear
vector equation (the GH-form of BM/CC/SSSP after the FGH rewrite)

    x[y]  =  init[y] ⊕ ⊕_z x[z] ⊗ E[z, y]

by GSN rounds ``y ⊕= Δ; Δ = (Δ ⊗ E) ⊖ y`` for one source (``(n,)``
init) or a ``(B, n)`` pack of sources.  Two modes share the round body,
so their carries are interchangeable mid-stream:

* ``mode="jit"`` — the staged loop (``lax.while_loop`` becomes a Python
  loop): Δ is a dense ``(n, B)`` carry re-derived in O(nnz(E)) a round;
  the carry, the per-row ``live`` mask and the per-row counts stay on
  the device, and only the "any row live" test reads the host, once a
  round.  Three backends advance Δ: ``"torch"`` — the gather/⊗/segment-⊕
  composition of :mod:`repro_torch.sparse.contract` whose ⊕ is kernel
  B3's ``runs`` path — ``"kernel"`` — the fused SpMM kernel B1 — and
  ``"fused"``, the CPU host loop (the reference's
  ``_fused_host_fixpoint``): 𝔹 rounds on the carry packed into uint64
  words of 64 lanes (:func:`repro_torch.kernels.coo_spmm.
  bool_round_packed`), the other lattices on B1's plain version.  Its
  rounds, live masks and counts are the other backends'; on a CUDA
  tensor it raises (on the card B1 runs the rounds).
* ``mode="frontier"`` — the worklist: each round expands only the
  out-edges of the live Δ entries through a CSR index of the edges
  (:func:`csr_index`, cached per buffer pair and extended by
  ``SparseRelation.apply_delta`` / ``delete_keys`` without a re-sort),
  so a round costs O(Σ_{z ∈ frontier} deg(z)).  It runs on the
  relation's device: the frontier's out-edges come from the index by a
  ``repeat_interleave`` over the degrees, ⊗ is torch, and the ⊕ into
  the ``(n,)`` derived vector is kernel B3's ``scatter`` path (the ids
  are new every round, so they have no segment plan).  A round reads
  the host once, for the frontier size, the expanded-edge count and the
  overlay hits together (:class:`FrontierStats` records them).  A
  ``(B, n)`` pack runs one worklist per row.

``mode="auto"`` is the frontier on CPU tensors and the staged loop on
CUDA ones, as the reference's is on a CPU host and on an accelerator;
budgeted ``auto`` calls take the staged chunk.  :func:`fixpoint`'s own
default is ``"jit"``.

Iteration counts: a row counts a round whenever it enters it live.  A
cold staged run starts every row live, so an all-0̄ (inert) row counts
one round there; the worklist starts from the live Δ and counts 0 for
it, as the reference's frontier does.
"""

from __future__ import annotations

import dataclasses
import warnings
import weakref

import numpy as np
import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.sparse import contract
from repro_torch.sparse.coo import SparseRelation


@dataclasses.dataclass
class FrontierStats:
    """Frontier observations from one run or one bounded chunk.  The
    worklist fills the per-round lists (frontier sizes and expanded
    edges); a chunk reports the carry at its boundary (``nnz`` live Δ
    entries, their ``density`` over the ``(B, n)`` carry, at global
    ``iteration``)."""

    frontier_sizes: list[int]
    edges_expanded: list[int]
    nnz: int = 0
    density: float = 0.0
    iteration: int = 0

    @property
    def total_edges(self) -> int:
        return int(sum(self.edges_expanded))


@dataclasses.dataclass
class FixpointState:
    """The resumable carry of a GSN fixpoint: ``y`` a pre-fixpoint,
    ``delta = F(y) ⊖ y`` its pending frontier, both ``(B, n)`` tensors
    (``B = 1`` for one source; ``batched`` remembers whether the
    caller's init had a batch axis), ``iters`` the per-row ``(B,)`` int32
    iteration counter carried across chunks."""

    y: torch.Tensor
    delta: torch.Tensor
    iters: torch.Tensor
    semiring: str = "bool"
    batched: bool = True

    @classmethod
    def cold(cls, edges, init: torch.Tensor, *,
             semiring: str | None = None) -> "FixpointState":
        """``y = 0̄``, ``delta = init ⊖ 0̄`` (``0̄ ⊗ E = 0̄``).  ``edges``
        is a :class:`SparseRelation`, or a dense matrix with its
        ``semiring`` named."""
        semiring = semiring or edges.semiring
        sr = sr_mod.get(semiring)
        if sr.minus is None:
            raise ValueError(f"semiring {sr.name} lacks ⊖; "
                             "GSN needs an idempotent complete lattice")
        i2 = init.to(sr.dtype)
        batched = i2.dim() == 2
        if not batched:
            i2 = i2[None]
        y0 = sr.zeros(i2.shape, i2.device)
        return cls(y0, sr.minus(i2, y0),
                   torch.zeros(i2.shape[0], dtype=torch.int32,
                               device=i2.device),
                   semiring, batched)

    @classmethod
    def from_numpy(cls, y, delta, iters, semiring: str, batched: bool, *,
                   device) -> "FixpointState":
        """Adopt a warm host carry (``(B, n)`` y/delta, ``(B,)`` iters)."""
        srn = sr_mod.get(semiring, lib="np")

        def t(a, dtype):
            return torch.from_numpy(np.array(a, dtype, order="C")).to(device)
        return cls(t(y, srn.dtype), t(delta, srn.dtype),
                   t(np.reshape(iters, -1), np.int32), semiring, batched)

    @property
    def batch(self) -> int:
        return int(self.y.shape[0])

    @property
    def n(self) -> int:
        return int(self.y.shape[1])

    def frontier_nnz(self) -> int:
        """Live (non-0̄) Δ entries across all rows (one host read)."""
        return int(sr_mod.get(self.semiring).live(self.delta).sum())

    def density(self) -> float:
        return self.frontier_nnz() / max(1, self.batch * self.n)

    def live_rows(self) -> int:
        """Rows whose Δ has a live entry (one host read)."""
        return int(sr_mod.get(self.semiring).live(self.delta).any(dim=1)
                   .sum())

    @property
    def converged(self) -> bool:
        return self.frontier_nnz() == 0

    def stats(self) -> FrontierStats:
        nnz = self.frontier_nnz()
        it = int(self.iters.max()) if self.iters.numel() else 0
        return FrontierStats([], [], nnz=nnz,
                             density=nnz / max(1, self.batch * self.n),
                             iteration=it)

    def solution(self):
        """``(x*, iters)`` in the caller's original shape."""
        if self.batched:
            return self.y, self.iters
        return self.y[0], int(self.iters[0])


def fixpoint(edges: SparseRelation, init=None, *, state=None,
             budget=None, max_iters: int = 10_000, mode: str = "jit",
             backend: str = "torch"):
    """Least fixpoint of ``x = init ⊕ vspm(x, edges)`` — cold, warm and
    chunked.

    Pass exactly one of ``init`` (cold start, ``(n,)`` or ``(B, n)``) or
    ``state`` (a :class:`FixpointState` to resume).  With ``budget=None``
    the run converges and returns ``(x*, iters)``: ``iters`` is an int
    for one source and a ``(B,)`` int32 tensor for a pack, and a resumed
    run's iters include the rounds already in the carry.  With
    ``budget=k`` at most k rounds run and the updated
    :class:`FixpointState` comes back.  ``mode`` is ``"jit"``,
    ``"frontier"`` or ``"auto"``; ``backend`` (``"torch"``, ``"kernel"``
    or, on the CPU, ``"fused"``) picks the staged loop's advance (module
    docstring).
    """
    if (init is None) == (state is None):
        raise ValueError("fixpoint() takes exactly one of init= or state=")
    sr = _check(edges, backend, init if state is None else state.y)
    mode = _resolve_mode(mode, edges, budget, backend)
    if mode == "frontier" and backend != "torch":
        raise ValueError(f"the frontier worklist has no {backend!r} "
                         f"backend; B1 advances the staged loop")
    if budget is None and state is None:
        if mode == "frontier":
            y, iters, _ = _frontier_run(edges, init, max_iters)
            return y, iters
        batched = init.dim() == 2
        i2 = (init if batched else init[None]).to(sr.dtype)
        y = sr.zeros(i2.shape[::-1], i2.device)                 # (n, B)
        d = sr.minus(i2.t().contiguous(), y)
        live = torch.ones(i2.shape[0], dtype=torch.bool, device=i2.device)
        it_rows = torch.zeros(i2.shape[0], dtype=torch.int32,
                              device=i2.device)
        y, _, it_rows = _staged(edges, backend, batched, sr, y, d, it_rows,
                                max_iters, live=live)
        if batched:
            return y.t(), it_rows
        return y[:, 0], int(it_rows[0])
    st = state if state is not None else FixpointState.cold(edges, init)
    rounds = max_iters if budget is None else int(min(budget, max_iters))
    if mode == "frontier":
        y, d, it_rows = _frontier_chunk(edges, st.y, st.delta, st.iters,
                                        rounds)
        out = FixpointState(y, d, it_rows, st.semiring, st.batched)
    else:
        y = st.y.t().contiguous()
        d = st.delta.t().contiguous()
        y, d, it_rows = _staged(edges, backend, st.batched, sr, y, d,
                                st.iters.clone(), rounds)
        out = FixpointState(y.t(), d.t(), it_rows, st.semiring, st.batched)
    return out.solution() if budget is None else out


def _resolve_mode(mode: str, edges: SparseRelation, budget,
                  backend: str = "torch") -> str:
    if mode == "auto":
        # a budgeted pass is the staged chunk unless the worklist is
        # asked for by name; the "fused" backend is a staged loop
        if budget is not None or edges.device.type != "cpu" \
                or backend == "fused":
            return "jit"
        return "frontier"
    if mode not in ("jit", "frontier"):
        raise ValueError(f"unknown mode {mode!r}")
    return mode


def sparse_seminaive_fixpoint(edges: SparseRelation, init, *,
                              max_iters: int = 10_000, mode: str = "auto",
                              backend: str = "torch"):
    """Deprecated alias of :func:`fixpoint` (cold start)."""
    warnings.warn("sparse_seminaive_fixpoint is deprecated; use "
                  "fixpoint(edges, init, ...)", DeprecationWarning,
                  stacklevel=2)
    return fixpoint(edges, init, max_iters=max_iters, mode=mode,
                    backend=backend)


def sparse_seminaive_fixpoint_stats(edges: SparseRelation, init, *,
                                    max_iters: int = 10_000,
                                    mode: str = "frontier"):
    """``(x*, iters, stats)``: the worklist's :class:`FrontierStats`
    (a list of them, one a source, for a ``(B, n)`` init), or None for
    the staged loop."""
    _check(edges, "torch")
    if _resolve_mode(mode, edges, None) == "frontier":
        return _frontier_run(edges, init, max_iters)
    y, iters = fixpoint(edges, init, max_iters=max_iters, mode="jit")
    return y, iters, None


def resume_fixpoint(edges: SparseRelation, y0, d0, *,
                    max_iters: int = 10_000, mode: str = "auto"):
    """Re-converge ``x = init ⊕ x ⊗ E`` from a warm ``(y0, d0)`` pair:
    ``y0`` a pre-fixpoint, ``d0 = F(y0) ⊖ y0`` its pending Δ, ``(n,)``
    or ``(B, n)``.  Returns ``(x*, iters)``; ``iters`` counts only the
    resumed rounds.

    Deprecated: build a :class:`FixpointState` and call
    ``fixpoint(edges, state=state)`` (whose iters include the carry's).
    """
    warnings.warn("resume_fixpoint is deprecated; use fixpoint(edges, "
                  "state=FixpointState(y0, d0, ...))", DeprecationWarning,
                  stacklevel=2)
    batched = y0.dim() == 2
    y2, d2 = (y0, d0) if batched else (y0[None], d0[None])
    st = FixpointState(y2, d2, torch.zeros(y2.shape[0], dtype=torch.int32,
                                           device=y2.device),
                       edges.semiring, batched)
    return fixpoint(edges, state=st, max_iters=max_iters, mode=mode)


def resume_fixpoint_chunk(edges: SparseRelation, y0, d0, it0, *,
                          max_iters: int, backend: str = "torch"):
    """One bounded slice of the batched staged loop, carry in and carry
    out: advances the ``(B, n)`` pair ``(y0, d0)`` with its ``(B,)``
    counts ``it0`` by at most ``max_iters`` rounds and returns ``(y, d,
    it_rows)``.

    Deprecated: use ``fixpoint(edges, state=state, budget=k)``.
    """
    warnings.warn("resume_fixpoint_chunk is deprecated; use "
                  "fixpoint(edges, state=state, budget=max_iters)",
                  DeprecationWarning, stacklevel=2)
    st = FixpointState(y0, d0, torch.as_tensor(it0, dtype=torch.int32,
                                               device=y0.device),
                       edges.semiring, True)
    out = fixpoint(edges, state=st, budget=max_iters, mode="jit",
                   backend=backend)
    return out.y, out.delta, out.iters


def _check(edges: SparseRelation, backend: str,
           carry=None) -> sr_mod.Semiring:
    if edges.arity != 2 or edges.shape[0] != edges.shape[1]:
        raise ValueError(f"recursive expansion needs a square binary edge "
                         f"relation, got shape {edges.shape}")
    sr = sr_mod.get(edges.semiring)
    if sr.minus is None:
        raise ValueError(f"semiring {sr.name} lacks ⊖; "
                         "GSN needs an idempotent complete lattice")
    if backend == "fused":
        # the CPU host loop, never a way around B1 on the card
        for t in (edges.values, carry):
            if t is not None and t.device.type != "cpu":
                raise ValueError(f"the 'fused' backend runs on the CPU; a "
                                 f"tensor lives on {t.device} (B1 runs the "
                                 f"rounds there: backend='kernel')")
    elif backend not in contract.BACKENDS:
        raise ValueError(f"unknown fixpoint backend {backend!r}")
    return sr


def _staged(edges: SparseRelation, backend: str, batched: bool, sr, y, d,
            it_rows, max_rounds: int, *, live=None):
    """The staged rounds over an (n, B) carry with ``backend``'s advance:
    the packed 𝔹 loop for ``"fused"`` 𝔹, else :func:`_gsn_loop`."""
    if backend == "fused" and sr.name == "bool":
        return _packed_loop(edges, y, d, it_rows, max_rounds, live=live)
    return _gsn_loop(_advance(edges, backend, batched), sr, y, d, it_rows,
                     max_rounds, live=live)


def _advance(edges: SparseRelation, backend: str, batched: bool):
    """The (n, B) → (n, B) frontier advance ``Δ ⊗ E`` of one round
    (``"fused"`` off 𝔹: B1's plain version on the CPU)."""
    if backend in ("kernel", "fused"):
        from repro_torch.kernels import coo_spmm
        plan = coo_spmm.plan_geometry(edges, transpose=True)
        return lambda d: coo_spmm.spmm(plan, d)
    if batched:
        return lambda d: contract.spmm(edges, d, transpose=True)
    # one source: the SpMV over a length-n vector (B3 on scalar payloads)
    return lambda d: contract.vspm(d[:, 0], edges)[:, None]


def _gsn_loop(adv, sr, y, d, it_rows, max_rounds: int, *, live=None):
    """GSN rounds over an (n, B) carry until no row is live or
    ``max_rounds`` rounds ran.  A row's count advances in every round it
    enters live; a row whose Δ went all-0̄ re-derives 0̄ forever, so the
    loop masks only the counts, never the values.  ``live`` defaults to
    the rows whose Δ is non-0̄ (a warm carry); a cold start passes all
    rows live."""
    if live is None:
        live = sr.live(d).any(dim=0)
    rounds = 0
    while rounds < max_rounds and bool(live.any()):
        it_rows += live.to(torch.int32)
        y = sr.add(y, d)
        d = sr.minus(adv(d), y)
        live = sr.live(d).any(dim=0)
        rounds += 1
    return y, d, it_rows


def _packed_loop(edges: SparseRelation, y, d, it_rows, max_rounds: int, *,
                 live=None):
    """The ``"fused"`` backend's 𝔹 rounds: the (n, B) carry packed into
    (n, W) words of 64 lanes and advanced by :func:`packed_rounds` — the
    reference's ``_fused_host_fixpoint`` / ``_fused_resume_chunk``."""
    from repro_torch.kernels import coo_spmm
    plan = coo_spmm.plan_geometry(edges, transpose=True)
    b = y.shape[1]
    yw = coo_spmm.pack_lanes(y.t()).view(torch.int64)
    dw = coo_spmm.pack_lanes(d.t()).view(torch.int64)
    yw, dw, it_rows = packed_rounds(plan, yw, dw, it_rows, b, max_rounds,
                                    live=live)
    return (coo_spmm.unpack_lanes(yw.view(torch.uint64), b).t(),
            coo_spmm.unpack_lanes(dw.view(torch.uint64), b).t(), it_rows)


def packed_rounds(plan, yw, dw, it_rows, b: int, max_rounds: int, *,
                  live=None):
    """𝔹 GSN rounds over (n, W) words of 64 lanes: a round is ``Y |= Δ;
    Δ = round(Δ) & ~Y`` (:func:`repro_torch.kernels.coo_spmm.
    bool_round_packed`), a lane's count advances in every round it
    enters live, as in :func:`_gsn_loop`.  Torch has no bitwise not on
    uint64, so the words are int64 (same bits); ``yw`` is updated in
    place.  Shared by the ``"fused"`` backend and the serve loop's
    bitset stepper."""
    from repro_torch.kernels import coo_spmm
    if live is None:
        live = coo_spmm.packed_live(dw, b)
    rounds = 0
    while rounds < max_rounds and bool(live.any()):
        it_rows += live.to(it_rows.dtype)
        yw |= dw
        dw = coo_spmm.bool_round_packed(
            plan, dw.view(torch.uint64)).view(torch.int64) & ~yw
        live = coo_spmm.packed_live(dw, b)
        rounds += 1
    return yw, dw, it_rows


# --------------------------------------------------------------------------
# The worklist over a CSR view of the edges
# --------------------------------------------------------------------------
#
# The CSR index is cached per (coords, values) buffer pair, weakref-evicted
# like B3's segment plans.  ``SparseRelation.apply_delta`` extends the
# parent's index with an O(nnz(Δ)) unsorted overlay instead of re-sorting;
# once the overlay outgrows a quarter of the base (and 1024 rows) the child
# is left unindexed, so its next worklist run rebuilds a sorted base.
# ``delete_keys`` hands the child a copy whose deleted entries weigh 0̄.


@dataclasses.dataclass
class _CsrIndex:
    """Sorted CSR base + unsorted appended overlay of one edge relation,
    on the relation's device (int64 keys, semiring-dtype weights)."""

    counts: torch.Tensor   # (n,) out-degrees of the sorted base
    starts: torch.Tensor   # (n,) row starts into src/dst/w
    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    xsrc: torch.Tensor     # overlay rows (appended by apply_delta)
    xdst: torch.Tensor
    xw: torch.Tensor


_CSR_CACHE: dict[tuple[int, int, bool],
                 tuple[weakref.ref, weakref.ref, _CsrIndex]] = {}


def _csr_lookup(rel: SparseRelation, transpose: bool = False
                ) -> _CsrIndex | None:
    # keyed on BOTH buffers: transposes share values and semiring casts
    # share coords — either alone would alias distinct relations
    ent = _CSR_CACHE.get((id(rel.coords), id(rel.values), transpose))
    if ent is not None and ent[0]() is rel.coords \
            and ent[1]() is rel.values:
        return ent[2]
    return None


def _csr_store(rel: SparseRelation, idx: _CsrIndex,
               transpose: bool = False) -> None:
    key = (id(rel.coords), id(rel.values), transpose)

    def _evict(ref, k=key):
        cur = _CSR_CACHE.get(k)
        if cur is not None and ref in (cur[0], cur[1]):
            _CSR_CACHE.pop(k, None)

    _CSR_CACHE[key] = (weakref.ref(rel.coords, _evict),
                       weakref.ref(rel.values, _evict), idx)


def csr_index(edges: SparseRelation, *,
              transpose: bool = False) -> _CsrIndex:
    """The (cached) CSR adjacency of a binary sparse relation, built on
    its device: a stable sort of the source column, a bincount and a
    cumsum.  ``transpose=True`` indexes in-edges: row ``a`` lists the
    ``(z, E[z, a])`` pairs.  Both orientations share the cache."""
    if edges.arity != 2:
        raise ValueError(f"csr_index needs a binary relation, got {edges!r}")
    idx = _csr_lookup(edges, transpose)
    if idx is None:
        k = edges.nnz
        a, b = (1, 0) if transpose else (0, 1)
        src, order = torch.sort(edges.col(a)[:k], stable=True)
        dst = edges.col(b)[:k].index_select(0, order)
        w = edges.values[:k].index_select(0, order)
        counts = torch.bincount(src, minlength=edges.shape[a])
        starts = torch.cumsum(counts, 0) - counts
        empty = src[:0]
        idx = _CsrIndex(counts, starts, src, dst, w, empty, empty, w[:0])
        _csr_store(edges, idx, transpose)
    return idx


def register_delta(parent: SparseRelation, child: SparseRelation,
                   coords: torch.Tensor, values: torch.Tensor) -> None:
    """``child = parent ⊕ appended rows`` (``coords`` ``(d, 2)`` int64 and
    ``values`` on the relation's device): give the child the parent's
    cached index plus an O(nnz(Δ)) overlay — a no-op when the parent was
    never indexed, or at the compaction point.  Both orientations."""
    for transpose in (False, True):
        pidx = _csr_lookup(parent, transpose)
        if pidx is None:
            continue
        a, b = (1, 0) if transpose else (0, 1)
        xsrc = torch.cat([pidx.xsrc, coords[:, a]])
        if xsrc.shape[0] > max(1024, pidx.src.shape[0] // 4):
            continue  # compaction point: the child rebuilds a sorted base
        xdst = torch.cat([pidx.xdst, coords[:, b]])
        xw = torch.cat([pidx.xw, values])
        _csr_store(child, _CsrIndex(pidx.counts, pidx.starts, pidx.src,
                                    pidx.dst, pidx.w, xsrc, xdst, xw),
                   transpose)


def register_delete(parent: SparseRelation, child: SparseRelation,
                    coords: torch.Tensor) -> None:
    """``child = parent ∖ deleted keys``: hand the child a copy of any
    cached index whose deleted entries weigh 0̄.  A 0̄ weight annihilates
    under ⊗ and is the ⊕ identity, so a poisoned entry contributes
    nothing, and ``counts``/``starts`` stay as they are — no re-sort.
    The probe walks only the deleted keys' rows (O(Σ deg)), on the
    device."""
    coords = coords.reshape(-1, 2)
    sr = parent.sr()
    for transpose in (False, True):
        pidx = _csr_lookup(parent, transpose)
        if pidx is None:
            continue
        a, b = (1, 0) if transpose else (0, 1)
        n_rows, n_cols = parent.shape[a], parent.shape[b]
        ok = (coords[:, a] >= 0) & (coords[:, a] < n_rows)
        dsrc, ddst = coords[ok, a], coords[ok, b]
        deg = pidx.counts.index_select(0, dsrc)
        rep = torch.repeat_interleave(
            torch.arange(dsrc.shape[0], device=dsrc.device), deg)
        esel = (pidx.starts.index_select(0, dsrc) - (torch.cumsum(deg, 0)
                - deg)).index_select(0, rep) + torch.arange(
                    rep.shape[0], device=rep.device)
        hit = pidx.dst.index_select(0, esel) == ddst.index_select(0, rep)
        w = pidx.w.clone()
        w[esel[hit]] = sr.zero
        xw = pidx.xw
        if pidx.xsrc.shape[0]:
            pair = ok & (coords[:, b] >= 0) & (coords[:, b] < n_cols)
            keys = coords[pair, a] * n_cols + coords[pair, b]
            xhit = torch.isin(pidx.xsrc * n_cols + pidx.xdst, keys)
            xw = torch.where(xhit, sr.const(sr.zero, xw.device), xw)
        _csr_store(child, _CsrIndex(pidx.counts, pidx.starts, pidx.src,
                                    pidx.dst, w, pidx.xsrc, pidx.xdst, xw),
                   transpose)


def _frontier_run(edges: SparseRelation, init, max_iters: int):
    """A cold worklist run: ``(x*, iters, stats)``, batched per row."""
    if init.dim() == 2:
        return _batched_frontier_fixpoint(edges, init, max_iters)
    y, _, iters, stats = _frontier_fixpoint(edges, init, max_iters)
    return y, iters, stats


def _frontier_rows(edges, max_iters: int, *, init=None, warm=None):
    """One worklist per row of a ``(B, n)`` init or warm ``(y, d)`` pair:
    the frontier is per source, so the batched hot path is the staged
    loop.  Returns the stacked ``(y, d)``, ``(B,)`` int32 iters and one
    :class:`FrontierStats` per row."""
    rows = [_frontier_fixpoint(edges, row, max_iters) for row in init] \
        if warm is None else [_frontier_fixpoint(edges, None, max_iters,
                                                 warm=yd)
                              for yd in zip(warm[0], warm[1])]
    ys, ds, iters, stats = zip(*rows)
    return (torch.stack(ys), torch.stack(ds),
            torch.tensor(iters, dtype=torch.int32, device=edges.device),
            list(stats))


def _batched_frontier_fixpoint(edges, init, max_iters):
    """Cold worklists for a ``(B, n)`` init: the stacked answers, ``(B,)``
    int32 iters and one :class:`FrontierStats` per row."""
    y, _, iters, stats = _frontier_rows(edges, max_iters, init=init)
    return y, iters, stats


def _frontier_chunk(edges, y0, d0, it0, budget: int):
    """At most ``budget`` worklist rounds over a ``(B, n)`` carry; a row
    counts only the rounds its Δ was live in, as in the staged chunk."""
    y, d, rounds, _ = _frontier_rows(edges, budget, warm=(y0, d0))
    return y, d, it0 + rounds.to(it0.device)


def _frontier_fixpoint(edges: SparseRelation, init, max_iters: int, *,
                       warm=None):
    """One source's worklist: ``(y, d, iters, stats)``, where ``(y, d)``
    at exit is a resumable carry (``d`` is 0̄ when converged)."""
    sr = sr_mod.get(edges.semiring)
    idx = csr_index(edges)
    n_out = edges.shape[1]
    dev = edges.device
    if warm is None:
        y = sr.zeros((n_out,), dev)
        d = sr.minus(init.to(dev, sr.dtype), y)   # δ of the constant term
    else:
        y, d = warm[0].to(dev, sr.dtype), warm[1].to(dev, sr.dtype)
    stats = FrontierStats([], [])
    iters = 0
    while iters < max_iters:
        live = sr.live(d)
        size, expanded, hits = _round_sizes(idx, live)
        if size == 0:
            break
        y = sr.add(y, d)                                  # Y ← Y ⊕ Δ
        derived = _expand(idx, sr, d, live, size, expanded, hits, n_out)
        d = sr.minus(derived, y)                          # Δ ← δF(Δ) ⊖ Y
        stats.frontier_sizes.append(size)
        stats.edges_expanded.append(expanded + hits)
        iters += 1
    return y, d, iters, stats


def _round_sizes(idx: _CsrIndex, live: torch.Tensor) -> list[int]:
    """The round's one host read: the frontier size, the base edges it
    expands and the overlay rows it hits."""
    parts = [live.sum(), torch.where(live, idx.counts, 0).sum()]
    if idx.xsrc.shape[0]:
        parts.append(live.index_select(0, idx.xsrc).sum())
    else:
        parts.append(torch.zeros((), dtype=parts[0].dtype,
                                 device=live.device))
    return torch.stack(parts).tolist()


def _expand(idx: _CsrIndex, sr, d, live, size: int, expanded: int,
            hits: int, n_out: int) -> torch.Tensor:
    """δF(Δ) over the frontier's out-edges: gather them from the index,
    ⊗ with Δ at their source, and ⊕ them into an ``(n,)`` vector through
    B3 (its ``scatter`` path: these ids have no segment plan)."""
    from repro_torch.kernels import ops as kops
    dev = d.device
    frontier = torch.nonzero_static(live, size=size).squeeze(1)
    deg = idx.counts.index_select(0, frontier)
    rep = torch.repeat_interleave(torch.arange(size, device=dev), deg,
                                  output_size=expanded)
    base = idx.starts.index_select(0, frontier) - (torch.cumsum(deg, 0)
                                                   - deg)
    esel = base.index_select(0, rep) + torch.arange(expanded, device=dev)
    dst = idx.dst.index_select(0, esel)
    vals = sr.mul(d.index_select(0, frontier).index_select(0, rep),
                  idx.w.index_select(0, esel))
    if hits:
        # the unsorted apply_delta overlay: a scan of O(nnz(Δ)) a round
        hit = torch.nonzero_static(live.index_select(0, idx.xsrc),
                                   size=hits).squeeze(1)
        xsrc = idx.xsrc.index_select(0, hit)
        dst = torch.cat([dst, idx.xdst.index_select(0, hit)])
        vals = torch.cat([vals, sr.mul(d.index_select(0, xsrc),
                                       idx.xw.index_select(0, hit))])
    return kops.semiring_segment_reduce(sr, vals, dst.to(torch.int32),
                                        n_out)
