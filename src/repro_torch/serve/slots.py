"""Slot pools: persistent batched fixpoints with per-row admit/evict.

The counterpart of ``repro/serve/slots.py``, the continuous-batching
core.  A :class:`SlotPool` owns one live ``(B, n)`` GSN carry for a
(family, B-bucket) pair.  Instead of packing a batch and running it to
*global* convergence, the pool

* **admits** a queued source into a free slot by splicing its ``init``
  into the live carry (``y_row ← 0̄``, ``Δ_row ← init ⊖ 0̄`` — the cold
  GSN seed; rows are independent under the per-row masks, so a spliced
  row's trajectory is bit-identical to its single-source run);
* **steps** the whole carry a bounded number of rounds (one chunk);
* **harvests** rows whose per-row convergence mask fired — their
  answers leave at once and their slots free up.

Three chunk steppers implement the same GSN body:

* :class:`TorchChunkStepper` — the general path: the plan runner's
  ``serve_chunk_fn`` (:mod:`repro_torch.core.runners`), whose rounds on
  the card are kernel B1 (``sparse_frontier_pallas``) or the torch
  composition over B3 (``sparse_jit``).  Its carry lives on the
  operator's device and never comes to the host: the rows admitted
  before a chunk go there in one copy, and the chunk's one host read is
  the per-row live mask, the iteration counts and the live-Δ count
  together.
* :class:`BitsetBoolStepper` — 𝔹 on a CPU operator: the B lanes live as
  bits of ``⌈B/64⌉`` 64-bit words per vertex and a round is
  :func:`repro_torch.kernels.coo_spmm.bool_round_packed` (the ``"fused"``
  fixpoint backend's round).
* :class:`LevelSyncTropStepper` — trop with small positive integer
  weights on a CPU operator: min-plus distances as level-synchronous
  BFS over the weight-expanded graph, lane bitsets with one
  ``bitwise_or.reduceat`` per weight class per level (numpy: torch has
  no segment OR).

The host steppers are picked only for an operator on the CPU
(:func:`build_stepper`): a family on the card always steps through
:class:`TorchChunkStepper`.  Iteration counts: the chunk and bitset
steppers count exact GSN rounds (equal to the single-source run's); the
level-sync stepper counts BFS levels.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.kernels import coo_spmm
from repro_torch.serve.family import Family, QueryRequest
from repro_torch.sparse import fixpoint
from repro_torch.sparse.coo import SparseRelation

#: level-sync admissibility: weights must be positive integers ≤ this
#: (the ring buffer holds wmax+1 frontier levels; huge weights would
#: also walk absurd level counts — the chunk stepper handles those)
TROP_WMAX_CAP = 64

_INF32 = np.uint32(0xFFFFFFFF)


def _dst_sorted(edges: SparseRelation, select=None):
    """Destination-sorted COO view + unique-dst segment starts, the
    ``reduceat`` geometry of the level-sync stepper."""
    eh = edges.as_np()
    k = int(eh.nnz)
    src = eh.coords[:k, 0].astype(np.int64)
    dst = eh.coords[:k, 1].astype(np.int64)
    w = eh.values[:k]
    if select is not None:
        src, dst, w = src[select], dst[select], w[select]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    udst, seg = np.unique(dst, return_index=True)
    return src, udst, seg, w[order]


def _lane_bits(words: np.ndarray, b: int) -> np.ndarray:
    """(…, W) uint64 words → (…, b) bool lanes."""
    return np.unpackbits(words.view(np.uint8), axis=-1,
                         bitorder="little")[..., :b].astype(bool)


def _lane(j: int) -> tuple[int, torch.Tensor]:
    """Word index and int64 bit mask of lane ``j`` (bit 63 included)."""
    wj, bit = divmod(j, 64)
    return wj, torch.ones((), dtype=torch.int64) << bit


class BitsetBoolStepper:
    """𝔹 GSN rounds over lane-bitset state (a CPU operator).  The words
    are int64 CPU tensors holding the uint64 lanes bit for bit."""

    def __init__(self, edges: SparseRelation, n: int, b: int,
                 geom_cache: dict | None = None):
        if edges.semiring != "bool":
            raise ValueError("bitset stepper is boolean-only")
        if edges.device.type != "cpu":
            raise ValueError("the bitset stepper is a host kernel; the "
                             f"operator lives on {edges.device}")
        self.n, self.b = n, b
        self.w = (b + 63) // 64
        cache = geom_cache if geom_cache is not None else {}
        key = ("spmm_plan", "fused")
        plan = cache.get(key)
        if plan is None:
            plan = cache[key] = coo_spmm.plan_geometry(edges,
                                                       transpose=True)
        self._plan = plan
        self.y = torch.zeros((n, self.w), dtype=torch.int64)
        self.d = torch.zeros((n, self.w), dtype=torch.int64)
        self.it = torch.zeros(b, dtype=torch.int64)

    def admit(self, j: int, init: np.ndarray) -> bool:
        wj, one = _lane(j)
        col = torch.where(torch.from_numpy(np.asarray(init, bool)), one,
                          torch.zeros((), dtype=torch.int64))
        self.y[:, wj] &= ~one
        self.d[:, wj] = (self.d[:, wj] & ~one) | col
        self.it[j] = 0
        return True

    def live_lanes(self) -> np.ndarray:
        return coo_spmm.packed_live(self.d, self.b).numpy()

    def frontier_nnz(self) -> int:
        return int(np.unpackbits(self.d.numpy().view(np.uint8)).sum())

    def step(self, k: int) -> None:
        self.y, self.d, self.it = fixpoint.packed_rounds(
            self._plan, self.y, self.d, self.it, self.b, k)

    def extract(self, j: int) -> tuple[torch.Tensor, int]:
        wj, one = _lane(j)
        return (self.y[:, wj] & one) != 0, int(self.it[j])

    def release(self, j: int) -> None:
        wj, one = _lane(j)
        self.y[:, wj] &= ~one
        self.d[:, wj] &= ~one


class LevelSyncTropStepper:
    """Min-plus distances as level-synchronous bitset BFS (a CPU
    operator; numpy words, as the reference's).

    Raises ``ValueError`` at construction when the operator's weights
    are not positive integers ≤ :data:`TROP_WMAX_CAP` — selection then
    falls back to the chunk stepper.
    """

    def __init__(self, edges: SparseRelation, n: int, b: int,
                 geom_cache: dict | None = None):
        if edges.semiring != "trop":
            raise ValueError("level-sync stepper is tropical-only")
        if edges.device.type != "cpu":
            raise ValueError("the level-sync stepper is a host kernel; "
                             f"the operator lives on {edges.device}")
        self.n, self.b = n, b
        self.w = (b + 63) // 64
        cache = geom_cache if geom_cache is not None else {}
        geom = cache.get("trop_geom")
        if geom is None:
            eh = edges.as_np()
            vals = eh.values[:int(eh.nnz)]
            if len(vals) and (not np.all(vals == np.round(vals))
                              or vals.min() < 1
                              or vals.max() > TROP_WMAX_CAP):
                raise ValueError("level-sync needs positive integer "
                                 f"weights ≤ {TROP_WMAX_CAP}")
            wmax = int(vals.max()) if len(vals) else 1
            iw = vals.astype(np.int64)
            classes = []
            for wc in range(1, wmax + 1):
                sel = np.flatnonzero(iw == wc)
                classes.append(_dst_sorted(edges, sel)[:3]
                               if len(sel) else None)
            geom = cache["trop_geom"] = (vals.dtype, wmax, classes)
        self.dtype, self.wmax, self._classes = geom
        self.ring = np.zeros((self.wmax + 1, n, self.w), np.uint64)
        self.settled = np.zeros((n, self.w), np.uint64)
        # (b, n): lane-major so extract/release touch one contiguous row
        self.dist = np.full((b, n), _INF32, np.uint32)
        self.admit_level = np.zeros(b, np.int64)
        self.level = 0
        self.it = np.zeros(b, np.int64)

    def admit(self, j: int, init: np.ndarray) -> bool:
        init = np.asarray(init)
        finite = np.isfinite(init)
        if finite.any() and init[finite].any():
            return False  # only 0/∞ inits encode as a level-0 frontier
        wj, bit = divmod(j, 64)
        col = finite.astype(np.uint64) << np.uint64(bit)
        self.ring[self.level % (self.wmax + 1), :, wj] |= col
        self.settled[:, wj] |= col
        self.dist[j, finite] = np.uint32(self.level)
        self.admit_level[j] = self.level
        self.it[j] = 0
        return True

    def live_lanes(self) -> np.ndarray:
        any_front = np.bitwise_or.reduce(
            np.bitwise_or.reduce(self.ring, axis=0), axis=0)
        return _lane_bits(any_front, self.b)

    def frontier_nnz(self) -> int:
        front = np.bitwise_or.reduce(self.ring, axis=0)
        return int(np.unpackbits(front.view(np.uint8)).sum())

    def step(self, k: int) -> None:
        r = self.wmax + 1
        for _ in range(k):
            live = self.live_lanes()
            if not live.any():
                return
            self.it += live
            self.level += 1
            t = self.level
            new = np.zeros((self.n, self.w), np.uint64)
            for wc in range(1, self.wmax + 1):
                cls = self._classes[wc - 1]
                if cls is None or t - wc < 0:
                    continue
                src, udst, seg = cls
                new[udst] |= np.bitwise_or.reduceat(
                    self.ring[(t - wc) % r][src], seg, axis=0)
            new &= ~self.settled
            self.ring[t % r] = new
            rows = np.flatnonzero(new.any(axis=1))
            if len(rows):
                self.settled |= new
                # scatter only the (vertex, lane) pairs that settled
                r_idx, l_idx = np.nonzero(_lane_bits(new[rows], self.b))
                self.dist[l_idx, rows[r_idx]] = np.uint32(t)

    def extract(self, j: int) -> tuple[torch.Tensor, int]:
        col = self.dist[j]
        out = col.astype(np.float64) - self.admit_level[j]
        out[col == _INF32] = np.inf
        return torch.from_numpy(out.astype(self.dtype)), int(self.it[j])

    def release(self, j: int) -> None:
        wj, bit = divmod(j, 64)
        mask = ~np.uint64(1 << bit)
        # no ring sweep: a releasable lane converged, i.e. has no
        # frontier bits anywhere in the ring by definition
        self.settled[:, wj] &= mask
        self.dist[j] = _INF32


class TorchChunkStepper:
    """The general chunk stepper: a ``(B, n)`` carry on the operator's
    device advanced by the plan runner's ``serve_chunk_fn``.

    The host keeps a copy of what it needs between chunks — the per-row
    live mask, the per-row iteration counts and the live-Δ count — read
    in one transfer after each chunk, so liveness tests and harvest read
    nothing more from the device.  Admission only stages the init on
    the host: the rows admitted before a chunk go to the device
    together, in one copy, when the chunk starts, and their seed ``init
    ⊖ 0̄`` is formed there; a staged row counts as live until that
    chunk's read says otherwise.  Release writes nothing: a released
    row converged, so its Δ is already 0̄, and its ``y`` and count are
    reset when the slot is admitted again.
    """

    def __init__(self, edges: SparseRelation, n: int, b: int, chunk_fn):
        self.edges = edges
        self.n, self.b = n, b
        self._chunk = chunk_fn          # (edges, y, d, it) -> (y, d, it)
        self._sr = sr_mod.get(edges.semiring)
        self._srn = sr_mod.get(edges.semiring, lib="np")
        dev = edges.device
        self.y = self._sr.zeros((b, n), dev)
        self.d = self._sr.zeros((b, n), dev)
        self.it = torch.zeros(b, dtype=torch.int32, device=dev)
        self._live = np.zeros(b, bool)
        self._iters = np.zeros(b, np.int64)
        self._nnz = 0
        self._staged: dict[int, np.ndarray] = {}
        self._host_rows = None          # pinned (b, n) staging on CUDA
        self._copied = None             # event: the last copy left it

    def admit(self, j: int, init: np.ndarray) -> bool:
        self._staged[j] = np.asarray(init, self._srn.dtype)
        self._live[j] = True
        self._iters[j] = 0
        return True

    def _flush(self) -> None:
        """Write the staged rows into the carry: one host→device copy of
        their inits, the cold GSN seed ``d0 = (init ⊕ 0̄⊗E) ⊖ 0̄ = init ⊖
        0̄`` formed on the device, then ``d`` rows copied and ``y`` rows
        and counts reset by index."""
        if not self._staged:
            return
        rows = sorted(self._staged)
        k = len(rows)
        dev = self.d.device
        if dev.type == "cuda":
            if self._host_rows is None:
                self._host_rows = torch.empty(
                    (self.b, self.n), dtype=self._sr.dtype, pin_memory=True)
                self._copied = torch.cuda.Event()
            self._copied.synchronize()  # the buffer's last copy is done
            host = self._host_rows[:k]
        else:
            host = torch.empty((k, self.n), dtype=self._sr.dtype)
        hv = host.numpy()
        for i, j in enumerate(rows):
            hv[i] = self._staged[j]
        self._staged.clear()
        inits = host.to(dev, non_blocking=True)
        if dev.type == "cuda":
            self._copied.record()
        idx = torch.tensor(rows, dtype=torch.int64).to(dev)
        self.d.index_copy_(0, idx, self._sr.minus(
            inits, self._sr.zeros(inits.shape, dev)))
        self.y.index_fill_(0, idx, self._sr.zero)
        self.it.index_fill_(0, idx, 0)

    def live_lanes(self) -> np.ndarray:
        return self._live.copy()

    def frontier_nnz(self) -> int:
        return self._nnz

    def step(self, k: int) -> None:
        self._flush()
        if not self._live.any():
            return
        self.y, self.d, self.it = self._chunk(self.edges, self.y, self.d,
                                              self.it)
        live = self._sr.live(self.d)
        obs = torch.cat([live.any(dim=1).to(torch.int64),
                         self.it.to(torch.int64),
                         live.sum().reshape(1)]).cpu().numpy()
        b = self.b
        self._live = obs[:b].astype(bool)
        self._iters = obs[b:2 * b]
        self._nnz = int(obs[-1])

    def extract(self, j: int) -> tuple[torch.Tensor, int]:
        if j in self._staged:           # admitted, not stepped yet
            self._flush()
        return self.y[j].clone(), int(self._iters[j])

    def release(self, j: int) -> None:
        self._live[j] = False


def build_stepper(fam: Family, b: int, *, host_kernels: bool,
                  chunk_fn_factory):
    """Pick the cheapest applicable stepper for this family's operator.

    The host kernels apply only to an operator on the CPU (the
    reference's CPU-backend test, read through the device): a family on
    the card always gets :class:`TorchChunkStepper`.
    ``chunk_fn_factory()`` lazily supplies the runner's chunk function
    (so host-kernel pools never touch the compile cache).
    """
    edges = fam.edges
    if not isinstance(edges, SparseRelation):
        raise ValueError("slot pools need a sparse linear operator")
    if host_kernels and edges.device.type == "cpu":
        if edges.semiring == "bool":
            return BitsetBoolStepper(edges, fam.n, b,
                                     geom_cache=fam.kernel_cache)
        if edges.semiring == "trop":
            try:
                return LevelSyncTropStepper(edges, fam.n, b,
                                            geom_cache=fam.kernel_cache)
            except ValueError:
                pass
    return TorchChunkStepper(edges, fam.n, b, chunk_fn_factory())


class SlotPool:
    """Occupancy bookkeeping around one chunk stepper."""

    def __init__(self, fam: Family, b: int, *, host_kernels: bool,
                 chunk_fn_factory):
        self.fam = fam
        self.b = b
        self.stepper = build_stepper(fam, b, host_kernels=host_kernels,
                                     chunk_fn_factory=chunk_fn_factory)
        self.slots: list[QueryRequest | None] = [None] * b
        self._free: list[int] = list(range(b))[::-1]

    @property
    def occupied(self) -> int:
        return self.b - len(self._free)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def admit(self, req: QueryRequest, init: np.ndarray) -> bool:
        """Splice ``init`` into a free slot; False when the stepper
        cannot encode this init (caller serves it another way) or the
        pool is full."""
        if not self._free:
            return False
        j = self._free[-1]
        if not self.stepper.admit(j, init):
            return False
        self._free.pop()
        self.slots[j] = req
        return True

    def step(self, k: int) -> None:
        self.stepper.step(k)

    def frontier_nnz(self) -> int:
        """Live Δ entries across all lanes — the chunk-boundary frontier
        observation the scheduler streams into its per-family
        :class:`~repro_torch.serve.metrics.FrontierMetrics`."""
        return self.stepper.frontier_nnz()

    def frontier_density(self) -> float:
        return self.frontier_nnz() / float(self.b * self.fam.n or 1)

    def harvest(self) -> list[tuple[QueryRequest, torch.Tensor, int]]:
        """Evict every occupied slot whose convergence mask fired:
        extract its answer, free the slot."""
        live = self.stepper.live_lanes()
        out = []
        for j, req in enumerate(self.slots):
            if req is None or live[j]:
                continue
            y, iters = self.stepper.extract(j)
            self.stepper.release(j)
            self.slots[j] = None
            self._free.append(j)
            out.append((req, y, iters))
        return out
