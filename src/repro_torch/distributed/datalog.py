"""Graph-axis sharded fixpoints: row-partitioned semiring SpMM over ranks.

The counterpart of ``repro/distributed/datalog.py``.  The recursive
matvec

    x[y]  =  init[y] ⊕ ⊕_z x[z] ⊗ E[z, y]

is partitioned along the graph axis by **destination-row blocks**: rank
``k`` of ``D`` owns rows ``[k·nb, (k+1)·nb)`` of ``x``/``Δ`` (``nb =
⌈n/D⌉``) and the edge tuples landing there.

The reference is single-controller (one process, ``shard_map`` over a
jax mesh).  This module is multi-controller SPMD over a
:class:`~repro_torch.launch.mesh.GraphMesh`: every rank calls the same
public function with the same full arguments (the whole relation or
:class:`ShardedRelation`, the whole ``(n,)``/``(B, n)`` init), works
only on its own shard, and at exit all-gathers the answer, so every rank
returns the full result in global vertex ids — the reference's return
contract, so the planner, the runners and the servers run unchanged on
every rank.

As in the reference, two things make the partition fast:

* **Balanced destination blocks.**  :func:`shard_relation` relabels
  vertices (a snake-deal by in-degree) so every block owns ≈ nnz/D
  edges; the relabeling ``perm``/``inv`` rides on the
  :class:`ShardedRelation` and is inverted at every public boundary.
* **Δ-sparse frontier exchange.**  Each rank compacts its live Δ rows
  to a ``(ids, values)`` buffer of a tier's capacity and all-gathers
  only those (𝔹 lanes packed 8 to a byte); a receiver expands just the
  out-edges of the gathered sources through a per-shard CSR-by-source
  index.  A ladder of tiers (small, large) ends in the dense all-gather
  fallback.  The capacity ladder sets the all-gathered buffers' sizes
  (every rank sends the same count), and so the bytes
  :func:`exchange_byte_report` counts; the ``rounds`` vector counts the
  derive rounds each tier took, the dense fallback last, as the
  reference's does.  The dense fallback is part of the semantics, not a
  device fallback.

**Lockstep.**  The reference reduces each branch predicate with
``pmax``/``psum`` inside ``lax.cond``.  Here each one is an
``all_reduce`` whose result is read on the host once, so every rank
takes the same branch and the collectives stay matched.  A round makes
one packed ``all_reduce`` (MAX) of the new Δ's live-row mask — the
convergence test, ``changed_of`` — together with its live count — the
next round's tier choice, ``cnt_max`` — and reads it on the host; a
round on a sparse tier makes one more, of its expansion size (the
overflow test, ``over``).  So a round reads the host once on the dense
exchange and twice on a sparse tier.

The local derive's ⊕ is kernel B3's ``runs`` path over one segment plan
of the shard's local destinations, built once per shard and used every
round (the payload gathered in plan order, as ``SparseRelation.runs``
does); the expansion's ⊕ is B3's ``scatter`` path (its destinations
change every round).  So a sharded run launches B3 ``runs`` once per
dense round and ``scatter`` once per sparse round.

Iteration counts and answers equal the single-device runners' bit for
bit, whichever tier each round took (⊕ is an idempotent lattice wherever
the fixpoint is defined).  A cold start runs the first round for every
row, as the single-device staged loop does; warm restarts test the
seeded Δ.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import semiring as sr_mod
from repro_torch.launch.mesh import GraphMesh
from repro_torch.sparse.coo import SparseRelation

#: the axis name every sharded fixpoint runs over (the reference's)
GRAPH_AXIS = "graph"


def mesh_size(mesh) -> int:
    """Rank count along the graph axis of ``mesh`` (a
    :class:`~repro_torch.launch.mesh.GraphMesh`, or a plain int D for
    planning and host-side partitioning)."""
    if isinstance(mesh, int):
        if mesh < 1:
            raise ValueError(f"device count must be ≥ 1, got {mesh}")
        return mesh
    if isinstance(mesh, GraphMesh):
        return mesh.d
    raise TypeError(f"mesh must be a GraphMesh or an int device count, "
                    f"got {type(mesh).__name__}")


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _balance_perm(dst: torch.Tensor, n: int, d: int,
                  nb: int) -> torch.Tensor:
    """The vertex relabeling ``perm[old] = new`` that snake-deals
    vertices, by in-degree descending (ties by id), across the D blocks:
    position ``i`` of that order goes to block ``i mod D`` on even deal
    rounds and ``D − 1 − i mod D`` on odd ones, at row ``i // D`` of the
    block (each round gives every block exactly one vertex)."""
    indeg = torch.bincount(dst, minlength=n)
    order = torch.sort(-indeg, stable=True).indices
    i = torch.arange(n, device=dst.device)
    rounds, lane = i // d, i % d
    blk = torch.where(rounds % 2 == 0, lane, d - 1 - lane)
    perm = torch.empty(n, dtype=torch.int64, device=dst.device)
    perm[order] = blk * nb + rounds
    return perm.to(torch.int32)


def _build_geometry(coords: torch.Tensor, values: torch.Tensor, nnz,
                    nb: int, n_pad: int, sr):
    """The Δ-exchange receive geometry, on the relation's device: per
    shard, the live edges stably sorted by global source (``ssrc``,
    ``sdst``, ``sval``; dead slots keep the padding sentinels), the
    sorted unique sources padded with ``n_pad`` to a power-of-two
    ``ucap`` (``usrc``) and their ``(D, ucap+1)`` CSR run starts
    (``ustart``).  One stable sort over (shard, source) keys does every
    shard at once."""
    d, cap = values.shape
    dev = values.device
    counts = torch.tensor(nnz, dtype=torch.int64, device=dev)
    starts = torch.cumsum(counts, 0) - counts
    total = int(sum(nnz))
    slot = torch.arange(cap, device=dev)
    shard = torch.arange(d, device=dev)[:, None].expand(d, cap)
    src = coords[:, :, 0].long()
    span = n_pad + 1
    key = torch.where(slot[None, :] < counts[:, None], shard * span + src,
                      d * span).reshape(-1)
    skey, order = torch.sort(key, stable=True)
    skey, order = skey[:total], order[:total]
    k_of = order // cap
    at = torch.arange(total, device=dev) - starts[k_of]
    ssrc = torch.full((d, cap), n_pad, dtype=torch.int32, device=dev)
    sdst = torch.full((d, cap), nb, dtype=torch.int32, device=dev)
    sval = sr.zeros((d, cap), dev)
    flat = coords.reshape(-1, 2)
    ssrc[k_of, at] = flat[order, 0]
    sdst[k_of, at] = flat[order, 1]
    sval[k_of, at] = values.reshape(-1)[order]
    first = torch.ones(total, dtype=torch.bool, device=dev)
    first[1:] = skey[1:] != skey[:-1]
    run = torch.nonzero(first).squeeze(1)
    run_k = k_of[run]
    per = torch.bincount(run_k, minlength=d)
    ucap = _pow2ceil(max(1, int(per.max()) if total else 1))
    j = torch.arange(run.shape[0], device=dev) - (torch.cumsum(per, 0)
                                                  - per)[run_k]
    usrc = torch.full((d, ucap), n_pad, dtype=torch.int32, device=dev)
    usrc[run_k, j] = ssrc[run_k, at[run]]
    ustart = counts[:, None].expand(d, ucap + 1).to(torch.int32).clone()
    ustart[run_k, j] = at[run].to(torch.int32)
    return ssrc, sdst, sval, usrc, ustart


def default_exchange_caps(nb: int, cap: int) -> tuple[tuple[int, int], ...]:
    """The static-capacity ladder for the Δ-sparse exchange: a list of
    ``(frontier_cap, expansion_cap)`` tiers, cheapest first; rounds
    whose (max-reduced) frontier exceeds every tier take the dense
    all-gather fallback.  Per-shard frontier caps are fractions of the
    row block ``nb``; expansion caps are fractions of the edge capacity
    ``cap`` (the reference's fractions, fitted on its CPU host)."""
    tiers = []
    for fs, fe in ((32, 16), (4, 2)):
        cs = min(nb, _pow2ceil(max(64, nb // fs)))
        ce = min(cap, _pow2ceil(max(256, cap // fe)))
        if tiers and (cs, ce) == tiers[-1]:
            continue
        tiers.append((cs, ce))
    return tuple(tiers)


class ShardedBuffers(NamedTuple):
    """Host numpy view of a :class:`ShardedRelation` (``as_np``): the
    reference's field names and dtypes."""

    coords: np.ndarray
    values: np.ndarray
    nnz: np.ndarray
    shape: tuple
    semiring: str
    perm: np.ndarray | None
    inv: np.ndarray | None
    ssrc: np.ndarray | None
    sdst: np.ndarray | None
    sval: np.ndarray | None
    usrc: np.ndarray | None
    ustart: np.ndarray | None


_GEO_FIELDS = ("perm", "inv", "ssrc", "sdst", "sval", "usrc", "ustart")


@dataclasses.dataclass(eq=False)
class ShardedRelation:
    """A binary S-relation partitioned into D destination-row blocks, as
    tensors on one device.

    ``coords[(D, cap, 2)]`` holds each shard's tuples as (global source,
    **local** destination), ``values[(D, cap)]`` their values, ``nnz``
    the ragged live counts (host ints).  One capacity is shared by every
    shard.  Padding: source sentinel ``n_pad``, destination sentinel
    ``nb``, value 0̄.  When built by :func:`shard_relation` it also
    carries the balance relabeling ``perm``/``inv`` (None: identity) and
    the Δ-exchange geometry ``ssrc``/``sdst``/``sval``/``usrc``/
    ``ustart`` (None: dense exchange only); :meth:`apply_delta` rebuilds
    them.  Each rank's working view of its shard is memoized on the
    relation (:func:`_local_shard`).
    """

    coords: torch.Tensor
    values: torch.Tensor
    nnz: tuple[int, ...]
    shape: tuple[int, ...]
    semiring: str
    perm: torch.Tensor | None = None
    inv: torch.Tensor | None = None
    ssrc: torch.Tensor | None = None
    sdst: torch.Tensor | None = None
    sval: torch.Tensor | None = None
    usrc: torch.Tensor | None = None
    ustart: torch.Tensor | None = None
    _local: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)

    @property
    def d(self) -> int:
        """Shard count D (the graph mesh size this was built for)."""
        return int(self.coords.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.coords.shape[1])

    @property
    def row_block(self) -> int:
        """Destination rows per shard, ``nb = ⌈n/D⌉``."""
        return -(-self.shape[1] // self.d)

    @property
    def n_pad(self) -> int:
        return self.row_block * self.d

    @property
    def has_exchange_geometry(self) -> bool:
        return self.ssrc is not None

    @property
    def device(self) -> torch.device:
        return self.values.device

    def total_nnz(self) -> int:
        return int(sum(self.nnz))

    def __repr__(self) -> str:
        return (f"ShardedRelation({self.semiring}{list(self.shape)}, "
                f"D={self.d}×nnz≤{self.capacity}, "
                f"rows/shard={self.row_block}, {self.device})")

    def as_np(self) -> ShardedBuffers:
        def host(t):
            return None if t is None else t.cpu().numpy()
        return ShardedBuffers(
            host(self.coords), host(self.values),
            np.asarray(self.nnz, np.int32), tuple(self.shape),
            self.semiring, *(host(getattr(self, f)) for f in _GEO_FIELDS))

    def as_torch(self, device) -> "ShardedRelation":
        """The relation with every tensor on ``device``."""
        device = torch.device(device)
        if device == self.device:
            return self
        return ShardedRelation(
            self.coords.to(device), self.values.to(device), self.nnz,
            self.shape, self.semiring,
            **{f: None if getattr(self, f) is None
               else getattr(self, f).to(device) for f in _GEO_FIELDS})

    def apply_delta(self, coords, values=None) -> "ShardedRelation":
        """⊕-merge a batch of global-coordinate tuple updates, routing
        each row to its owning destination shard, on the relation's
        device.  Rows land in padding slots while every shard fits;
        appended duplicates are left for the ⊕-combining consumers; an
        overflow re-pads **all** shards by doubling until the worst
        shard fits.  The exchange geometry is rebuilt."""
        sr = sr_mod.get(self.semiring)
        srn = sr_mod.get(self.semiring, lib="np")
        dev = self.device
        coords = _tensor(np.asarray(coords, np.int64) if not isinstance(
            coords, torch.Tensor) else coords, dev, torch.int64
        ).reshape(-1, 2)
        if values is None:
            values = sr.ones((coords.shape[0],), dev)
        else:
            values = _tensor(values if isinstance(values, torch.Tensor)
                             else np.asarray(values, srn.dtype), dev,
                             sr.dtype).reshape(-1)
        if coords.shape[0] != values.shape[0]:
            raise ValueError(f"coords {tuple(coords.shape)} vs values "
                             f"{tuple(values.shape)}")
        shape = torch.tensor(self.shape, dtype=torch.int64, device=dev)
        if bool(((coords < 0) | (coords >= shape)).any()):
            raise ValueError("delta coordinates out of range for shape "
                             f"{self.shape}")
        live = sr.live(values)
        coords, values = coords[live], values[live]
        if values.shape[0] == 0:
            return self
        nb, d = self.row_block, self.d
        if self.perm is not None:
            coords = self.perm.long()[coords]      # old ids → balanced ids
        owner = coords[:, 1] // nb
        k = torch.tensor(self.nnz, dtype=torch.int64, device=dev)
        add = torch.bincount(owner, minlength=d)
        need = k + add
        worst = int(need.max())
        cap = self.capacity
        if worst > cap:
            cap = max(1, cap)
            while cap < worst:
                cap <<= 1
        new_coords = torch.empty((d, cap, 2), dtype=torch.int32, device=dev)
        new_coords[:, :, 0] = self.n_pad
        new_coords[:, :, 1] = nb
        new_values = sr.zeros((d, cap), dev)
        new_coords[:, :self.capacity] = self.coords
        new_values[:, :self.capacity] = self.values
        order = torch.sort(owner, stable=True).indices
        ow = owner[order]
        slot = k[ow] + torch.arange(ow.shape[0], device=dev) - (
            torch.cumsum(add, 0) - add)[ow]
        new_coords[ow, slot, 0] = coords[order, 0].to(torch.int32)
        new_coords[ow, slot, 1] = (coords[order, 1] - ow * nb).to(
            torch.int32)
        new_values[ow, slot] = values[order]
        nnz = tuple(int(v) for v in need.tolist())
        geo = {}
        if self.has_exchange_geometry:
            geo = dict(zip(("ssrc", "sdst", "sval", "usrc", "ustart"),
                           _build_geometry(new_coords, new_values, nnz, nb,
                                           self.n_pad, sr)))
        return ShardedRelation(new_coords, new_values, nnz, self.shape,
                               self.semiring, perm=self.perm, inv=self.inv,
                               **geo)


def _tensor(x, device, dtype) -> torch.Tensor:
    """``x`` (numpy or a tensor) as a ``dtype`` tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype)
    return torch.from_numpy(np.array(x, order="C")).to(device, dtype)


def shard_relation(rel: SparseRelation, mesh, *,
                   balance: bool = True) -> ShardedRelation:
    """Partition a binary :class:`SparseRelation` into destination-row
    blocks for ``mesh`` (a GraphMesh or an int D), on the relation's
    device.

    Shard ``k`` receives every live tuple whose (balanced) destination
    lands in ``[k·nb, (k+1)·nb)``, stored block-local, in the
    relation's order; every shard shares the worst shard's capacity.
    ``balance=True`` relabels vertices first (:func:`_balance_perm`) on
    a square relation with D > 1.  The Δ-exchange geometry is built
    here too.  Every field equals the reference's for the same input.
    """
    if rel.arity != 2:
        raise ValueError(f"graph sharding needs a binary relation, got "
                         f"arity {rel.arity}")
    d = mesh_size(mesh)
    dev = rel.device
    k = rel.nnz
    src = rel.coords[:k, 0].long()
    dst = rel.coords[:k, 1].long()
    w = rel.values[:k]
    n = rel.shape[1]
    nb = -(-n // d)
    n_pad = nb * d
    perm = inv = None
    if balance and d > 1 and k and rel.shape[0] == rel.shape[1]:
        perm = _balance_perm(dst, n, d, nb)
        inv = torch.full((n_pad,), n, dtype=torch.int32, device=dev)
        inv[perm.long()] = torch.arange(n, dtype=torch.int32, device=dev)
        src = perm.long()[src]
        dst = perm.long()[dst]
    owner = dst // nb
    counts = torch.bincount(owner, minlength=d)
    cap = max(1, int(counts.max()) if k else 1)
    sr = sr_mod.get(rel.semiring)
    coords = torch.empty((d, cap, 2), dtype=torch.int32, device=dev)
    coords[:, :, 0] = n_pad
    coords[:, :, 1] = nb
    values = sr.zeros((d, cap), dev)
    order = torch.sort(owner, stable=True).indices
    ow = owner[order]
    slot = torch.arange(k, device=dev) - (torch.cumsum(counts, 0)
                                          - counts)[ow]
    coords[ow, slot, 0] = src[order].to(torch.int32)
    coords[ow, slot, 1] = (dst[order] - ow * nb).to(torch.int32)
    values[ow, slot] = w[order]
    nnz = tuple(int(v) for v in counts.tolist())
    ssrc, sdst, sval, usrc, ustart = _build_geometry(coords, values, nnz,
                                                     nb, n_pad, sr)
    return ShardedRelation(coords, values, nnz, rel.shape, rel.semiring,
                           perm=perm, inv=inv, ssrc=ssrc, sdst=sdst,
                           sval=sval, usrc=usrc, ustart=ustart)


def unshard(sh: ShardedRelation, *,
            capacity: int | None = None) -> SparseRelation:
    """Reassemble the global COO relation on the host (coalescing ⊕ at
    duplicate keys and inverting the balance relabeling — the round-trip
    inverse of :func:`shard_relation`), on the sharded relation's
    device."""
    host = sh.as_np()
    nb = sh.row_block
    coords, values = [], []
    for s in range(sh.d):
        c = int(host.nnz[s])
        blk = host.coords[s, :c].astype(np.int64)
        src, dst = blk[:, 0], blk[:, 1] + s * nb
        if host.inv is not None:
            src, dst = host.inv[src], host.inv[dst]
        coords.append(np.stack([src, dst], axis=1))
        values.append(host.values[s, :c])
    return SparseRelation.from_coo(np.concatenate(coords),
                                   np.concatenate(values), sh.shape,
                                   sh.semiring, capacity=capacity,
                                   device=sh.device)


def payload_row_bytes(semiring: str, batch: int) -> int:
    """Exchanged bytes per vertex row of Δ payload (after bit-packing)."""
    sr = sr_mod.get(semiring)
    if batch > 1 and sr.dtype == torch.bool:
        return -(-batch // 8)
    return batch * sr.dtype.itemsize


def exchange_byte_report(es: ShardedRelation, rounds, *, batch: int = 1,
                         exchange_caps=None) -> dict:
    """Exchanged-byte accounting for one fixpoint run: ``rounds`` is the
    counter vector from :func:`sharded_seminaive_fixpoint_stats`.  The
    baseline is one ``n_pad``-row all-gather of the raw (unpacked)
    payload per round; "actual" prices each round at the buffer its tier
    gathered (ids + bit-packed payload; the dense fallback packs too)."""
    rounds = np.asarray(rounds, np.int64)
    caps = tuple(exchange_caps or default_exchange_caps(es.row_block,
                                                        es.capacity))
    if len(rounds) != len(caps) + 1:
        raise ValueError(f"{len(rounds)} round counters for {len(caps)} "
                         f"tiers and the dense fallback")
    prow = payload_row_bytes(es.semiring, batch)
    raw = max(1, batch) * sr_mod.get(es.semiring).dtype.itemsize
    dense_ref = es.n_pad * raw
    per_round = [es.d * cs * (4 + prow) for cs, _ in caps] \
        + [es.n_pad * prow]
    total = int(np.dot(rounds, per_round))
    nrounds = max(1, int(rounds.sum()))
    return {
        "rounds": rounds.tolist(),
        "bytes_per_iter": total / nrounds,
        "dense_bytes_per_iter": float(dense_ref),
        "bytes_total": total,
        "dense_bytes_total": float(dense_ref * nrounds),
        "byte_reduction": (dense_ref * nrounds) / max(1, total),
    }


# --------------------------------------------------------------------------
# One rank's shard and the collectives
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Shard:
    """Rank ``k``'s working view of its shard, on its device: the local
    derive's B3 segment plan over the local destinations with the source
    column and values in plan order, the global ids of its rows, and the
    exchange geometry padded by one sentinel slot."""

    dst: torch.Tensor          # (cap,) int32 local destinations (plan ids)
    plan: object               # B3 SegmentPlan of dst over nb rows
    src: torch.Tensor          # (m_live,) int64 sources in plan order
    w: torch.Tensor            # (m_live,) values in plan order
    rows: torch.Tensor         # (nb,) int64 old id of each row; n = none
    geo: tuple | None          # (sdst, sval, usrc, ustart, usrc_pad,
    #                             ustart_pad), sentinel-padded


def _local_shard(es: ShardedRelation, rank: int, device) -> _Shard:
    """Rank ``rank``'s :class:`_Shard` on ``device``, memoized on the
    relation (the segment plan is built once and reused every round)."""
    from repro_torch.kernels import coo_segment
    key = (rank, str(device))
    got = es._local.get(key)
    if got is not None:
        return got
    nb, n = es.row_block, es.shape[1]
    coords = es.coords[rank].to(device)
    dst = coords[:, 1].contiguous()
    plan = coo_segment.plan_segment(dst, nb)
    src = coords[:, 0].long().index_select(0, plan.order)
    w = es.values[rank].to(device).index_select(0, plan.order)
    if es.inv is not None:
        rows = es.inv[rank * nb:(rank + 1) * nb].to(device).long()
    else:
        rows = torch.arange(rank * nb, (rank + 1) * nb, device=device)
        rows = torch.where(rows < n, rows, n)
    geo = None
    if es.has_exchange_geometry:
        sr = sr_mod.get(es.semiring)
        one = torch.ones(1, dtype=torch.int32, device=device)
        usrc = es.usrc[rank].to(device)
        ustart = es.ustart[rank].to(device)
        geo = (torch.cat([es.sdst[rank].to(device), one * nb]),
               torch.cat([es.sval[rank].to(device), sr.zeros((1,), device)]),
               usrc, ustart, torch.cat([usrc, -one]),
               torch.cat([ustart, 0 * one]))
    got = es._local[key] = _Shard(dst, plan, src, w, rows, geo)
    return got


def _all_gather(mesh: GraphMesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked along axis 0, in rank order."""
    t = t.contiguous()
    out = torch.empty((mesh.d * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.split(t.shape[0])), t, group=mesh.group)
    return out


def _all_max(mesh: GraphMesh, t: torch.Tensor) -> list:
    """The element-wise max of ``t`` over the ranks, read on the host
    (the one host read of a lockstep predicate)."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t.tolist()


_BITS: dict[str, torch.Tensor] = {}


def _bits(device) -> torch.Tensor:
    """The shifts of one packed byte's lanes, first lane in the high bit
    (``np.packbits``' order), on ``device`` (made once per device)."""
    t = _BITS.get(str(device))
    if t is None:
        t = _BITS[str(device)] = torch.tensor(
            [7, 6, 5, 4, 3, 2, 1, 0], dtype=torch.uint8, device=device)
    return t


def _pack(sr, x: torch.Tensor) -> torch.Tensor:
    """The exchanged payload of an ``(m, B)`` Δ block: 𝔹 lanes packed 8
    to a byte (``(m, ⌈B/8⌉)`` uint8, first lane in the high bit, as
    ``np.packbits``), other semirings as they are."""
    if sr.name != "bool":
        return x
    m, b = x.shape
    w = -(-b // 8)
    lanes = torch.zeros((m, 8 * w), dtype=torch.uint8, device=x.device)
    lanes[:, :b] = x
    bits = lanes.view(m, w, 8) << _bits(x.device)
    return bits.sum(dim=2, dtype=torch.uint8)


def _unpack(sr, p: torch.Tensor, b: int) -> torch.Tensor:
    """The inverse of :func:`_pack` for ``b`` lanes."""
    if sr.name != "bool":
        return p
    bits = (p[:, :, None] >> _bits(p.device)) & 1
    return bits.reshape(p.shape[0], -1)[:, :b].bool()


def _local_derive(sr, sh: _Shard, d_full: torch.Tensor,
                  nb: int) -> torch.Tensor:
    """One shard's δF: the gathered ``(n_pad, B)`` frontier at the
    shard's sources, ⊗ its values, ⊕-reduced by local destination
    through B3's ``runs`` path — ``(nb, B)``."""
    from repro_torch.kernels import ops as kops
    prod = sr.mul(sh.w[:, None], d_full.index_select(0, sh.src))
    return kops.semiring_segment_reduce(sr, prod, sh.dst, nb, plan=sh.plan)


class _Round:
    """The derive of one GSN round on one rank under the exchange ladder
    (the reference's ``_sparse_exchange_derive`` and ``dense_derive``)."""

    def __init__(self, sr, mesh, es, sh, caps, use_sparse, b, observer):
        self.sr, self.mesh, self.sh, self.b = sr, mesh, sh, b
        self.nb, self.n_pad, self.cap = es.row_block, es.n_pad, es.capacity
        self.caps = caps if use_sparse else ()
        self.observer = observer

    def dense(self, dl):
        full = _all_gather(self.mesh, _pack(self.sr, dl))
        return _local_derive(self.sr, self.sh,
                             _unpack(self.sr, full, self.b), self.nb)

    def __call__(self, dl, cnt: int):
        """``(derived, tier)``: the first tier whose frontier cap holds
        the max-reduced live count ``cnt``, the dense fallback past the
        last tier or when that tier's expansion overflows."""
        for tier, (cs, ce) in enumerate(self.caps):
            if cnt <= cs:
                out = self.sparse(dl, cs, ce, tier)
                if out is not None:
                    return out, tier
                break
        if self.observer is not None:
            self.observer(len(self.caps), None)
        return self.dense(dl), len(self.caps)

    def sparse(self, dl, cs: int, ce: int, tier: int):
        """One Δ-sparse exchange: the live rows (at most ``cs``) and
        their values all-gathered, their out-edges looked up in the
        CSR-by-source index; ``None`` when some rank's expansion exceeds
        ``ce`` (the overflow test, one host read)."""
        sr, sh, nb, dev = self.sr, self.sh, self.nb, dl.device
        sdst, sval, usrc, ustart, usrc_pad, ustart_pad = sh.geo
        live = sr.live(dl).any(dim=1)
        idx = torch.nonzero_static(live, size=cs, fill_value=nb).squeeze(1)
        pad = idx == nb
        vals = torch.where(pad[:, None], sr.const(sr.zero, dev),
                           dl.index_select(0, idx.clamp(max=nb - 1)))
        gsrc = torch.where(pad, self.n_pad,
                           self.mesh.rank * nb + idx).to(torch.int32)
        # the ids go first, so the index lookup below can overlap the
        # larger payload's transfer where the backend is asynchronous
        g = _all_gather(self.mesh, gsrc)
        v = _unpack(sr, _all_gather(self.mesh, _pack(sr, vals)), self.b)
        pos = torch.searchsorted(usrc, g)
        hit = usrc_pad.index_select(0, pos) == g
        stt = ustart.index_select(0, pos).long()
        en = ustart_pad.index_select(0, pos + 1).long()
        deg = torch.where(hit, en - stt, 0)
        offs = torch.cumsum(deg, 0)
        total = offs[-1:]
        (worst,) = _all_max(self.mesh, total.clone())
        if worst > ce:
            return None
        # the expansion: ``worst`` slots on every rank (the largest
        # total, read with the overflow test; the reference keeps all
        # ``ce``, a static shape).  Slot e belongs to gathered entry
        # row(e), the first whose running total passes e; slots past the
        # local total hit the padding sentinels and the ⊕ drops them
        e = torch.arange(worst, device=dev)
        row = torch.searchsorted(offs, e, right=True).clamp(
            max=deg.shape[0] - 1)
        slot = stt.index_select(0, row) + e - (offs - deg).index_select(
            0, row)
        slot = torch.where(e < total, slot, self.cap)
        dsts = sdst.index_select(0, slot)
        prod = sr.mul(sval.index_select(0, slot)[:, None],
                      v.index_select(0, row))
        if self.observer is not None:
            self.observer(tier, (prod, dsts))
        from repro_torch.kernels import ops as kops
        return kops.semiring_segment_reduce(sr, prod, dsts, nb)


# --------------------------------------------------------------------------
# The sharded GSN loop
# --------------------------------------------------------------------------


def sharded_seminaive_fixpoint(edges, init, *, mesh: GraphMesh,
                               max_iters: int = 10_000,
                               exchange: str = "auto",
                               exchange_caps=None):
    """Least fixpoint of ``x = init ⊕ x ⊗ E`` with the graph axis
    partitioned across ``mesh`` (module docstring); every rank of the
    mesh calls it with the same arguments and gets the same answer.

    ``edges`` is a :class:`ShardedRelation` built for the mesh's D (or a
    :class:`SparseRelation`, sharded here).  ``init`` is ``(n,)`` or a
    ``(B, n)`` pack (numpy or a tensor); results and iteration counts
    equal :func:`repro_torch.sparse.fixpoint.fixpoint`'s staged loop,
    row for row: ``(y, iters)`` with ``y`` on the mesh's device and
    ``iters`` an int, or a ``(B,)`` int32 tensor for a pack.

    ``exchange="auto"`` runs the Δ-sparse ladder with its dense
    fallback; ``"dense"`` all-gathers the whole Δ every round.  Both give
    bit-identical answers.  ``exchange_caps`` overrides the ladder (a
    tuple of ``(frontier_cap, expansion_cap)`` tiers).
    """
    y, iters, _ = _dispatch(edges, mesh, init=init, max_iters=max_iters,
                            exchange=exchange, exchange_caps=exchange_caps)
    return y, iters


def sharded_seminaive_fixpoint_stats(edges, init, *, mesh: GraphMesh,
                                     max_iters: int = 10_000,
                                     exchange: str = "auto",
                                     exchange_caps=None, observer=None):
    """:func:`sharded_seminaive_fixpoint` plus the exchange round
    counters: ``(y, iters, rounds)`` where ``rounds[i]`` counts the
    derive rounds tier ``i`` took and ``rounds[-1]`` the dense ones (an
    int32 CPU tensor; :func:`exchange_byte_report`'s input).
    ``observer(tier, payload)``, if given, sees every derive round:
    ``payload`` is the ``(values, ids)`` pair a sparse tier hands B3's
    ``scatter``, None on a dense round."""
    return _dispatch(edges, mesh, init=init, max_iters=max_iters,
                     exchange=exchange, exchange_caps=exchange_caps,
                     observer=observer)


def sharded_resume_fixpoint(edges, y0, d0, *, mesh: GraphMesh,
                            max_iters: int = 10_000,
                            exchange: str = "auto",
                            exchange_caps=None):
    """Warm-start re-convergence from a ``(y0, d0)`` pre-fixpoint pair —
    the sharded twin of ``fixpoint(edges, state=...)``, sharing this
    module's loop body.  ``iters`` counts only the resumed rounds."""
    y, iters, _ = _dispatch(edges, mesh, warm=(y0, d0),
                            max_iters=max_iters, exchange=exchange,
                            exchange_caps=exchange_caps)
    return y, iters


def sharded_resume_chunk(edges, y0, d0, it0, *, mesh: GraphMesh,
                         max_iters: int, exchange: str = "auto",
                         exchange_caps=None):
    """At most ``max_iters`` rounds of the sharded loop over a batched
    ``(B, n)`` carry ``(y0, d0)`` with its ``(B,)`` per-row counts
    ``it0``; returns the full carry ``(y, d, it_rows)`` in global vertex
    ids, so the adaptive executor can hand it to any single-device
    runner bit for bit (the ``sparse_sharded`` runner's ``run_chunk``)."""
    if _ndim(y0) != 2:
        raise ValueError("sharded_resume_chunk needs a batched (B, n) "
                         "carry — add a leading batch axis")
    return _dispatch(edges, mesh, warm=(y0, d0), it0=it0, chunk=True,
                     max_iters=max_iters, exchange=exchange,
                     exchange_caps=exchange_caps)


def sharded_contract(edges, x, *, mesh: GraphMesh):
    """One sharded ``x ⊗ E``: all-gather the operand, derive locally,
    all-gather the row blocks back to ``(n,)``/``(B, n)``.  Defined for
    every semiring (no ⊖ needed) — the exact-agreement probe for ℕ∞.
    One-shot, so it keeps the dense exchange."""
    es = _as_sharded(edges, mesh)
    sr = sr_mod.get(es.semiring)
    sh = _local_shard(es, mesh.rank, mesh.device)
    batched = _ndim(x) == 2
    x_loc = _seed(sr, sh, x, batched, es.shape[1], mesh.device)
    out = _local_derive(sr, sh, _all_gather(mesh, x_loc), es.row_block)
    return _gather_out(mesh, es, out, batched)


def _ndim(x) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)


def _as_sharded(edges, mesh) -> ShardedRelation:
    if not isinstance(mesh, GraphMesh):
        raise TypeError(f"sharded execution needs a GraphMesh "
                        f"(launch.mesh.make_graph_mesh), got "
                        f"{type(mesh).__name__}; an int D only plans")
    if isinstance(edges, ShardedRelation):
        if edges.d != mesh.d:
            raise ValueError(
                f"relation sharded for D={edges.d} cannot run on a "
                f"{mesh.d}-device graph mesh — re-shard it")
        return edges
    if isinstance(edges, SparseRelation):
        return shard_relation(edges, mesh)
    raise TypeError(f"edges must be a SparseRelation or ShardedRelation, "
                    f"got {type(edges).__name__}")


def _seed(sr, sh: _Shard, x, batched: bool, n: int, device) -> torch.Tensor:
    """This rank's ``(nb, B)`` block of an ``(n,)``/``(B, n)`` global
    vector: rows in the balanced id space, 0̄ on padding rows."""
    x = _tensor(x, device, sr.dtype)
    xt = (x if batched else x[None]).t()
    got = xt.index_select(0, sh.rows.clamp(max=n - 1))
    return torch.where((sh.rows < n)[:, None], got,
                       sr.const(sr.zero, device))


def _gather_out(mesh, es, loc: torch.Tensor, batched: bool):
    """All ranks' ``(nb, B)`` blocks back to global vertex ids:
    ``(B, n)``, or ``(n,)`` unbatched."""
    full = _all_gather(mesh, loc)
    n = es.shape[1]
    full = full.index_select(0, es.perm.to(full.device).long()) \
        if es.perm is not None else full[:n]
    return full.t().contiguous() if batched else full[:, 0].contiguous()


def _dispatch(edges, mesh, *, init=None, warm=None, max_iters=10_000,
              exchange="auto", exchange_caps=None, it0=None, chunk=False,
              observer=None):
    if exchange not in ("auto", "dense"):
        raise ValueError(f"exchange must be 'auto' or 'dense', "
                         f"got {exchange!r}")
    es = _as_sharded(edges, mesh)
    if es.shape[0] != es.shape[1]:
        raise ValueError(f"recursive expansion needs a square binary "
                         f"edge relation, got shape {es.shape}")
    sr = sr_mod.get(es.semiring)
    if sr.minus is None:
        raise ValueError(f"semiring {sr.name} lacks ⊖; "
                         "GSN needs an idempotent lattice")
    dev = mesh.device
    batched = _ndim(init if warm is None else warm[0]) == 2
    n, nb = es.shape[1], es.row_block
    sh = _local_shard(es, mesh.rank, dev)
    use_sparse = exchange == "auto" and es.has_exchange_geometry
    caps = tuple(exchange_caps) if exchange_caps else \
        default_exchange_caps(nb, es.capacity)
    rounds = [0] * ((len(caps) if use_sparse else 0) + 1)

    def seed(x):
        return _seed(sr, sh, x, batched, n, dev)

    def reduce(d_loc):
        """The lockstep predicates of a new Δ in one MAX all-reduce:
        each row's liveness anywhere (``changed_of``) and the largest
        per-rank live count (the next tier choice, ``cnt_max``)."""
        lv = sr.live(d_loc)
        t = torch.cat([lv.any(dim=0), lv.any(dim=1).sum()[None]]).to(
            torch.int64)
        got = _all_max(mesh, t)
        return t[:-1].bool(), got[:-1], got[-1]

    if warm is None:
        i_loc = seed(init)
        x0 = sr.zeros(i_loc.shape, dev)
    else:
        x0, d_loc = seed(warm[0]), seed(warm[1])
    b = x0.shape[1]
    derive = _Round(sr, mesh, es, sh, caps, use_sparse, b, observer)
    if warm is None:
        d_raw, tier = derive(x0, 0)        # 0̄ has no live row anywhere
        rounds[tier] += 1
        d_loc = sr.minus(sr.add(i_loc, d_raw), x0)
        _, _, cnt = reduce(d_loc)
        # a cold start runs the first round for every row, as the
        # single-device staged loop does
        live = torch.ones(b, dtype=torch.bool, device=dev)
        live_host = [1] * b
    else:
        live, live_host, cnt = reduce(d_loc)
    it_rows = torch.zeros(b, dtype=torch.int32, device=dev) if it0 is None \
        else _tensor(it0, dev, torch.int32).reshape(b).clone()
    y, d = x0, d_loc
    done = 0
    while done < max_iters and any(live_host):
        it_rows += live.to(torch.int32)
        y = sr.add(y, d)
        d_raw, tier = derive(d, cnt)
        rounds[tier] += 1
        d = sr.minus(d_raw, y)
        live, live_host, cnt = reduce(d)
        done += 1
    y_out = _gather_out(mesh, es, y, batched)
    if chunk:
        return y_out, _gather_out(mesh, es, d, batched), it_rows
    rc = torch.tensor(rounds, dtype=torch.int32)
    return y_out, (it_rows if batched else int(it_rows[0])), rc
