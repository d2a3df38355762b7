"""B1: fused batched COO semiring SpMM (``csrc/coo_spmm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/coo_spmm.py:214``
(``_spmm_kernel`` via ``_spmm_pallas_call`` :260 / ``spmm_pallas``
:284): the batched fixpoint's frontier advance
``out[d, b] = ⊕_{e: dst(e)=d} w_e ⊗ x[src(e), b]`` — gather, ⊗ and
segment-⊕ fused.

Geometry (:func:`plan_geometry` / :func:`_build_plan`) is the
reference's, host-built from the concrete operator and cached weakly
per (coords, values, transpose): edges stably sorted by destination,
the unique destinations ``udst`` and their segment starts ``seg``.  The
reference's (out-block, src-block) chunk bucketing exists only for the
TPU's VMEM and is not ported.  On top of it the plan cuts work items
(:meth:`SpmmPlan.items`): at most ``E_CHUNK`` consecutive edges of one
row each, a longer row cut into several items in edge order, one empty
item for a row no edge reaches.  They depend only on the operator and
are built once; their device copies are memoized on the plan with its
other arrays, once per device.

Two paths under one dispatch, :func:`plan_spmm` (see the source note in
the ``.cu`` file):

* ``words_bool`` — 𝔹: x packed into 32-bit words (lane b in bit b % 32
  of word b // 32; in memory the reference's :func:`pack_lanes`
  layout), a round that ORs gathered word rows, and an unpack into the
  bool output.  Bound: bytes.
* ``lanes_f32`` — trop, maxplus, nat, real: 16-byte loads where the
  row width allows, lanes in slabs whose slice of x fits in L2.
  Bound: bytes (the L2 rate for the gathers in practice).

One warp runs one item at a time (``ITEMS_PER_WARP`` of them, a grid's
width of warps apart); items of a split row write partials that a fold
kernel combines in item order, so every ⊕ runs in a fixed order.

:func:`spmm` dispatches on ``x``'s device: CPU tensors take the plain
version (:func:`repro_torch.kernels.ref.coo_spmm_ref`), CUDA tensors
launch the kernels or raise.  :func:`pack_lanes` / :func:`unpack_lanes`
and :func:`words_round_plain` are the plain versions of the
``words_bool`` steps; :func:`bool_round_packed` is the host round over
uint64 words that the CPU ``"fused"`` fixpoint backend runs.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.kernels import costing, cuda_lib, ref

#: the plain PyTorch version of this kernel
coo_spmm_plain = ref.coo_spmm_ref

_MODE = {"bool": 0, "trop": 1, "maxplus": 2, "nat": 3, "real": 3}
PATHS = ("words_bool", "lanes_f32")
#: most edges one work item holds (csrc: E_CHUNK).  An item is one
#: warp's serial work; at 128 the power-law graph's hub row (1,374
#: in-edges) becomes 11 items, and 669 of its 81,306 rows are split
#: (1,740 partial rows of scratch).
E_CHUNK = 128
#: warps a block of the round (csrc: WARPS)
WARPS = 8
#: consecutive items a warp runs one after another (csrc: ITEMS)
ITEMS_PER_WARP = 4
#: lanes_f32 slab budget: the x slice one slab gathers from should stay
#: in L2 beside the streaming indices and output (the H100's L2 is
#: 50 MB, in two partitions); 64 lanes of 81,306 rows are 20.8 MB
SLAB_BYTES = 24 << 20
#: the narrowest lanes_f32 slab the budget may shrink to (lanes)
MIN_SLAB = 32
#: grid.y limit
_GRID_Y = 65535


class Items(NamedTuple):
    """A plan's work items, in row order and, within a row, edge order
    (numpy arrays in B1's host plan, device tensors in B3's)."""

    edge: np.ndarray      # (n_items + 1,) edge starts, end sentinel nnz
    dst: np.ndarray       # (n_items,) output row, or ~slot of a partial
    fold_row: np.ndarray  # (n_split,) rows cut into several items
    fold_seg: np.ndarray  # (n_split + 1,) their partial slots' starts
    max_edges: int        # edges of the longest item

    @property
    def n_items(self) -> int:
        return len(self.dst)

    @property
    def n_split(self) -> int:
        return len(self.fold_row)

    @property
    def n_part(self) -> int:
        return int(self.fold_seg[-1])


def cut_items(deg: torch.Tensor) -> Items:
    """Work items over rows of ``deg`` entries each, the entries sorted by
    row: each row cut into ``ceil(deg / E_CHUNK)`` near-equal items of
    consecutive entries (one empty item for a row with none); a row of
    several items gets one partial slot per item, in order.  Built with
    torch on ``deg``'s device; the index arrays are int32."""
    dev = deg.device
    deg = deg.long()
    n = deg.shape[0]
    start = torch.cumsum(deg, 0) - deg
    pieces = torch.clamp(-(-deg // E_CHUNK), min=1)
    row = torch.repeat_interleave(torch.arange(n, device=dev), pieces)
    first = torch.cumsum(pieces, 0) - pieces
    k = torch.arange(row.shape[0], device=dev) - first[row]
    lo = start[row] + (k * deg[row]) // pieces[row]
    split = pieces[row] > 1
    dst = row.clone()
    dst[split] = ~torch.arange(int(split.sum()), device=dev)
    many = pieces > 1
    edge = torch.cat([lo, deg.sum().reshape(1)]).int()
    fold_seg = torch.cat([deg.new_zeros(1), torch.cumsum(pieces[many], 0)])
    return Items(edge=edge, dst=dst.int(),
                 fold_row=torch.nonzero(many).flatten().int(),
                 fold_seg=fold_seg.int(),
                 max_edges=int(torch.diff(edge).max()) if n else 0)


class Geometry(NamedTuple):
    """Launch geometry of one SpMM at a lane count."""

    items: Items
    row_len: int           # elements a row: 32-bit words (𝔹) or lanes
    vec: int               # row elements one thread loads at once (1, 4)
    threads_per_edge: int  # lanes of a warp that span one slab
    grid: tuple[int, int]  # (item blocks, slabs)
    scratch: int           # elements of split-row partials

    @property
    def slab(self) -> int:
        """Row elements one warp covers."""
        return self.threads_per_edge * self.vec


@dataclasses.dataclass
class SpmmPlan:
    """Host-planned geometry for one (operator, transpose) orientation."""

    sr_name: str
    n_in: int
    n_out: int
    transpose: bool
    nnz: int
    src: np.ndarray    # (nnz,) gather index per edge, dst-sorted
    dst: np.ndarray    # (nnz,) output index per edge, sorted
    udst: np.ndarray   # unique output indices
    seg: np.ndarray    # segment starts of each udst row into src/dst
    w: np.ndarray      # (nnz,) edge values, semiring dtype
    device_cache: dict = dataclasses.field(default_factory=dict)
    _items: Items | None = None

    def items(self) -> Items:
        """The work items (built once, :func:`cut_items` over the rows'
        in-degrees)."""
        if self._items is None:
            deg = np.zeros(self.n_out, np.int64)
            if self.nnz:
                deg[self.udst] = np.diff(np.append(self.seg, self.nnz))
            it = cut_items(torch.from_numpy(deg))
            self._items = Items(*(t.numpy() for t in it[:4]), it.max_edges)
        return self._items

    def on(self, device) -> dict:
        """The plan's arrays on ``device`` (int32 indices, the work
        items), copied once per device."""
        device = torch.device(device)
        cached = self.device_cache.get(device)
        if cached is None:
            def t(a, dtype=None):
                arr = np.ascontiguousarray(a if dtype is None
                                           else a.astype(dtype))
                return torch.from_numpy(arr).to(device)
            it = self.items()
            cached = self.device_cache[device] = dict(
                src=t(self.src, np.int32), dst=t(self.dst, np.int32),
                w=t(self.w), item_edge=t(it.edge), item_dst=t(it.dst),
                fold_row=t(it.fold_row), fold_seg=t(it.fold_seg))
        return cached


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def plan_spmm(plan: SpmmPlan, lanes: int) -> tuple[str, Geometry]:
    """The path (``words_bool`` or ``lanes_f32``) and launch geometry of
    ``plan`` over an x of ``lanes`` lanes (1 for an ``(n,)`` x)."""
    if plan.sr_name not in _MODE:
        raise ValueError(f"coo_spmm: unknown semiring {plan.sr_name!r}")
    if lanes < 0:
        raise ValueError(f"coo_spmm: negative lane count {lanes}")
    items = plan.items()
    if plan.sr_name == "bool":     # 32 lanes a word
        path, row_len = "words_bool", -(-lanes // 32)
        vec = 4 if row_len % 4 == 0 else 1
        tpe = min(32, _pow2_at_least(-(-row_len // vec)))
    else:
        path, row_len = "lanes_f32", lanes
        vec = 4 if lanes % 4 == 0 and lanes > 0 else 1
        tpe = min(32, _pow2_at_least(-(-lanes // vec)))
        # halve the slab while its slice of x overfills the L2 budget
        while tpe * vec > MIN_SLAB and \
                plan.n_in * tpe * vec * 4 > SLAB_BYTES:
            tpe //= 2
    slabs = max(1, -(-row_len // (tpe * vec)))
    if slabs > _GRID_Y:
        raise ValueError(f"coo_spmm: {lanes} lanes exceed the grid limit")
    grid = (math.ceil(items.n_items / (WARPS * ITEMS_PER_WARP)), slabs)
    return path, Geometry(items, row_len, vec, tpe, grid,
                          items.n_part * row_len)


_PLANS: dict[tuple[int, int, bool], tuple[object, object, SpmmPlan]] = {}


def plan_geometry(rel, *, transpose: bool = False) -> SpmmPlan:
    """The (cached) fused-SpMM geometry of a binary sparse relation."""
    key = (id(rel.coords), id(rel.values), bool(transpose))
    ent = _PLANS.get(key)
    if ent is not None and ent[0]() is rel.coords \
            and ent[1]() is rel.values:
        return ent[2]
    plan = _build_plan(rel, transpose)

    def _evict(r, k=key):
        cur = _PLANS.get(k)
        if cur is not None and r in (cur[0], cur[1]):
            _PLANS.pop(k, None)

    _PLANS[key] = (weakref.ref(rel.coords, _evict),
                   weakref.ref(rel.values, _evict), plan)
    return plan


def _build_plan(rel, transpose: bool) -> SpmmPlan:
    h = rel.as_np()
    k = int(h.nnz)
    ci, co = (0, 1) if transpose else (1, 0)
    gidx = np.asarray(h.coords[:k, ci], np.int64)
    oidx = np.asarray(h.coords[:k, co], np.int64)
    vals = np.asarray(h.values[:k])
    order = np.argsort(oidx, kind="stable")
    src, dst, w = gidx[order], oidx[order], vals[order]
    if k:
        udst, seg = np.unique(dst, return_index=True)
    else:
        udst, seg = np.zeros(0, np.int64), np.zeros(0, np.int64)
    return SpmmPlan(rel.semiring, int(h.shape[ci]), int(h.shape[co]),
                    transpose, k, src, dst, udst, seg, w)


# --------------------------------------------------------------------------
# plain versions of the words_bool steps
# --------------------------------------------------------------------------


def pack_words(x: torch.Tensor) -> torch.Tensor:
    """(n, lanes) bool → (n, ceil(lanes / 32)) int32 words, lane b in
    bit b % 32 of word b // 32 (the pack kernel's output)."""
    n, lanes = x.shape
    words = -(-lanes // 32)
    bits = torch.zeros((n, words * 32), dtype=torch.int64, device=x.device)
    bits[:, :lanes] = x.to(torch.int64)
    shift = torch.arange(32, dtype=torch.int64, device=x.device)
    w = (bits.reshape(n, words, 32) << shift).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_words(words: torch.Tensor, lanes: int) -> torch.Tensor:
    """(n, W) int32 words → (n, lanes) bool: inverse of :func:`pack_words`
    (the unpack kernel's output)."""
    shift = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shift) & 1
    return bits.reshape(words.shape[0], -1)[:, :lanes].bool()


def pack_lanes(x: torch.Tensor) -> torch.Tensor:
    """(B, n) bool → (n, W) uint64 words, lane b in bit b % 64 of word
    b // 64: the reference's ``pack_lanes`` (``repro/kernels/
    coo_spmm.py:314``) on torch tensors."""
    words = pack_words(x.t())
    if words.shape[1] % 2:          # whole uint64 words, at least one
        words = torch.cat([words, words.new_zeros((words.shape[0], 1))], 1)
    return words.contiguous().view(torch.int64).view(torch.uint64)


def unpack_lanes(words: torch.Tensor, b: int) -> torch.Tensor:
    """(n, W) uint64 → (B, n) bool: inverse of :func:`pack_lanes`."""
    return unpack_words(words.view(torch.int64).view(torch.int32), b).t()


def words_round_plain(plan: SpmmPlan, words: torch.Tensor) -> torch.Tensor:
    """The ``words_bool`` round on (n_in, W) int32 words, as the kernels
    run it: each item ORs its edges' gathered word rows (an edge of
    weight 0̄ contributes nothing) into its row, or into its partial slot
    for a split row, and the fold ORs each split row's partials in item
    order.  Returns (n_out, W) words."""
    it = plan.items()
    dev = words.device
    n_words = words.shape[1]
    shift = torch.arange(32, dtype=torch.int32, device=dev)
    src = torch.from_numpy(plan.src).to(dev)
    live = torch.from_numpy(plan.w.astype(bool)).to(dev)
    bits = (words.index_select(0, src)[..., None] >> shift) & 1
    bits *= live[:, None, None]
    item_of = torch.from_numpy(np.repeat(np.arange(it.n_items),
                                         np.diff(it.edge))).to(dev)
    acc = torch.zeros((it.n_items, n_words, 32), dtype=torch.int32,
                      device=dev)
    acc.scatter_reduce_(0, item_of[:, None, None].expand_as(bits), bits,
                        "amax")
    per_item = pack_words(acc.reshape(it.n_items, -1).bool())
    dst = torch.from_numpy(it.dst.astype(np.int64)).to(dev)
    out = torch.empty((plan.n_out, n_words), dtype=torch.int32, device=dev)
    whole = dst >= 0
    out[dst[whole]] = per_item[whole]
    part = torch.empty((it.n_part, n_words), dtype=torch.int32, device=dev)
    part[~dst[~whole]] = per_item[~whole]
    for k in range(it.n_split):
        a, b = int(it.fold_seg[k]), int(it.fold_seg[k + 1])
        row = part[a]
        for s in range(a + 1, b):
            row = row | part[s]
        out[int(it.fold_row[k])] = row
    return out


def bool_round_packed(plan: SpmmPlan, words: torch.Tensor) -> torch.Tensor:
    """One 𝔹 round over packed lanes on the host: (n_in, W) uint64 words
    (:func:`pack_lanes`) → (n_out, W), the reference's
    ``bool_round_packed`` (``repro/kernels/coo_spmm.py:331``).  Every
    live 𝔹 edge carries 1̄ (``from_coo`` drops 0̄, ``delete_keys``
    compacts), so the round is a gather and one ``bitwise_or.reduceat``
    over the plan's dst-sorted edges, 64 lanes a word; torch has no
    segment OR, so it runs in numpy on the tensor's zero-copy view.  The
    fixpoint's ``"fused"`` backend and the serve loop's bitset stepper
    step with it; CPU tensors only (on the card a round is B1's
    ``words_bool`` path)."""
    if words.device.type != "cpu":
        raise ValueError(f"bool_round_packed runs on the host; words live "
                         f"on {words.device}")
    w = words.numpy()
    out = np.zeros((plan.n_out, w.shape[1]), np.uint64)
    if plan.nnz:
        out[plan.udst] = np.bitwise_or.reduceat(w[plan.src], plan.seg,
                                                axis=0)
    return torch.from_numpy(out)


def packed_live(words: torch.Tensor, b: int) -> torch.Tensor:
    """Per-lane liveness of packed (n, W) host words (uint64 or their
    int64 view): lane b has a bit set in some row.  An OR over rows, in
    numpy on the CPU view; returns a (b,) bool tensor."""
    agg = np.bitwise_or.reduce(words.numpy().view(np.uint64), axis=0)
    return torch.from_numpy(np.unpackbits(
        agg.view(np.uint8), bitorder="little")[:b].astype(bool))


# --------------------------------------------------------------------------
# dispatch and launch
# --------------------------------------------------------------------------


def spmm_cost(plan: SpmmPlan, x: torch.Tensor) -> tuple[str, float, float]:
    """``(path, operations, bytes)`` of one call as its bound reckons
    them: a ⊗ and a ⊕ an edge a lane; the edges' int32 source and value,
    8 bytes an item and a split row, x read once and the output written
    once."""
    lanes = int(x.shape[1]) if x.dim() == 2 else 1
    it = plan.items()
    idx = (4 + plan.w.itemsize) * plan.nnz + 8 * (it.n_items + it.n_split)
    row = x.element_size() * lanes
    return (plan_spmm(plan, lanes)[0], 2.0 * plan.nnz * lanes,
            float(idx + (plan.n_in + plan.n_out) * row))


@costing.counted("coo_spmm", spmm_cost)
def spmm(plan: SpmmPlan, x: torch.Tensor) -> torch.Tensor:
    """Fused SpMM: ``x`` ``(n_in, B)`` or ``(n_in,)`` → ``(n_out, ...)``."""
    if x.shape[0] != plan.n_in:
        raise ValueError(f"x has {x.shape[0]} rows, operator takes "
                         f"{plan.n_in}")
    if x.device.type == "cpu":
        p = plan.on(x.device)
        return coo_spmm_plain(sr_mod.get(plan.sr_name), p["src"], p["w"],
                              p["dst"], x, plan.n_out)
    return spmm_cuda(plan, x)


def spmm_cuda(plan: SpmmPlan, x: torch.Tensor) -> torch.Tensor:
    """Launch the path :func:`plan_spmm` picks on a CUDA ``x`` of the
    semiring's type (``torch.bool`` for 𝔹, float32 otherwise).  Counts
    one launch per call in ``.launches`` and by path in ``.by_path``."""
    sr = sr_mod.get(plan.sr_name)
    if x.dim() not in (1, 2):
        raise ValueError(f"spmm: x must be (n,) or (n, B), got "
                         f"{tuple(x.shape)}")
    if x.shape[0] != plan.n_in:
        raise ValueError(f"x has {x.shape[0]} rows, operator takes "
                         f"{plan.n_in}")
    cuda_lib.require(x, "x", dtype=sr.dtype)
    lanes = int(x.shape[1]) if x.dim() == 2 else 1
    path, geo = plan_spmm(plan, lanes)
    out = torch.empty((plan.n_out,) + tuple(x.shape[1:]), dtype=sr.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    if x.data_ptr() % 16:           # 16-byte loads want an aligned base
        x = x.clone()
    p = plan.on(x.device)
    it = geo.items
    lib, stream = cuda_lib.library(), cuda_lib.stream_of(x)
    if path == "words_bool":
        xw = torch.empty((plan.n_in, geo.row_len), dtype=torch.int32,
                         device=x.device)
        ow = torch.empty((plan.n_out, geo.row_len), dtype=torch.int32,
                         device=x.device)
        cuda_lib.check(lib.coo_spmm_pack(x.data_ptr(), xw.data_ptr(),
                                         plan.n_in, lanes, geo.row_len,
                                         stream), "coo_spmm (pack)")
        src_t, dst_t = xw, ow
    else:
        src_t, dst_t = x, out
    part = torch.empty(geo.scratch, dtype=src_t.dtype, device=x.device)
    err = lib.coo_spmm_items(
        _MODE[plan.sr_name], p["src"].data_ptr(), p["w"].data_ptr(),
        p["item_edge"].data_ptr(), p["item_dst"].data_ptr(),
        p["fold_row"].data_ptr(), p["fold_seg"].data_ptr(),
        src_t.data_ptr(), dst_t.data_ptr(), part.data_ptr(), plan.nnz,
        plan.n_out, lanes, geo.row_len, geo.vec, geo.threads_per_edge,
        E_CHUNK, it.n_items, int(it.edge[0]), int(it.edge[-1]),
        it.max_edges, it.n_split, it.n_part, geo.scratch, *geo.grid,
        stream)
    cuda_lib.check(err, f"coo_spmm ({path})")
    if path == "words_bool":
        cuda_lib.check(lib.coo_spmm_unpack(ow.data_ptr(), out.data_ptr(),
                                           plan.n_out, lanes, geo.row_len,
                                           stream), "coo_spmm (unpack)")
    spmm_cuda.launches += 1
    spmm_cuda.by_path[path] += 1
    return out


spmm_cuda.launches = 0
spmm_cuda.by_path = dict.fromkeys(PATHS, 0)
