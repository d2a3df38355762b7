"""Logical-axis sharding: the bridge between models and meshes
(counterpart of ``repro/distributed/sharding.py``).

Models and launchers name tensor axes with *logical* names (``"embed"``,
``"heads"``, ``"batch"``, …).  The launcher installs a rule set mapping
logical → mesh axes (:mod:`repro_torch.launch.rules`); :func:`spec_for`
resolves a logical tuple to a :class:`P`, one mesh axis (or tuple of
axes, or None) a tensor dimension, skipping any axis whose size does
not divide the dimension — the reference's resolver, choice for choice,
but for a head dimension (:class:`Heads`), which goes to ``"model"``
where its heads lay out whole there (:func:`head_split`).

The reference is single-controller: one process holds a global array
and XLA lays it out.  The port is multi-controller SPMD: every rank is
its own process running the same code, and a sharded tensor exists only
as each rank's *block* of it.  So:

* :func:`constrain` is the identity.  Where the reference constrains an
  activation to the ``"model"`` axis (``attention.py:147,202``,
  ``layers.py:52``, ``transformer.py:318,426``), GSPMD partitions the
  products around it; the port's model code makes that partition itself
  with the operators of :mod:`~repro_torch.distributed.collectives`
  (``copy_to_model`` at a column-parallel region's entry,
  ``reduce_from_model`` after a row-parallel product), at the same
  sites, on the active mesh's ``"model"`` axis (:func:`model_mesh`).
  At the two in ``moe.py:89,96`` the port's MoE layer keeps each rank's
  experts on the rank and routes identically on every rank of the axis
  (``models/moe.py``).  Where the caller has split the batch over
  ``"data"`` (``use_rules(..., batch_axis="data")``, the sharded train
  step), :func:`data_mesh` tells the MoE layer to reckon capacity over
  the global batch.
* A rank's *compute block* of a leaf is what the model code computes
  with.  For most leaves it is one slice a dimension
  (:func:`block_slices`).  A fused leaf (:class:`Fused`: ``w_in``'s
  value and output gate, ``w_qk``'s q and k, side by side in the last
  dimension) is cut half by half: rank ``r`` of M holds ``[v_r |
  og_r]``, the r-th block of each half, so its value, gate, q and k
  cover the same channels.  :func:`block_parts` gives the global
  slices a block is made of, :func:`take_block` cuts a full tensor into
  this rank's block, :func:`gather_block` puts the full tensor, in the
  reference's layout, back together from every rank's block.
* :func:`put` is the host-side twin of ``constrain`` for activations:
  a full tensor in, this rank's block out (a view).
* :func:`tree_specs` stands in for ``tree_shardings``: there is no
  ``NamedSharding``, so a tree's layout is its tree of :class:`P`
  together with the mesh.
* Whole heads on a model axis that need not divide them: a logical
  spec marked :class:`Heads` (``wq``'s and ``wo``'s ``"heads"``
  dimension, ``wk``'s and ``wv``'s ``"kv"``) resolved on a ``"model"``
  axis of M ranks gives a :class:`P` whose ``table`` is each rank's
  ``(start, size)`` of that dimension, from :func:`head_split`'s rule:
  where M is at most the kv heads, a contiguous run of whole GQA groups
  a rank (the first ranks one more where M does not divide them); where
  M is a larger multiple of the kv heads, each kv head on ``M / n_kv``
  consecutive ranks (``P.rep``), its query heads split over them, or,
  where the group is narrower than that, each query head replicated on
  its ranks too (and ``wo``'s rows of it split over them).  A rank's
  query heads always use the kv heads it holds, rank 0 holds the most,
  and the ``rep`` consecutive ranks of a replicated head hold the same
  block.  :func:`kv_groups` gives the process groups that split such a
  leaf (one rank of each head) and that replicate it (the ranks of one
  head); a replicated block's gradient is summed over the latter
  (``collectives.copy_to_group``).
* ZeRO-3 one layer at a time: the sharded train step installs a
  :class:`LayerGatherer` (:func:`use_gatherer`, scoped as
  :func:`use_rules` is), and the model code hands each layer's blocks to
  :func:`gather_layer` just before the layer runs, and the entries
  outside the stacks where it uses them; the specs decide which gathered
  leaves are kept through the step, and :meth:`LayerGatherer.bound`
  prices what is gathered at once.  With no gatherer installed it
  is the identity: the unsharded step, serving and GPipe compute on
  what they are given.

``mesh`` is a :class:`~repro_torch.launch.mesh.ShardMesh` (only its
``shape``, ``coords`` and ``groups`` are read).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import weakref
from typing import NamedTuple

_state = threading.local()

#: the mesh axis of tensor-parallel compute, the one ``P.rep`` refers to
MODEL = "model"


class P(tuple):
    """A partition spec: one entry a dimension, each a mesh-axis name,
    a tuple of names, or None (replicated).  Equal as the reference's
    ``PartitionSpec`` is, entry for entry as a tuple (``P("data") !=
    P("data", None)``, ``P(None) == (None,)``).  ``fused`` (default 1)
    is the count of tensors the last dimension holds side by side, each
    split alike (:class:`Fused`); ``rep`` (default 1) the count of
    consecutive ``"model"`` ranks that hold each block of the dimension
    split over ``"model"`` (a replicated head, :class:`Heads`);
    ``table`` (default None: even blocks) that dimension's ``(start,
    size)`` on each ``"model"`` rank, in rank order (whole heads,
    :func:`head_split`).  None of them takes part in equality."""

    def __new__(cls, *parts, fused: int = 1, rep: int = 1,
                table: tuple | None = None):
        out = super().__new__(cls, parts)
        out.fused, out.rep, out.table = fused, rep, table
        return out

    def __getnewargs_ex__(self):
        return tuple(self), {"fused": self.fused, "rep": self.rep,
                             "table": self.table}

    def __repr__(self) -> str:
        extra = f", fused={self.fused}" if self.fused > 1 else ""
        extra += f", rep={self.rep}" if self.rep > 1 else ""
        if self.table is not None:
            extra += ", sizes=" + "/".join(str(z) for _, z in self.table)
        return "P(" + ", ".join(repr(p) for p in self) + extra + ")"

    def like(self, parts, fused: int = 1) -> "P":
        """A spec of the entries ``parts`` (some of this one's) with this
        one's layout of ``"model"``, its ``rep`` and ``table``, where
        ``parts`` still hold the ``"model"`` axis."""
        has = any(MODEL in entry_axes(e) for e in parts)
        return P(*parts, fused=fused, rep=self.rep if has else 1,
                 table=self.table if has else None)


class Fused(tuple):
    """A logical spec whose last dimension holds ``parts`` tensors side
    by side (``w_in``: value and output gate), each cut over the mesh
    on its own; equal to the plain tuple, as the reference's spec is."""

    def __new__(cls, logical, parts: int = 2):
        out = super().__new__(cls, logical)
        out.parts = parts
        return out

    def __getnewargs__(self):
        return tuple(self), self.parts

    def prefixed(self, *names) -> "Fused":
        """This spec with ``names`` in front (a stacked leaf's)."""
        return Fused(names + tuple(self), self.parts)


class Heads(tuple):
    """A logical spec whose head dimension holds whole heads; equal to
    the plain tuple, as the reference's spec is.  ``count`` is the kv
    head count; ``queries`` the query head count where the dimension
    is ``"heads"``, query heads (``wq``'s columns, with ``rows`` set
    ``wo``'s rows), or None where it is ``"kv"``, kv heads (``wk``,
    ``wv``).  Resolved on a ``"model"`` axis, the dimension is laid out
    in whole heads by :func:`head_split` (``P.table``, ``P.rep``)."""

    def __new__(cls, logical, count: int, queries: int | None = None,
                rows: bool = False):
        out = super().__new__(cls, logical)
        out.count, out.queries, out.rows = count, queries, rows
        return out

    def __getnewargs__(self):
        return tuple(self), self.count, self.queries, self.rows

    @property
    def dim_name(self) -> str:
        """The logical name of the dimension that holds the heads."""
        return "kv" if self.queries is None else "heads"

    def prefixed(self, *names) -> "Heads":
        """This spec with ``names`` in front (a stacked leaf's)."""
        return Heads(names + tuple(self), self.count, self.queries,
                     self.rows)


class HeadSplit(NamedTuple):
    """Whole heads on a model axis of M ranks (:func:`head_split`): for
    each rank, in rank order, ``q[r]`` and ``kv[r]`` its ``(first,
    count)`` query and kv heads; ``q_rep`` and ``kv_rep`` the
    consecutive ranks that hold each query and kv head."""

    q: tuple
    kv: tuple
    q_rep: int
    kv_rep: int


def _runs(n: int, m: int, first: int = 0, width: int = 1) -> list:
    """``n`` items in ``m`` contiguous runs, the first ``n mod m`` one
    longer: each run's ``(first, count)``, both times ``width``, from
    ``first``."""
    base, extra = divmod(n, m)
    out, at = [], first
    for r in range(m):
        k = base + (r < extra)
        out.append((at * width, k * width))
        at += k
    return out


@functools.lru_cache(maxsize=None)
def head_split(n_q: int, n_kv: int, m: int) -> HeadSplit:
    """``n_q`` query heads over ``n_kv`` kv heads (a GQA group of ``g =
    n_q / n_kv``) on a model axis of ``m`` ranks, in whole heads, each
    rank's query heads inside the kv heads it holds (an integral group
    on every rank, as kernel B5 wants):

    (a) ``m <= n_kv``: rank r holds a contiguous run of ⌈n_kv/m⌉ or
        ⌊n_kv/m⌋ kv heads, the first ``n_kv mod m`` ranks one more,
        with all ``g`` query heads of each (``m`` dividing ``n_kv``:
        ``n_kv / m`` each);
    (b) ``m`` a larger multiple of ``n_kv``, ``g >= rep = m / n_kv``:
        each kv head on its ``rep`` consecutive ranks, its ``g`` query
        heads split over them ⌈g/rep⌉ or ⌊g/rep⌋ each, the first ranks
        one more;
    (c) ``m`` a larger multiple of ``n_kv``, ``g < rep``, ``rep`` a
        multiple of ``g``: each query head on ``rep / g`` consecutive
        ranks too (``q_rep``).

    Any other split raises ``ValueError`` naming the counts."""
    if n_kv < 1 or n_q % n_kv:
        raise ValueError(f"{n_q} query heads do not make whole groups of "
                         f"{n_kv} kv heads")
    g = n_q // n_kv
    if m <= n_kv:
        kv = _runs(n_kv, m)
        return HeadSplit(tuple((a * g, k * g) for a, k in kv), tuple(kv),
                         1, 1)
    rep = m // n_kv
    if m % n_kv == 0 and g >= rep:
        q = [run for h in range(n_kv) for run in _runs(g, rep, h * g)]
        return HeadSplit(tuple(q), tuple((r // rep, 1) for r in range(m)),
                         1, rep)
    if m % n_kv == 0 and rep % g == 0:
        q_rep = rep // g
        return HeadSplit(tuple((r // q_rep, 1) for r in range(m)),
                         tuple((r // rep, 1) for r in range(m)), q_rep, rep)
    raise ValueError(f"a model axis of {m} ranks does not split {n_q} "
                     f"query heads over {n_kv} kv heads into whole heads "
                     f"(it must be at most the kv heads, or rep times "
                     f"them with rep at most the group of {g} query heads "
                     f"or a multiple of it)")


def head_table(logical: Heads, n: int, m: int):
    """``(table, rep)`` of the head dimension of ``logical`` (``n``
    entries) on a model axis of ``m`` ranks (:class:`P`'s), or None
    where :func:`head_split` has no split (or the heads are not whole
    in ``n``)."""
    heads = logical.queries or logical.count
    try:
        split = head_split(heads, logical.count, m)
    except ValueError:
        return None
    if n % heads:
        return None
    hd = n // heads
    if logical.queries is None:
        return tuple((a * hd, k * hd) for a, k in split.kv), split.kv_rep
    if logical.rows and split.q_rep > 1:    # a head's rows over its ranks
        return (tuple(_runs(n, m)), 1) if n % m == 0 else None
    return tuple((a * hd, k * hd) for a, k in split.q), split.q_rep


def current_rules() -> dict | None:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


def current_batch_axis():
    return getattr(_state, "batch_axis", None)


@contextlib.contextmanager
def use_rules(mesh, rules: dict, batch_axis: str | None = None):
    """Install logical→mesh axis rules on this thread for the block.
    ``batch_axis``: the mesh axis the caller split the batch over (each
    rank holds its rows of the global batch), or None where every rank
    holds the whole batch."""
    prev = (current_mesh(), current_rules(), current_batch_axis())
    _state.mesh, _state.rules, _state.batch_axis = mesh, rules, batch_axis
    try:
        yield
    finally:
        _state.mesh, _state.rules, _state.batch_axis = prev


def current_gatherer():
    return getattr(_state, "gatherer", None)


@contextlib.contextmanager
def use_gatherer(gatherer):
    """Install ``gatherer`` (a :class:`LayerGatherer`, or None) on this
    thread for the block: what :func:`gather_layer` gathers with."""
    prev = current_gatherer()
    _state.gatherer = gatherer
    try:
        yield
    finally:
        _state.gatherer = prev


def gather_layer(path, tree):
    """This rank's blocks ``tree`` of the parameters at ``path`` (a
    top-level key, or a tuple of keys down the tree) gathered by the
    installed gatherer: a stacked entry's one layer (its leading layer
    axis gone), any other entry whole.  ``tree`` itself, untouched, when
    no gatherer is installed."""
    g = current_gatherer()
    return tree if g is None else g.gather(path, tree)


def stacked(logical) -> bool:
    """Whether a leaf of logical spec ``logical`` is stacked over layers
    (led by ``"layers"``), so that the model computes on one layer's view
    of it at a time."""
    return len(logical) > 0 and logical[0] == "layers"


class LayerGatherer:
    """Gathers parameter blocks over one mesh axis (``"data"``, ZeRO-3's
    axis) where the model computes with them.

    ``specs`` is the whole parameter tree's tree of :class:`P` and
    ``logical`` its logical specs (``param_specs``); a leaf whose spec
    does not split over ``axis`` passes as it is.  A split leaf goes
    through ``collectives.gather_param``: all-gathered forward, its
    gradient reduce-scattered to the block backward.  The specs decide
    what is kept: a stacked leaf (:func:`stacked`) is handed over one
    layer at a time and gathered as not resident, so that under
    ``collectives.reshard_after_forward`` the layer's gathered weights go
    when its forward ends and are gathered again in its backward; any
    other leaf is resident, kept from its gather to its last use in the
    backward.  :meth:`bound` prices that choice."""

    def __init__(self, mesh, specs: dict, logical: dict, axis: str = "data"):
        self.mesh, self.specs, self.logical, self.axis = (mesh, specs,
                                                          logical, axis)

    def _dim(self, spec):
        return next((i for i, e in enumerate(spec)
                     if self.axis in entry_axes(e)), None)

    def gather(self, path, tree):
        spec, names = self.specs, self.logical
        for key in (path,) if isinstance(path, str) else path:
            spec, names = spec[key], names[key]
        return self._walk(spec, names, tree)

    def _walk(self, spec, names, node):
        if isinstance(node, dict):
            return {k: self._walk(spec[k], names[k], v)
                    for k, v in node.items()}
        dim = self._dim(spec)
        if dim is None:
            return node
        lead = int(stacked(names))
        if dim < lead:
            raise ValueError(f"a stacked leaf split over {self.axis!r} on "
                             f"its layer axis ({spec!r}) has no one layer")
        from repro_torch.distributed import collectives
        return collectives.gather_param(node, self.mesh, self.axis,
                                        dim - lead, resident=not lead)

    def gathered_bytes(self, blocks: dict) -> dict:
        """For this rank's ``blocks`` (the whole tree): the gathered bytes
        (a block's times the ranks of ``axis``) of the resident leaves
        split over ``axis`` (``"resident"``), of the largest layer of any
        stack (``"layer"``) and of every split leaf (``"whole"``)."""
        w = axis_size(self.mesh, self.axis)
        out, layers = {"resident": 0, "whole": 0}, {}

        def walk(top, spec, names, node):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(top, spec[k], names[k], v)
                return
            if self._dim(spec) is None:
                return
            n = node.numel() * node.element_size() * w
            out["whole"] += n
            if stacked(names):
                layers[top] = layers.get(top, 0) + n // node.shape[0]
            else:
                out["resident"] += n

        for k, v in blocks.items():
            walk(k, self.specs[k], self.logical[k], v)
        out["layer"] = max(layers.values(), default=0)
        return out

    def bound(self, blocks: dict) -> tuple[int, int]:
        """``(bound, whole)``: the most gathered bytes a step on
        ``blocks`` holds at once — every resident leaf and the largest
        layer — and what gathering the whole tree at once would hold."""
        b = self.gathered_bytes(blocks)
        return b["resident"] + b["layer"], b["whole"]


def axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def spec_for(logical: tuple, shape: tuple | None = None, mesh=None,
             rules: dict | None = None) -> P:
    """Map logical axes to a :class:`P`, skipping non-divisible dims
    (a :class:`Fused` spec's last dim must divide once a part).  A
    :class:`Heads` spec's head dimension goes to ``"model"`` where
    :func:`head_split` lays its heads out whole there (``P.table``,
    ``P.rep``), divisible or not."""
    mesh = mesh or current_mesh()
    rules = rules or current_rules() or {}
    fused = getattr(logical, "parts", 1)
    rep, table = 1, None
    parts = []
    used: set = set()
    for i, name in enumerate(logical):
        options = rules.get(name, None)
        if options is None:
            parts.append(None)
            continue
        if not isinstance(options, list):
            options = [options]
        heads = (mesh is not None and isinstance(logical, Heads)
                 and name == logical.dim_name)
        chosen = layout = None
        for axis in options:
            axes = axis if isinstance(axis, tuple) else (axis,)
            if any(a in used for a in axes):
                continue
            if (heads and shape is not None and axis == MODEL
                    and mesh.shape[MODEL] > 1):
                layout = head_table(logical, shape[i], mesh.shape[MODEL])
                if layout is None:
                    continue
            elif shape is not None and mesh is not None:
                n = shape[i] // fused if i == len(logical) - 1 else shape[i]
                if n % axis_size(mesh, axis) != 0:
                    continue
            chosen = axis
            break
        if chosen is not None:
            used.update(chosen if isinstance(chosen, tuple) else (chosen,))
            if layout is not None:
                table, rep = layout
        parts.append(chosen)
    return P(*parts, fused=fused, rep=rep, table=table)


def constrain(x, logical: tuple):
    """The identity.  A rank already holds its block, and the
    reference's ``with_sharding_constraint`` is a layout hint to XLA;
    the work GSPMD does at a ``"model"`` constraint is the model code's
    own, through the model-axis operators of
    :mod:`~repro_torch.distributed.collectives` (the module's
    docstring)."""
    return x


def model_mesh():
    """The active mesh when its ``"model"`` axis spans more than one
    rank, else None: what the model code reads to compute on its blocks
    (``use_rules`` installs it)."""
    mesh = current_mesh()
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return mesh


def data_mesh():
    """The active mesh when the batch is split over its ``"data"`` axis
    (with a ``"pod"`` axis, over ``("pod", "data")``) of more than one
    rank (``use_rules(..., batch_axis=…)``), else None: what a layer
    whose answer depends on the whole batch (MoE capacity) reads; its
    axes are :func:`batch_axes`."""
    mesh = current_mesh()
    if mesh is None or not batch_axes():
        return None
    return mesh


def batch_axes() -> tuple:
    """The mesh axes of more than one rank that the active batch is
    split over, outermost first (``use_rules``' ``batch_axis``: a name or
    a tuple of names); ``()`` where every rank holds the whole batch."""
    mesh, axis = current_mesh(), current_batch_axis()
    if mesh is None or axis is None:
        return ()
    return tuple(a for a in entry_axes(axis) if mesh.shape.get(a, 1) > 1)


def model_coords(mesh) -> tuple[int, int]:
    """``(index, size)`` of this rank along ``"model"``; ``(0, 1)``
    without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.coords.get("model", 0), mesh.shape.get("model", 1)


def entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_count(entry, mesh, rep: int = 1) -> int:
    """The distinct blocks of a dimension split over ``entry`` (its
    ranks, less ``"model"``'s replicas with ``rep``)."""
    out = 1
    for a in entry_axes(entry):
        out *= mesh.shape[a] // (rep if a == MODEL else 1)
    return out


def block_index(entry, mesh, rep: int = 1) -> int:
    """This rank's index along a dimension sharded over ``entry``'s
    axes, the first axis major (the reference's layout); ``rep``
    consecutive ``"model"`` ranks share one."""
    idx = 0
    for a in entry_axes(entry):
        r = rep if a == MODEL else 1
        idx = idx * (mesh.shape[a] // r) + mesh.coords[a] // r
    return idx


def _dim_block(n: int, entry, mesh, what, rep: int = 1,
               table=None) -> tuple[int, int]:
    """``(start, size)`` of this rank's block of a dimension of ``n``
    split over ``entry`` (``table``'s entry for this rank where the
    dimension is split over ``"model"`` in whole heads)."""
    if table is not None and MODEL in entry_axes(entry):
        if entry_axes(entry) != (MODEL,) or table_extent(table) != n:
            raise ValueError(f"{what} is not the {table_extent(table)} "
                             f"entries of its head table over {entry!r}")
        return table[mesh.coords[MODEL]]
    k = block_count(entry, mesh, rep)
    if n % k:
        raise ValueError(f"{what} does not split over {entry!r} ({k} "
                         f"blocks)")
    b = n // k
    return block_index(entry, mesh, rep) * b, b


def table_extent(table) -> int:
    """The whole dimension a head table lays out."""
    return max(a + b for a, b in table)


def _entry(spec, i):
    return spec[i] if i < len(spec) else None


def block_slices(shape: tuple, spec: P, mesh) -> tuple:
    """This rank's global slice of a tensor of ``shape`` laid out by
    ``spec``: one ``slice`` a dimension.  A sharded dimension must
    divide (``spec_for`` only picks axes that do) or follow the spec's
    head table.  A fused spec split over more than one rank has no one
    slice (:func:`block_parts`)."""
    parts = block_parts(shape, spec, mesh)
    if len(parts) > 1:
        raise ValueError(f"a fused block of {tuple(shape)} under {spec!r} "
                         f"is {len(parts)} slices: use block_parts")
    return parts[0]


def block_parts(shape: tuple, spec: P, mesh) -> list:
    """The global slices this rank's compute block of a tensor of
    ``shape`` laid out by ``spec`` is made of, in the order they are
    concatenated along the last dimension: one for a plain spec;
    ``spec.fused`` for a fused one split over more than one rank (the
    rank's block of each part)."""
    out = []
    rep = getattr(spec, "rep", 1)
    table = getattr(spec, "table", None)
    for i, n in enumerate(shape):
        a, b = _dim_block(n, _entry(spec, i), mesh,
                          f"dimension {i} of {tuple(shape)}", rep, table)
        out.append(slice(a, a + b))
    k = getattr(spec, "fused", 1)
    if k == 1 or not shape or axis_size(mesh, _entry(spec, len(shape) - 1)
                                        ) == 1:
        return [tuple(out)]
    n = shape[-1]
    if n % k:
        raise ValueError(f"the last dimension of {tuple(shape)} does not "
                         f"hold {k} fused parts")
    a, b = _dim_block(n // k, _entry(spec, len(shape) - 1), mesh,
                      f"a fused part of {tuple(shape)}")
    return [tuple(out[:-1]) + (slice(j * n // k + a, j * n // k + a + b),)
            for j in range(k)]


def take_block(x, spec: P, mesh):
    """This rank's compute block of the full tensor ``x`` (a view for a
    plain spec, a new tensor for a fused one)."""
    parts = block_parts(tuple(x.shape), spec, mesh)
    if len(parts) == 1:
        return x[parts[0]]
    import torch
    return torch.cat([x[p] for p in parts], -1)


def global_shape(block_shape: tuple, spec: P, mesh) -> tuple:
    """The full shape of which ``block_shape`` is a rank's block."""
    rep = getattr(spec, "rep", 1)
    table = getattr(spec, "table", None)
    return tuple(
        table_extent(table) if table is not None and MODEL in entry_axes(
            _entry(spec, i)) else n * block_count(_entry(spec, i), mesh, rep)
        for i, n in enumerate(block_shape))


def put(x, logical: tuple):
    """This rank's block of the full tensor ``x`` under the active rules
    (a view); ``x`` itself when no mesh is active.  The host-side twin
    of :func:`constrain`: the serve loop lays a packed query batch out
    over the data axis with it."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = spec_for(logical, tuple(x.shape), mesh)
    return x[block_slices(tuple(x.shape), spec, mesh)]


def gather_block(x, spec: P, mesh):
    """The full tensor, in the reference's layout, from every rank's
    block ``x`` under ``spec``: an ``all_gather`` over each sharded
    dimension's axis group, the last dimension first (over ``"model"``
    with a head table or replicated heads, each rank's block padded to
    the largest, then cut back, one block of each head kept); a fused
    last dimension is put back part by part.  A replicated spec returns
    ``x``."""
    from repro_torch.distributed import collectives
    k = getattr(spec, "fused", 1)
    rep = getattr(spec, "rep", 1)
    table = getattr(spec, "table", None)
    for i in reversed(range(x.dim())):
        entry = _entry(spec, i)
        for a in reversed(entry_axes(entry)):
            if mesh.shape[a] <= 1:
                continue
            if a == MODEL and (rep > 1 or table is not None):
                x = _gather_heads(x, mesh, i, rep, table)
            else:
                x = collectives.all_gather(x, mesh, a, dim=i)
        s = axis_size(mesh, entry)
        if i == x.dim() - 1 and k > 1 and s > 1:
            # ranks' blocks [p0_r | p1_r] in rank order → [p0 | p1]
            lead = tuple(x.shape[:-1])
            x = x.reshape(lead + (s, k, -1)).transpose(-3, -2).reshape(
                lead + (-1,))
    return x


def _gather_heads(x, mesh, dim: int, rep: int, table):
    """The whole of dimension ``dim`` from every ``"model"`` rank's block
    ``x`` of it, laid out by ``table`` (even blocks where None), each
    block of ``rep`` consecutive ranks taken once.  The collectives want
    equal blocks: each is padded to the largest and cut back."""
    import torch
    from repro_torch.distributed import collectives
    m = mesh.shape[MODEL]
    if table is None:
        table = tuple((r // rep * x.shape[dim], x.shape[dim])
                      for r in range(m))
    big = max(b for _, b in table)
    pad = big - x.shape[dim]
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:dim] + (pad,)
                                      + x.shape[dim + 1:])], dim)
    whole = collectives.all_gather(x, mesh, MODEL, dim=dim)
    return torch.cat([whole.narrow(dim, r * big, table[r][1])
                      for r in range(m) if r % rep == 0], dim)


def kv_groups(mesh, rep: int) -> tuple:
    """``(split, replicas)``: the process groups of this rank's ``"model"``
    ranks that hold distinct blocks of a leaf laid out with ``rep`` (one
    rank of each head: this rank's index modulo ``rep``) and that hold
    this rank's block (its ``rep`` consecutive ranks) — a kv head's
    ranks, or a replicated query head's (``head_split``'s ``kv_rep``,
    ``q_rep``).  Made once a mesh
    and ``rep``, every rank of the world making every group in the same
    order (a collective call, as the mesh's own groups are)."""
    made = _KV_GROUPS.setdefault(mesh, {})
    if rep not in made:
        import torch.distributed as dist
        mi = mesh.axis_names.index(MODEL)
        m = mesh.shape[MODEL]
        rows = mesh.device_mesh.mesh.movedim(mi, -1).reshape(-1, m).tolist()
        reps = [row[h * rep:(h + 1) * rep] for row in rows
                for h in range(m // rep)]
        splits = [row[c::rep] for row in rows for c in range(rep)]
        made[rep] = (dist.new_subgroups_by_enumeration(splits)[0],
                     dist.new_subgroups_by_enumeration(reps)[0])
    return made[rep]


#: :func:`kv_groups` made so far: mesh → {rep: groups}
_KV_GROUPS = weakref.WeakKeyDictionary()


def tree_specs(specs, shapes, mesh, rules: dict):
    """:class:`P` for every leaf of a tree, given its tree of logical
    tuples and a tree of the same keys whose leaves have ``.shape`` (a
    leaf without one, an int, is a scalar)."""
    if isinstance(specs, dict):
        return {k: tree_specs(specs[k], shapes[k], mesh, rules)
                for k in specs}
    logical = specs if isinstance(specs, (Fused, Heads)) else tuple(specs)
    return spec_for(logical, tuple(getattr(shapes, "shape", ())), mesh,
                    rules)
