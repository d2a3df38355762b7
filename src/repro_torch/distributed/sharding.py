"""Logical-axis sharding: the bridge between models and meshes
(counterpart of ``repro/distributed/sharding.py``).

Models and launchers name tensor axes with *logical* names (``"embed"``,
``"heads"``, ``"batch"``, …).  The launcher installs a rule set mapping
logical → mesh axes (:mod:`repro_torch.launch.rules`); :func:`spec_for`
resolves a logical tuple to a :class:`P`, one mesh axis (or tuple of
axes, or None) a tensor dimension, skipping any axis whose size does
not divide the dimension — the reference's resolver, choice for choice.

The reference is single-controller: one process holds a global array
and XLA lays it out.  The port is multi-controller SPMD: every rank is
its own process running the same code, and a sharded tensor exists only
as each rank's *block* of it.  So:

* :func:`constrain` is the identity.  A rank already holds its block;
  the reference's sharding constraint only tells XLA a layout, and no
  model code of the data axis needs more.  Tensor-parallel compute at
  the ``"model"`` axis gives it work (ROADMAP A7c-2).
* :func:`put` is the host-side twin: a full tensor in, this rank's
  block out (a view).
* :func:`block_slices` is this rank's global slice of a tensor under a
  spec, :func:`gather_block` the full tensor from every rank's block.
* :func:`tree_specs` stands in for ``tree_shardings``: there is no
  ``NamedSharding``, so a tree's layout is its tree of :class:`P`
  together with the mesh.

``mesh`` is a :class:`~repro_torch.launch.mesh.ShardMesh` (only its
``shape``, ``coords`` and ``groups`` are read).
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()


class P(tuple):
    """A partition spec: one entry a dimension, each a mesh-axis name,
    a tuple of names, or None (replicated).  Equal as the reference's
    ``PartitionSpec`` is, entry for entry as a tuple (``P("data") !=
    P("data", None)``, ``P(None) == (None,)``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


def current_rules() -> dict | None:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_rules(mesh, rules: dict):
    """Install logical→mesh axis rules on this thread for the block."""
    prev = (current_mesh(), current_rules())
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


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
    """Map logical axes to a :class:`P`, skipping non-divisible dims."""
    mesh = mesh or current_mesh()
    rules = rules or current_rules() or {}
    parts = []
    used: set = set()
    for i, name in enumerate(logical):
        options = rules.get(name, None)
        if options is None:
            parts.append(None)
            continue
        if not isinstance(options, list):
            options = [options]
        chosen = None
        for axis in options:
            axes = axis if isinstance(axis, tuple) else (axis,)
            if any(a in used for a in axes):
                continue
            if shape is not None and mesh is not None:
                if shape[i] % axis_size(mesh, axis) != 0:
                    continue
            chosen = axis
            break
        if chosen is not None:
            used.update(chosen if isinstance(chosen, tuple) else (chosen,))
        parts.append(chosen)
    return P(*parts)


def constrain(x, logical: tuple):
    """The identity.  In multi-controller SPMD a rank already holds its
    block; the reference's ``with_sharding_constraint`` is a layout hint
    to XLA, and the data axis needs no work here (the ``"model"`` axis
    will: ROADMAP A7c-2)."""
    return x


def entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_index(entry, mesh) -> int:
    """This rank's index along a dimension sharded over ``entry``'s
    axes, the first axis major (the reference's layout)."""
    idx = 0
    for a in entry_axes(entry):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def block_slices(shape: tuple, spec: P, mesh) -> tuple:
    """This rank's global slice of a tensor of ``shape`` laid out by
    ``spec``: one ``slice`` a dimension.  A sharded dimension must
    divide (``spec_for`` only picks axes that do)."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        k = axis_size(mesh, entry)
        if n % k:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"split over {entry!r} ({k} ranks)")
        b = n // k
        j = block_index(entry, mesh)
        out.append(slice(j * b, (j + 1) * b))
    return tuple(out)


def global_shape(block_shape: tuple, spec: P, mesh) -> tuple:
    """The full shape of which ``block_shape`` is a rank's block."""
    return tuple(n * axis_size(mesh, spec[i] if i < len(spec) else None)
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
    """The full tensor from every rank's block ``x`` under ``spec``: an
    ``all_gather`` over each sharded dimension's axis group, the last
    dimension first.  A replicated spec returns ``x``."""
    from repro_torch.distributed import collectives
    for i in reversed(range(x.dim())):
        entry = spec[i] if i < len(spec) else None
        for a in reversed(entry_axes(entry)):
            if mesh.shape[a] > 1:
                x = collectives.all_gather(x, mesh, a, dim=i)
    return x


def tree_specs(specs, shapes, mesh, rules: dict):
    """:class:`P` for every leaf of a tree, given its tree of logical
    tuples and a tree of the same keys whose leaves have ``.shape`` (a
    leaf without one, an int, is a scalar)."""
    if isinstance(specs, dict):
        return {k: tree_specs(specs[k], shapes[k], mesh, rules)
                for k in specs}
    return spec_for(tuple(specs), tuple(getattr(shapes, "shape", ())), mesh,
                    rules)
