"""DeltaLog: a typed log of streaming relation updates.

The counterpart of ``repro/incremental/delta.py``.  Each entry is one
batch of tuple updates against one named relation, kept as numpy
arrays on the host (a log is small; only :meth:`DeltaLog.merged` and
:meth:`repro_torch.core.engine.Database.apply_delta` move it to a
device).  The operations are chosen so the *monotone* case is
recognizable without looking at the stored data:

* ``merge`` — the ⊕-merge ``R′ = R ⊕ Δ``, monotone in the semiring order
  (``R′ ⊒ R``): boolean edge insertion (∨), tropical weight decrease
  (min — a weight *above* the stored one is absorbed, still monotone),
  counting increments (+).  Delta-restart re-converges the old fixpoint
  under merges without recomputing.
* ``delete`` — remove keys outright.  Not expressible as ⊕ on any of the
  semirings, hence non-monotone: the old solution may over-derive and a
  warm restart is unsound.  :func:`repro_torch.incremental.
  refresh_program` repairs deletes through a CEGIS-verified ⊖/recount
  maintenance rule (:mod:`repro_torch.incremental.maintenance`) when one
  exists for the program's (signature, semiring, op), and falls back to
  a full recompute with a recorded reason otherwise.
* ``increase`` — replace stored values with *larger* ones (a tropical
  weight increase).  ⊕ = min would absorb it, so it is the other
  non-monotone mutation: recorded as delete-the-old ⊕ insert-the-new and
  routed through the same maintenance path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import semiring as sr_mod
from repro_torch.sparse.coo import SparseRelation


@dataclasses.dataclass(frozen=True)
class DeltaEntry:
    """One batch of updates against one relation."""

    relation: str
    coords: np.ndarray           # (k, arity) int
    values: np.ndarray | None    # (k,) semiring values; None → 1̄ each
    op: str                      # "merge" | "delete" | "increase"

    @property
    def size(self) -> int:
        return len(self.coords)


class DeltaLog:
    """An append-only log of updates, consumable by
    :meth:`repro_torch.core.engine.Database.apply_delta` and the
    delta-restart machinery (:mod:`repro_torch.incremental.restart`)."""

    def __init__(self) -> None:
        self.entries: list[DeltaEntry] = []

    def __len__(self) -> int:
        return len(self.entries)

    def __repr__(self) -> str:
        per = {}
        for e in self.entries:
            per[e.relation] = per.get(e.relation, 0) + e.size
        return f"DeltaLog({per})"

    # -- recording -----------------------------------------------------------
    def insert(self, relation: str, coords, values=None) -> "DeltaLog":
        """⊕-merge tuples into ``relation`` (edge insertions; for
        trop/minplus the same call records a monotone weight decrease,
        since ⊕ = min).  Returns ``self`` for chaining."""
        coords = np.atleast_2d(np.asarray(coords, np.int64))
        if values is not None:
            values = np.asarray(values).reshape(-1)
            assert len(values) == len(coords), (coords.shape, values.shape)
        self.entries.append(DeltaEntry(relation, coords, values, "merge"))
        return self

    def delete(self, relation: str, coords) -> "DeltaLog":
        """Remove keys from ``relation`` — the non-monotone mutation."""
        coords = np.atleast_2d(np.asarray(coords, np.int64))
        self.entries.append(DeltaEntry(relation, coords, None, "delete"))
        return self

    def increase(self, relation: str, coords, values) -> "DeltaLog":
        """Replace the stored values at ``coords`` with the (larger)
        ``values`` — a tropical weight increase, the mutation ⊕ = min
        would silently absorb.  Semantically delete-then-insert; the
        maintenance path seeds from the deleted old values and merges
        the new ones."""
        coords = np.atleast_2d(np.asarray(coords, np.int64))
        values = np.asarray(values).reshape(-1)
        assert len(values) == len(coords), (coords.shape, values.shape)
        self.entries.append(DeltaEntry(relation, coords, values,
                                       "increase"))
        return self

    # -- classification ------------------------------------------------------
    def monotone(self) -> tuple[bool, str | None]:
        """Whether every entry is a ⊕-merge (so the post-update least
        fixpoint dominates the old one and delta-restart is exact);
        otherwise the human-readable reason for the full-recompute
        fallback."""
        for e in self.entries:
            if e.op != "merge":
                return False, (f"{e.op} of {e.size} key(s) from "
                               f"{e.relation} is non-monotone (not a "
                               f"⊕-merge) — restarting from the old "
                               f"solution could over-derive")
        return True, None

    def nonmonotone_op(self) -> str | None:
        """The update-op class the maintenance rule cache is keyed on:
        ``None`` for all-merge logs, else ``"delete"``/``"increase"``
        when one kind of non-monotone entry appears, ``"mixed"`` when
        both do (repaired with the delete rule plus merge seeding)."""
        ops = {e.op for e in self.entries} - {"merge"}
        if not ops:
            return None
        return ops.pop() if len(ops) == 1 else "mixed"

    def touched(self) -> set[str]:
        return {e.relation for e in self.entries}

    def nnz(self, relation: str | None = None) -> int:
        """Total updated-tuple count (optionally for one relation) —
        the nnz(Δ) the planner prices ``objective="incremental"`` with."""
        return sum(e.size for e in self.entries
                   if relation is None or e.relation == relation)

    # -- materialization -----------------------------------------------------
    def removed_coords(self, relation: str) -> np.ndarray:
        """Keys whose stored value stops holding: ``delete`` entries
        plus the old keys of ``increase`` entries (an increase is
        delete-the-old ⊕ insert-the-new).  What the maintenance rule's
        seed selector distrusts."""
        coords = [e.coords for e in self.entries
                  if e.relation == relation
                  and e.op in ("delete", "increase")]
        if not coords:
            return np.zeros((0, 2), np.int64)
        return np.concatenate(coords)

    def merged(self, relation: str, shape, semiring: str, *,
               device=None) -> SparseRelation:
        """All ⊕-contributing entries for ``relation`` coalesced into
        one sparse Δ relation on ``device`` (the seed operand of
        delta-restart): ``merge`` entries plus the *new* values of
        ``increase`` entries (their old keys come back via
        :meth:`removed_coords`).  ``device=None`` is ``cuda``, as for
        every entry point."""
        sr = sr_mod.get(semiring, lib="np")
        coords, values = [], []
        for e in self.entries:
            if e.relation != relation or e.op not in ("merge",
                                                      "increase"):
                continue
            coords.append(e.coords)
            values.append(np.full(e.size, sr.one, sr.dtype)
                          if e.values is None
                          else np.asarray(e.values, sr.dtype))
        if not coords:
            coords = [np.zeros((0, len(shape)), np.int64)]
            values = [np.zeros((0,), sr.dtype)]
        return SparseRelation.from_coo(
            np.concatenate(coords), np.concatenate(values), tuple(shape),
            semiring, device=device)
