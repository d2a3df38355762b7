"""Synthesized ⊖/recount maintenance for non-monotone updates.

The counterpart of ``repro/incremental/maintenance.py``.  Deleting an
edge (or increasing its weight) voids the pre-fixpoint property that
delta-restart rides on: the old solution ``y*`` may *over-derive* under
the shrunk operator, and on a plain semiring there is no subtraction to
cancel the lost derivations with.  On the idempotent complete lattices
(𝔹, trop, maxplus) an exact repair still exists, but its shape is a
program — which seeds to distrust, how far the distrust propagates, and
what to recount — so it is *synthesized* the way the rest of the
package synthesizes H from F and G:

* a small **rule grammar** over ⊕/⊗/⊖/recount primitives — terms
  ``recount(cone(seed(Δ)))`` with seeds ∈ {touched, supported,
  unsupported} and cones ∈ {seeds, one_hop, tight, forward, all};
* a **CEGIS loop**: candidates are enumerated cheapest-first, replayed
  on adversarial + randomized probes (:func:`repro_torch.core.verify.
  sample_update_probes`) against a from-scratch ground truth, and every
  refutation is kept as a counterexample that later candidates must
  pass first;
* **e-graph normalization** (:func:`repro_torch.core.egraph.normalize`
  under ``MAINTENANCE_RULES``) rejects the degenerate full-cone rule by
  proof;
* the verified winner is **cached** per (program signature, semiring,
  update op).

Synthesis keeps the reference's code and candidate order and runs on
the host over CPU probe relations (``mode="frontier"``), so it reaches
the same rule through the same refutations.  The executor
(:func:`maintain_nonmonotone`) runs on the relation's device: the cone
is a hop-by-hop walk of the cached CSR index with one host read a hop,
the recount ⊕ is kernel B3's ``scatter`` path, and the resume is the
ordinary GSN loop.  The winning rule on all three lattices is
``recount(cone_tight(seed_supported(Δ)))``.  Semirings without ⊖ (nat,
real) record a synthesis failure and callers fall back to a full
recompute.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import egraph
from repro_torch.core import semiring as sr_mod
from repro_torch.core import verify
from repro_torch.incremental.restart import _on, delta_seed
from repro_torch.sparse import fixpoint as fx
from repro_torch.sparse.coo import SparseRelation
from repro_torch.sparse.fixpoint import FixpointState, fixpoint

# -- rule grammar -----------------------------------------------------------

#: seed selectors: which update endpoints to distrust.
#: * ``touched`` — every dst of an updated edge;
#: * ``supported`` — only dsts whose deleted edge was tight under y*
#:   (it actually carried the stored value);
#: * ``unsupported`` — supported dsts whose remaining in-edges carry no
#:   support (DRed-style counting — *unsound* on cyclic support, kept in
#:   the grammar precisely so CEGIS refutes it with the cycle probes).
SEED_KINDS = ("supported", "touched", "unsupported")

#: cone selectors: how far the distrust propagates from the seeds.
#: ``seeds``/``one_hop`` are unsound (effects chain), ``tight`` is the
#: minimal sound closure, ``forward`` a sound over-approximation, and
#: ``all`` the degenerate whole-universe cone (≡ cold fixpoint —
#: rejected by e-graph proof, not by probing).
CONE_KINDS = ("seeds", "one_hop", "tight", "forward", "all")

_SEED_COST = {"supported": 0, "touched": 1, "unsupported": 2}
_CONE_COST = {"seeds": 0, "one_hop": 1, "tight": 2, "forward": 3, "all": 4}


@dataclasses.dataclass(frozen=True)
class MaintenanceRule:
    """One (possibly verified) maintenance program from the grammar."""

    seeds: str
    cone: str
    semiring: str
    op: str                       # "delete" | "increase"
    verified: bool
    reason: str                   # why verified / why rejected
    term: tuple = ()              # normalized s-expression
    probes: int = 0               # ground-truth comparisons passed
    refuted: tuple = ()           # ((seeds, cone, probe-name), ...) trail

    @property
    def name(self) -> str:
        """The display name ``explain()`` and reports surface."""
        return f"⊖-recount[seed={self.seeds}, cone={self.cone}]"


def rule_term(seeds: str, cone: str) -> tuple:
    return ("recount", (f"cone_{cone}", (f"seed_{seeds}", "delta")))


def _candidates():
    cands = [(s, c) for c in CONE_KINDS for s in SEED_KINDS]
    cands.sort(key=lambda sc: (_CONE_COST[sc[1]], _SEED_COST[sc[0]]))
    return cands


# -- rule cache -------------------------------------------------------------

_RULE_CACHE: dict[tuple[str, str, str], MaintenanceRule] = {}


def cached_rule(signature: str, semiring: str, op: str
                ) -> MaintenanceRule | None:
    """The cached synthesis outcome for this (program, semiring, op) —
    positive *or* negative; ``None`` means never attempted.  The planner
    consults this without side effects; :func:`ensure_rule` populates it."""
    return _RULE_CACHE.get((signature, semiring, op))


def clear_rule_cache() -> None:
    _RULE_CACHE.clear()


def ensure_rule(signature: str, semiring: str, op: str = "delete", *,
                budget_s: float = 5.0, probes: int = 8,
                seed: int = 0) -> MaintenanceRule:
    """Return the cached rule for this key, synthesizing (and caching the
    outcome, including failures) on a miss."""
    key = (signature, semiring, op)
    rule = _RULE_CACHE.get(key)
    if rule is None:
        rule = synthesize_maintenance(semiring, op, budget_s=budget_s,
                                      probes=probes, seed=seed)
        _RULE_CACHE[key] = rule
    return rule


# -- CEGIS ------------------------------------------------------------------


def synthesize_maintenance(semiring: str, op: str = "delete", *,
                           budget_s: float = 5.0, probes: int = 8,
                           seed: int = 0) -> MaintenanceRule:
    """CEGIS over the rule grammar: enumerate cheapest-first, reject the
    degenerate cone by e-graph proof, replay survivors on accumulated
    counterexamples before fresh probes, and return the first candidate
    whose repairs match the from-scratch ground truth everywhere."""
    sr = sr_mod.get(semiring, lib="np")
    if sr.minus is None:
        return MaintenanceRule(
            "-", "-", semiring, op, False,
            f"semiring {semiring} has no ⊖ (not an idempotent complete "
            f"lattice) — maintenance carries are inexpressible; full "
            f"recompute is the only exact refresh")
    if op == "increase" and semiring == "bool":
        return MaintenanceRule(
            "-", "-", semiring, op, False,
            "weight increase is not expressible on 𝔹 (edges are "
            "unweighted) — record it as delete ⊕ insert instead")
    rng = np.random.default_rng(seed)
    pool = verify.sample_update_probes(semiring, rng, probes, op=op)
    counterexamples: list[verify.UpdateProbe] = []
    refuted: list[tuple[str, str, str]] = []
    deadline = time.monotonic() + budget_s
    for seeds, cone in _candidates():
        term = egraph.normalize(rule_term(seeds, cone))
        if term == "cold_fixpoint" or "univ" in _leaves(term):
            refuted.append((seeds, cone,
                            "egraph: normalizes to cold_fixpoint "
                            "(≡ full recompute)"))
            continue
        if time.monotonic() > deadline:
            return MaintenanceRule(
                seeds, cone, semiring, op, False,
                f"synthesis budget ({budget_s:.1f}s) exhausted after "
                f"{len(refuted)} refutations — falling back to full "
                f"recompute", term, 0, tuple(refuted))
        cand = MaintenanceRule(seeds, cone, semiring, op, False, "",
                               term)
        bad = _first_failure(cand, counterexamples) \
            or _first_failure(cand, pool)
        if bad is not None:
            if bad not in counterexamples:
                counterexamples.append(bad)
            refuted.append((seeds, cone, f"counterexample: {bad.name}"))
            continue
        checked = len(counterexamples) + len(pool)
        return MaintenanceRule(
            seeds, cone, semiring, op, True,
            f"verified on {checked} probe(s) "
            f"({len(counterexamples)} CEGIS counterexample(s) reused)",
            term, checked, tuple(refuted))
    return MaintenanceRule(
        "-", "-", semiring, op, False,
        f"no candidate in the {len(_candidates())}-rule grammar "
        f"survived verification", (), 0, tuple(refuted))


def _leaves(term) -> set:
    if isinstance(term, str):
        return {term}
    out = set()
    for c in term[1:]:
        out |= _leaves(c)
    return out


def _first_failure(rule: MaintenanceRule, probes
                   ) -> verify.UpdateProbe | None:
    """Replay ``rule`` on each probe against the from-scratch ground
    truth (sound refutation: a mismatch is a real counterexample)."""
    for p in probes:
        if not _check_probe(rule, p):
            return p
    return None


def _check_probe(rule: MaintenanceRule, p: verify.UpdateProbe) -> bool:
    # stamp the candidate executable for the replay: CEGIS is exactly the
    # process that decides whether the stamp is deserved
    rule = dataclasses.replace(rule, verified=True,
                               reason="candidate under CEGIS replay")
    old = p.edges
    dvals = _gather_values(old, p.coords)
    new = old.delete_keys(p.coords)
    merge = None
    if rule.op == "increase" and p.new_values is not None:
        new = new.apply_delta(p.coords, p.new_values)
        merge = SparseRelation.from_coo(p.coords, p.new_values,
                                        old.shape, old.semiring,
                                        device=old.device)
    init = torch.from_numpy(p.init)
    y_star, _ = fixpoint(old, init, mode="frontier", max_iters=512)
    y_true, _ = fixpoint(new, init, mode="frontier", max_iters=512)
    y_got, _ = maintain_nonmonotone(new, p.coords, dvals, y_star, init,
                                    rule, merge_delta=merge, max_iters=512,
                                    mode="frontier")
    return verify.values_equal(y_got.numpy(), y_true.numpy())


def _gather_values(rel: SparseRelation, coords) -> torch.Tensor:
    """Old stored values at ``coords`` (0̄ where absent) on the relation's
    device — what the tightness test of a deleted edge is evaluated
    against.  The live entries whose key is wanted are picked by one
    ``isin`` pass; one device sort of their keys (``torch.unique``), the
    values of a key stored twice ⊕-combined through kernel B3's
    ``scatter`` path, and a ``searchsorted`` of the wanted keys."""
    from repro_torch.kernels import ops as kops
    sr = rel.sr()
    want = rel._keys(coords)
    out = sr.zeros((want.shape[0],), rel.device)
    k = rel.nnz
    if k == 0 or want.shape[0] == 0:
        return out
    keys = rel._flat_keys(rel.coords[:k])
    want = rel._flat_keys(want)
    hit = torch.isin(keys, want)
    uniq, inv = torch.unique(keys[hit], sorted=True, return_inverse=True)
    if uniq.shape[0] == 0:
        return out
    vals = kops.semiring_segment_reduce(sr, rel.values[:k][hit],
                                        inv.to(torch.int32).contiguous(),
                                        uniq.shape[0])
    pos = torch.searchsorted(uniq, want).clamp_(max=uniq.shape[0] - 1)
    found = uniq.index_select(0, pos) == want
    return torch.where(found, vals.index_select(0, pos), out)


# -- executor ---------------------------------------------------------------


def maintain_nonmonotone(edges_new: SparseRelation, deleted_coords,
                         deleted_values, prev, init,
                         rule: MaintenanceRule, *, merge_delta=None,
                         max_iters: int = 10_000, mode: str = "auto"):
    """Repair ``y* = lfp(x ↦ init ⊕ x ⊗ E)`` after the non-monotone
    update that produced ``edges_new`` from ``E``, using a verified
    maintenance ``rule``, on ``edges_new``'s device:

    1. **seed** — select the distrusted endpoints of the deleted edges
       (``deleted_coords``/``deleted_values`` are the *old* keys and
       stored values; tightness is judged against ``prev``);
    2. **cone** — close the seeds under the rule's cone relation over
       ``edges_new``: a hop-by-hop walk of its cached forward CSR index
       (deleted entries are 0̄-poisoned there, so they never carry
       support), one host read a hop;
    3. **reset ⊕ recount** — ``y₀ = prev`` outside the cone, 0̄ on it;
       ``d₀ = F′(y₀) ⊖ y₀`` is recounted over the cone's in-edges alone
       (the transposed CSR index), ⊕-combined by kernel B3's ``scatter``
       path — in-cone contributions vanish at 0̄, so one pass against
       the intact exterior is exact;
    4. **resume** — hand ``(y₀, d₀)`` to :func:`repro_torch.sparse.
       fixpoint.fixpoint` as an ordinary warm carry.  ⊕-merges riding in
       the same batch seed extra frontier via :func:`repro_torch.
       incremental.restart.delta_seed` on top.

    ``prev``/``init`` (numpy or tensors) may be ``(n,)`` or a ``(B, n)``
    pack of warm solutions with per-row inits.  Returns ``(y′*, iters)``
    like :func:`repro_torch.incremental.delta_restart_fixpoint`.
    """
    if not rule.verified:
        raise ValueError(f"refusing to execute unverified rule "
                         f"{rule.name}: {rule.reason}")
    sr = sr_mod.get(edges_new.semiring)
    dev = edges_new.device
    prev = _on(prev, dev, sr.dtype)
    init = _on(init, dev, sr.dtype)
    batched = prev.dim() == 2
    rows = prev if batched else prev[None]
    inits = init if batched else init[None]
    assert inits.shape == rows.shape, (inits.shape, rows.shape)
    coords = _on(deleted_coords, dev, torch.int64).reshape(-1, 2)
    dvals = _on(deleted_values, dev, sr.dtype).reshape(-1)
    y0 = rows.clone()
    d0 = sr.zeros(tuple(rows.shape), dev)
    for b in range(rows.shape[0]):
        cone = _cone(rule, rows[b], coords, dvals, edges_new, sr)
        y0[b].index_fill_(0, cone, sr.zero)
        if cone.shape[0]:
            d0[b].index_copy_(0, cone, _recount(cone, y0[b], inits[b],
                                                edges_new, sr))
    if merge_delta is not None and merge_delta.nnz:
        backend = "np" if dev.type == "cpu" else "torch"
        d0 = sr.add(d0, delta_seed(merge_delta, y0, backend=backend))
    st = FixpointState(y0, d0, torch.zeros(rows.shape[0],
                                           dtype=torch.int32, device=dev),
                       edges_new.semiring, batched)
    return fixpoint(edges_new, state=st, max_iters=max_iters, mode=mode)


def _tight_mask(y: torch.Tensor, src, w, dst, sr) -> torch.Tensor:
    """Which edges (src, w, dst) carry their dst's stored value."""
    ys, yd = y.index_select(0, src), y.index_select(0, dst)
    if sr.name == "bool":
        return ys & w.bool() & yd
    return (yd != sr.zero) & (yd == sr.mul(ys, w))


def _follow_mask(cone: str, y, src, w, dst, sr) -> torch.Tensor:
    if cone == "tight":
        return _tight_mask(y, src, w, dst, sr)
    # one_hop / forward: any surviving (non-0̄) edge propagates
    return w.bool() if sr.name == "bool" else w != sr.zero


def _mark(mask: torch.Tensor, ids: torch.Tensor, keep: torch.Tensor
          ) -> None:
    """``mask[ids[keep]] = True`` without a host read: dropped ids land
    in ``mask``'s last slot, one past the vertices."""
    n = mask.shape[0] - 1
    mask.index_fill_(0, torch.where(keep, ids, n), True)


def _cone(rule: MaintenanceRule, y: torch.Tensor, coords, dvals,
          edges_new: SparseRelation, sr) -> torch.Tensor:
    """The rule's cone as sorted vertex ids on the relation's device."""
    dev = y.device
    src, dst = coords[:, 0], coords[:, 1]
    n = edges_new.shape[1]
    visited = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    in_range = (dst >= 0) & (dst < n)
    if rule.seeds == "touched":
        _mark(visited, dst, in_range)
    else:
        sup = _tight_mask(y, src, dvals, dst, sr)
        _mark(visited, dst, in_range & sup)
        if rule.seeds == "unsupported":
            _drop_supported(visited, y, edges_new, sr)
    visited[n] = False
    if rule.cone == "seeds":
        return torch.nonzero(visited[:n]).squeeze(1)
    idx = fx.csr_index(edges_new)
    counts = torch.cat([idx.counts, idx.counts.new_zeros(1)])
    size, expanded = _hop_sizes(visited, counts)
    if size == 0:
        return torch.nonzero(visited[:n]).squeeze(1)
    if rule.cone == "all":
        return torch.arange(n, device=dev)
    new, hops = visited.clone(), 0
    while size:
        nxt = torch.zeros_like(visited)
        frontier = torch.nonzero_static(new, size=size).squeeze(1)
        deg = counts.index_select(0, frontier)
        rep = torch.repeat_interleave(torch.arange(size, device=dev), deg,
                                      output_size=expanded)
        base = idx.starts.index_select(0, frontier) - (
            torch.cumsum(deg, 0) - deg)
        esel = base.index_select(0, rep) + torch.arange(expanded,
                                                        device=dev)
        a, b = frontier.index_select(0, rep), idx.dst.index_select(0, esel)
        _mark(nxt, b, _follow_mask(rule.cone, y, a,
                                   idx.w.index_select(0, esel), b, sr))
        if idx.xsrc.shape[0]:
            # the apply_delta overlay: every visited source's appended
            # edges (equal, at hop 0, to the seeds')
            m = visited.index_select(0, idx.xsrc) & \
                ~visited.index_select(0, idx.xdst)
            _mark(nxt, idx.xdst, m & _follow_mask(
                rule.cone, y, idx.xsrc, idx.xw, idx.xdst, sr))
        nxt[n] = False
        new = nxt & ~visited
        visited |= new
        hops += 1
        if rule.cone == "one_hop" and hops >= 1:
            break
        size, expanded = _hop_sizes(new, counts)
    return torch.nonzero(visited[:n]).squeeze(1)


def _hop_sizes(mask: torch.Tensor, counts: torch.Tensor) -> list[int]:
    """A hop's one host read: the frontier size and its out-degree sum."""
    return torch.stack([mask.sum(), torch.where(mask, counts, 0).sum()]
                       ).tolist()


def _drop_supported(visited, y, edges_new, sr) -> None:
    """DRed-style seeds: drop seeds that still have a tight in-edge in
    the new graph (unsound on cyclic support — the grammar keeps it so
    the cycle probes can refute it).  A host loop per seed; CEGIS replays
    it on CPU probes only."""
    tidx = fx.csr_index(edges_new, transpose=True)
    for a in torch.nonzero(visited[:-1]).squeeze(1).tolist():
        lo = int(tidx.starts[a])
        hi = lo + int(tidx.counts[a])
        z, w = tidx.dst[lo:hi], tidx.w[lo:hi]
        alive = bool(_tight_mask(y, z, w, torch.full_like(z, a),
                                 sr).any())
        if tidx.xsrc.shape[0] and not alive:
            m = tidx.xsrc == a
            alive = bool(_tight_mask(y, tidx.xdst[m], tidx.xw[m],
                                     torch.full_like(tidx.xdst[m], a),
                                     sr).any())
        if alive:
            visited[a] = False


def _recount(cone: torch.Tensor, y0: torch.Tensor, init: torch.Tensor,
             edges_new: SparseRelation, sr) -> torch.Tensor:
    """``d₀[a] = init[a] ⊕ ⊕_z y₀[z] ⊗ E′[z, a]`` for each cone vertex
    ``a`` — one pass over the cone's in-edges via the transposed CSR
    index, ⊕-combined into the cone's local rows by B3's ``scatter``
    path.  In-cone sources hold 0̄ in ``y₀`` and annihilate under ⊗, so
    only the intact exterior contributes, which is exactly ``F′(y₀)``
    there."""
    from repro_torch.kernels import ops as kops
    dev = y0.device
    tidx = fx.csr_index(edges_new, transpose=True)
    size = cone.shape[0]
    raw = init.index_select(0, cone)
    deg = tidx.counts.index_select(0, cone)
    parts = [deg.sum()]
    if tidx.xsrc.shape[0]:
        loc = torch.full((y0.shape[0],), -1, dtype=torch.int64, device=dev)
        loc[cone] = torch.arange(size, device=dev)
        xloc = loc.index_select(0, tidx.xsrc)
        parts.append((xloc >= 0).sum())
    expanded, *hits = torch.stack(parts).tolist()
    hits = hits[0] if hits else 0
    if expanded + hits == 0:
        return raw
    rep = torch.repeat_interleave(torch.arange(size, device=dev), deg,
                                  output_size=expanded)
    base = tidx.starts.index_select(0, cone) - (torch.cumsum(deg, 0) - deg)
    esel = base.index_select(0, rep) + torch.arange(expanded, device=dev)
    vals = sr.mul(y0.index_select(0, tidx.dst.index_select(0, esel)),
                  tidx.w.index_select(0, esel))
    ids = rep
    if hits:
        hit = torch.nonzero_static(xloc >= 0, size=hits).squeeze(1)
        vals = torch.cat([vals, sr.mul(
            y0.index_select(0, tidx.xdst.index_select(0, hit)),
            tidx.xw.index_select(0, hit))])
        ids = torch.cat([ids, xloc.index_select(0, hit)])
    return sr.add(raw, kops.semiring_segment_reduce(
        sr, vals, ids.to(torch.int32).contiguous(), size))
