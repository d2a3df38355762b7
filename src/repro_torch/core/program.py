"""Datalog° programs: rules, strata, ICOs, and end-to-end execution.

The counterpart of ``repro/core/program.py``.  A :class:`Program` is a
list of strata run in order, each holding one merged rule per IDB plus
an optional non-0̄ initial state, then an output chain G.  Which
physical runner executes each stratum is decided by the cost-based
planner (:mod:`repro_torch.core.planner`); :func:`run_program` is a thin
plan-then-execute shell.  ``backend="np"`` on the ICO helpers evaluates
with the engine's numpy backend, as the synthesizer does.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core import engine, fixpoint, ir
from repro_torch.core import semiring as sr_mod


@dataclasses.dataclass(frozen=True)
class Rule:
    head: str
    body: ir.SSP  # body.head are the rule's head variables

    def __post_init__(self):
        if not isinstance(self.body, ir.SSP):
            raise TypeError(f"rule body must be an SSP, got {self.body!r}")


@dataclasses.dataclass
class Stratum:
    """One fixpoint block: mutually recursive IDBs and their merged rules."""

    rules: dict[str, Rule]
    init: dict[str, ir.SSP] | None = None  # optional Y₀ expressions

    @property
    def idbs(self) -> tuple[str, ...]:
        return tuple(self.rules)

    def is_linear(self) -> bool:
        for r in self.rules.values():
            for t in r.body.terms:
                n = sum(1 for a in t.atoms
                        if isinstance(a, ir.RelAtom) and a.name in self.rules)
                if n > 1:
                    return False
        return True


@dataclasses.dataclass
class Program:
    """``strata`` run in order; then the ``outputs`` chain G; ``post`` is
    an optional host-side epilogue ``(answer, db) → answer``."""

    name: str
    schema: ir.Schema
    strata: list[Stratum]
    outputs: list[Rule]
    post: object | None = None
    sort_hints: dict[str, str] = dataclasses.field(default_factory=dict)

    def idb_semiring(self, name: str) -> sr_mod.Semiring:
        return sr_mod.get(self.schema[name].semiring)

    @property
    def answer(self) -> str:
        return self.outputs[-1].head


# --------------------------------------------------------------------------
# ICO construction
# --------------------------------------------------------------------------


def zero_state(stratum: Stratum, db: engine.Database,
               backend: str = "torch") -> fixpoint.State:
    """0̄ for every IDB of the stratum: tensors on the database's device,
    or numpy arrays for ``backend="np"`` (the engine's np backend)."""
    out = {}
    for name in stratum.idbs:
        rs = db.schema[name]
        shape = tuple(db.dom(s) for s in rs.sorts)
        if backend == "np":
            srn = sr_mod.get(rs.semiring, lib="np")
            out[name] = np.full(shape, srn.zero, srn.dtype)
        else:
            out[name] = sr_mod.get(rs.semiring).zeros(shape, db.device)
    return out


def init_state(stratum: Stratum, db: engine.Database,
               hints: Mapping[str, str],
               backend: str = "torch") -> fixpoint.State:
    state = zero_state(stratum, db, backend)
    if stratum.init:
        for name, expr in stratum.init.items():
            state[name] = engine.eval_ssp(expr, db, hints, backend=backend)
    return state


def make_ico(stratum: Stratum, db: engine.Database,
             hints: Mapping[str, str], backend: str = "torch"):
    def ico(state: fixpoint.State) -> fixpoint.State:
        cur = db.with_relations(state)
        return {name: engine.eval_ssp(rule.body, cur, hints,
                                      backend=backend)
                for name, rule in stratum.rules.items()}
    return ico


def make_delta_ico(stratum: Stratum, db: engine.Database,
                   hints: Mapping[str, str]):
    """δF for linear strata: keep only terms containing an IDB atom and
    evaluate them against the Δ state."""
    if not stratum.is_linear():
        raise ValueError("GSN differential needs a linear program")
    delta_rules = {}
    for name, rule in stratum.rules.items():
        lin_terms = tuple(
            t for t in rule.body.terms
            if any(isinstance(a, ir.RelAtom) and a.name in stratum.rules
                   for a in t.atoms))
        delta_rules[name] = Rule(name, ir.SSP(rule.body.head, lin_terms,
                                              rule.body.semiring))

    def dico(delta: fixpoint.State) -> fixpoint.State:
        cur = db.with_relations(delta)
        out = {}
        for name, rule in delta_rules.items():
            if rule.body.terms:
                out[name] = engine.eval_ssp(rule.body, cur, hints)
            else:
                sr = sr_mod.get(db.schema[name].semiring)
                shape = tuple(db.dom(s) for s in db.schema[name].sorts)
                out[name] = sr.zeros(shape, db.device)
        return out

    return dico


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RunStats:
    iterations: list[int]
    mode: str
    plan: object | None = None  # the ExecutionPlan that was executed


def run_program(prog: Program, db: engine.Database, *, mode: str = "auto",
                max_iters: int = 10_000,
                plan=None) -> tuple[torch.Tensor, RunStats]:
    """Run all strata to fixpoint, then evaluate the output rule G.

    ``mode="auto"`` lets :func:`repro_torch.core.planner.plan_program`
    pick a physical runner and per-relation storage per stratum;
    "naive"/"seminaive"/"host" (or a runner name) force one.  Pass a pre-built
    ``plan`` to skip planning.
    """
    from repro_torch.core import planner
    if plan is None:
        plan = planner.plan_for(prog, db, mode=mode, max_iters=max_iters)
    return planner.execute_plan(plan, prog, db, max_iters=max_iters)


def declare_idbs(prog: Program) -> None:
    """Sanity: every IDB referenced by rules must be in the schema."""
    for stratum in prog.strata:
        for name in stratum.idbs:
            if name not in prog.schema:
                raise ValueError(f"IDB {name} missing from schema")
