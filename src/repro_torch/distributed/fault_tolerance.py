"""Fleet orchestration: heartbeats, straggler detection, restart policy
(the port's own copy of ``repro/distributed/fault_tolerance.py``, which
imports no JAX; kept apart so that the port imports nothing of the
reference).

A coordinator supervises one worker process per host:

* **Heartbeats** — a worker writes a per-host heartbeat file every step
  (``train(heartbeat_dir=...)``); the coordinator marks a host dead
  after ``dead_after`` seconds of silence and decides a restart of the
  fleet from the latest checkpoint (the data pipeline's deterministic
  addressing makes this exactly-once: ``train`` resumes its iterator at
  the restored step).
* **Straggler mitigation** — per-step durations ride in the heartbeat
  payload; a host whose p50 over the last window exceeds
  ``straggler_factor`` × the fleet's median is flagged for a restart.
* **Elasticity** — :func:`plan_remesh` picks the largest (data, model)
  mesh the surviving hosts support.  ``train`` restores a sharded
  checkpoint onto a ``(data, model)`` mesh of any shape (each rank reads
  its blocks of the parameters and of the optimizer's state, AdamW's or
  Adafactor's, for every family).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time


@dataclasses.dataclass
class FTConfig:
    heartbeat_dir: str
    dead_after: float = 60.0
    straggler_factor: float = 1.5
    window: int = 20


class HeartbeatWriter:
    """Worker side: called once per step."""

    def __init__(self, cfg: FTConfig, host: int):
        self.path = os.path.join(cfg.heartbeat_dir, f"host_{host}.json")
        os.makedirs(cfg.heartbeat_dir, exist_ok=True)
        self._durations: list[float] = []
        self._last = time.time()
        self.window = cfg.window

    def beat(self, step: int):
        now = time.time()
        self._durations.append(now - self._last)
        self._last = now
        self._durations = self._durations[-self.window:]
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": now,
                       "durations": self._durations}, f)
        os.replace(tmp, self.path)


@dataclasses.dataclass
class HostStatus:
    host: int
    alive: bool
    step: int
    p50_step_s: float
    straggler: bool


class Coordinator:
    """Coordinator side: poll heartbeats, decide restarts/remesh."""

    def __init__(self, cfg: FTConfig, n_hosts: int):
        self.cfg = cfg
        self.n_hosts = n_hosts

    def poll(self, now: float | None = None) -> list[HostStatus]:
        now = now or time.time()
        stats = []
        for h in range(self.n_hosts):
            path = os.path.join(self.cfg.heartbeat_dir, f"host_{h}.json")
            try:
                with open(path) as f:
                    hb = json.load(f)
                alive = (now - hb["time"]) < self.cfg.dead_after
                dur = sorted(hb.get("durations", [0.0]))
                p50 = dur[len(dur) // 2]
                stats.append(HostStatus(h, alive, hb.get("step", -1), p50,
                                        False))
            except (FileNotFoundError, json.JSONDecodeError):
                stats.append(HostStatus(h, False, -1, float("inf"), False))
        med = sorted(s.p50_step_s for s in stats if s.alive)
        fleet_p50 = med[len(med) // 2] if med else 0.0
        for s in stats:
            if s.alive and fleet_p50 > 0 and \
                    s.p50_step_s > self.cfg.straggler_factor * fleet_p50:
                s.straggler = True
        return stats

    def decide(self, stats: list[HostStatus]) -> dict:
        dead = [s.host for s in stats if not s.alive]
        stragglers = [s.host for s in stats if s.straggler]
        if dead:
            return {"action": "restart_from_checkpoint", "lost": dead,
                    "remesh": plan_remesh(self.n_hosts - len(dead))}
        if stragglers:
            return {"action": "restart_hosts", "hosts": stragglers}
        return {"action": "none"}


def plan_remesh(usable_hosts: int, chips_per_host: int = 4,
                model_parallel: int = 16) -> dict:
    """Largest (data, model) mesh on the surviving chips (elastic)."""
    chips = usable_hosts * chips_per_host
    model = min(model_parallel, chips)
    data = max(1, chips // model)
    # keep powers of two on the data axis for even batch sharding
    p = 1
    while p * 2 <= data:
        p *= 2
    return {"data": p, "model": model, "chips_used": p * model}
