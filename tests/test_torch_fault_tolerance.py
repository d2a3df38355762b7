"""The port's copy of the fleet's fault tolerance
(``repro_torch/distributed/fault_tolerance.py``) against the reference's
(``repro/distributed/fault_tolerance.py``): both packages' heartbeat
writers, both coordinators on the same heartbeat files, and a sweep of
``plan_remesh``.  Pure host code: the answers must be equal."""

import ast
import dataclasses
import json
import os
import time

import pytest

from repro.distributed import fault_tolerance as jft
from repro_torch.distributed import fault_tolerance as ft

PACKAGES = {"reference": jft, "port": ft}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_heartbeat_payload(tmp_path, pkg):
    """Each package's writer leaves ``host_{h}.json`` with the step, a
    time and the last ``window`` step durations."""
    mod = PACKAGES[pkg]
    w = mod.HeartbeatWriter(mod.FTConfig(str(tmp_path), window=3), 2)
    for step in range(5):
        w.beat(step)
    with open(tmp_path / "host_2.json") as f:
        hb = json.load(f)
    assert set(hb) == {"step", "time", "durations"}
    assert hb["step"] == 4 and len(hb["durations"]) == 3
    assert abs(hb["time"] - time.time()) < 60
    assert os.listdir(tmp_path) == ["host_2.json"]     # no .tmp left


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_heartbeat_coordinator_detects_death(tmp_path, pkg):
    mod = PACKAGES[pkg]
    cfg = mod.FTConfig(str(tmp_path), dead_after=0.5)
    mod.HeartbeatWriter(cfg, 0).beat(1)
    co = mod.Coordinator(cfg, n_hosts=2)  # host 1 never beats
    stats = co.poll()
    assert stats[0].alive and not stats[1].alive
    decision = co.decide(stats)
    assert decision["action"] == "restart_from_checkpoint"
    assert decision["lost"] == [1]
    assert decision["remesh"]["chips_used"] > 0


#: heartbeat files: host → (age in s, step, durations), or None (no file)
#: or "garbled" (a half-written file)
FLEETS = {
    "healthy": {0: (1, 9, [1.0] * 5), 1: (2, 9, [1.1] * 5),
                2: (0, 9, [0.9] * 5)},
    "straggler": {0: (1, 3, [1.0] * 5), 1: (1, 3, [1.0] * 5),
                  2: (1, 3, [5.0] * 5)},
    "dead_and_straggler": {0: (1, 3, [1.0] * 5), 1: (500, 2, [1.0] * 5),
                           2: (1, 3, [1.0, 9.0, 9.0]), 3: (1, 3, [1.0] * 5)},
    "missing": {0: (1, 7, [2.0, 1.0]), 1: None, 2: (3, 7, [3.0])},
    "garbled": {0: (1, 7, [1.0]), 1: "garbled"},
    "all_dead": {0: (900, 1, [1.0]), 1: None},
}


def _write_fleet(path, fleet, now):
    for h, spec in fleet.items():
        if spec is None:
            continue
        with open(os.path.join(path, f"host_{h}.json"), "w") as f:
            if spec == "garbled":
                f.write('{"step": 3, "ti')
                continue
            age, step, dur = spec
            json.dump({"step": step, "time": now - age, "durations": dur}, f)


@pytest.mark.parametrize("fleet", list(FLEETS))
def test_coordinators_agree_on_the_same_files(tmp_path, fleet):
    """Equal statuses and decisions.  With every host dead both
    packages' ``decide`` raises ``ZeroDivisionError`` (``plan_remesh(0)``
    divides by a model axis of 0 chips), the reference's fault kept in
    the copy."""
    now = 1.7e9
    _write_fleet(str(tmp_path), FLEETS[fleet], now)
    n = len(FLEETS[fleet])
    out = {}
    for pkg, mod in PACKAGES.items():
        co = mod.Coordinator(mod.FTConfig(str(tmp_path), dead_after=60.0,
                                          straggler_factor=1.5), n)
        stats = co.poll(now)
        try:
            decision = co.decide(stats)
        except ZeroDivisionError:
            decision = ZeroDivisionError
        out[pkg] = ([dataclasses.astuple(s) for s in stats], decision)
    assert out["port"] == out["reference"]
    assert (out["port"][1] is ZeroDivisionError) == (fleet == "all_dead")
    if fleet == "straggler":
        assert out["port"][1] == {"action": "restart_hosts", "hosts": [2]}


@pytest.mark.parametrize("chips_per_host", [1, 4, 8])
@pytest.mark.parametrize("model_parallel", [1, 2, 8, 16, 64])
def test_plan_remesh_sweep(chips_per_host, model_parallel):
    for hosts in range(1, 130):
        kw = dict(chips_per_host=chips_per_host,
                  model_parallel=model_parallel)
        got = ft.plan_remesh(hosts, **kw)
        assert got == jft.plan_remesh(hosts, **kw), hosts
        assert 0 < got["chips_used"] <= hosts * chips_per_host


def test_plan_remesh_elastic():
    full = ft.plan_remesh(128, chips_per_host=4, model_parallel=16)
    assert full == {"data": 32, "model": 16, "chips_used": 512}
    degraded = ft.plan_remesh(127, chips_per_host=4, model_parallel=16)
    assert degraded == {"data": 16, "model": 16, "chips_used": 256}
    for mod in (ft, jft):               # no survivor: no mesh
        with pytest.raises(ZeroDivisionError):
            mod.plan_remesh(0)


def test_the_port_imports_nothing_of_the_reference():
    tree = ast.parse(open(ft.__file__).read())
    roots = {(n.module or "").split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    roots |= {a.name.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.Import) for a in n.names}
    assert not roots & {"repro", "jax"}
