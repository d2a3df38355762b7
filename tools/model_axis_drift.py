#!/usr/bin/env python3
"""Where the model axis's AdamW updates part from the reference's.

Llama-3's smoke config (8 query / 2 kv heads) takes three AdamW steps
with the batches, schedule and weights of
``tests/test_torch_kv_replication.py``: on spawned gloo worlds of the
port at ``(data 1, model M)`` for M = 1, 2 and 4, and in the reference's
jitted step on the whole batch, each in float32 and in float64 (the same
float32 weights widened; the reference under ``jax.enable_x64``, scoped
to its calls).  Both packages keep their optimizer moments, their RMS
norms and their logits in float32 whatever the parameters' dtype, so a
float64 run is float64 in every product and sum but rounds at those
casts as both packages do.

Prints, per world, dtype, step and leaf, the largest gap between the
port's and the reference's update ``|Δ_port − Δ_ref|`` in units of the
step's learning rate, over the entries the parity test holds (those
whose reference gradient is not below ``GRAD_TOL`` of the leaf's largest
at any step so far), and the count of entries past the test's old
bound, 0.01; the same for each float32 update against its own package's
float64 one; and, per step, the sum of the three worst gaps that bound
the float32 gap between the packages by the triangle inequality (the
port's float32 rounding, the float64 gap, the reference's float32
rounding).  The last line is JSON.  CPU only::

    PYTHONPATH=src python tools/model_axis_drift.py
"""

from __future__ import annotations

import functools
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from repro.launch import steps as jsteps                    # noqa: E402
from repro.models import transformer as JT                  # noqa: E402
from repro.optimizer import optimizers as jopt              # noqa: E402
from repro.optimizer import schedules as jsched             # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, spawn_world  # noqa: E402
from repro_torch.optimizer import optimizers as opt         # noqa: E402

import test_torch_model_axis as ma                          # noqa: E402
import torch_model_axis_worker as worker                    # noqa: E402
from torch_lm_pairs import Model                            # noqa: E402

ARCH = "llama3-405b"
WORLDS = (1, 2, 4)


def _wide(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def reference_steps(m, wide: bool):
    """The reference's 3 jitted AdamW steps on the whole batch: each
    step's parameters (numpy), and the float32 gradients at the
    parameters each step starts from (for the mask)."""
    ocfg = jopt.OptConfig(lr=jsched.cosine_schedule(ma.LR, ma.WARMUP,
                                                    ma.TOTAL))
    with jax.enable_x64(wide):
        step_fn, init = jsteps.make_train_step(m.jcfg, ocfg, remat="none")
        step_fn = jax.jit(step_fn)
        grad_fn = jax.jit(jax.grad(lambda p, b: JT.loss_fn(p, m.jcfg, b)[0]))
        params = jax.tree.map(jnp.asarray, _wide(m.jparams) if wide
                              else m.jparams)
        state = init(params)
        out, grads = [ma._np(params)], []
        for b in ma._step_batches(m.cfg):
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            grads.append(ma._np(grad_fn(params, jb)))
            params, state, _ = step_fn(params, state, jb)
            out.append(ma._np(params))
    return out, grads


def port_steps(m, workdir):
    """``{(M, dtype): [params after each step]}`` from spawned worlds."""
    tree = ma._np(m.jparams)
    batches = ma._step_batches(m.cfg)
    out = {}
    for w in WORLDS:
        cases = {dt: ("steps", (ARCH, t, batches, ma.LR, ma.WARMUP,
                                ma.TOTAL))
                 for dt, t in (("float32", tree), ("float64", _wide(tree)))}
        ranks = spawn_world(worker.run_cases, w, cases, device="cpu",
                            mesh_fn=functools.partial(make_host_mesh, w),
                            workdir=workdir)
        for dt in cases:
            out[(w, dt)] = [p for _, _, p in ranks[0][dt]]
    return out


def gaps(got: list, start: dict, want: list, masks: list, lr) -> list:
    """Per step: ``{leaf: (max |Δgot − Δwant| / lr, entries past 0.01)}``
    over the masked entries."""
    rows, before = [], start
    for i, params in enumerate(got):
        row = {}
        for path, p in opt.tree_paths(params):
            d_got = np.asarray(p, np.float64) - np.asarray(
                opt.tree_at(before, path), np.float64)
            d_want = (np.asarray(opt.tree_at(want[i + 1], path), np.float64)
                      - np.asarray(opt.tree_at(want[i], path), np.float64))
            keep = ~masks[i][path]
            err = np.abs(d_got - d_want)[keep] / float(lr(i + 1))
            row["/".join(path)] = (float(err.max()), int((err > 0.01).sum()))
        rows.append(row)
        before = params
    return rows


def masks_of(grads: list) -> list:
    """The parity test's cumulative mask of each step: entries whose
    reference gradient was ever below ``GRAD_TOL`` of its leaf's largest
    (and not 0)."""
    out, unknown = [], {}
    for g_tree in grads:
        for path, g in opt.tree_paths(g_tree):
            g = np.abs(np.asarray(g))
            unknown[path] = unknown.get(path, False) | (
                (g > 0) & (g < ma.GRAD_TOL * g.max()))
        out.append(dict(unknown))
    return out


def main():
    m = Model.build(ARCH)
    lr = jsched.cosine_schedule(ma.LR, ma.WARMUP, ma.TOTAL)
    refs = {dt: reference_steps(m, dt == "float64")
            for dt in ("float32", "float64")}
    masks = masks_of(refs["float32"][1])
    with tempfile.TemporaryDirectory() as tmp:
        ports = port_steps(m, tmp)
    summary = {}
    for (w, dt), got in ports.items():
        want = refs[dt][0]
        for tag, base in (("ref", want), ("port_f64", None)):
            if tag == "port_f64":
                if dt == "float64":
                    continue
                f64 = ports[(w, "float64")]
                base = [want[0]] + f64     # the port's own float64 run
            rows = gaps(got, want[0], base, masks, lr)
            for i, row in enumerate(rows):
                worst = max(row.items(), key=lambda kv: kv[1][0])
                past = sum(n for _, n in row.values())
                key = f"M={w} {dt} vs {tag} step {i + 1}"
                summary[key] = {"max_over_lr": worst[1][0],
                                "worst_leaf": worst[0],
                                "ffn_wi_max_over_lr":
                                    row["stack/ffn/wi"][0],
                                "entries_past_0.01": past}
                print(f"{key}: max {worst[1][0]:.3e} lr ({worst[0]}), "
                      f"ffn/wi {row['stack/ffn/wi'][0]:.3e} lr, "
                      f"{past} entries past 0.01 lr", flush=True)
    ref_rows = gaps(refs["float32"][0][1:], refs["float32"][0][0],
                    refs["float64"][0], masks, lr)
    for i, row in enumerate(ref_rows):
        worst = max(row.items(), key=lambda kv: kv[1][0])
        key = f"reference float32 vs its float64 step {i + 1}"
        summary[key] = {"max_over_lr": worst[1][0], "worst_leaf": worst[0],
                        "ffn_wi_max_over_lr": row["stack/ffn/wi"][0],
                        "entries_past_0.01": sum(n for _, n in row.values())}
        print(f"{key}: max {worst[1][0]:.3e} lr ({worst[0]})", flush=True)
    # |Δport32 − Δref32| ≤ |Δport32 − Δport64| + |Δport64 − Δref64|
    #                       + |Δref64 − Δref32|, each side's worst
    bound = {}
    for i in range(len(ref_rows)):
        step = i + 1
        parts = (max(summary[f"M={w} float32 vs port_f64 step {step}"]
                     ["max_over_lr"] for w in WORLDS),
                 max(summary[f"M={w} float64 vs ref step {step}"]
                     ["max_over_lr"] for w in WORLDS),
                 summary[f"reference float32 vs its float64 step {step}"]
                 ["max_over_lr"])
        bound[f"step {step}"] = {"port_f32_rounding": parts[0],
                                 "f64_gap": parts[1],
                                 "reference_f32_rounding": parts[2],
                                 "sum_over_lr": sum(parts)}
        print(f"step {step}: rounding bound {sum(parts):.3e} lr = port "
              f"{parts[0]:.3e} + f64 gap {parts[1]:.3e} + reference "
              f"{parts[2]:.3e}", flush=True)
    summary["bound"] = bound
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
