"""Experts across ranks and Adafactor on split leaves (ROADMAP A7c-2,
1b) against the JAX package.

As in ``tests/test_torch_model_axis.py``, the reference cannot run under
a mesh on this JAX (ROADMAP C), and its GSPMD computes the unsharded
function: so the port's ranks are held against the reference run
without a mesh on the *global* batch, on the same weights (carried
across with ``params_from_reference`` and cut into each rank's blocks),
within ``atol = rtol = 1e-4``.  Three spawned gloo worlds, ``(data 1,
model 2)``, ``(data 2, model 1)`` and ``(data 2, model 2)``, each run:

* DeepSeekMoE's and Llama 4's smoke configs, each as published (its
  ``capacity_factor`` 8.0 drops nothing) and at ``DROP_CF``, where every
  MoE layer drops choices: the global loss, ``aux`` and every gradient
  leaf of the sharded step's gradient (``steps.make_sharded_grads``) on
  each rank's rows; the dropped masks and chosen experts of a forward
  over the rows, gathered over ``"data"``, equal to the reference's
  exactly (its routing read layer by layer from an eager forward);
  teacher-forced prefill and decode logits and ``serve_batch(mesh=)``
  tokens against the reference's greedy loop;
* two AdamW and two Adafactor steps of ``make_sharded_train_step`` for
  both MoE configs at ``DROP_CF`` and for xLSTM's smoke config, against
  the reference's ``make_train_step`` on the whole batch (losses, grad
  norms and parameter updates, masked as in ``tests/test_torch_train.
  py``);
* at ``(1, 2)``: a sharded checkpoint of DeepSeekMoE's blocks and their
  Adafactor state, restored whole here; and a whole one restored at two
  ranks;
* at ``(2, 1)``: two AdamW steps of both MoE configs at ``DROP_CF`` with
  ``accum_steps`` 2 and 4 on a batch of ``ACCUM_BATCH`` rows, against
  the reference's ``make_train_step(accum_steps=a)`` on the global batch
  (each rank's micro-batch i is its share of the reference's global
  micro-batch i, ``steps.micro_batches``).

The data is sensitive: at ``DROP_CF`` capacity reckoned on each rank's
own rows drops other choices than the global batch's (asserted), so a
port that reckoned it per rank fails the mask and loss checks.
"""

import dataclasses
import functools
import os
import threading
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.optimizer import optimizers as jopt
from repro.optimizer import schedules as jsched
from repro_torch import checkpoint as ck
from repro_torch import configs
from repro_torch.data import pipeline as pipe
from repro_torch.distributed import sharding as sh
from repro_torch.launch import serve, steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_host_mesh, spawn_world
from repro_torch.launch.rules import make_rules
from repro_torch.models import transformer as T
from repro_torch.optimizer import OptConfig
from repro_torch.optimizer import optimizers as opt

import torch_model_axis_worker as worker
from torch_lm_pairs import Model, port_cfg, prompts, smoke_jcfg

TOL = dict(atol=1e-4, rtol=1e-4)
#: a gradient leaf's tolerance, as a share of its largest entry
GRAD_TOL = 1e-4
DEEPSEEK, LLAMA4, XLSTM = ("deepseek-moe-16b", "llama4-maverick-400b-a17b",
                           "xlstm-125m")
#: a capacity factor at which every MoE layer drops choices, and the
#: per-rank capacity drops others
DROP_CF = 0.5
MODELS = {"deepseek": (DEEPSEEK, {}),
          "deepseek-drops": (DEEPSEEK, {"capacity_factor": DROP_CF}),
          "llama4": (LLAMA4, {}),
          "llama4-drops": (LLAMA4, {"capacity_factor": DROP_CF})}
#: the models trained two steps with each optimizer
STEP_MODELS = ("deepseek-drops", "llama4-drops", "xlstm")
OPTIMIZERS = ("adamw", "adafactor")
#: (name, ranks, model axis)
WORLDS = (("1x2", 2, 2), ("2x1", 2, 1), ("2x2", 4, 2))
BATCH, SEQ, STEPS = 4, 16, 2
LR, WARMUP, TOTAL = 3e-3, 2, 10
MASKED_SHARE = 0.15
LENGTHS, MAX_NEW, T_MAX = (5, 9), 3, 16
#: the accumulation cases: micro-batches, and the global batch's rows (a
#: multiple of the largest a times W = 2, so a micro-batch is one row a
#: rank at a = 4)
ACCUMS, ACCUM_BATCH, ACCUM_MODELS = (2, 4), 8, ("deepseek-drops",
                                                "llama4-drops")


def _batches(cfg, n=STEPS, seed=3, batch=BATCH):
    it = pipe.synthetic_stream(train_mod.data_config(cfg, batch=batch,
                                                     seq=SEQ, seed=seed))
    return [next(it) for _ in range(n)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _routing(router, x, jcfg, ranks=1):
    """The reference's routing lines (``repro/models/moe.py:67-80``) on
    ``x`` (B, S, D) as ``ranks`` data ranks would reckon them on their
    own rows: ``(keep (B, S, k), chosen (B, S, k))``; ``ranks=1`` is the
    reference itself."""
    m = jcfg.moe
    b, s, d = x.shape
    keep, idx = [], []
    for xr in np.split(x, ranks):
        xf = jnp.asarray(xr.reshape(-1, d))
        probs = jax.nn.softmax((xf @ router).astype(jnp.float32), -1)
        _, i = jax.lax.top_k(probs, m.top_k)
        cap = max(int(np.ceil(xf.shape[0] * m.top_k / m.n_experts
                              * m.capacity_factor)), 4)
        onehot = jax.nn.one_hot(i.reshape(-1), m.n_experts, dtype=jnp.int32)
        pos = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
        keep.append(np.asarray(pos < cap).reshape(-1, s, m.top_k))
        idx.append(np.asarray(i).reshape(-1, s, m.top_k))
    return np.concatenate(keep), np.concatenate(idx)


def _served(m):
    """Left-padded prompts and the port's unsharded greedy tokens on
    them: the teacher-forced ranks are fed these (the serving test holds
    them to the reference's)."""
    ps = prompts(m.cfg.vocab, LENGTHS)
    toks = np.zeros((len(ps), max(LENGTHS)), np.int64)
    for i, p in enumerate(ps):
        toks[i, toks.shape[1] - len(p):] = p
    return toks, m.serve(ps, MAX_NEW, T_MAX)[0]


class Reference:
    """One model's reference side without a mesh.  Its loss and gradient
    are jitted once, with the MoE layer spied on: each call records
    every MoE layer's router and input (``jax.debug.callback``), from
    which :func:`_routing` reads the reference's routing."""

    def __init__(self, m):
        self.m, self.seen = m, []
        real = jmoe.moe_apply

        def spy(p, x, cfg):
            jax.debug.callback(lambda r, x: self.seen.append(
                (np.asarray(r), np.asarray(x))), p["router"], x)
            return real(p, x, cfg)
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(p, m.jcfg, b), has_aux=True))

        def value_and_grad(p, b):
            with mock.patch.object(jmoe, "moe_apply", spy):
                return vg(p, {k: jnp.asarray(v) for k, v in b.items()})
        self.value_and_grad = value_and_grad

    def loss_and_routing(self):
        """Loss, aux and gradient of the global batch; each MoE layer's
        routing, and the kept choices two data ranks would get by
        reckoning capacity on their own rows; greedy serving's tokens
        and the logits after the prefill and each decode step."""
        self.seen.clear()
        (loss, (_, aux)), grads = self.value_and_grad(
            self.m.jparams, _batches(self.m.cfg, 1)[0])
        jcfg = self.m.jcfg
        routing = [(_routing(r, x, jcfg), _routing(r, x, jcfg, 2)[0])
                   for r, x in self.seen]
        _, out, logits = self.m.jax_greedy(prompts(self.m.cfg.vocab,
                                                   LENGTHS), MAX_NEW, T_MAX)
        return {"loss": float(loss), "aux": float(aux), "grads": _np(grads),
                "routing": routing, "out": out, "logits": logits}

    def steps(self, kind):
        """The reference's train step on the whole batch (``make_train_
        step``'s: the gradient of ``loss_fn``, then ``make_optimizer``'s
        update, jitted), ``STEPS`` steps with optimizer ``kind``: each
        step's params, loss and grad norm, and the gradient at the params
        it starts from (for the mask)."""
        ocfg = jopt.OptConfig(kind=kind,
                              lr=jsched.cosine_schedule(LR, WARMUP, TOTAL))
        init, update = jopt.make_optimizer(ocfg)
        update = jax.jit(update)
        params, state = self.m.jparams, init(self.m.jparams)
        out, losses, norms, grads = [_np(params)], [], [], []
        for b in _batches(self.m.cfg):
            (loss, _), g = self.value_and_grad(params, b)
            grads.append(_np(g))
            params, state, gnorm = update(params, g, state)
            out.append(_np(params))
            losses.append(float(loss))
            norms.append(float(gnorm))
        return out, losses, norms, grads

    def accum_steps(self, accum):
        """The reference's ``make_train_step(accum_steps=accum)`` (AdamW)
        on ``ACCUM_BATCH`` rows, ``STEPS`` steps: each step's params,
        loss (the last micro-batch's) and grad norm, and the mean of the
        micro-batches' gradients at the params it starts from (for the
        mask); and, over every step's micro-batches, whether some MoE
        layer dropped a choice."""
        ocfg = jopt.OptConfig(lr=jsched.cosine_schedule(LR, WARMUP, TOTAL))
        step, init = jsteps.make_train_step(self.m.jcfg, ocfg, remat="none",
                                            accum_steps=accum)
        step = jax.jit(step)
        params, state = self.m.jparams, init(self.m.jparams)
        out, losses, norms, grads = [_np(params)], [], [], []
        dropped = False
        for b in _batches(self.m.cfg, batch=ACCUM_BATCH):
            micro = [{k: np.split(v, accum)[i] for k, v in b.items()}
                     for i in range(accum)]
            self.seen.clear()
            gs = [self.value_and_grad(params, mb)[1] for mb in micro]
            dropped |= any(not keep.all() for keep, _ in (
                _routing(r, x, self.m.jcfg) for r, x in self.seen))
            grads.append(jax.tree.map(lambda *g: np.mean(np.stack(
                [np.asarray(x) for x in g]), 0), *gs))
            params, state, met = step(params, state,
                                      {k: jnp.asarray(v)
                                       for k, v in b.items()})
            out.append(_np(params))
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        return (out, losses, norms, grads), dropped


@pytest.fixture(scope="module")
def models():
    """The smoke models in both packages; a capacity factor changes no
    weight, so each arch is built once."""
    built = {arch: Model.build(arch) for arch in (DEEPSEEK, LLAMA4, XLSTM)}
    out = {"xlstm": built[XLSTM]}
    for name, (arch, changes) in MODELS.items():
        m = built[arch]
        if changes:
            jcfg = smoke_jcfg(arch, **changes)
            m = dataclasses.replace(m, jcfg=jcfg, cfg=port_cfg(jcfg))
        out[name] = m
    return out


def _adafactor_state(m, seed=12):
    """A full Adafactor state of ``m``'s shape, filled from a seed."""
    rng = np.random.default_rng(seed)
    state = opt.adafactor_init(m.params)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return rng.random(tuple(node.shape)).astype(np.float32)
    return {"f": fill(state["f"]), "step": 5}


@pytest.fixture(scope="module")
def run(models, tmp_path_factory):
    """The three spawned worlds (in a thread) and the reference's side:
    ``(ranks by world, refs, dirs, state)``."""
    tmp = tmp_path_factory.mktemp("moe")
    dirs = {"save": str(tmp / "save"), "whole": str(tmp / "whole")}
    ds = models["deepseek"]
    state = _adafactor_state(ds)
    ck.save_checkpoint(dirs["whole"], state["step"], {
        "params": ds.params,
        "opt": {"f": worker._torch_tree(state["f"]), "step": state["step"]}})
    # the worlds need the batches and prompts only: made here, not by the
    # reference
    cases = {}
    for name, m in models.items():
        tree = _np(m.jparams)
        if name in MODELS:
            b = _batches(m.cfg, 1)[0]
            ps = prompts(m.cfg.vocab, LENGTHS)
            cases[f"grad_{name}"] = ("moe_grad", (m.cfg, tree, b))
            cases[f"serve_{name}"] = ("serve", (m.cfg, tree, ps, MAX_NEW,
                                                T_MAX))
            toks, served = _served(m)
            cases[f"logits_{name}"] = ("logits", (m.cfg, tree, toks, served,
                                                  T_MAX))
        if name in STEP_MODELS:
            for kind in OPTIMIZERS:
                cases[f"steps_{name}_{kind}"] = (
                    "steps", (m.cfg, tree, _batches(m.cfg), LR, WARMUP,
                              TOTAL, kind))
    accum_cases = {}
    for name in ACCUM_MODELS:
        m = models[name]
        bs = _batches(m.cfg, batch=ACCUM_BATCH)
        for a in ACCUMS:
            accum_cases[f"accum{a}_{name}"] = ("steps", (
                m.cfg, _np(m.jparams), bs, LR, WARMUP, TOTAL, "adamw", a))
            accum_cases[f"accum_grad{a}_{name}"] = ("moe_grad", (
                m.cfg, _np(m.jparams), bs[0], a))
    out = {}

    def world(name, n, mp):
        extra = {}
        if name == "1x2":
            extra["ckpt"] = ("adafactor_ckpt", (
                ds.cfg, _np(ds.jparams), state, dirs["save"],
                dirs["whole"]))
        if name == "2x1":
            extra.update(accum_cases)
        os.makedirs(tmp / name)
        try:
            out[name] = spawn_world(
                worker.run_cases, n, {**cases, **extra}, device="cpu",
                mesh_fn=functools.partial(make_host_mesh, mp),
                workdir=str(tmp / name))
        except BaseException as e:          # raised in the test process
            out["error"] = e
    threads = [threading.Thread(target=world, args=w) for w in WORLDS]
    for th in threads:
        th.start()
    try:
        refs = {}
        for name, m in models.items():
            ref = Reference(m)
            if name in MODELS:
                refs[name] = ref.loss_and_routing()
            for kind in OPTIMIZERS if name in STEP_MODELS else ():
                refs[f"steps_{name}_{kind}"] = ref.steps(kind)
            for a in ACCUMS if name in ACCUM_MODELS else ():
                refs[f"accum{a}_{name}"] = ref.accum_steps(a)
    finally:
        for th in threads:
            th.join()
    if "error" in out:
        raise out["error"]
    return out, refs, dirs, state


def _ranks(run, world):
    return run[0][world]


# -- the MoE layer's gradient and routing ------------------------------------


@pytest.mark.parametrize("world", [w for w, _, _ in WORLDS])
@pytest.mark.parametrize("name", list(MODELS))
def test_moe_loss_aux_and_every_grad_leaf_match_the_unsharded_reference(
        run, name, world):
    want = run[1][name]
    for r in _ranks(run, world):
        got = r[f"grad_{name}"]
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
        np.testing.assert_allclose(got["aux"], want["aux"], **TOL)
        np.testing.assert_allclose(got["aux_forward"], want["aux"], **TOL)
        n = 0
        for path, g in opt.tree_paths(got["grads"]):
            w = np.asarray(opt.tree_at(want["grads"], path))
            np.testing.assert_allclose(
                g, w, rtol=1e-4,
                atol=GRAD_TOL * max(float(np.abs(w).max()), 1e-30),
                err_msg=f"{name} {world} {'/'.join(path)}")
            n += 1
        assert n == len(jax.tree.leaves(want["grads"]))


@pytest.mark.parametrize("world", [w for w, _, _ in WORLDS])
@pytest.mark.parametrize("name", list(MODELS))
def test_drop_masks_and_choices_equal_the_reference(run, name, world):
    """Every MoE layer's dropped choices and chosen experts over the
    global batch, gathered from the ranks' rows, are the reference's
    exactly; at ``DROP_CF`` each layer drops, and capacity reckoned on a
    rank's own rows would drop others (the data is sensitive)."""
    routing = run[1][name]["routing"]
    drops = "drops" in name
    for r in _ranks(run, world):
        got = r[f"grad_{name}"]
        assert len(got["dropped"]) == len(routing)
        for i, (d, c, ((keep, chosen), _)) in enumerate(zip(
                got["dropped"], got["chosen"], routing)):
            np.testing.assert_array_equal(d, ~keep, err_msg=f"layer {i}")
            np.testing.assert_array_equal(c, chosen, err_msg=f"layer {i}")
            assert bool(d.any()) == drops
    if drops:
        assert any((keep != per_rank).any()
                   for (keep, _), per_rank in routing)


# -- serving ------------------------------------------------------------------


@pytest.mark.parametrize("world", [w for w, _, _ in WORLDS])
@pytest.mark.parametrize("name", list(MODELS))
def test_moe_served_tokens_and_logits_match_the_reference(run, models,
                                                          name, world):
    """``serve_batch(mesh=)`` emits the reference's greedy tokens on
    every rank with its last logits; teacher-forced on those tokens, the
    ranks' prefill and decode logits are the reference's at each step."""
    want = run[1][name]
    np.testing.assert_array_equal(_served(models[name])[1], want["out"])
    for r in _ranks(run, world):
        toks, last = r[f"serve_{name}"]
        np.testing.assert_array_equal(toks, want["out"])
        np.testing.assert_allclose(last, want["logits"][-1], **TOL)
        got, _ = r[f"logits_{name}"]
        assert len(got) == MAX_NEW + 1
        for i, (g, w) in enumerate(zip(got, want["logits"])):
            np.testing.assert_allclose(g, w, **TOL, err_msg=f"step {i}")


# -- training -----------------------------------------------------------------


@pytest.mark.parametrize("world", [w for w, _, _ in WORLDS])
@pytest.mark.parametrize("kind", OPTIMIZERS)
@pytest.mark.parametrize("name", STEP_MODELS)
def test_sharded_steps_match_the_reference_step(run, name, kind, world):
    """Two steps of ``make_sharded_train_step`` (loss, grad norm and
    parameter update) against the reference's step on the whole batch.
    An entry whose reference gradient is nonzero but below ``GRAD_TOL``
    of its leaf's largest is masked from then on, as in
    ``tests/test_torch_train.py``."""
    _check_steps(_ranks(run, world), f"steps_{name}_{kind}",
                 run[1][f"steps_{name}_{kind}"], world)


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("name", ACCUM_MODELS)
def test_moe_micro_batches_across_the_data_axis_match_the_reference(
        run, name, accum):
    """At ``(2, 1)``, ``accum_steps`` micro-batches (each rank's share of
    the reference's global micro-batch) against the reference's
    ``make_train_step(accum_steps=…)`` on the global batch: the sharded
    gradient (the micro-batches' mean, every leaf within ``rtol`` 1e-4
    and ``GRAD_TOL`` of its largest entry) and the last micro-batch's
    loss; two AdamW steps' losses, grad norms and parameters within
    ``TOL``, an entry whose reference gradient is nonzero but below
    ``GRAD_TOL`` of its leaf's largest masked from then on (AdamW's
    first update of such an entry is ±lr on the sign of noise).  Some
    micro-batch drops a choice, so capacity is reckoned over the
    micro-batch the reference reckons it over.  Every rank ends with the
    same parameters."""
    (ref_params, ref_losses, ref_norms, ref_grads), dropped = \
        run[1][f"accum{accum}_{name}"]
    assert dropped
    ranks = _ranks(run, "2x1")
    for r in ranks:
        got = r[f"accum_grad{accum}_{name}"]
        np.testing.assert_allclose(got["loss"], ref_losses[0], **TOL)
        for path, g in opt.tree_paths(got["grads"]):
            w = np.asarray(opt.tree_at(ref_grads[0], path))
            np.testing.assert_allclose(
                g, w, rtol=1e-4,
                atol=GRAD_TOL * max(float(np.abs(w).max()), 1e-30),
                err_msg=f"{'/'.join(path)}")
        got = r[f"accum{accum}_{name}"]
        assert len(got) == STEPS
        unknown = {}
        for i, (loss, norm, params) in enumerate(got):
            np.testing.assert_allclose(loss, ref_losses[i], **TOL)
            np.testing.assert_allclose(norm, ref_norms[i], **TOL)
            for path, p in opt.tree_paths(params):
                g = np.abs(np.asarray(opt.tree_at(ref_grads[i], path)))
                unknown[path] = unknown.get(path, False) | (
                    (g > 0) & (g < GRAD_TOL * g.max()))
                keep = ~unknown[path]
                np.testing.assert_allclose(
                    p[keep],
                    np.asarray(opt.tree_at(ref_params[i + 1], path))[keep],
                    **TOL, err_msg=f"step {i + 1} {'/'.join(path)}")
    for a, b in zip(opt.tree_leaves(ranks[0][f"accum{accum}_{name}"][-1][2]),
                    opt.tree_leaves(ranks[1][f"accum{accum}_{name}"][-1][2])):
        np.testing.assert_array_equal(a, b)


def test_a_batch_that_does_not_split_over_micro_batches_and_ranks_raises():
    """A global batch of B rows over W data ranks needs B divisible by
    a·W; the error names the three numbers before any collective."""
    ds = configs.get(DEEPSEEK, smoke=True)
    mesh = _fake(2, 1)
    params = T.init_params(ds, 0, torch.float32, "cpu")
    specs = sh.tree_specs(T.param_specs(ds), params, mesh,
                          make_rules(mesh, "train"))
    step, init = steps.make_sharded_train_step(ds, OptConfig(), mesh, specs,
                                               accum_steps=4)
    batch = {"tokens": torch.zeros((6, SEQ), dtype=torch.long),
             "labels": torch.zeros((6, SEQ), dtype=torch.long)}
    with pytest.raises(ValueError, match=r"12 rows .* 4 micro-batches "
                                         r"over 2 data ranks"):
        step(params, None, batch)


def _check_steps(ranks, key, ref, world):
    """Each rank's steps ``key`` (loss, grad norm, parameters) against the
    reference's ``ref``; updates of entries whose reference gradient is
    nonzero but below ``GRAD_TOL`` of its leaf's largest are masked from
    then on.  Every rank ends with the same parameters."""
    ref_params, ref_losses, ref_norms, ref_grads = ref
    lr = jsched.cosine_schedule(LR, WARMUP, TOTAL)
    for r in ranks:
        got = r[key]
        unknown = {}
        before = ref_params[0]
        for i, (loss, norm, params) in enumerate(got):
            np.testing.assert_allclose(loss, ref_losses[i], **TOL)
            np.testing.assert_allclose(norm, ref_norms[i], **TOL)
            for path, p in opt.tree_paths(params):
                d_got = p - np.asarray(opt.tree_at(before, path))
                d_want = (np.asarray(opt.tree_at(ref_params[i + 1], path))
                          - np.asarray(opt.tree_at(ref_params[i], path)))
                g = np.abs(np.asarray(opt.tree_at(ref_grads[i], path)))
                unknown[path] = unknown.get(path, False) | (
                    (g > 0) & (g < GRAD_TOL * g.max()))
                keep = ~unknown[path]
                np.testing.assert_allclose(
                    d_got[keep], d_want[keep], rtol=0,
                    atol=0.01 * float(lr(i + 1)),
                    err_msg=f"{world} step {i + 1} {'/'.join(path)}")
            before = params
        masked = sum(int(u.sum()) for u in unknown.values())
        total = sum(u.size for u in unknown.values())
        assert masked < MASKED_SHARE * total, (masked, total)
    for a, b in zip(opt.tree_leaves(ranks[0][key][-1][2]),
                    opt.tree_leaves(ranks[-1][key][-1][2])):
        np.testing.assert_array_equal(a, b)


# -- checkpoints --------------------------------------------------------------


def test_adafactor_state_saved_at_two_ranks_restores_whole(run, models):
    """Each rank of ``(1, 2)`` wrote its blocks of DeepSeekMoE's weights
    and of the Adafactor state (``r`` and ``c`` cut as their leaf's
    spec without one dimension); read whole at M = 1, every leaf is the
    saved one."""
    _, _, dirs, state = run
    ds = models["deepseek"]
    like = {"params": opt.tree_like(ds.params, [
        torch.zeros_like(p) for p in opt.tree_leaves(ds.params)]),
        "opt": opt.adafactor_init(ds.params)}
    got = ck.load_checkpoint(dirs["save"], state["step"], like)
    assert got["opt"]["step"] == state["step"]
    for (path, p), g in zip(opt.tree_paths(ds.params),
                            opt.tree_leaves(got["params"])):
        assert torch.equal(g, p), path
    n = 0
    for path, want in opt.tree_paths(state["f"]):
        np.testing.assert_array_equal(
            opt.tree_at(got["opt"]["f"], path).numpy(), want,
            err_msg=str(path))
        n += 1
    assert n == len(opt.tree_leaves(like["opt"]["f"]))


def test_adafactor_state_saved_whole_restores_at_two_ranks(run):
    """A one-rank checkpoint with Adafactor state restored at M = 2 into
    fresh blocks gathers back to the saved state."""
    _, _, _, state = run
    for r in _ranks(run, "1x2"):
        step, got = r["ckpt"]
        assert step == state["step"]
        for path, want in opt.tree_paths(state["f"]):
            np.testing.assert_array_equal(opt.tree_at(got, path), want,
                                          err_msg=str(path))


# -- this process -------------------------------------------------------------


def _fake(d, m, rd=0, rm=0):
    """Rank ``(rd, rm)``'s layout of a ``(d, m)`` host mesh (no
    collective)."""
    return types.SimpleNamespace(
        axis_names=("data", "model"), shape={"data": d, "model": m},
        coords={"data": rd, "model": rm},
        groups={"data": None, "model": None})


@pytest.mark.parametrize("arch", configs.list_archs())
def test_block_build_is_the_cut_of_the_whole_tree(arch):
    """``T.init_param_blocks`` on ``(1, 2)``, ``(2, 2)`` and ``(4, 1)``
    (every rank of the first, the first and the last of the others),
    under the train and the serve rules, equals
    ``steps.param_blocks(T.init_params(...))`` bit for bit, key order
    and specs included."""
    cfg = configs.get(arch, smoke=True)
    full = T.init_params(cfg, 3, torch.float32, "cpu")
    for d, mp in ((1, 2), (2, 2), (4, 1)):
        for rd, rm in sorted({(0, 0), (d - 1, mp - 1)}):
            mesh = _fake(d, mp, rd, rm)
            for rules in (make_rules(mesh, "train"),
                          serve.serve_rules(cfg, mesh)):
                specs = sh.tree_specs(T.param_specs(cfg), full, mesh, rules)
                want = steps.param_blocks(full, specs, mesh)
                got, got_specs = T.init_param_blocks(cfg, mesh, rules, 3,
                                                     torch.float32, "cpu")
                assert [p for p, _ in opt.tree_paths(got)] == \
                    [p for p, _ in opt.tree_paths(want)]
                for (path, a), b in zip(opt.tree_paths(got),
                                        opt.tree_leaves(want)):
                    assert torch.equal(a, b), (d, mp, rd, rm, path)
                for a, b in zip(opt.tree_leaves(got_specs),
                                opt.tree_leaves(specs)):
                    assert a == b and a.fused == b.fused


def test_serve_and_train_build_only_the_blocks(monkeypatch):
    """With no ``params``, ``serve_batch(mesh=)`` and ``train`` on a
    mesh build the blocks alone: ``T.init_params`` is not called."""
    def refuse(*a, **k):
        raise AssertionError("the whole tree was built")
    mesh = make_host_mesh(1, device="cpu")
    monkeypatch.setattr(T, "init_params", refuse)
    reqs = [serve.Request(p, max_new=2) for p in prompts(512, LENGTHS)]
    serve.serve_batch(DEEPSEEK, reqs, t_max=T_MAX, device="cpu", mesh=mesh)
    assert all(len(r.out) == 2 for r in reqs)
    _, losses = train_mod.train(DEEPSEEK, steps=1, batch=2, seq=8,
                                device="cpu", mesh=mesh, log_every=100)
    assert len(losses) == 1 and np.isfinite(losses[0])


@pytest.mark.parametrize("kind", OPTIMIZERS)
def test_state_specs_follow_the_state(kind):
    """``steps.state_specs`` gives a spec for every leaf of an optimizer
    state over blocks, in the state's own order (a checkpoint pairs
    them leaf by leaf), each the shape of its block's leaf: AdamW's
    moments as their parameter, Adafactor's ``r`` and ``c`` as their
    parameter without one dimension."""
    cfg = configs.get(XLSTM, smoke=True)
    mesh = _fake(2, 2, 1, 1)
    rules = make_rules(mesh, "train")
    blocks, specs = T.init_param_blocks(cfg, mesh, rules, 0,
                                        torch.float32, "cpu")
    init, _ = opt.make_optimizer(OptConfig(kind=kind))
    state = init(blocks)
    sspecs = steps.state_specs(state, specs)
    assert [p for p, _ in opt.tree_paths(sspecs)] == \
        [p for p, _ in opt.tree_paths(state)]
    for (path, x), s in zip(opt.tree_paths(state), opt.tree_leaves(sspecs)):
        if isinstance(x, torch.Tensor):
            full = sh.global_shape(tuple(x.shape), s, mesh)
            assert sh.take_block(torch.zeros(full), s, mesh).shape == \
                x.shape, path


def test_what_the_moe_axis_refuses():
    """M must divide the routed experts and the shared experts' width
    (``ValueError`` naming them); MoE with ``accum_steps`` > 1 builds a
    step at one data rank and at two."""
    ds = configs.get(DEEPSEEK, smoke=True)
    three = dataclasses.replace(ds, n_heads=6, n_kv_heads=6, d_ff=384,
                                vocab=768)
    with pytest.raises(ValueError, match=r"routed experts \(8\)"):
        T.check_model_axis(three, 3)
    odd = dataclasses.replace(ds, moe=dataclasses.replace(
        ds.moe, n_shared=1, d_ff_expert=65))
    with pytest.raises(ValueError, match=r"shared experts' width \(65\)"):
        T.check_model_axis(odd, 2)
    for d, mp in ((2, 1), (1, 2)):
        mesh = _fake(d, mp)
        specs = sh.tree_specs(T.param_specs(ds),
                              T.init_params(ds, 0, torch.float32, "cpu"),
                              mesh, make_rules(mesh, "train"))
        step, _ = steps.make_sharded_train_step(ds, OptConfig(), mesh,
                                                specs, accum_steps=2)
        assert callable(step)
