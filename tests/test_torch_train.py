"""One card's training step (ROADMAP A7a) against the JAX package: the
loss and every gradient leaf of all ten smoke configs, the xLSTM train
step over three steps (AdamW and Adafactor, accumulation 1 and 2, the
three remat modes), the prefill and serve steps, and ``train``.

The reference runs without its mesh, as ``tests/torch_lm_pairs.py``
drives it for serving; its weights are carried across.  Tolerances (f32,
the packages sum in other orders):

* loss and grad norm ``atol = rtol = 1e-4``;
* a gradient leaf ``atol = 1e-4 · max |g_ref|`` (``GRAD_TOL``),
  ``rtol = 1e-4``;
* a step's parameter update Δp within 1% of that step's lr.  Under
  AdamW an entry whose reference gradient is nonzero but below the
  gradient tolerance, at this step or an earlier one, is masked from
  then on: the gradient test pins such an entry down only to within
  its own size, so not its sign, and Adam's normalised step follows the
  sign (a full step either way; below 1e-4 of the leaf's largest, 1e-6
  and 1e-5 let through entries 5.6% and 1.7% of lr apart).  The masked
  entries are counted and bounded (``MASKED_SHARE``).  Adafactor
  divides by row and column statistics, which damps them: no entry is
  masked.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optimizer import optimizers as jopt
from repro.optimizer import schedules as jsched
from repro_torch.data import pipeline as pipe
from repro_torch.launch import steps, train as train_mod
from repro_torch.models import transformer as T
from repro_torch.optimizer import optimizers as opt
from repro_torch.optimizer import schedules as sched

from torch_lm_pairs import Model

TOL = dict(atol=1e-4, rtol=1e-4)
#: the train-step cases: xLSTM's smoke config, B = 4 sequences of 32
STEP_ARCH, STEP_BATCH, STEP_SEQ, STEPS = "xlstm-125m", 4, 32, 3
LR, WARMUP, TOTAL = 3e-3, 2, 10
#: a gradient leaf's tolerance, as a share of its largest entry
GRAD_TOL = 1e-4
#: most AdamW entries the train-step test may mask (measured 3.6–12.9%
#: over the three steps, nearly all in lm_head's rows for tokens the
#: random init's peaked softmax gives ~0 probability)
MASKED_SHARE = 0.15


def _batch(cfg, batch=2, seq=16, seed=0, step=0):
    """One batch of the reference training loop's data for ``cfg``'s
    family."""
    dcfg = train_mod.data_config(cfg, batch=batch, seq=seq, seed=seed)
    return next(pipe.synthetic_stream(dcfg, start_step=step))


def _on(tree, fn):
    return {k: _on(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _trainable(m: Model) -> dict:
    params = _on(m.params, lambda x: x.clone())
    for p in opt.tree_leaves(params):
        p.requires_grad_(True)
    return params


# -- the loss and its gradient ----------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_loss_and_every_grad_leaf_match_reference(arch):
    m = Model.build(arch)
    b = _batch(m.cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, (jce, jaux)), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, m.jcfg, jb), has_aux=True)(m.jparams)
    params = _trainable(m)
    loss, (ce, aux) = T.loss_fn(params, m.cfg,
                                {k: torch.from_numpy(v) for k, v in b.items()})
    for got, want in ((loss, jl), (ce, jce), (aux, jaux)):
        np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    if m.cfg.family == "moe":
        assert float(aux.detach()) > 0
    grads = torch.autograd.grad(loss, opt.tree_leaves(params),
                                allow_unused=True, materialize_grads=True)
    n = 0
    for (path, _), g in zip(opt.tree_paths(params), grads):
        want = np.asarray(opt.tree_at(jg, path))
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-4,
            atol=GRAD_TOL * max(float(np.abs(want).max()), 1e-30),
            err_msg=f"{arch} {'/'.join(path)}")
        n += 1
    assert n == len(jax.tree.leaves(jg))


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["xlstm-125m", "minicpm-2b"])
def test_remat_modes_recompute_what_they_should(arch):
    """The backward of ``"full"`` recomputes the layers' 2-D products
    (those up to the layer's last saved tensor: the recompute stops
    early); ``"selective"`` saved them, so its backward runs as many as
    without remat.  Values are the same in all three modes."""
    m = Model.build(arch)
    tb = {k: torch.from_numpy(v) for k, v in _batch(m.cfg).items()}
    params = _trainable(m)
    counts, grads = {}, {}
    for remat in T.REMAT:
        loss, _ = T.loss_fn(params, m.cfg, tb, remat=remat)
        with _CountMM() as mode:
            grads[remat] = torch.autograd.grad(loss, opt.tree_leaves(params))
        counts[remat] = mode.mm
    with _CountMM() as fwd:
        with torch.no_grad():
            T.loss_fn(params, m.cfg, tb)
    recomputed = counts["full"] - counts["none"]
    # at least the first product of each layer, at most all but the head
    assert m.cfg.n_layers <= recomputed <= fwd.mm - 1
    assert counts["selective"] == counts["none"]
    for remat in ("full", "selective"):
        for x, y in zip(grads[remat], grads["none"]):
            torch.testing.assert_close(x, y, atol=0, rtol=0)


def test_forward_refuses_an_unknown_remat():
    m = Model.build("xlstm-125m")
    with pytest.raises(ValueError, match="remat"):
        T.forward(m.params, m.cfg, torch.zeros((1, 4), dtype=torch.long),
                  remat="offload")


# -- the train step ----------------------------------------------------------


def _step_batches(cfg, n):
    dcfg = train_mod.data_config(cfg, batch=STEP_BATCH, seq=STEP_SEQ,
                                 seed=3)
    it = pipe.synthetic_stream(dcfg)
    return [next(it) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _reference_run(kind, accum, arch=STEP_ARCH):
    """The reference's jitted train step, 3 steps from the smoke init:
    each step's params, loss and grad norm, and the full-batch gradient
    at the params it starts from (for the mask)."""
    m = Model.build(arch)
    ocfg = jopt.OptConfig(kind=kind,
                          lr=jsched.cosine_schedule(LR, WARMUP, TOTAL))
    step_fn, init = jsteps.make_train_step(m.jcfg, ocfg, remat="none",
                                           accum_steps=accum)
    step_fn = jax.jit(step_fn)
    grad_fn = jax.jit(jax.grad(lambda p, b: JT.loss_fn(p, m.jcfg, b)[0]))
    params, state = m.jparams, init(m.jparams)
    out = [jax.tree.map(np.asarray, params)]
    losses, norms, grads = [], [], []
    for b in _step_batches(m.cfg, STEPS):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        grads.append(jax.tree.map(np.asarray, grad_fn(params, jb)))
        params, state, metrics = step_fn(params, state, jb)
        out.append(jax.tree.map(np.asarray, params))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return out, losses, norms, grads


@pytest.mark.parametrize("remat", ["none", "full", "selective"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_step_matches_reference_over_three_steps(kind, accum, remat):
    _check_three_steps(kind, accum, remat, STEP_ARCH)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "minicpm-2b"])
def test_attention_train_step_matches_reference_over_three_steps(arch,
                                                                 remat):
    """The same three steps for two attention families, whose attention
    trains through ``AttnFn`` (B5's gradient): Zamba2's shared block
    between its Mamba2 layers, MiniCPM's dense stack; AdamW, no
    accumulation."""
    _check_three_steps("adamw", 1, remat, arch)


def _check_three_steps(kind, accum, remat, arch):
    ref_params, ref_losses, ref_norms, ref_grads = _reference_run(
        kind, accum, arch)
    m = Model.build(arch)
    lr = sched.cosine_schedule(LR, WARMUP, TOTAL)
    step_fn, init = steps.make_train_step(
        m.cfg, opt.OptConfig(kind=kind, lr=lr), remat=remat,
        accum_steps=accum)
    params = _trainable(m)
    state = init(params)
    unknown = {}                     # AdamW: entries whose sign is unknown
    for i, b in enumerate(_step_batches(m.cfg, STEPS)):
        before = _on(params, lambda x: x.detach().clone())
        params, state, metrics = step_fn(
            params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(metrics["loss"]), ref_losses[i],
                                   **TOL)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   ref_norms[i], **TOL)
        for path, p in opt.tree_paths(params):
            d_got = (p.detach() - opt.tree_at(before, path)).numpy()
            d_want = (opt.tree_at(ref_params[i + 1], path)
                      - opt.tree_at(ref_params[i], path))
            g = np.abs(opt.tree_at(ref_grads[i], path))
            if kind == "adamw":
                unknown[path] = unknown.get(path, False) | (
                    (g > 0) & (g < GRAD_TOL * g.max()))
            keep = ~unknown.get(path, np.zeros(g.shape, bool))
            np.testing.assert_allclose(
                d_got[keep], d_want[keep], rtol=0, atol=0.01 * lr(i + 1),
                err_msg=f"step {i + 1} {'/'.join(path)}")
    assert state["step"] == STEPS
    if kind == "adamw":
        masked = sum(int(u.sum()) for u in unknown.values())
        total = sum(u.size for u in unknown.values())
        assert masked < MASKED_SHARE * total, (masked, total)


def test_train_step_last_micro_batch_loss():
    """With accumulation the reported loss is the last micro-batch's."""
    m = Model.build(STEP_ARCH)
    step_fn, init = steps.make_train_step(m.cfg, opt.OptConfig(),
                                          remat="none", accum_steps=2)
    params = _trainable(m)
    b = {k: torch.from_numpy(v)
         for k, v in _step_batches(m.cfg, 1)[0].items()}
    half = {k: v[STEP_BATCH // 2:] for k, v in b.items()}
    want, _ = T.loss_fn(params, m.cfg, half)
    _, _, metrics = step_fn(params, init(params), b)
    assert float(metrics["loss"]) == float(want.detach())
    with pytest.raises(ValueError, match="micro-batches"):
        steps.make_train_step(m.cfg, opt.OptConfig(), accum_steps=3)[0](
            params, init(params), b)


def test_prefill_and_serve_steps_match_reference():
    m = Model.build(STEP_ARCH)
    toks = np.random.default_rng(5).integers(0, m.cfg.vocab, (2, 9))
    jcache = JT.init_cache(m.jcfg, 2, 16, jnp.float32)
    jlast, jcache = jsteps.make_prefill_step(m.jcfg)(
        m.jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                    "cache": jcache})
    jtok, _ = jsteps.make_serve_step(m.jcfg)(
        m.jparams, {"tokens": jnp.argmax(jlast[:, -1], -1)[:, None]
                    .astype(jnp.int32), "cache": jcache})
    cache = T.init_cache(m.cfg, 2, 16, torch.float32, "cpu")
    last, cache = steps.make_prefill_step(m.cfg)(
        m.params, {"tokens": torch.from_numpy(toks), "cache": cache})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    tok, cache = steps.make_serve_step(m.cfg)(
        m.params, {"tokens": last[:, -1].argmax(-1)[:, None],
                   "cache": cache})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert cache["pos"] == 10


# -- the training loop -------------------------------------------------------


def test_train_on_the_cpu_lowers_the_loss(capsys):
    history = []
    params, losses = train_mod.train("xlstm-125m", steps=12, batch=4,
                                     seq=32, lr=3e-3, log_every=4,
                                     device="cpu", history=history)
    assert len(losses) == len(history) == 12
    assert all(np.isfinite([h["loss"] for h in history]))
    assert all(np.isfinite([h["grad_norm"] for h in history]))
    assert np.mean(losses[-3:]) < losses[0]
    assert [h["loss"] for h in history] == losses
    assert all(p.device.type == "cpu" and p.requires_grad
               for p in opt.tree_leaves(params))
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step    11 loss" in out


def test_train_defaults_to_the_gpu_and_refuses_what_is_not_ported(
        monkeypatch, tmp_path):
    """No GPU: the default device raises.  Model parallelism in one
    process raises the mesh's error (two ranks are needed); checkpoints
    and heartbeats (A7b) run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        train_mod.train("xlstm-125m", steps=1)
    with pytest.raises(ValueError, match="ranks"):
        train_mod.train("xlstm-125m", steps=1, device="cpu",
                        model_parallel=2)
    train_mod.train("xlstm-125m", steps=1, batch=2, seq=16, device="cpu",
                    ckpt_dir=str(tmp_path / "ckpt"),
                    heartbeat_dir=str(tmp_path / "hb"))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_1"]
    assert os.listdir(tmp_path / "hb") == ["host_0.json"]


def test_train_cli_on_the_cpu(capsys):
    train_mod.main(["--arch", "xlstm-125m", "--steps", "2", "--batch", "2",
                    "--seq", "16", "--device", "cpu", "--accum", "2",
                    "--remat", "full"])
    assert "final loss" in capsys.readouterr().out


def test_train_iterator_batches_feed_the_step():
    """The same seed gives the training loop's data: the first batch of
    ``train``'s iterator equals the reference stream's."""
    m = Model.build(STEP_ARCH)
    dcfg = train_mod.data_config(m.cfg, batch=2, seq=8, seed=0)
    got = next(pipe.make_train_iterator(dcfg, device="cpu"))
    want = next(jpipe.synthetic_stream(jpipe.DataConfig(seq_len=8,
                                                        global_batch=2,
                                                        vocab=m.cfg.vocab)))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
