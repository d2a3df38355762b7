"""Tensor parallelism over the ``"model"`` axis (ROADMAP A7c-2, 1a)
against the JAX package.

The reference cannot be the oracle under a mesh: its ``loss_fn`` under
``use_rules(make_host_mesh(2), …)`` raises on this JAX (``with_sharding_
constraint`` takes only Auto axes, ROADMAP C), and its GSPMD computes
the unsharded function anyway.  So the port's ranks are held against
the reference run without a mesh, on the same weights (carried across
with ``params_from_reference`` and cut into each rank's blocks by
``steps.param_blocks``), within ``atol = rtol = 1e-4``:

* a spawned world of two gloo ranks, mesh ``(data 1, model 2)``, for
  the seven smoke configs without experts (xLSTM, Zamba2, Llama-3's
  8/2-head GQA, StarCoder2's window and ungated MLP, MiniCPM's tied
  embeddings, Whisper's cross-attention, LLaVA-NeXT's patch embeddings):
  the loss and every gradient leaf, gathered (``remat="full"``, so the
  checkpointed layers replay their collectives); prefill logits and 4
  teacher-forced decode steps; ``serve_batch(mesh=)`` tokens equal to
  one rank's; each rank's block sizes, the fused ``w_in`` block and the
  cache's block shapes; a sharded checkpoint saved at M = 2 and one
  saved whole restored at M = 2 in place; the model-axis operators and
  the global argmax;
* a world of four ranks, ``(data 2, model 2)``: three AdamW steps of
  xLSTM and Zamba2 against the reference's ``make_train_step`` on the
  whole batch (losses, grad norms, each step's parameter update, masked
  as ``tests/test_torch_train.py`` masks it);
* in this process: a one-rank model axis bit for bit with the unsharded
  run, the fused block layout, and the refusals.

The two worlds run in a thread while this process computes the
reference's side.
"""

import functools
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optimizer import optimizers as jopt
from repro.optimizer import schedules as jsched
from repro_torch import checkpoint as ck
from repro_torch import configs
from repro_torch.data import pipeline as pipe
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch import serve, steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_host_mesh, spawn_world
from repro_torch.launch.rules import make_rules
from repro_torch.models import transformer as T
from repro_torch.optimizer import OptConfig
from repro_torch.optimizer import optimizers as opt

import torch_model_axis_worker as worker
from torch_lm_pairs import Model, prompts

TOL = dict(atol=1e-4, rtol=1e-4)
#: a gradient leaf's tolerance, as a share of its largest entry
#: (``tests/test_torch_train.py``'s)
GRAD_TOL = 1e-4
ARCHS = ("xlstm-125m", "zamba2-2.7b", "llama3-405b", "starcoder2-7b",
         "minicpm-2b", "whisper-base", "llava-next-mistral-7b")
#: the four-rank world's runs: archs, global batch, seq, steps, schedule
STEP_ARCHS = ("xlstm-125m", "zamba2-2.7b")
STEP_BATCH, STEP_SEQ, STEPS = 4, 16, 3
LR, WARMUP, TOTAL = 3e-3, 2, 10
#: most AdamW entries a four-rank run may mask (tests/test_torch_train.py)
MASKED_SHARE = 0.15
#: serving and teacher forcing: prompt lengths, new tokens, cache slots
LENGTHS, MAX_NEW, T_MAX = (5, 9), 4, 16
MODEL2 = functools.partial(make_host_mesh, 2)


def _batch(cfg, batch=2, seq=16, seed=0, step=0):
    dcfg = train_mod.data_config(cfg, batch=batch, seq=seq, seed=seed)
    return next(pipe.synthetic_stream(dcfg, start_step=step))


def _step_batches(cfg):
    it = pipe.synthetic_stream(train_mod.data_config(
        cfg, batch=STEP_BATCH, seq=STEP_SEQ, seed=3))
    return [next(it) for _ in range(STEPS)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _teacher_tokens(m):
    """Left-padded prompts and the tokens the decode steps are fed."""
    ps = prompts(m.cfg.vocab, LENGTHS)
    toks = np.zeros((len(ps), max(LENGTHS)), np.int64)
    for i, p in enumerate(ps):
        toks[i, toks.shape[1] - len(p):] = p
    fed = np.random.default_rng(11).integers(0, m.cfg.vocab,
                                             (len(ps), MAX_NEW))
    return ps, toks, fed


def _save_whole(m, path):
    """A one-rank checkpoint of ``m``'s weights, moments filled with
    twice the weights, at step 1."""
    params = {k: v for k, v in m.params.items()}
    twice = opt.tree_like(params, [2 * p for p in opt.tree_leaves(params)])
    ck.save_checkpoint(path, 1, {"params": params,
                                 "opt": {"m": twice, "v": twice,
                                         "step": 1}})


@pytest.fixture(scope="module")
def models():
    return {a: Model.build(a) for a in ARCHS}


@pytest.fixture(scope="module")
def run(models, tmp_path_factory):
    """The two spawned worlds (in a thread) and the reference's side:
    ``(ranks2, ranks4, refs, dirs)``."""
    tmp = tmp_path_factory.mktemp("tp")
    dirs = {"save": str(tmp / "save"), "whole": str(tmp / "whole")}
    xl = models["xlstm-125m"]
    _save_whole(xl, dirs["whole"])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5)).astype(np.float32)
    ties = rng.standard_normal((3, 8)).astype(np.float32)
    ties[0, [1, 6]] = ties[1, [2, 3]] = ties[2, [5, 7]] = 9.0
    cases2 = {"collectives": ("collectives", (x, ties)),
              "ckpt": ("ckpt", ("xlstm-125m", _np(xl.jparams),
                                dirs["save"], dirs["whole"]))}
    for a, m in models.items():
        tree = _np(m.jparams)
        ps, toks, fed = _teacher_tokens(m)
        cases2[f"grad_{a}"] = ("grad", (a, tree, _batch(m.cfg)))
        cases2[f"logits_{a}"] = ("logits", (a, tree, toks, fed, T_MAX))
        cases2[f"serve_{a}"] = ("serve", (a, tree, ps, MAX_NEW, T_MAX))
    cases4 = {a: ("steps", (a, _np(models[a].jparams),
                            _step_batches(models[a].cfg), LR, WARMUP, TOTAL))
              for a in STEP_ARCHS}
    out = {}

    def worlds():
        try:
            out[2] = spawn_world(worker.run_cases, 2, cases2, device="cpu",
                                 mesh_fn=MODEL2, workdir=str(tmp))
            out[4] = spawn_world(worker.run_cases, 4, cases4, device="cpu",
                                 mesh_fn=MODEL2, workdir=str(tmp))
        except BaseException as e:          # raised in the test process
            out["error"] = e
    th = threading.Thread(target=worlds)
    th.start()
    try:
        refs = {a: _reference(m) for a, m in models.items()}
        refs.update({f"steps_{a}": _reference_steps(models[a])
                     for a in STEP_ARCHS})
    finally:
        th.join()
    if "error" in out:
        raise out["error"]
    return out[2], out[4], refs, dirs


def _reference(m):
    """The reference without a mesh: loss and gradient of one batch,
    teacher-forced logits (prefill, then 4 decode steps)."""
    jb = {k: jnp.asarray(v) for k, v in _batch(m.cfg).items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, m.jcfg, jb), has_aux=True))(m.jparams)
    _, toks, fed = _teacher_tokens(m)
    jcfg, b = m.jcfg, toks.shape[0]
    enc = (jnp.zeros((b, toks.shape[1], jcfg.d_model), jnp.float32)
           if jcfg.family == "encdec" else None)
    prefill = jax.jit(lambda p, t, c: JT.forward(p, jcfg, t, enc_embeds=enc,
                                                 cache=c))
    decode = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    logits, _, cache = prefill(m.jparams, jnp.asarray(toks, jnp.int32),
                               JT.init_cache(jcfg, b, T_MAX, jnp.float32))
    steps_ = [np.asarray(logits[:, -1])]
    for i in range(MAX_NEW):
        logits, cache = decode(m.jparams,
                               jnp.asarray(fed[:, i:i + 1], jnp.int32), cache)
        steps_.append(np.asarray(logits[:, -1]))
    return {"loss": float(loss), "grads": _np(grads), "logits": steps_}


def _reference_steps(m):
    """The reference's jitted AdamW step on the whole batch, 3 steps:
    each step's params, loss and grad norm, and the gradient at the
    params it starts from (for the mask)."""
    ocfg = jopt.OptConfig(lr=jsched.cosine_schedule(LR, WARMUP, TOTAL))
    step_fn, init = jsteps.make_train_step(m.jcfg, ocfg, remat="none")
    step_fn = jax.jit(step_fn)
    grad_fn = jax.jit(jax.grad(lambda p, b: JT.loss_fn(p, m.jcfg, b)[0]))
    params, state = m.jparams, init(m.jparams)
    out = [_np(params)]
    losses, norms, grads = [], [], []
    for b in _step_batches(m.cfg):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        grads.append(_np(grad_fn(params, jb)))
        params, state, metrics = step_fn(params, state, jb)
        out.append(_np(params))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return out, losses, norms, grads


# -- the two-rank world -------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_the_unsharded_reference(run, arch):
    ranks, _, refs, _ = run
    want = refs[arch]
    for r in ranks:
        got = r[f"grad_{arch}"]
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
        n = 0
        for path, g in opt.tree_paths(got["grads"]):
            w = np.asarray(opt.tree_at(want["grads"], path))
            np.testing.assert_allclose(
                g, w, rtol=1e-4,
                atol=GRAD_TOL * max(float(np.abs(w).max()), 1e-30),
                err_msg=f"{arch} {'/'.join(path)}")
            n += 1
        assert n == len(jax.tree.leaves(want["grads"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_the_reference(run, arch):
    ranks, _, refs, _ = run
    for r in ranks:
        got, _ = r[f"logits_{arch}"]
        assert len(got) == MAX_NEW + 1
        for i, (g, w) in enumerate(zip(got, refs[arch]["logits"])):
            np.testing.assert_allclose(g, w, **TOL,
                                       err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_equal_one_rank(run, models, arch):
    """``serve_batch`` at M = 2 emits one rank's tokens on every rank,
    and its last logits are one rank's."""
    ranks, _, _, _ = run
    m = models[arch]
    ps = prompts(m.cfg.vocab, LENGTHS)
    reqs = [serve.Request(p, max_new=MAX_NEW) for p in ps]
    stats = serve.serve_batch(m.cfg, reqs, t_max=T_MAX, device="cpu",
                              params=m.params)
    want = np.array([r.out for r in reqs])
    for r in ranks:
        toks, last = r[f"serve_{arch}"]
        np.testing.assert_array_equal(toks, want)
        np.testing.assert_allclose(last, stats["last_logits"].numpy(),
                                   **TOL)


def test_each_rank_holds_its_block_of_every_model_split_leaf(run, models):
    """On M = 2 a rank holds half of every leaf split over ``"model"``
    (the whole of a replicated one), whole heads and channels: the
    cache's kv heads and recurrent state are halved; the fused ``w_in``
    block is ``[v_r | og_r]``; the gathered gradients came back in the
    reference's layout (the previous tests)."""
    ranks, _, _, _ = run
    for arch, m in models.items():
        for r in ranks:
            blocks = r[f"grad_{arch}"]["blocks"]
            assert len(blocks) == len(opt.tree_leaves(m.params))
            assert any("'model'" in s for _, s in blocks.values()), arch
            for path, (n, spec) in blocks.items():
                whole = opt.tree_at(m.params, path).numel()
                assert n == (whole // 2 if "'model'" in spec else whole), \
                    (arch, path, spec)
            _, shapes = r[f"logits_{arch}"]
            cfg = m.cfg
            if "layers" in shapes or "shared" in shapes:
                kv = shapes.get("layers", shapes.get("shared"))
                assert kv[-2:] == (cfg.n_kv_heads // 2, cfg.hd), arch
            if "state" in shapes:
                assert shapes["state"][-1] == cfg.d_inner_mult * \
                    cfg.d_model // 2, arch
    for arch in ("xlstm-125m", "zamba2-2.7b"):
        w_in = np.asarray(models[arch].jparams["stack"]["rec"]["w_in"])
        di = w_in.shape[-1] // 2
        for k, r in enumerate(ranks):
            want = np.concatenate([w_in[..., k * di // 2:(k + 1) * di // 2],
                                   w_in[..., di + k * di // 2:
                                        di + (k + 1) * di // 2]], -1)
            np.testing.assert_array_equal(r[f"grad_{arch}"]["w_in"], want)


def test_model_axis_operators_and_the_global_argmax(run):
    """``copy_to_model`` is the identity forward and sums the gradient
    over ranks; ``reduce_from_model`` sums forward and passes the
    gradient as it is; ``max_over_model`` is the max; the greedy argmax
    over vocabulary shards picks the lowest global id on a tie, within a
    rank's columns and across ranks."""
    ranks, _, _, _ = run
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5)).astype(np.float32)
    ties = rng.standard_normal((3, 8)).astype(np.float32)
    ties[0, [1, 6]] = ties[1, [2, 3]] = ties[2, [5, 7]] = 9.0
    for k, r in enumerate(ranks):
        got = r["collectives"]
        np.testing.assert_array_equal(got["copy"], x[k])
        np.testing.assert_array_equal(got["g_copy"], np.full_like(x[k], 3))
        np.testing.assert_array_equal(got["reduce"], x[0] + x[1])
        np.testing.assert_array_equal(got["g_reduce"],
                                      np.full_like(x[k], k + 1))
        np.testing.assert_array_equal(got["max"], np.maximum(x[0], x[1]))
        np.testing.assert_array_equal(got["argmax"], [1, 2, 5])
        np.testing.assert_array_equal(got["argmax"], ties.argmax(-1))


def test_a_checkpoint_saved_at_two_ranks_restores_whole(run, models):
    """Each rank wrote its blocks at their global slices (a fused block
    as its two parts); read whole at M = 1, every leaf is the reference
    tree's, and the ranks' shard keys tile ``w_in`` part by part."""
    _, _, _, dirs = run
    xl = models["xlstm-125m"]
    like = {"params": {k: v for k, v in xl.params.items()}}
    like["params"] = opt.tree_like(like["params"], [
        torch.zeros_like(p) for p in opt.tree_leaves(xl.params)])
    like["opt"] = {"m": opt.tree_like(like["params"], [
        torch.zeros_like(p) for p in opt.tree_leaves(xl.params)]),
        "v": opt.tree_like(like["params"], [
            torch.zeros_like(p) for p in opt.tree_leaves(xl.params)]),
        "step": 0}
    got = ck.load_checkpoint(dirs["save"], 1, like)
    assert got["opt"]["step"] == 1
    for (path, p), g, m_ in zip(opt.tree_paths(xl.params),
                                opt.tree_leaves(got["params"]),
                                opt.tree_leaves(got["opt"]["m"])):
        assert torch.equal(g, p), path
        assert torch.equal(m_, p), path
    di = xl.cfg.d_inner_mult * xl.cfg.d_model
    keys = [k for r in range(2) for k in np.load(os.path.join(
        dirs["save"], "step_1", f"shards_h{r}.npz")).files
        if k.startswith("['params']['stack']['rec']['w_in']")]
    h = di // 2
    assert sorted(keys) == sorted(
        f"['params']['stack']['rec']['w_in']|0:-1,0:-1,{a}:{a + h}"
        for a in (0, h, di, di + h))


def test_a_checkpoint_saved_whole_restores_at_two_ranks(run, models):
    """A one-rank checkpoint restored at M = 2 into fresh blocks, in
    place, gathers back to the saved tree."""
    ranks, _, _, _ = run
    xl = models["xlstm-125m"]
    for r in ranks:
        step, params, moment = r["ckpt"]
        assert step == 1
        for path, p in opt.tree_paths(xl.params):
            np.testing.assert_array_equal(opt.tree_at(params, path),
                                          p.numpy(), err_msg=str(path))
            np.testing.assert_array_equal(opt.tree_at(moment, path),
                                          2 * p.numpy(), err_msg=str(path))


# -- the four-rank world ------------------------------------------------------


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_four_ranks_train_as_the_reference_step(run, models, arch):
    """``(data 2, model 2)``: every rank's three AdamW steps (loss, grad
    norm, parameter update) against the reference's step on the whole
    batch.  An entry whose reference gradient is nonzero but below
    ``GRAD_TOL`` of its leaf's largest is masked from then on, as in
    ``tests/test_torch_train.py``."""
    _, ranks, refs, _ = run
    ref_params, ref_losses, ref_norms, ref_grads = refs[f"steps_{arch}"]
    lr = jsched.cosine_schedule(LR, WARMUP, TOTAL)
    for r in ranks:
        got = r[arch]
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
                    err_msg=f"step {i + 1} {'/'.join(path)}")
            before = params
        masked = sum(int(u.sum()) for u in unknown.values())
        total = sum(u.size for u in unknown.values())
        assert masked < MASKED_SHARE * total, (masked, total)
    for a, b in zip(opt.tree_leaves(ranks[0][arch][-1][2]),
                    opt.tree_leaves(ranks[3][arch][-1][2])):
        np.testing.assert_array_equal(a, b)


# -- this process ----------------------------------------------------------------


def test_one_rank_model_axis_is_the_unsharded_run_bit_for_bit():
    """``make_host_mesh(1)``: ``train`` of Zamba2's smoke config (B4 and
    B5 under the sharded step, the norm's groups of one rank) and
    ``serve_batch`` on the mesh equal the runs without one, bit for
    bit."""
    mesh = make_host_mesh(1, device="cpu")
    kw = dict(steps=2, batch=2, seq=16, lr=3e-3, device="cpu",
              log_every=100)
    p0, l0 = train_mod.train("zamba2-2.7b", **kw)
    p1, l1 = train_mod.train("zamba2-2.7b", mesh=mesh, model_parallel=1,
                             **kw)
    assert l0 == l1
    for a, b in zip(opt.tree_leaves(p0), opt.tree_leaves(p1)):
        assert torch.equal(a.detach(), b)
    outs = []
    for m in (None, mesh):
        reqs = [serve.Request(p, max_new=3) for p in
                prompts(512, LENGTHS)]
        stats = serve.serve_batch("zamba2-2.7b", reqs, t_max=T_MAX,
                                  device="cpu", mesh=m)
        outs.append(([r.out for r in reqs], stats["last_logits"]))
    assert outs[0][0] == outs[1][0]
    assert torch.equal(outs[0][1], outs[1][1])


def _fake(m, r=0, d=1):
    """Rank ``r``'s layout of a ``(d, m)`` host mesh (no collective)."""
    return types.SimpleNamespace(
        axis_names=("data", "model"), shape={"data": d, "model": m},
        coords={"data": 0, "model": r},
        groups={"data": None, "model": None})


def test_fused_leaves_take_their_block_part_by_part():
    """A fused spec's block on rank r of M is the r-th block of each
    part side by side; ``block_slices`` refuses it, and a one-rank axis
    is the whole leaf; the mapping survives pickling (spawned ranks)."""
    import pickle
    x = torch.arange(2 * 12, dtype=torch.float32).reshape(2, 12)
    spec = sh.spec_for(sh.Fused(("embed", "mlp")), (2, 12), _fake(2),
                       make_rules(_fake(2), "train"))
    assert spec == P("data", "model") and spec.fused == 2
    assert pickle.loads(pickle.dumps(spec)).fused == 2
    assert pickle.loads(pickle.dumps(sh.Fused(("a", "b")))).parts == 2
    blocks = [sh.take_block(x, spec, _fake(2, r)) for r in range(2)]
    assert torch.equal(blocks[0], torch.cat([x[:, 0:3], x[:, 6:9]], 1))
    assert torch.equal(blocks[1], torch.cat([x[:, 3:6], x[:, 9:12]], 1))
    assert [sh.block_parts((2, 12), spec, _fake(2, 1))] == [
        [(slice(0, 2), slice(3, 6)), (slice(0, 2), slice(9, 12))]]
    with pytest.raises(ValueError, match="block_parts"):
        sh.block_slices((2, 12), spec, _fake(2))
    assert torch.equal(sh.take_block(x, spec, _fake(1)), x)
    # the stacked recurrent leaves keep the mark through param_specs
    specs = T.param_specs(configs.get("xlstm-125m", smoke=True))
    assert isinstance(specs["stack"]["rec"]["w_in"], sh.Fused)
    assert isinstance(specs["stack"]["rec"]["w_qk"], sh.Fused)
    assert specs["stack"]["rec"]["w_in"] == ("layers", "embed", "mlp")


def test_what_the_model_axis_refuses():
    """A head count (or width) that M does not divide raises
    ``ValueError`` naming it — a kv count only where M is not a multiple
    of it either (kv heads replicate across a wider axis:
    ``tests/test_torch_kv_replication.py``) — and so does an expert
    count; MoE at M > 1 and Adafactor on a leaf split over ``"model"``
    build a step (their values: ``tests/test_torch_moe_axis.py``)."""
    llama = configs.get("llama3-405b", smoke=True)
    mistral = configs.get("mistral-large-123b", smoke=True)  # 6 q / 2 kv
    with pytest.raises(ValueError, match=r"kv heads \(2\)"):
        T.check_model_axis(mistral, 3)
    T.check_model_axis(llama, 2)
    T.check_model_axis(llama, 4)
    params = T.init_params(mistral, 0, torch.float32, "cpu")
    three = _fake(3)
    specs = sh.tree_specs(T.param_specs(mistral), params, three,
                          make_rules(three, "train"))
    with pytest.raises(ValueError, match="kv heads"):
        steps.make_sharded_train_step(mistral, OptConfig(), three, specs)
    two = _fake(2)
    moe = configs.get("deepseek-moe-16b", smoke=True)
    with pytest.raises(ValueError, match=r"routed experts \(8\)"):
        T.check_model_axis(moe, 3)
    mspecs = sh.tree_specs(T.param_specs(moe),
                           T.init_params(moe, 0, torch.float32, "cpu"), two,
                           make_rules(two, "train"))
    xl = configs.get("xlstm-125m", smoke=True)
    xspecs = sh.tree_specs(T.param_specs(xl),
                           T.init_params(xl, 0, torch.float32, "cpu"), two,
                           make_rules(two, "train"))
    for cfg, sp, kind in ((moe, mspecs, "adamw"), (moe, mspecs, "adafactor"),
                          (xl, xspecs, "adafactor"), (xl, xspecs, "adamw")):
        step_fn, _ = steps.make_sharded_train_step(cfg, OptConfig(kind=kind),
                                                   two, sp)
        assert callable(step_fn)
