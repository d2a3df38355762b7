"""Whole query heads on a model axis that does not divide them (ROADMAP C)
against the JAX package.

``sharding.head_split`` lays H query heads over K kv heads out on M
ranks in whole heads, each rank's query heads inside the kv heads it
holds: (a) M ≤ K, a run of ⌈K/M⌉ or ⌊K/M⌋ whole GQA groups a rank, the
first ranks one more; (b) M a multiple of K with the group g = H / K at
least rep = M / K, each kv head on its rep ranks and its g query heads
split over them, the first ranks one more; (c) g < rep with rep a
multiple of g, each query head on rep / g ranks too, ``wo``'s rows of it
split over them.  The reference's GSPMD cuts inside a head instead and
computes the unsharded function, so the port's ranks are held against
the reference run without a mesh, on the same weights, as
``tests/test_torch_model_axis.py`` does, within its ``TOL``.

A spawned world of four gloo ranks at ``(data 1, model 4)`` runs four
smoke variants, each a ``dataclasses.replace`` of a smoke config applied
alike to both packages' configs:

* Mistral's smoke config, 6 query / 2 kv heads: case (b), 2, 1 query
  heads a kv head's two ranks;
* MiniCPM with 6 heads of 32 (MHA): case (a), 2, 2, 1, 1 heads a rank;
* Whisper with 2 heads of 32: case (c), each head on two ranks, in the
  decoder's self- and cross-attention and the encoder's;
* Llama 4 with 6 query / 2 kv heads: case (b) on its MoE pair layout,
  chunked and global layers.

Each variant's loss and every gradient leaf, prefill and teacher-forced
decode logits, greedy tokens, three AdamW steps (every update within
0.01 of the learning rate, masked as ``tests/test_torch_model_axis.py``
masks them), every leaf's block and a
gathered round trip (Adafactor's statistics too), and a checkpoint
saved at M = 4 read whole at M = 1; three Adafactor steps of the two
variants whose blocks differ most (MiniCPM's uneven run, Whisper's
replicated head).  In this process: the split of the four published
architectures the production mesh refused before (MiniCPM-2B,
StarCoder2-7B, Llama-4-Maverick, Whisper-base at M = 16), the
refusals, ``init_param_blocks`` bit for bit ``param_blocks(init_params
(...))`` on every rank, and the meta count of a step at a fake ``(1,
4)`` world equal to the CPU count of the same step.
"""

import functools
import os
import threading
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import checkpoint as ck
from repro_torch import configs
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, serve, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import make_host_mesh, spawn_world
from repro_torch.launch.rules import make_rules
from repro_torch.models import transformer as T
from repro_torch.optimizer import optimizers as opt

import test_torch_model_axis as ma
import torch_model_axis_worker as worker
from torch_lm_pairs import Model, prompts

TOL = ma.TOL
M = 4
#: name → (arch, the changes to its smoke config), and the heads each
#: rank holds at M = 4: query heads, kv heads
VARIANTS = {
    "mistral": ("mistral-large-123b", {}, (2, 1, 2, 1), (1, 1, 1, 1)),
    "minicpm": ("minicpm-2b", dict(n_heads=6, n_kv_heads=6, head_dim=32),
                (2, 2, 1, 1), (2, 2, 1, 1)),
    "whisper": ("whisper-base", dict(n_heads=2, n_kv_heads=2, head_dim=32),
                (1, 1, 1, 1), (1, 1, 1, 1)),
    "llama4": ("llama4-maverick-400b-a17b",
               dict(n_heads=6, n_kv_heads=2, head_dim=32),
               (2, 1, 2, 1), (1, 1, 1, 1)),
}
ADAFACTOR = ("minicpm", "whisper")
#: the four architectures at the production mesh's M = 16: (query heads
#: a rank, kv heads a rank, q_rep, kv_rep)
PUBLISHED = {
    "minicpm-2b": ((3,) * 4 + (2,) * 12, (3,) * 4 + (2,) * 12, 1, 1),
    "starcoder2-7b": ((3, 2, 2, 2) * 4, (1,) * 16, 1, 4),
    "llama4-maverick-400b-a17b": ((3, 2) * 8, (1,) * 16, 1, 2),
    "whisper-base": ((1,) * 16, (1,) * 16, 2, 2),
}


@pytest.fixture(scope="module", autouse=True)
def no_world_left():
    """The fake worlds of this file end with it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def models():
    return {v: Model.build(arch, **changes)
            for v, (arch, changes, _, _) in VARIANTS.items()}


@pytest.fixture(scope="module")
def run(models, tmp_path_factory):
    """The ``(1, 4)`` world (in a thread) and the reference's side:
    ``(ranks, refs, dirs)``."""
    tmp = tmp_path_factory.mktemp("heads")
    dirs, cases = {}, {}
    for v, m in models.items():
        tree = ma._np(m.jparams)
        ps, toks, fed = ma._teacher_tokens(m)
        dirs[v] = {"save": str(tmp / f"save_{v}"),
                   "whole": str(tmp / f"whole_{v}")}
        ma._save_whole(m, dirs[v]["whole"])
        batches = ma._step_batches(m.cfg)
        cases.update({
            f"grad_{v}": ("grad", (m.cfg, tree, ma._batch(m.cfg))),
            f"logits_{v}": ("logits", (m.cfg, tree, toks, fed, ma.T_MAX)),
            f"serve_{v}": ("serve", (m.cfg, tree, ps, ma.MAX_NEW, ma.T_MAX)),
            f"steps_{v}": ("steps", (m.cfg, tree, batches, ma.LR, ma.WARMUP,
                                     ma.TOTAL)),
            f"gather_{v}": ("gather", (m.cfg, tree)),
            f"ckpt_{v}": ("ckpt", (m.cfg, tree, dirs[v]["save"],
                                   dirs[v]["whole"]))})
        if v in ADAFACTOR:
            cases[f"adafactor_{v}"] = ("steps", (
                m.cfg, tree, batches, ma.LR, ma.WARMUP, ma.TOTAL,
                "adafactor"))
    out = {}

    def world():
        try:
            out["ranks"] = spawn_world(
                worker.run_cases, M, cases, device="cpu",
                mesh_fn=functools.partial(make_host_mesh, M),
                workdir=str(tmp))
        except BaseException as e:          # raised in the test process
            out["error"] = e
    th = threading.Thread(target=world)
    th.start()
    try:
        refs = {}
        for v, m in models.items():
            refs[v] = ma._reference(m)
            refs[v]["steps"] = ma._reference_steps(m)
            _, refs[v]["greedy"], _ = m.jax_greedy(
                prompts(m.cfg.vocab, ma.LENGTHS), ma.MAX_NEW, ma.T_MAX)
            if v in ADAFACTOR:
                refs[v]["adafactor"] = _reference_adafactor(m)
    finally:
        th.join()
    if "error" in out:
        raise out["error"]
    return out["ranks"], refs, dirs


def _reference_adafactor(m):
    """The reference's optimizer update (Adafactor) after its gradient
    on the whole batch, jitted, 3 steps: as ``ma._reference_steps``."""
    jax, jnp = ma.jax, ma.jnp
    ocfg = ma.jopt.OptConfig(kind="adafactor", lr=ma.jsched.cosine_schedule(
        ma.LR, ma.WARMUP, ma.TOTAL))
    init, update = ma.jopt.make_optimizer(ocfg)
    update = jax.jit(update)
    vg = jax.jit(jax.value_and_grad(lambda p, b: ma.JT.loss_fn(
        p, m.jcfg, b)[0]))
    params, state = m.jparams, init(m.jparams)
    out, losses, norms, grads = [ma._np(params)], [], [], []
    for b in ma._step_batches(m.cfg):
        loss, g = vg(params, {k: jnp.asarray(v) for k, v in b.items()})
        grads.append(ma._np(g))
        params, state, gnorm = update(params, g, state)
        out.append(ma._np(params))
        losses.append(float(loss))
        norms.append(float(gnorm))
    return out, losses, norms, grads


# -- the four-rank world ------------------------------------------------------


@pytest.mark.parametrize("name", list(VARIANTS))
def test_loss_and_every_grad_leaf_match_on_uneven_heads(run, name):
    ranks, refs, _ = run
    want = refs[name]
    for r in ranks:
        got = r[f"grad_{name}"]
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
        n = 0
        for path, g in opt.tree_paths(got["grads"]):
            w = np.asarray(opt.tree_at(want["grads"], path))
            np.testing.assert_allclose(
                g, w, rtol=1e-4,
                atol=ma.GRAD_TOL * max(float(np.abs(w).max()), 1e-30),
                err_msg=f"{name} {'/'.join(path)}")
            n += 1
        assert n == len(ma.jax.tree.leaves(want["grads"]))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_and_decode_logits_match_on_uneven_heads(run, name):
    ranks, refs, _ = run
    for r in ranks:
        got, _ = r[f"logits_{name}"]
        assert len(got) == ma.MAX_NEW + 1
        for i, (g, w) in enumerate(zip(got, refs[name]["logits"])):
            np.testing.assert_allclose(g, w, **TOL,
                                       err_msg=f"{name} step {i}")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_served_tokens_equal_the_reference_greedy_tokens(run, name):
    """``serve_batch(mesh=)`` on four ranks emits the reference's greedy
    tokens on every rank."""
    ranks, refs, _ = run
    for r in ranks:
        toks, last = r[f"serve_{name}"]
        np.testing.assert_array_equal(toks, refs[name]["greedy"])
        assert np.isfinite(last).all()


def _check_steps(ranks, key, ref, lr):
    """Every rank's steps (loss, grad norm, each update of every leaf
    within 0.01 of the learning rate, masked as
    ``tests/test_torch_model_axis.py`` masks them) against the
    reference's ``(params, losses, norms, grads)``; every rank ends with
    the same parameters."""
    ref_params, ref_losses, ref_norms, ref_grads = ref
    for r in ranks:
        unknown = {}
        before = ref_params[0]
        assert len(r[key]) == len(ref_losses)
        for i, (loss, norm, params) in enumerate(r[key]):
            np.testing.assert_allclose(loss, ref_losses[i], **TOL)
            np.testing.assert_allclose(norm, ref_norms[i], **TOL)
            for path, p in opt.tree_paths(params):
                d_got = p - np.asarray(opt.tree_at(before, path))
                d_want = (np.asarray(opt.tree_at(ref_params[i + 1], path))
                          - np.asarray(opt.tree_at(ref_params[i], path)))
                g = np.abs(np.asarray(opt.tree_at(ref_grads[i], path)))
                unknown[path] = unknown.get(path, False) | (
                    (g > 0) & (g < ma.GRAD_TOL * g.max()))
                keep = ~unknown[path]
                np.testing.assert_allclose(
                    d_got[keep], d_want[keep], rtol=0,
                    atol=0.01 * float(lr(i + 1)),
                    err_msg=f"{key} step {i + 1} {'/'.join(path)}")
            before = params
        masked = sum(int(u.sum()) for u in unknown.values())
        total = sum(u.size for u in unknown.values())
        assert masked < ma.MASKED_SHARE * total, (masked, total)
    for a, b in zip(opt.tree_leaves(ranks[0][key][-1][2]),
                    opt.tree_leaves(ranks[-1][key][-1][2])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_adamw_steps_match_the_reference_step_on_uneven_heads(run, name):
    """Three AdamW steps on four ranks against the reference's step on
    the whole batch; each head counts once in the norm (a replicated
    query head's ``wq`` block through the split group)."""
    ranks, refs, _ = run
    _check_steps(ranks, f"steps_{name}", refs[name]["steps"],
                 ma.jsched.cosine_schedule(ma.LR, ma.WARMUP, ma.TOTAL))


@pytest.mark.parametrize("name", ADAFACTOR)
def test_adafactor_steps_count_each_head_once(run, name):
    """Three Adafactor steps on four ranks against the reference's:
    the row and column statistics over an uneven run of heads divide by
    the whole leaf's counts, and a replicated query head's block counts
    once in them (its ``wq`` and ``c`` through the split group)."""
    ranks, refs, _ = run
    _check_steps(ranks, f"adafactor_{name}", refs[name]["adafactor"],
                 ma.jsched.cosine_schedule(ma.LR, ma.WARMUP, ma.TOTAL))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_each_rank_holds_whole_heads(run, models, name):
    """Rank r's ``wq`` block is its query heads' columns, ``wk``/``wv``
    its kv heads', ``wo`` its query heads' rows (where a head is on two
    ranks, half of them each), and its cache holds its kv heads."""
    ranks, _, _ = run
    _, _, q_heads, kv_heads = VARIANTS[name]
    cfg = models[name].cfg
    for k, r in enumerate(ranks):
        _, _, shapes = r[f"gather_{name}"]
        attn = [(p, s) for p, s in shapes.items() if "attn" in p
                or "cross" in p]
        assert attn
        q_rep = 2 if name == "whisper" else 1
        for path, (shape, spec) in attn:
            want = {"wq": q_heads[k] * cfg.hd, "wk": kv_heads[k] * cfg.hd,
                    "wv": kv_heads[k] * cfg.hd}
            if path[-1] == "wo":
                assert shape[-2] == q_heads[k] * cfg.hd // q_rep, (path, spec)
            else:
                assert shape[-1] == want[path[-1]], (path, spec)
        _, cache = r[f"logits_{name}"]
        assert cache["layers"][-2:] == (kv_heads[k], cfg.hd)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_gather_of_uneven_blocks_round_trips(run, models, name):
    """Each rank's blocks, gathered (uneven blocks padded to the largest
    for the collective and cut back, a replicated block taken once),
    are the whole tree; so are Adafactor's row and column statistics
    laid out by ``state_specs``."""
    ranks, _, _ = run
    want = ma._np(models[name].jparams)
    for r in ranks:
        got, gap, _ = r[f"gather_{name}"]
        assert gap == 0.0
        n = 0
        for path, g in opt.tree_paths(got):
            np.testing.assert_array_equal(g, np.asarray(opt.tree_at(
                want, path)), err_msg=str(path))
            n += 1
        assert n == len(ma.jax.tree.leaves(want))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_a_checkpoint_saved_at_four_ranks_reads_whole_at_one(run, models,
                                                            name):
    """Each rank wrote its blocks at their global slices (a replicated
    head's block by the first of its ranks only); read whole at M = 1,
    every leaf is the reference tree's and every moment its weights'.
    A one-rank checkpoint restored at M = 4 into fresh blocks gathers
    back to the saved tree."""
    ranks, _, dirs = run
    m = models[name]

    def zeros():
        return opt.tree_like(m.params, [torch.zeros_like(p) for p in
                                        opt.tree_leaves(m.params)])
    like = {"params": zeros(), "opt": {"m": zeros(), "v": zeros(),
                                       "step": 0}}
    got = ck.load_checkpoint(dirs[name]["save"], 1, like)
    assert got["opt"]["step"] == 1
    for (path, p), g, m_ in zip(opt.tree_paths(m.params),
                                opt.tree_leaves(got["params"]),
                                opt.tree_leaves(got["opt"]["m"])):
        assert torch.equal(g, p), path
        assert torch.equal(m_, p), path
    wq = [k for r in range(M) for k in np.load(os.path.join(
        dirs[name]["save"], "step_1", f"shards_h{r}.npz")).files
        if k.startswith("['params']['stack']")
        and k.split("|")[0].endswith("['wq']")]
    q_rep = 2 if name == "whisper" else 1
    leaves = 2 if name in ("llama4", "whisper") else 1    # a/b, attn/cross
    assert len(wq) == M // q_rep * leaves
    for r in ranks:
        step, params, moment = r[f"ckpt_{name}"]
        assert step == 1
        for path, p in opt.tree_paths(m.params):
            np.testing.assert_array_equal(opt.tree_at(params, path),
                                          p.numpy(), err_msg=str(path))
            np.testing.assert_array_equal(opt.tree_at(moment, path),
                                          2 * p.numpy(), err_msg=str(path))


# -- this process -------------------------------------------------------------


def _fake(m, r):
    """Rank ``r``'s layout of a ``(1, m)`` host mesh (no collective)."""
    return types.SimpleNamespace(
        axis_names=("data", "model"), shape={"data": 1, "model": m},
        coords={"data": 0, "model": r},
        groups={"data": None, "model": None})


@pytest.mark.parametrize("arch", list(PUBLISHED))
def test_the_published_archs_split_at_sixteen(arch):
    """``check_model_axis`` accepts the four architectures the production
    mesh refused before, and ``head_split`` lays them out as the rule
    says: MiniCPM-2B's 36 kv groups 3, 3, 3, 3 then 2 × 12; StarCoder2-
    7B's 9 query heads of each kv head 3, 2, 2, 2; Llama-4-Maverick's 5
    as 3, 2; Whisper-base's 8 heads each on 2 ranks.  Rank 0 holds the
    most; its ``wq`` block is its query heads' columns."""
    cfg = configs.get(arch)
    T.check_model_axis(cfg, 16)
    split = sh.head_split(cfg.n_heads, cfg.n_kv_heads, 16)
    q, kv, q_rep, kv_rep = PUBLISHED[arch]
    assert tuple(n for _, n in split.q) == q
    assert tuple(n for _, n in split.kv) == kv
    assert (split.q_rep, split.kv_rep) == (q_rep, kv_rep)
    assert split.q[0][1] == max(q) and split.kv[0][1] == max(kv)
    # each rank's query heads use only the kv heads it holds
    g = cfg.n_heads // cfg.n_kv_heads
    for (qa, qn), (ka, kn) in zip(split.q, split.kv):
        assert ka <= qa // g and (qa + qn - 1) // g < ka + kn
    cols = cfg.n_heads * cfg.hd
    mesh = _fake(16, 0)
    spec = sh.spec_for(sh.Heads(("embed", "heads"), cfg.n_kv_heads,
                                cfg.n_heads), (cfg.d_model, cols), mesh,
                       make_rules(mesh, "train"))
    assert spec == sh.P("data", "model") and spec.rep == q_rep
    assert sh.block_slices((cfg.d_model, cols), spec, mesh)[1] == slice(
        0, q[0] * cfg.hd)
    assert T.local_kv_heads(cfg, 16, 0) == kv[0]
    assert T.local_kv_heads(cfg, 16, 15) == kv[-1]


def test_what_the_head_split_refuses():
    """A model axis that is neither at most the kv heads nor a multiple
    of them raises ``ValueError`` naming the counts (Mistral's smoke
    config, 6 query / 2 kv heads, at M = 3), and so does a multiple
    whose share of a kv head's ranks neither holds whole query heads nor
    divides them (3 query heads of a kv head on 4 ranks); the spec of
    such a leaf stays replicated."""
    mistral = configs.get("mistral-large-123b", smoke=True)
    with pytest.raises(ValueError, match=r"query heads \(6\) over its kv "
                                         r"heads \(2\)"):
        T.check_model_axis(mistral, 3)
    with pytest.raises(ValueError, match="3 query heads over 1 kv heads"):
        sh.head_split(3, 1, 4)
    mesh = _fake(3, 0)
    spec = sh.spec_for(sh.Heads(("embed", "heads"), 2, 6), (192, 192), mesh,
                       make_rules(mesh, "train"))
    assert spec == sh.P("data", None) and spec.table is None


@pytest.mark.parametrize("name", list(VARIANTS))
def test_block_build_is_the_cut_of_the_whole_tree_on_uneven_heads(name):
    """``T.init_param_blocks`` on every rank of ``(1, 4)``, under the
    train and the serve rules, equals ``steps.param_blocks(
    T.init_params(...))`` bit for bit, key order, specs and head tables
    included."""
    arch, changes, _, _ = VARIANTS[name]
    import dataclasses
    cfg = dataclasses.replace(configs.get(arch, smoke=True), **changes)
    full = T.init_params(cfg, 3, torch.float32, "cpu")
    for r in range(M):
        mesh = _fake(M, r)
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
                assert torch.equal(a, b), (r, path)
            for a, b in zip(opt.tree_leaves(got_specs),
                            opt.tree_leaves(specs)):
                assert repr(a) == repr(b) and a.table == b.table


#: the dry run's cells counted at a fake (1, 4) world
COUNT_SHAPES = ("train_4k", "decode_32k")


@pytest.mark.parametrize("shape", COUNT_SHAPES)
@pytest.mark.parametrize("name", list(VARIANTS))
def test_the_meta_count_is_the_cpu_count_on_a_fake_1x4_world(name, shape):
    """As ``tests/test_torch_dryrun.py`` (c): rank 0's step of the
    variant staged on the meta device counts what the same step counts
    on the CPU, FLOPs, bytes, collectives and kernels."""
    arch, changes, _, _ = VARIANTS[name]
    import dataclasses
    cfg = dataclasses.replace(configs.get(arch, smoke=True), **changes)
    dryrun.fake_world(M)
    mesh = mesh_mod.make_host_mesh(M, device="cpu")
    rows = []
    for dev in ("meta", "cpu"):
        built, reason = dryrun.build_cell(cfg, shape, mesh, device=dev,
                                          batch=4, seq=32)
        assert built is not None, reason
        fn, args, c, w = built
        rows.append(dryrun._row(dryrun.stage(fn, args, warm=dev == "cpu"),
                                c, w))
    for key in ("flops", "bytes_accessed", "collectives", "kernels"):
        assert rows[0][key] == rows[1][key], key
    assert rows[0]["memory"]["argument_bytes"] == \
        rows[1]["memory"]["argument_bytes"]
    assert rows[0]["flops"] > 0 and rows[0]["collectives"]["total_bytes"] > 0
