"""Kv heads replicated across a model axis wider than them (Megatron's
GQA rule, ROADMAP C) against the JAX package.

Where the ``"model"`` axis M is a multiple of ``n_kv_heads`` larger than
it, rank r keeps its ``n_heads / M`` query heads and kv head ``r // (M /
n_kv)`` whole (``sharding.Heads``, ``P.rep``); each replica's ``wk``/
``wv`` gradient is summed over the ranks of its head.  The reference's
GSPMD would cut each kv head's columns over the axis and computes the
unsharded function, so the port's ranks are held against the reference
run without a mesh (as ``tests/test_torch_model_axis.py`` does), within
its ``TOL``:

* a spawned world of four gloo ranks at ``(data 1, model 4)`` for the
  smoke configs of Llama-3 (8 q / 2 kv heads), LLaVA-NeXT, StarCoder2
  and Llama 4 (4 / 2): the loss and every gradient leaf, prefill logits
  and four decode steps, the cache's one kv head a rank; three AdamW
  steps of Llama-3 and LLaVA (the norm summed over one rank of each
  head); a checkpoint written at M = 4, each replicated block by the
  first of its ranks, read whole at M = 1;
* a world of four ranks at ``(data 2, model 2)`` with Llama-3's smoke
  config, where no head is replicated: its AdamW steps as before.
"""

import functools
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ck
from repro_torch import configs
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh, spawn_world
from repro_torch.launch.rules import make_rules
from repro_torch.models import transformer as T
from repro_torch.optimizer import optimizers as opt

import test_torch_model_axis as ma
import torch_model_axis_worker as worker
from torch_lm_pairs import Model

TOL = ma.TOL
ARCHS = ("llama3-405b", "llava-next-mistral-7b", "starcoder2-7b",
         "llama4-maverick-400b-a17b")
STEP_ARCHS = ("llama3-405b", "llava-next-mistral-7b")
M = 4


@pytest.fixture(scope="module")
def models():
    return {a: Model.build(a) for a in ARCHS}


@pytest.fixture(scope="module")
def run(models, tmp_path_factory):
    """The ``(1, 4)`` and ``(2, 2)`` worlds (in a thread) and the
    reference's side: ``(ranks14, ranks22, refs, save_dir)``."""
    tmp = tmp_path_factory.mktemp("kv")
    save, whole = str(tmp / "save"), str(tmp / "whole")
    ma._save_whole(models["llama3-405b"], whole)
    cases = {"ckpt": ("ckpt", ("llama3-405b",
                               ma._np(models["llama3-405b"].jparams),
                               save, whole))}
    for a, m in models.items():
        tree = ma._np(m.jparams)
        _, toks, fed = ma._teacher_tokens(m)
        cases[f"grad_{a}"] = ("grad", (a, tree, ma._batch(m.cfg)))
        cases[f"logits_{a}"] = ("logits", (a, tree, toks, fed, ma.T_MAX))
    steps_args = {a: (a, ma._np(models[a].jparams),
                      ma._step_batches(models[a].cfg), ma.LR, ma.WARMUP,
                      ma.TOTAL) for a in STEP_ARCHS}
    cases.update({f"steps_{a}": ("steps", args)
                  for a, args in steps_args.items()})
    cases22 = {"steps_llama3-405b": ("steps", steps_args["llama3-405b"])}
    out = {}

    def worlds():
        try:
            out[14] = spawn_world(worker.run_cases, M, cases, device="cpu",
                                  mesh_fn=functools.partial(make_host_mesh,
                                                            M),
                                  workdir=str(tmp))
            out[22] = spawn_world(worker.run_cases, 4, cases22,
                                  device="cpu", mesh_fn=ma.MODEL2,
                                  workdir=str(tmp))
        except BaseException as e:          # raised in the test process
            out["error"] = e
    th = threading.Thread(target=worlds)
    th.start()
    try:
        refs = {a: ma._reference(m) for a, m in models.items()}
        refs.update({f"steps_{a}": ma._reference_steps(models[a])
                     for a in STEP_ARCHS})
    finally:
        th.join()
    if "error" in out:
        raise out["error"]
    return out[14], out[22], refs, save


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_with_kv_heads_replicated(run,
                                                                 arch):
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
                atol=ma.GRAD_TOL * max(float(np.abs(w).max()), 1e-30),
                err_msg=f"{arch} {'/'.join(path)}")
            n += 1
        assert n == len(opt.tree_leaves(got["grads"])) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_with_kv_heads_replicated(run,
                                                                  arch):
    ranks, _, refs, _ = run
    for r in ranks:
        got, _ = r[f"logits_{arch}"]
        assert len(got) == ma.MAX_NEW + 1
        for i, (g, w) in enumerate(zip(got, refs[arch]["logits"])):
            np.testing.assert_allclose(g, w, **TOL,
                                       err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_the_kv_head_its_query_heads_use(run, models,
                                                         arch):
    """At M = 4 over 2 kv heads: ``wk``/``wv`` are one head's ``hd``
    columns a rank (``rep=2``), the query blocks a quarter, and the
    cache holds one kv head a rank."""
    ranks, _, _, _ = run
    cfg = models[arch].cfg
    for r in ranks:
        blocks = r[f"grad_{arch}"]["blocks"]
        kv = [(p, n, s) for p, (n, s) in blocks.items()
              if p[-1] in ("wk", "wv")]
        assert kv
        for path, n, spec in kv:
            whole = opt.tree_at(models[arch].params, path).numel()
            assert "rep=2" in spec, (path, spec)
            assert n == whole // cfg.n_kv_heads, (path, n)
        _, shapes = r[f"logits_{arch}"]
        assert shapes["layers"][-2:] == (1, cfg.hd)


def test_a_replicated_block_is_the_head_of_its_query_heads():
    """``take_block`` of a ``rep`` spec gives rank r head ``r // rep``;
    ``global_shape`` and ``block_parts`` count the heads, not the ranks;
    the spec survives pickling (spawned ranks)."""
    import pickle
    import types
    llama = configs.get("llama3-405b", smoke=True)
    x = torch.arange(3 * 2 * llama.hd, dtype=torch.float32).reshape(3, -1)

    def fake(r):
        return types.SimpleNamespace(
            axis_names=("data", "model"), shape={"data": 1, "model": M},
            coords={"data": 0, "model": r}, groups={})
    spec = sh.spec_for(sh.Heads(("embed", "kv"), 2), tuple(x.shape),
                       fake(0), make_rules(fake(0), "train"))
    assert spec == sh.P("data", "model") and spec.rep == 2
    assert pickle.loads(pickle.dumps(spec)).rep == 2
    for r in range(M):
        h = r // 2
        assert torch.equal(sh.take_block(x, spec, fake(r)),
                           x[:, h * llama.hd:(h + 1) * llama.hd])
        assert sh.global_shape((3, llama.hd), spec, fake(r)) == tuple(
            x.shape)
    specs = T.param_specs(llama)
    assert isinstance(specs["stack"]["attn"]["wk"], sh.Heads)
    assert specs["stack"]["attn"]["wk"] == ("layers", "embed", "kv")


@pytest.mark.parametrize("world", ["1x4", "2x2"])
def test_adamw_steps_match_the_reference_step(run, models, world):
    """Three AdamW steps (loss, grad norm, each update) against the
    reference's step on the whole batch, masked as
    ``tests/test_torch_model_axis.py`` masks them: Llama-3 and LLaVA at
    ``(1, 4)``, where each kv head is on two ranks and counts once in
    the norm; Llama-3 at ``(2, 2)``, where no head is replicated.  Every
    leaf is held at every step within 0.01 of the learning rate, but at
    ``(1, 4)``'s step 2, where leaves other than ``wk``/``wv`` are held
    at the float32 rounding bound that ``tools/model_axis_drift.py``
    derives (the unsharded port and the reference's own float32 step are
    as far from float64 there)."""
    ranks14, ranks22, refs, _ = run
    ranks = ranks14 if world == "1x4" else ranks22
    archs = STEP_ARCHS if world == "1x4" else ("llama3-405b",)
    lr = ma.jsched.cosine_schedule(ma.LR, ma.WARMUP, ma.TOTAL)
    for arch in archs:
        ref_params, ref_losses, ref_norms, ref_grads = refs[f"steps_{arch}"]
        for r in ranks:
            unknown = {}
            before = ref_params[0]
            for i, (loss, norm, params) in enumerate(r[f"steps_{arch}"]):
                np.testing.assert_allclose(loss, ref_losses[i], **TOL)
                np.testing.assert_allclose(norm, ref_norms[i], **TOL)
                for path, p in opt.tree_paths(params):
                    d_got = p - np.asarray(opt.tree_at(before, path))
                    d_want = (np.asarray(opt.tree_at(ref_params[i + 1],
                                                     path))
                              - np.asarray(opt.tree_at(ref_params[i], path)))
                    g = np.abs(np.asarray(opt.tree_at(ref_grads[i], path)))
                    unknown[path] = unknown.get(path, False) | (
                        (g > 0) & (g < ma.GRAD_TOL * g.max()))
                    keep = ~unknown[path]
                    # at step 2 a few entries whose first and second
                    # gradients nearly cancel in the first moment move by
                    # more in float32 rounding alone: over M = 1, 2 and 4
                    # tools/model_axis_drift.py measures the port's float32
                    # update 2.32e-2 from its own float64 one, the
                    # reference's 1.73e-2, the two float64 runs 4.2e-3
                    # apart, so the float32 updates at most 4.47e-2 apart
                    # (at steps 1 and 3 that sum is 2.8e-4 and 8.5e-3)
                    atol = 0.05 if (world == "1x4" and i + 1 == 2 and
                                    path[-1] not in ("wk", "wv")) else 0.01
                    np.testing.assert_allclose(
                        d_got[keep], d_want[keep], rtol=0,
                        atol=atol * float(lr(i + 1)),
                        err_msg=f"{arch} step {i + 1} {'/'.join(path)}")
                before = params
            masked = sum(int(u.sum()) for u in unknown.values())
            total = sum(u.size for u in unknown.values())
            assert masked < ma.MASKED_SHARE * total, (masked, total)


def test_a_checkpoint_saved_at_four_ranks_reads_whole(run, models):
    """Written at M = 4 (a replicated kv block by the first rank of its
    head only), read whole at M = 1: every leaf is the reference
    tree's; the ranks' ``wk`` shard keys are one a head."""
    _, _, _, save = run
    m = models["llama3-405b"]

    def zeros():
        return opt.tree_like(m.params, [torch.zeros_like(p) for p in
                                        opt.tree_leaves(m.params)])
    like = {"params": zeros(), "opt": {"m": zeros(), "v": zeros(),
                                       "step": 0}}
    got = ck.load_checkpoint(save, 1, like)
    assert got["opt"]["step"] == 1
    for (path, p), g, m_ in zip(opt.tree_paths(m.params),
                                opt.tree_leaves(got["params"]),
                                opt.tree_leaves(got["opt"]["m"])):
        assert torch.equal(g, p), path
        assert torch.equal(m_, p), path
    hd = m.cfg.hd
    keys = [k for r in range(M) for k in np.load(os.path.join(
        save, "step_1", f"shards_h{r}.npz")).files
        if k.startswith("['params']['stack']['attn']['wk']")]
    assert sorted(keys) == sorted(
        f"['params']['stack']['attn']['wk']|0:-1,0:-1,{a}:{a + hd}"
        for a in (0, hd))


def test_what_kv_replication_accepts_and_refuses():
    """M = 4 and 16 over Llama-3's 2 kv heads (smoke) and 8 (full) pass
    ``check_model_axis``, and so does StarCoder2-7B's 36 query heads
    over 4 kv heads at 16 (each kv head on 4 ranks, its 9 query heads
    split 3, 2, 2, 2: ``tests/test_torch_head_split.py``); a kv count
    that neither divides M nor is divided by it raises naming the
    counts."""
    llama = configs.get("llama3-405b", smoke=True)
    for m in (2, 4, 8):
        T.check_model_axis(llama, m)
    T.check_model_axis(configs.get("llama3-405b"), 16)
    mistral = configs.get("mistral-large-123b", smoke=True)   # 6 q / 2 kv
    with pytest.raises(ValueError, match=r"kv heads \(2\)"):
        T.check_model_axis(mistral, 3)
    T.check_model_axis(configs.get("starcoder2-7b"), 16)
    assert T.local_kv_heads(llama, 4) == 1
    assert T.local_kv_heads(llama, 2) == 1
    assert T.local_kv_heads(configs.get("llama3-405b"), 2) == 4
