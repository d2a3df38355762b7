"""Data-parallel training and sharded checkpoints (ROADMAP A7c-1).

* ``train`` on a spawned world of two gloo ranks (xLSTM and Zamba2
  smoke configs, 3 steps: B4 and B5 forward and backward on each rank)
  against one rank fed the two ranks' batches concatenated: losses,
  grad norms and final parameters within 1e-5.
* ``make_sharded_train_step`` on a VLM whose ranks hold unequal numbers
  of labels: the global batch's token mean, not a mean of the ranks'
  means, against the unsharded step on the whole batch.
* W = 1 (a one-rank mesh in this process) is the unsharded run bit for
  bit, and half the moments' bytes sit on each of two ranks.
* Sharded checkpoints: saved at W = 2 and read whole (W = 1) and in
  blocks at W = 4, bit for bit; a W = 2 run resumed at W = 1; no
  ``step_N`` while a rank's shard is missing.
* ``model_parallel=2`` on the two ranks (a ``(1, 2)`` mesh) trains as
  the unsharded run; in one process it raises the mesh's error.
* The refusals: an MoE model at W > 1 or M > 1 and Adafactor on a leaf
  split over ranks of either axis (ROADMAP A7c-2, 1b).
"""

import os
import types

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ck
from repro_torch import configs
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.data import pipeline as pipe
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_host_mesh, spawn_world
from repro_torch.launch.rules import make_rules
from repro_torch.models import transformer as T
from repro_torch.optimizer import OptConfig, cosine_schedule, wsd_schedule
from repro_torch.optimizer import optimizers as opt

import torch_mesh_worker as worker

#: W = 2 against one rank on the concatenated batches: f32 sums in
#: another order (the reduce of two halves against one batch) — losses
#: and grad norms
TOL = dict(rtol=1e-5, atol=1e-5)
#: the parameters after the steps: AdamW divides by √v, so an entry whose
#: gradient is near zero moves a rounding-level change in it up to lr;
#: ``tests/test_torch_train.py``'s tolerance
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
RUN = dict(steps=3, batch=4, seq=32, lr=3e-3)
ARCHS = ("xlstm-125m", "zamba2-2.7b")
VLM = "llava-next-mistral-7b"
VLM_LR = 3e-3


def _vlm_batches(n_steps=2, batch=4, seq=16):
    """VLM batches whose first half of rows (rank 0's) has most labels
    masked: the ranks hold unequal numbers of labels."""
    cfg = configs.get(VLM, smoke=True)
    stream = pipe.synthetic_stream(train_mod.data_config(
        cfg, batch=batch, seq=seq, seed=5))
    out = []
    for _ in range(n_steps):
        b = dict(next(stream))
        b["labels"] = b["labels"].copy()
        b["labels"][: batch // 2, 3:] = -1
        out.append(b)
    return out


def _mixed_tree(rng):
    return {"params": {"w": rng.standard_normal((6, 4)).astype(np.float32),
                       "b": rng.standard_normal(5).astype(np.float32),
                       "e": rng.standard_normal((8, 4)).astype(np.float32)},
            "opt": {"step": 7}}


MIXED_LOGICAL = {"params": {"w": ("embed", "mlp"), "b": ("norm",),
                            "e": ("vocab", "embed")},
                 "opt": {"step": ()}}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One spawned world of two ranks running every case: ``(dirs,
    [rank 0's results, rank 1's])``."""
    tmp = tmp_path_factory.mktemp("dp")
    dirs = {"save": str(tmp / "save"), "resume": str(tmp / "resume")}
    cases = {f"train_{a}": ("train", (a, RUN)) for a in ARCHS}
    cases["vlm"] = ("step", (VLM, _vlm_batches(), VLM_LR))
    cases["save"] = ("save", (dirs["save"], 3,
                              _mixed_tree(np.random.default_rng(0)),
                              MIXED_LOGICAL))
    cases["resume"] = ("train", ("xlstm-125m",
                                 dict(RUN, steps=4, ckpt_dir=dirs["resume"])))
    cases["train_tp"] = ("train", ("xlstm-125m", dict(RUN, model_parallel=2)))
    ranks = spawn_world(worker.run_cases, 2, cases, device="cpu",
                        workdir=str(tmp))
    return dirs, ranks


def _schedule(cfg, lr, steps_):
    return (wsd_schedule if cfg.schedule == "wsd" else cosine_schedule)(
        lr, warmup=max(steps_ // 20, 5), total=steps_)


def _concat_run(arch, w, *, steps, batch, seq, lr):
    """One rank, the unsharded step, fed each step the ``w`` host
    streams' batches concatenated (the global batch of ``w`` ranks)."""
    cfg = configs.get(arch, smoke=True)
    step_fn, init = _plain_step(cfg, _schedule(cfg, lr, steps))
    params = T.init_params(cfg, 0, torch.float32, "cpu")
    for p in opt.tree_leaves(params):
        p.requires_grad_(True)
    state = init(params)
    dcfg = train_mod.data_config(cfg, batch=batch, seq=seq, seed=0)
    streams = [pipe.synthetic_stream(dcfg, host=r, n_hosts=w)
               for r in range(w)]
    losses, norms = [], []
    for _ in range(steps):
        parts = [next(s) for s in streams]
        b = {k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
             for k in parts[0]}
        params, state, m = step_fn(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, params


def _plain_step(cfg, lr):
    return steps.make_train_step(cfg, OptConfig(lr=lr), remat="none")


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_train_as_one_on_the_concatenated_batches(world2, arch):
    _, ranks = world2
    losses, norms, params = _concat_run(arch, 2, **RUN)
    for r in ranks:
        got_l, got_p, got_n = r[f"train_{arch}"]
        np.testing.assert_allclose(got_l, losses, **TOL)
        np.testing.assert_allclose(got_n, norms, **TOL)
        for (path, want), g in zip(opt.tree_paths(params),
                                   opt.tree_leaves(got_p)):
            np.testing.assert_allclose(g, want.detach().numpy(),
                                       **PARAM_TOL, err_msg=str(path))
    # every rank ends with the same parameters, bit for bit
    for a, b in zip(opt.tree_leaves(ranks[0][f"train_{arch}"][1]),
                    opt.tree_leaves(ranks[1][f"train_{arch}"][1])):
        np.testing.assert_array_equal(a, b)


def test_unequal_label_counts_weigh_as_one_batch(world2):
    """Rank 0 holds 3 valid labels a row, rank 1 all 16: the step's loss
    and gradient are the whole batch's token mean (a mean of the two
    ranks' means would weigh each of rank 0's labels 16/3 × as much)."""
    _, ranks = world2
    cfg = configs.get(VLM, smoke=True)
    step_fn, init = steps.make_train_step(cfg, OptConfig(lr=VLM_LR),
                                          remat="none")
    params = T.init_params(cfg, 0, torch.float32, "cpu")
    for p in opt.tree_leaves(params):
        p.requires_grad_(True)
    state = init(params)
    want = []
    batches = _vlm_batches()
    assert [[int((b["labels"][rows] >= 0).sum())
             for rows in (slice(0, 2), slice(2, 4))]
            for b in batches] == [[6, 32], [6, 32]]
    for b in batches:
        params, state, m = step_fn(
            params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        want.append((float(m["loss"]), float(m["grad_norm"])))
    for r in ranks:
        got, full, moments = r["vlm"]
        np.testing.assert_allclose(got, want, **TOL)
        for p, g in zip(opt.tree_leaves(params), opt.tree_leaves(full)):
            np.testing.assert_allclose(g, p.detach().numpy(), **PARAM_TOL)
        whole = sum(p.numel() * 4 * 2 for p in opt.tree_leaves(params))
        assert moments < whole


def test_one_rank_mesh_is_the_unsharded_run_bit_for_bit():
    """W = 1: the gather, the reduce-scatter and the norm's all-reduce
    are copies, and losses and parameters are the unsharded ``train``'s
    bit for bit (xLSTM, and the VLM's -1 padded labels)."""
    mesh = make_host_mesh(device="cpu")
    assert (mesh.shape, mesh.coords) == ({"data": 1, "model": 1},
                                         {"data": 0, "model": 0})
    for arch in ("xlstm-125m", VLM):
        kw = dict(RUN, steps=2, device="cpu", log_every=100)
        p0, l0 = train_mod.train(arch, **kw)
        p1, l1 = train_mod.train(arch, mesh=mesh, **kw)
        assert l0 == l1
        for a, b in zip(opt.tree_leaves(p0), opt.tree_leaves(p1)):
            assert torch.equal(a.detach(), b)


def test_each_of_two_ranks_holds_half_the_moments(world2):
    """AdamW's moments of the VLM smoke config sit in blocks: each rank
    holds half of the moments of every leaf split over ``"data"``."""
    _, ranks = world2
    cfg = configs.get(VLM, smoke=True)
    params = T.init_params(cfg, 0, torch.float32, "cpu")
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 2, "model": 1},
                                 coords={"data": 0, "model": 0})
    specs = sh.tree_specs(T.param_specs(cfg), params, mesh,
                          make_rules(mesh, "train"))
    want = sum(p.numel() * 4 * 2 // (2 if steps.data_dim(s) is not None
                                     else 1)
               for p, s in zip(opt.tree_leaves(params),
                               opt.tree_leaves(specs)))
    assert [r["vlm"][2] for r in ranks] == [want, want]


# -- sharded checkpoints ------------------------------------------------------


def _fake_mesh(w, r):
    """The layout of rank ``r`` of a ``(w, 1)`` host mesh (a checkpoint
    read, or building a step, needs no collective)."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": w, "model": 1},
                                 coords={"data": r, "model": 0},
                                 groups={"data": None, "model": None})


def _block_shape(shape, spec, mesh):
    return tuple(s.stop - s.start
                 for s in sh.block_slices(tuple(shape), spec, mesh))


def test_a_checkpoint_saved_at_two_ranks_reads_whole_and_at_four(world2):
    """Each rank wrote its blocks under the reference's keys (a leaf held
    whole by rank 0 alone); read whole, and in blocks at W = 1 and W = 4
    (where ``w``'s 6 rows no longer split and ``e``'s 4 columns do),
    every tensor is the saved one bit for bit."""
    dirs, ranks = world2
    tree = _mixed_tree(np.random.default_rng(0))
    step_dir = os.path.join(dirs["save"], "step_3")
    assert sorted(os.listdir(step_dir)) == ["manifest.json",
                                            "shards_h0.npz", "shards_h1.npz"]
    keys = [sorted(np.load(os.path.join(step_dir, f"shards_h{r}.npz")).files)
            for r in range(2)]
    assert keys == [["['opt']['step']|full", "['params']['b']|full",
                     "['params']['e']|0:-1,0:2", "['params']['w']|0:3,0:-1"],
                    ["['params']['e']|0:-1,2:4", "['params']['w']|3:6,0:-1"]]
    like = {"params": {k: torch.zeros(v.shape) for k, v in
                       tree["params"].items()}, "opt": {"step": 0}}
    whole = ck.load_checkpoint(dirs["save"], 3, like)
    assert whole["opt"]["step"] == 7
    for k, v in tree["params"].items():
        assert np.array_equal(whole["params"][k].numpy(), v)
    for w in (1, 4):
        m0 = _fake_mesh(w, 0)
        specs = sh.tree_specs(MIXED_LOGICAL, like, m0, make_rules(m0, "train"))
        got = []
        for r in range(w):
            m = _fake_mesh(w, r)
            target = {"params": {
                k: torch.zeros(_block_shape(v.shape, specs["params"][k], m))
                for k, v in tree["params"].items()}, "opt": {"step": 0}}
            got.append(ck.load_checkpoint(dirs["save"], 3, target,
                                          shardings=specs, mesh=m))
        assert all(g["opt"]["step"] == 7 for g in got)
        for k, v in tree["params"].items():
            d = steps.data_dim(specs["params"][k])
            parts = [g["params"][k] for g in got]
            full = parts[0] if d is None else torch.cat(parts, d)
            assert np.array_equal(full.numpy(), v), (w, k)
    assert steps.data_dim(specs["params"]["w"]) is None
    assert steps.data_dim(specs["params"]["e"]) == 1


def test_no_step_dir_while_a_rank_shard_is_missing(tmp_path, monkeypatch):
    """Rank 0's save of a two-rank world completes only once rank 1's
    shard is there; until then only ``step_5.tmp`` exists, and a rank 1
    that never writes leaves no ``step_5``."""
    monkeypatch.setattr(torch.distributed, "barrier", lambda *a, **k: None)
    tree = {"w": torch.arange(8.0).reshape(4, 2)}
    specs = {"w": P("data", None)}

    def save(rank, **kw):
        monkeypatch.setattr(ckpt, "host_and_count", lambda: (rank, 2))
        m = _fake_mesh(2, rank)
        block = tree["w"][sh.block_slices((4, 2), specs["w"], m)]
        return ck.save_checkpoint(str(tmp_path), 5, {"w": block},
                                  shardings=specs, mesh=m, **kw)
    pending = save(0, async_=True)
    pending.join(0.3)
    assert pending.is_alive()
    assert sorted(os.listdir(tmp_path)) == ["step_5.tmp"]
    assert ck.latest_steps(str(tmp_path)) == []
    save(1)
    pending.result()
    assert ck.latest_steps(str(tmp_path)) == [5]
    out = ck.load_checkpoint(str(tmp_path), 5, {"w": torch.zeros(4, 2)})
    assert torch.equal(out["w"], tree["w"])
    monkeypatch.setattr(ckpt, "SHARD_WAIT_S", 0.2)
    lone = save(0, async_=True)
    with pytest.raises(TimeoutError, match="shards_h1"):
        lone.result()
    assert ck.latest_steps(str(tmp_path)) == [5]


def test_a_two_rank_run_resumes_at_one_rank(world2, tmp_path, capsys):
    """The W = 2 run's last checkpoint (step 4) restores at W = 1 — the
    unsharded run and a one-rank mesh alike — to the two ranks'
    gathered parameters, and both W = 1 runs go on bit for bit alike."""
    dirs, ranks = world2
    _, params2, _ = ranks[0]["resume"]
    assert ck.latest_steps(dirs["resume"]) == [4]
    cfg = configs.get("xlstm-125m", smoke=True)
    like = {"params": T.init_params(cfg, 0, torch.float32, "cpu")}
    like["opt"] = opt.adamw_init(like["params"])
    saved = ck.load_checkpoint(dirs["resume"], 4, like)
    assert saved["opt"]["step"] == 4
    for (path, p), g in zip(opt.tree_paths(saved["params"]),
                            opt.tree_leaves(params2)):
        assert np.array_equal(p.numpy(), g), path
    outs = []
    for mesh in (None, make_host_mesh(device="cpu")):
        d = str(tmp_path / ("mesh" if mesh else "plain"))
        os.makedirs(d)
        os.symlink(os.path.join(dirs["resume"], "step_4"),
                   os.path.join(d, "step_4"))
        capsys.readouterr()
        outs.append(train_mod.train("xlstm-125m", device="cpu",
                                    log_every=100, mesh=mesh,
                                    **dict(RUN, steps=6, ckpt_dir=d)))
        assert "resumed from step 4" in capsys.readouterr().out
    (pa, la), (pb, lb) = outs
    assert len(la) == 2 and la == lb
    for a, b in zip(opt.tree_leaves(pa), opt.tree_leaves(pb)):
        assert torch.equal(a.detach(), b)


# -- refusals -----------------------------------------------------------------


def test_what_the_data_axis_does_not_cover_raises(world2):
    """``model_parallel=2`` runs on a world of two ranks (tensor
    parallel, ``(data 1, model 2)``) and matches the unsharded run; in
    one process it raises the mesh's error for a world smaller than its
    shape.  An MoE model split over ranks and Adafactor on a leaf split
    over ranks (of ``"data"`` or of ``"model"``) build a step (their
    values: ``tests/test_torch_moe_axis.py``), MoE with ``accum_steps``
    > 1 over two data ranks too; at W = 1 Adafactor and MoE train."""
    _, ranks = world2
    hist = []
    want_p, want_l = train_mod.train("xlstm-125m", device="cpu",
                                     log_every=100, history=hist, **RUN)
    for r in ranks:
        got_l, got_p, got_n = r["train_tp"]
        np.testing.assert_allclose(got_l, want_l, **TOL)
        np.testing.assert_allclose(got_n, [h["grad_norm"] for h in hist],
                                   **TOL)
        for (path, want), g in zip(opt.tree_paths(want_p),
                                   opt.tree_leaves(got_p)):
            np.testing.assert_allclose(g, want.detach().numpy(),
                                       **PARAM_TOL, err_msg=str(path))
    with pytest.raises(ValueError, match="ranks"):
        train_mod.train("xlstm-125m", steps=1, device="cpu",
                        model_parallel=2)
    two = _fake_mesh(2, 0)
    tp = types.SimpleNamespace(axis_names=("data", "model"),
                               shape={"data": 1, "model": 2},
                               coords={"data": 0, "model": 0},
                               groups={"data": None, "model": None})
    for mesh in (two, tp):
        for arch, kind in (("deepseek-moe-16b", "adamw"),
                           ("deepseek-moe-16b", "adafactor"),
                           ("xlstm-125m", "adafactor"),
                           ("xlstm-125m", "adamw")):
            cfg = configs.get(arch, smoke=True)
            specs = sh.tree_specs(T.param_specs(cfg),
                                  T.init_params(cfg, 0, torch.float32,
                                                "cpu"),
                                  mesh, make_rules(mesh, "train"))
            step_fn, _ = steps.make_sharded_train_step(
                cfg, OptConfig(kind=kind), mesh, specs)
            assert callable(step_fn)
            if arch == "deepseek-moe-16b" and mesh is two:
                step_fn, _ = steps.make_sharded_train_step(
                    cfg, OptConfig(kind=kind), mesh, specs, accum_steps=2)
                assert callable(step_fn)
    one = make_host_mesh(device="cpu")
    cfg = configs.get("xlstm-125m", smoke=True)
    params = T.init_params(cfg, 0, torch.float32, "cpu")
    specs = sh.tree_specs(T.param_specs(cfg), params, one,
                          make_rules(one, "train"))
    step_fn, init = steps.make_sharded_train_step(
        cfg, OptConfig(kind="adafactor", lr=1e-3), one, specs, remat="none")
    batch = next(pipe.make_train_iterator(
        train_mod.data_config(cfg, batch=2, seq=16, seed=0), device="cpu",
        sharding=one))
    blocks = steps.param_blocks(params, specs, one)
    _, _, m = step_fn(blocks, init(blocks), batch)
    assert torch.isfinite(m["loss"])
