"""Checkpoints and resume (ROADMAP A7b) against the JAX package.

* The twins of ``tests/test_substrates.py``'s checkpoint tests (round
  trip, rotation with async saves, atomicity after a partial write,
  assembly from shards), the port's functions and the reference's on
  the same trees.
* The port reads the reference's files bit for bit (bf16, a 0-d int32
  step, shards keyed ``0:-1`` and ``|full``, and the sliced keys two
  hosts write); the reference reads the port's shards given a msgpack
  manifest, and the manifests agree.
* An async save is a snapshot; a failed write is raised.
* ``train`` resumed equals ``train`` uninterrupted bit for bit (losses,
  parameters, moments, step) for xLSTM and Zamba2 (B4 and B5 on the
  resume path), and AdamW's and Adafactor's state survive
  ``CheckpointManager``.
* ``train`` resumes a run the reference trained and saved, and matches
  the reference's uninterrupted losses within ``tests/test_torch_train.
  py``'s ``TOL`` (f32, the packages sum in other orders).
* The reference's resumed loop replays batch 0; the port's reads batch
  ``start``.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.optimizer import OptConfig as JOptConfig
from repro.optimizer import cosine_schedule as jcosine
from repro_torch import checkpoint as ck
from repro_torch import configs
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.data import pipeline as pipe
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as T
from repro_torch.optimizer import optimizers as opt

import torch_resume_worker as resume_worker
from torch_lm_pairs import Model

TOL = dict(atol=1e-4, rtol=1e-4)
#: the resume runs: 28 steps save at 25 (max(28 // 4, 25)) and 28
RUN = dict(steps=28, batch=4, seq=32, lr=3e-3, log_every=100, device="cpu")
RESUME_AT = 25


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def _assert_trees_equal(got, want):
    """Leaf by leaf, bit for bit (tensors by ``torch.equal`` with dtype
    and device, ints by value and type)."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            _assert_trees_equal(g, w)
        elif isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.device == w.device, k
            assert torch.equal(g, w), k
        else:
            assert type(g) is type(w) and g == w, k


# -- the reference's checkpoint tests, in both packages -----------------------


def test_checkpoint_roundtrip(tmp_path):
    w = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    jck.save_checkpoint(str(tmp_path / "ref"), 5,
                        {"params": {"w": jnp.asarray(w)},
                         "step": jnp.asarray(5)})
    ck.save_checkpoint(str(tmp_path / "port"), 5,
                       {"params": {"w": torch.from_numpy(w)}, "step": 5})
    for d in ("ref", "port"):
        assert jck.latest_step(str(tmp_path / d)) == 5
        assert ck.latest_step(str(tmp_path / d)) == 5
    jout = jck.load_checkpoint(str(tmp_path / "ref"), 5,
                               {"params": {"w": np.zeros_like(w)},
                                "step": np.zeros((), np.int32)})
    out = ck.load_checkpoint(str(tmp_path / "port"), 5,
                             {"params": {"w": torch.zeros(3, 4)},
                              "step": 0})
    np.testing.assert_array_equal(jout["params"]["w"], w)
    assert torch.equal(out["params"]["w"], torch.from_numpy(w))
    assert out["step"] == int(jout["step"]) == 5


def test_checkpoint_rotation_and_async(tmp_path):
    jmgr = jck.CheckpointManager(str(tmp_path / "ref"), keep=2, every=1)
    mgr = ck.CheckpointManager(str(tmp_path / "port"), keep=2, every=1)
    for s in range(1, 5):
        jmgr.maybe_save(s, {"w": jnp.ones(4) * s})
        mgr.maybe_save(s, {"w": torch.ones(4) * s})
    jmgr.wait()
    mgr.wait()
    for d in ("ref", "port"):
        assert sorted(os.listdir(tmp_path / d)) == ["step_3", "step_4"]
    jrestored, jstep = jmgr.restore_latest({"w": np.zeros(4, np.float32)})
    restored, step = mgr.restore_latest({"w": torch.zeros(4)})
    assert step == jstep == 4
    np.testing.assert_array_equal(restored["w"].numpy(), jrestored["w"])
    np.testing.assert_array_equal(restored["w"].numpy(), 4 * np.ones(4))


def test_checkpoint_atomicity_on_partial_write(tmp_path):
    for d, save, latest, w in (
            ("ref", jck.save_checkpoint, jck.latest_step, jnp.ones(4)),
            ("port", ck.save_checkpoint, ck.latest_step, torch.ones(4))):
        save(str(tmp_path / d), 1, {"w": w})
        # a crash mid-write of step 2 leaves only a .tmp directory
        os.makedirs(tmp_path / d / "step_2.tmp")
        assert latest(str(tmp_path / d)) == 1


def test_checkpoint_resharding_shape_agnostic(tmp_path):
    """Restore assembles from shards regardless of writer layout."""
    w = np.arange(16.0, dtype=np.float32).reshape(4, 4)
    jck.save_checkpoint(str(tmp_path / "ref"), 1, {"w": jnp.asarray(w)})
    ck.save_checkpoint(str(tmp_path / "port"), 1, {"w": torch.from_numpy(w)})
    jout = jck.load_checkpoint(str(tmp_path / "ref"), 1,
                               {"w": np.zeros((4, 4), np.float32)})
    np.testing.assert_array_equal(jout["w"], w)
    for d in ("ref", "port"):       # the port reads either writer's layout
        out = ck.load_checkpoint(str(tmp_path / d), 1,
                                 {"w": torch.zeros(4, 4)})
        np.testing.assert_array_equal(out["w"].numpy(), w)


# -- reading the reference's files --------------------------------------------


def _mixed_tree(rng):
    """A tree with every kind of leaf the reference writes: f32 arrays
    (keyed ``0:-1,…``), a bf16 array (``|V2``), a 0-d int32 step
    (``|full``) and a numpy int64 array (``|full``)."""
    return {"params": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                       "b": rng.standard_normal(5).astype(np.float32),
                       "h": rng.standard_normal((2, 4)).astype(np.float32)},
            "opt": {"m": {"w": rng.standard_normal((3, 5))
                          .astype(np.float32)},
                    "step": np.int32(7)},
            "ids": np.arange(6, dtype=np.int64)}


def test_port_reads_the_reference_files_bit_for_bit(tmp_path):
    tree = _mixed_tree(np.random.default_rng(0))
    bf16 = jnp.asarray(tree["params"]["h"], jnp.bfloat16)
    jtree = {"params": {"w": jnp.asarray(tree["params"]["w"]),
                        "b": jnp.asarray(tree["params"]["b"]),
                        "h": bf16},
             "opt": {"m": {"w": jnp.asarray(tree["opt"]["m"]["w"])},
                     "step": jnp.asarray(7, jnp.int32)},
             "ids": tree["ids"]}
    jck.save_checkpoint(str(tmp_path), 7, jtree)
    keys = np.load(tmp_path / "step_7" / "shards_h0.npz").files
    assert "['params']['w']|0:-1,0:-1" in keys
    assert "['opt']['step']|full" in keys and "['ids']|full" in keys
    like = {"opt": {"step": 0, "m": {"w": torch.zeros(3, 5)}},
            "ids": torch.zeros(6, dtype=torch.int64),
            "params": {"h": torch.zeros(2, 4, dtype=torch.bfloat16),
                       "b": torch.zeros(5), "w": torch.zeros(3, 5)}}
    out = ck.load_checkpoint(str(tmp_path), 7, like)
    assert list(out) == list(like)           # the target's order, by name
    assert out["opt"]["step"] == 7 and type(out["opt"]["step"]) is int
    h = out["params"]["h"]
    assert h.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        h.view(torch.int16).numpy(),
        np.asarray(bf16).view(np.int16))     # the bits, not the values
    for path in (("params", "w"), ("params", "b"), ("opt", "m", "w"),
                 ("ids",)):
        got, want = opt.tree_at(out, path), opt.tree_at(tree, path)
        assert got.dtype == opt.tree_at(like, path).dtype
        np.testing.assert_array_equal(got.numpy(), want)


def _two_host_files(path, w, extra):
    """The shards two hosts write of ``w`` split on axis 0, plus a
    replicated tensor that both write."""
    os.makedirs(path)
    half = w.shape[0] // 2
    for host, sl in enumerate((f"0:{half}", f"{half}:-1")):
        lo, hi = (0, half) if host == 0 else (half, w.shape[0])
        np.savez(os.path.join(path, f"shards_h{host}.npz"),
                 **{f"['w']|{sl},0:-1": w[lo:hi],
                    "['e']|0:-1": extra})
    with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
        f.write(msgpack.packb({"step": 3}))


def test_port_assembles_what_two_hosts_wrote(tmp_path):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    extra = rng.standard_normal(3).astype(np.float32)
    _two_host_files(str(tmp_path / "step_3"), w, extra)
    jout = jck.load_checkpoint(str(tmp_path), 3,
                               {"w": np.zeros((6, 4), np.float32),
                                "e": np.zeros(3, np.float32)})
    out = ck.load_checkpoint(str(tmp_path), 3,
                             {"w": torch.zeros(6, 4), "e": torch.zeros(3)})
    for k in ("w", "e"):
        np.testing.assert_array_equal(out[k].numpy(), jout[k])
    np.testing.assert_array_equal(out["w"].numpy(), w)


def test_port_refuses_what_does_not_fit_the_target(tmp_path):
    """The reference zero-fills a tensor its shards do not cover; the
    port raises, as it does on a missing tensor or another shape."""
    w = np.ones((6, 4), np.float32)
    path = tmp_path / "step_3"
    _two_host_files(str(path), w, np.zeros(3, np.float32))
    os.remove(path / "shards_h1.npz")
    like = {"w": torch.zeros(6, 4), "e": torch.zeros(3)}
    jout = jck.load_checkpoint(str(tmp_path), 3, _np_tree(like))
    assert not jout["w"][3:].any()                  # the reference's zeros
    with pytest.raises(ValueError, match="cover"):
        ck.load_checkpoint(str(tmp_path), 3, like)
    ck.save_checkpoint(str(tmp_path), 4, {"w": torch.ones(2, 3)})
    with pytest.raises(KeyError, match="missing tensor"):
        ck.load_checkpoint(str(tmp_path), 4, {"v": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        ck.load_checkpoint(str(tmp_path), 4, {"w": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="mesh"):
        ck.load_checkpoint(str(tmp_path), 4, {"w": torch.zeros(2, 3)},
                           shardings={"w": None})


def test_reference_reads_the_port_shards_and_the_manifests_agree(tmp_path):
    """Given a msgpack copy of the port's manifest, the reference loads
    the port's shards, bit for bit; the port's manifest holds the
    reference's names, structure, shapes and dtypes.  (The reference
    cannot load its own bf16 leaf: it assembles a ``0:-1`` shard into a
    bf16 array, and numpy has no cast from ``|V2``; the port's whole
    ``|full`` shards it takes as they are.)"""
    tree = _mixed_tree(np.random.default_rng(2))
    h = torch.from_numpy(tree["params"]["h"]).to(torch.bfloat16)
    port_tree = {"params": {"w": torch.from_numpy(tree["params"]["w"]),
                            "b": torch.from_numpy(tree["params"]["b"]),
                            "h": h},
                 "opt": {"m": {"w": torch.from_numpy(tree["opt"]["m"]["w"])},
                         "step": 7},
                 "ids": torch.from_numpy(tree["ids"])}
    jtree = {"params": {"w": jnp.asarray(tree["params"]["w"]),
                        "b": jnp.asarray(tree["params"]["b"]),
                        "h": jnp.asarray(tree["params"]["h"], jnp.bfloat16)},
             "opt": {"m": {"w": jnp.asarray(tree["opt"]["m"]["w"])},
                     "step": jnp.asarray(7, jnp.int32)},
             "ids": tree["ids"]}
    ck.save_checkpoint(str(tmp_path / "port"), 7, port_tree)
    jck.save_checkpoint(str(tmp_path / "ref"), 7, jtree)
    step_dir = tmp_path / "port" / "step_7"
    meta = json.loads((step_dir / "manifest.json").read_text())
    with open(tmp_path / "ref" / "step_7" / "manifest.msgpack", "rb") as f:
        jmeta = msgpack.unpackb(f.read())
    assert meta == jmeta
    (step_dir / "manifest.msgpack").write_bytes(msgpack.packb(meta))
    like = jax.tree.map(lambda x: np.zeros(np.shape(x), np.asarray(x).dtype),
                        jtree)
    jout = jck.load_checkpoint(str(tmp_path / "port"), 7, like)
    with pytest.raises(ValueError, match="cast"):
        jck.load_checkpoint(str(tmp_path / "ref"), 7, like)
    for (path, got), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(jout)[0],
            jax.tree_util.tree_flatten_with_path(jtree)[0]):
        got, w = np.asarray(got), np.asarray(w)
        assert got.dtype.itemsize == w.dtype.itemsize, path
        assert got.shape == w.shape, path
        assert got.tobytes() == w.tobytes(), path


def test_leaf_names_are_jax_keystr():
    tree = {"opt": {"m": {"stack": {"rec": {"w_in": 0}}}, "step": 0},
            "params": {"embed": 0}}
    want = [jax.tree_util.keystr(kp) for kp, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [n for n, _ in ckpt._flatten(tree)] == want
    assert want[0] == "['opt']['m']['stack']['rec']['w_in']"
    assert f"PyTreeDef({ckpt._structure(tree)})" == \
        str(jax.tree_util.tree_structure(tree))


# -- snapshots and errors -----------------------------------------------------


def test_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """The writer is held until the caller has updated the tree in place
    (as the optimizer does): the file holds the values at save time."""
    gate, real_savez = threading.Event(), np.savez

    def held(*a, **kw):
        assert gate.wait(30)
        return real_savez(*a, **kw)
    monkeypatch.setattr(np, "savez", held)
    w = torch.arange(8.0)
    m = torch.ones(2, 2, dtype=torch.bfloat16)
    mgr = ck.CheckpointManager(str(tmp_path), every=1)
    mgr.maybe_save(1, {"w": w, "opt": {"m": m, "step": 1}})
    assert mgr.writing()
    with torch.no_grad():
        w.add_(100.0)
        m.mul_(3)
    gate.set()
    mgr.wait()
    out = ck.load_checkpoint(str(tmp_path), 1,
                             {"w": torch.zeros(8), "opt": {
                                 "m": torch.zeros(2, 2, dtype=torch.bfloat16),
                                 "step": 0}})
    assert torch.equal(out["w"], torch.arange(8.0))
    assert torch.equal(out["opt"]["m"], torch.ones(2, 2,
                                                   dtype=torch.bfloat16))


def test_a_failed_write_is_raised(tmp_path):
    """``wait()`` raises what the writer raised, and so does the next
    ``maybe_save``; the failed step is not listed."""
    (tmp_path / "step_1.tmp").write_text("not a directory")
    mgr = ck.CheckpointManager(str(tmp_path), every=1)
    mgr.maybe_save(1, {"w": torch.ones(2)})
    with pytest.raises(FileExistsError):
        mgr.wait()
    mgr.wait()                               # raised once
    (tmp_path / "step_2.tmp").write_text("not a directory")
    mgr.maybe_save(2, {"w": torch.ones(2)})
    with pytest.raises(FileExistsError):
        mgr.maybe_save(3, {"w": torch.ones(2)})
    assert ck.latest_steps(str(tmp_path)) == []


def test_saving_from_a_world_of_two_ranks_raises(monkeypatch, tmp_path):
    """Without its blocks' layout: a world of ranks saves sharded state
    (``shardings=`` and ``mesh=``) or nothing."""
    monkeypatch.setattr(ckpt, "host_and_count", lambda: (0, 2))
    with pytest.raises(ValueError, match="shardings= and mesh="):
        ck.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    assert ck.latest_steps(str(tmp_path)) == []


def test_manager_save_stats_and_repeated_step(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), every=2)
    started = [mgr.maybe_save(s, {"w": torch.ones(3) * s})
               for s in range(1, 5)]
    assert started[0] is None and started[2] is None
    assert mgr.maybe_save(4, {"w": torch.zeros(3)}, force=True) is None
    mgr.wait()                                             # saved already
    stats = [started[1].stats, started[3].stats]
    assert [r["step"] for r in stats] == [2, 4]
    assert all(r["bytes"] == 12 and r["write_s"] > 0 and
               r["snapshot_ms"] > 0 for r in stats)
    tree, step = mgr.restore_latest({"w": torch.zeros(3)})
    assert step == 4 and torch.equal(tree["w"], torch.full((3,), 4.0))


def _mixed_like():
    """A zero target for :func:`_mixed_tree`, in the port's kinds."""
    return {"params": {"w": torch.zeros(3, 5), "b": torch.zeros(5),
                       "h": torch.zeros(2, 4, dtype=torch.bfloat16)},
            "opt": {"m": {"w": torch.zeros(3, 5)}, "step": 0},
            "ids": torch.zeros(6, dtype=torch.int64)}


def test_a_finished_write_lets_its_host_copy_go(tmp_path, monkeypatch):
    """The handle ``maybe_save`` returns keeps its stats, not the host
    copy of the state, once the write has ended."""
    held, real_savez = [], np.savez

    def savez(f, **arrays):
        held.extend(weakref.ref(a) for a in arrays.values())
        return real_savez(f, **arrays)
    monkeypatch.setattr(np, "savez", savez)
    mgr = ck.CheckpointManager(str(tmp_path), every=1)
    pending = mgr.maybe_save(1, {"w": torch.ones(1000), "step": 1})
    mgr.wait()
    gc.collect()
    assert len(held) == 2 and all(r() is None for r in held)
    assert pending.stats["bytes"] == 4004 and pending.stats["write_s"] > 0


def test_inplace_restore_writes_into_the_target(tmp_path):
    """``inplace=True``: the target's own tensors (a parameter still a
    leaf that requires grad) hold what the copying restore returns, bf16
    and the int step included, from the port's file and the reference's;
    a missing name raises before anything is written."""
    tree = _mixed_tree(np.random.default_rng(2))
    jtree = {"params": {"w": jnp.asarray(tree["params"]["w"]),
                        "b": jnp.asarray(tree["params"]["b"]),
                        "h": jnp.asarray(tree["params"]["h"], jnp.bfloat16)},
             "opt": {"m": {"w": jnp.asarray(tree["opt"]["m"]["w"])},
                     "step": jnp.asarray(7, jnp.int32)},
             "ids": tree["ids"]}
    jck.save_checkpoint(str(tmp_path / "ref"), 7, jtree)
    port = ck.load_checkpoint(str(tmp_path / "ref"), 7, _mixed_like())
    ck.save_checkpoint(str(tmp_path / "port"), 7, port)
    for d in ("ref", "port"):
        like = _mixed_like()
        like["params"]["w"].requires_grad_(True)
        leaves = [x for x in opt.tree_leaves(like)
                  if isinstance(x, torch.Tensor)]
        mgr = ck.CheckpointManager(str(tmp_path / d))
        out, step = mgr.restore_latest(like, inplace=True)
        assert out is like and step == 7
        assert like["params"]["w"].requires_grad
        assert all(x is y for x, y in zip(
            [x for x in opt.tree_leaves(like)
             if isinstance(x, torch.Tensor)], leaves))
        _assert_trees_equal({**like, "params": _clone(like["params"])},
                            port)
    like = {**_mixed_like(), "extra": torch.zeros(2)}
    with pytest.raises(KeyError, match="extra"):
        ck.load_checkpoint(str(tmp_path / "port"), 7, like, inplace=True)
    _assert_trees_equal(like, {**_mixed_like(), "extra": torch.zeros(2)})


# -- resume ------------------------------------------------------------------


def _like(arch, dtype=torch.float32):
    """The state ``train`` builds before it restores (seed 0)."""
    cfg = configs.get(arch, smoke=True)
    params = T.init_params(cfg, 0, dtype, "cpu")
    return {"params": params, "opt": opt.adamw_init(params)}


def _three_runs(arch, dtype, out):
    """The plain run, run A and run B, in a process of their own with the
    intra-op thread count pinned and MKL's dynamic threading off
    (``tests/torch_resume_worker.py``): what bit for bit needs, and what
    an xdist worker beside five others does not give (MKL dispatched one
    run's GEMMs to another code path under that load).  Returns the
    runs and the process's standard output."""
    env = {**os.environ, **resume_worker.PINNED,
           "PYTHONPATH": os.pathsep.join(
               [str(Path(__file__).resolve().parents[1] / "src")]
               + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).with_name(
            "torch_resume_worker.py")), arch, str(dtype).split(".")[-1],
         str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    runs = torch.load(os.path.join(out, "runs.pt"), weights_only=False)
    assert runs["threads"] == int(resume_worker.PINNED["OMP_NUM_THREADS"])
    return runs, proc.stdout


@pytest.mark.parametrize("arch, dtype", [("xlstm-125m", torch.float32),
                                         ("zamba2-2.7b", torch.float32),
                                         ("xlstm-125m", torch.bfloat16)])
def test_resumed_train_equals_uninterrupted(tmp_path, arch, dtype):
    """Run A saves at 25 and 28; run B starts from a directory holding
    only A's step 25 and runs 25–27.  A's losses equal a run without
    checkpoints; B's restore equals A's step 25 (its fresh weights do
    not); B's losses, parameters, moments and step equal A's, bit for
    bit."""
    assert resume_worker.RUN == RUN and resume_worker.RESUME_AT == RESUME_AT
    runs, out = _three_runs(arch, dtype, tmp_path)
    plain, losses_a, hist_a = runs["plain"], runs["losses_a"], runs["hist_a"]
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    params_a = runs["params_a"]
    assert losses_a == plain
    assert runs["steps_a"] == [f"step_{RESUME_AT}", "step_28"]
    assert ck.latest_steps(a_dir) == [RESUME_AT, 28]
    assert [h["step"] for h in hist_a] == list(range(28))
    hist_b, params_b, losses_b = (runs["hist_b"], runs["params_b"],
                                  runs["losses_b"])
    assert f"resumed from step {RESUME_AT}" in out.split("-- run B --")[1]
    assert [h["step"] for h in hist_b] == [25, 26, 27]
    assert losses_b == losses_a[RESUME_AT:]
    like = _like(arch, dtype)
    saved = ck.load_checkpoint(a_dir, RESUME_AT, like)
    assert saved["opt"]["step"] == RESUME_AT
    assert not all(torch.equal(x, y) for x, y in zip(
        opt.tree_leaves(like["params"]), opt.tree_leaves(saved["params"])))
    _assert_trees_equal(ck.load_checkpoint(b_dir, 28, like),
                        ck.load_checkpoint(a_dir, 28, like))
    for x, y in zip(opt.tree_leaves(params_b), opt.tree_leaves(params_a)):
        assert x.requires_grad and x.dtype == y.dtype
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_state_resumes_through_the_manager(tmp_path, kind):
    """Four train steps straight, against two, a save and restore into a
    fresh state, and two more: equal bit for bit."""
    m = Model.build("xlstm-125m")
    step_fn, init = steps.make_train_step(
        m.cfg, opt.OptConfig(kind=kind, lr=3e-3), remat="none")
    dcfg = train_mod.data_config(m.cfg, batch=2, seq=16, seed=0)
    stream = pipe.synthetic_stream(dcfg)
    batches = [{k: torch.from_numpy(v) for k, v in next(stream).items()}
               for _ in range(4)]

    def fresh():
        params = _clone(m.params)
        for p in opt.tree_leaves(params):
            p.requires_grad_(True)
        return params, init(params)
    p1, s1 = fresh()
    for b in batches:
        p1, s1, _ = step_fn(p1, s1, b)
    p2, s2 = fresh()
    for b in batches[:2]:
        p2, s2, _ = step_fn(p2, s2, b)
    mgr = ck.CheckpointManager(str(tmp_path), every=2)
    mgr.maybe_save(2, {"params": p2, "opt": s2})
    mgr.wait()
    p3, s3 = fresh()
    restored, at = mgr.restore_latest({"params": p3, "opt": s3},
                                      inplace=True)
    assert at == 2 and s3["step"] == 2 and restored["params"] is p3
    for b in batches[2:]:
        p3, s3, _ = step_fn(p3, s3, b)
    _assert_trees_equal({"params": _clone(p3), "opt": s3},
                        {"params": _clone(p1), "opt": s1})


# -- the reference's run, resumed in the port --------------------------------

#: the reference's run: N steps straight, a checkpoint after K
REF_ARCH, REF_N, REF_K, REF_BATCH, REF_SEQ, REF_LR = (
    "xlstm-125m", 6, 3, 4, 32, 3e-3)


def test_port_resumes_a_run_the_reference_saved(tmp_path, capsys):
    """The reference trains ``REF_N`` steps with its own train step (the
    schedule, optimizer and data ``train`` would give it), saving
    ``{"params", "opt"}`` after ``REF_K``; the port's ``train`` resumes
    that directory and its losses at ``REF_K…`` match the reference's."""
    m = Model.build(REF_ARCH)
    sched = jcosine(REF_LR, warmup=max(REF_N // 20, 5), total=REF_N)
    assert m.jcfg.schedule != "wsd"
    step_fn, init = jsteps.make_train_step(m.jcfg, JOptConfig(lr=sched),
                                           remat="none")
    step_fn = jax.jit(step_fn)
    dcfg = jpipe.DataConfig(seq_len=REF_SEQ, global_batch=REF_BATCH,
                            vocab=m.jcfg.vocab, seed=0)
    data = jpipe.synthetic_stream(dcfg)
    params, state = m.jparams, init(m.jparams)
    losses = []
    for i in range(REF_N):
        b = {k: jnp.asarray(v) for k, v in next(data).items()}
        params, state, metrics = step_fn(params, state, b)
        losses.append(float(metrics["loss"]))
        if i + 1 == REF_K:
            jck.save_checkpoint(str(tmp_path), REF_K,
                                {"params": params, "opt": state})
    capsys.readouterr()
    _, port_losses = train_mod.train(
        REF_ARCH, steps=REF_N, batch=REF_BATCH, seq=REF_SEQ, lr=REF_LR,
        device="cpu", ckpt_dir=str(tmp_path), log_every=100)
    assert f"resumed from step {REF_K}" in capsys.readouterr().out
    assert len(port_losses) == REF_N - REF_K
    np.testing.assert_allclose(port_losses, losses[REF_K:], **TOL)
    assert ck.latest_steps(str(tmp_path)) == [REF_K, REF_N]


def test_the_reference_replays_batch_zero_on_resume(tmp_path, monkeypatch):
    """The reference's ``train`` builds its iterator without
    ``start_step`` (``repro/launch/train.py:62``), so a run resumed at
    ``start`` feeds batch 0 to step ``start``; the port's feeds batch
    ``start``.  The reference's train step is replaced by one that only
    returns (its real step cannot run under the reference's mesh on this
    JAX: ROADMAP C), so the loop, its checkpoints and its iterator are
    the reference's own."""
    steps_n, start = 6, 3
    fed = {"reference": [], "port": []}

    def spy(real, who):
        def make(dcfg, **kw):
            for b in real(dcfg, **kw):
                fed[who].append(np.asarray(b["tokens"]))
                yield b
        return make

    def idle_step(cfg, opt_cfg, **kw):
        from repro.optimizer import adamw_init
        return ((lambda p, s, b: (p, s, {
            "loss": jnp.sum(b["tokens"]) * 0.0, "grad_norm": jnp.zeros(())})),
            adamw_init)
    monkeypatch.setattr(jtrain.steps_mod, "make_train_step", idle_step)
    monkeypatch.setattr(jtrain, "make_train_iterator",
                        spy(jtrain.make_train_iterator, "reference"))
    monkeypatch.setattr(train_mod, "make_train_iterator",
                        spy(train_mod.make_train_iterator, "port"))
    kw = dict(batch=2, seq=16, log_every=100)
    for who, run in (("reference", lambda n, d: jtrain.train(
            "xlstm-125m", steps=n, ckpt_dir=d, **kw)),
                     ("port", lambda n, d: train_mod.train(
            "xlstm-125m", steps=n, ckpt_dir=d, device="cpu", **kw))):
        d = str(tmp_path / who)
        run(start, d)                                  # saves step `start`
        fed[who].clear()
        run(steps_n, d)                                # resumes at `start`
    vocab = configs.get("xlstm-125m", smoke=True).vocab
    dcfg = jpipe.DataConfig(seq_len=16, global_batch=2, vocab=vocab)

    def batch(i):
        return next(jpipe.synthetic_stream(dcfg, start_step=i))["tokens"]
    np.testing.assert_array_equal(fed["reference"][0], batch(0))
    np.testing.assert_array_equal(fed["port"][0], batch(start))
    assert not np.array_equal(batch(0), batch(start))


def test_train_heartbeats_reach_the_coordinator(tmp_path):
    """``heartbeat_dir`` gets host 0's file; the port's coordinator reads
    it alive at the last step run."""
    from repro_torch.distributed import fault_tolerance as ft
    hb = str(tmp_path / "hb")
    train_mod.train("xlstm-125m", steps=3, batch=2, seq=16, device="cpu",
                    heartbeat_dir=hb, log_every=100)
    (st,) = ft.Coordinator(ft.FTConfig(hb), 1).poll()
    assert dataclasses.astuple(st)[:3] == (0, True, 2)


def test_train_past_its_last_step_saves_nothing(tmp_path, capsys):
    """A directory whose latest checkpoint is at or past ``steps``: the
    run restores it, trains no step and writes no checkpoint."""
    kw = dict(batch=2, seq=16, device="cpu", log_every=100,
              ckpt_dir=str(tmp_path))
    train_mod.train("xlstm-125m", steps=4, **kw)
    for steps in (4, 2):
        _, losses = train_mod.train("xlstm-125m", steps=steps, **kw)
        assert losses == []
        assert "resumed from step 4" in capsys.readouterr().out
        assert ck.latest_steps(str(tmp_path)) == [4]
