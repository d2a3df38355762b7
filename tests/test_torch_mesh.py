"""Logical-axis rules, meshes, compressed reductions, GPipe and the
query-batch server (ROADMAP A7c-1) against the JAX package.

* ``spec_for``, ``make_rules``, ``cache_spec_tree`` and
  ``batch_logical`` against the reference's, over meshes 1×1, 2×1,
  4×1, 2×2, 16×16 and 2×16×16 (the reference's ``spec_for`` reads only
  ``mesh.shape``) and every logical tuple of ``param_specs(cfg)`` of the
  ten smoke configs at their shapes; ``param_specs`` equal to the specs
  tree the reference's ``init_params`` returns.
* In a spawned world of 4 gloo ranks: ``bf16_all_reduce``,
  ``int8_all_reduce`` and ``compressed_grad_reduce`` against the
  reference's ``shard_map`` collectives on 4 XLA CPU devices (a
  subprocess), and ``run_pipeline`` against the reference's at its own
  test's inputs (S 4, M 8, B 2, D 16, seed 0) within 2e-4 and against
  the sequential stack.
* A checkpoint the reference saved from a tree sharded over 4 devices,
  read whole and in blocks.
* ``DatalogServer`` on ``make_datalog_mesh(d)`` at d = 1 (this
  process), 2, 3 and 4 (spawned worlds; 3 does not divide the buckets,
  so each rank runs the whole batch): answers, ``iters``, delivery
  order and ``stats`` equal the one-device server's and the
  reference's unmeshed server's (its own query-batch mesh fails on this
  JAX: ROADMAP C).
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro import configs as jconfigs
from repro.datalog import datasets as jdata
from repro.distributed import sharding as jsh
from repro.launch import rules as jrules
from repro.launch.datalog_serve import DatalogServer as JServer
from repro.models import transformer as JT
from repro_torch import checkpoint as ck
from repro_torch import configs
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.pipeline import bubble_fraction
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import rules
from repro_torch.launch.datalog_serve import DatalogServer
from repro_torch.models import transformer as T

import torch_mesh_worker as worker
from torch_serve_pairs import Sssp, bm_dbs, counters, jmk_bm

ROOT = Path(__file__).resolve().parents[1]
ARCHS = configs.list_archs()
MESHES = {"1x1": (1, 1), "2x1": (2, 1), "4x1": (4, 1), "2x2": (2, 2),
          "16x16": (16, 16), "2x16x16": (2, 16, 16)}
#: the reference pipeline test's inputs and tolerance
S, M, B, D = 4, 8, 2, 16
PIPE_TOL = dict(rtol=2e-4, atol=2e-4)


def _shape_mesh(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)),
                                 coords={a: 0 for a in names})


def _logical_leaves(tree, params, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _logical_leaves(v, params[k], out)
        else:
            out.append((tuple(v), tuple(params[k].shape)))
    return out


# -- rules and specs ----------------------------------------------------------


def test_partition_spec_equality_is_the_reference_s():
    from jax.sharding import PartitionSpec as JP
    for parts in [(), (None,), ("data",), ("data", None),
                  (("data", "model"), None)]:
        assert P(*parts) == tuple(JP(*parts)) == JP(*parts)
    assert (P("data") == P("data", None)) == (JP("data") == JP("data", None))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference_init_specs(arch):
    """The reference's own ``param_specs`` fails under ``eval_shape`` on
    this JAX (ROADMAP C); its ``init_params`` specs tree, through
    ``shape_init``, is the oracle."""
    want = JT.shape_init(jconfigs.get(arch, smoke=True))[1]
    got = T.param_specs(configs.get(arch, smoke=True))

    def norm(t):
        return ({k: norm(v) for k, v in t.items()} if isinstance(t, dict)
                else tuple(t))
    assert got == norm(want)
    params = T.init_params(configs.get(arch, smoke=True), 0, torch.float32,
                           "cpu")
    assert len(_logical_leaves(got, params, [])) == len(
        jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", ["train", "decode", "datalog"])
def test_rules_and_spec_for_equal_the_reference(mesh, kind):
    m = _shape_mesh(MESHES[mesh])
    want = jrules.make_rules(m, kind)
    got = rules.make_rules(m, kind)
    assert got == want
    leaves = {}
    for arch in ARCHS:
        cfg = configs.get(arch, smoke=True)
        for logical, shape in _logical_leaves(
                T.param_specs(cfg), T.init_params(cfg, 0, torch.float32,
                                                  "cpu"), []):
            leaves[(logical, shape)] = None
    for name in ("tokens", "labels", "embeds", "enc_embeds"):
        assert rules.batch_logical(name) == jrules.batch_logical(name)
        for shape in ((32, 128, 64), (6, 10, 4), (1, 7, 3)):
            lg = rules.batch_logical(name)
            leaves[(lg, shape[:len(lg)])] = None
    for logical in rules.CACHE_LOGICAL.values():
        leaves[(logical, (4, 32, 64, 16, 8)[:len(logical)])] = None
    assert len(leaves) > 50
    for logical, shape in leaves:
        ref = jsh.spec_for(logical, shape, m, want)
        port = sh.spec_for(logical, shape, m, got)
        assert tuple(port) == tuple(ref), (logical, shape)
        assert tuple(sh.spec_for(logical, None, m, got)) == tuple(
            jsh.spec_for(logical, None, m, want))
    with pytest.raises(KeyError):
        rules.batch_logical("mask")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_tree_equals_the_reference(arch):
    """On the reference's cache tree and on the port's (as numpy), the
    two functions give the same logical tree."""
    jcfg = jconfigs.get(arch, smoke=True)
    jcache = (JT.init_cache(jcfg, 2, 16, enc_len=8)
              if jcfg.family == "encdec" else JT.init_cache(jcfg, 2, 16))
    pcache = T.init_cache(configs.get(arch, smoke=True), 2, 16,
                          device="cpu")

    def as_np(t):
        if isinstance(t, dict):
            return {k: as_np(v) for k, v in t.items() if v is not None}
        if isinstance(t, list):
            return [as_np(v) for v in t]
        return np.asarray(t)

    def norm(t):
        if isinstance(t, dict):
            return {k: norm(v) for k, v in t.items()}
        if isinstance(t, list):
            return [norm(v) for v in t]
        return tuple(t)
    for tree in (as_np(jcache), as_np(pcache)):
        assert norm(rules.cache_spec_tree(tree)) == \
            norm(jrules.cache_spec_tree(tree))


def test_block_slices_put_and_gather_on_one_rank():
    m = _shape_mesh((4, 1))
    m.coords = {"data": 2, "model": 0}
    assert sh.block_slices((8, 6), P("data", "model"), m) == (
        slice(4, 6), slice(0, 6))
    assert sh.global_shape((2, 6), P("data", None), m) == (8, 6)
    x = torch.arange(48.0).reshape(8, 6)
    with sh.use_rules(m, rules.make_rules(m, "datalog")):
        assert torch.equal(sh.put(x, ("query_batch", "vertex")), x[4:6])
        assert torch.equal(sh.put(x[:6], ("query_batch", "vertex")), x[:6])
        assert sh.constrain(x, ("query_batch", "vertex")) is x
    assert sh.current_mesh() is None and sh.put(x, ("batch",)) is x
    with pytest.raises(ValueError, match="split"):
        sh.block_slices((6,), P("data"), m)


def test_mesh_makers_on_one_rank():
    """A one-rank world: the host and data meshes span it; the
    production mesh and more ranks than the world raise, naming the
    ranks they need."""
    host = mesh_mod.make_host_mesh(device="cpu")
    assert (host.axis_names, host.shape, host.coords) == (
        ("data", "model"), {"data": 1, "model": 1}, {"data": 0, "model": 0})
    data = mesh_mod.make_datalog_mesh(1, device="cpu")
    assert (data.axis_names, data.shape, data.size) == (("data",),
                                                        {"data": 1}, 1)
    assert data.device_mesh.mesh_dim_names == ("data",)
    for fn, what in ((lambda: mesh_mod.make_production_mesh(device="cpu"),
                      "256 ranks"),
                     (lambda: mesh_mod.make_production_mesh(
                         multi_pod=True, device="cpu"), "512 ranks"),
                     (lambda: mesh_mod.make_datalog_mesh(2, device="cpu"),
                      "2 ranks"),
                     (lambda: mesh_mod.make_host_mesh(2, device="cpu"),
                      "2 does not divide")):
        with pytest.raises(ValueError, match=what):
            fn()


def test_bubble_fraction():
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-12
    assert bubble_fraction(1, 5) == 0.0


# -- the reference in 4 XLA devices, and the port in 4 ranks ------------------

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro import checkpoint as jck
from repro.distributed.collectives import (bf16_all_reduce, int8_all_reduce,
                                           compressed_grad_reduce)
from repro.distributed.pipeline import run_pipeline

out, ckpt_dir = sys.argv[1], sys.argv[2]
inp = np.load(out + ".in.npz")
res = {}
mesh = jax.make_mesh((4,), ("stage",))
def stage_fn(params, x):
    return jnp.tanh(x @ params[0][0])
res["pipe"] = np.asarray(run_pipeline(
    mesh, stage_fn, (jnp.asarray(inp["w"]),), jnp.asarray(inp["x"]),
    n_stages=4, n_micro=int(inp["x"].shape[0])))
pod = jax.make_mesh((4,), ("pod",))
body = lambda t: (bf16_all_reduce(t, "pod")[None],
                  int8_all_reduce(t[0], "pod")[None])
f = shard_map(lambda t: (bf16_all_reduce(t, "pod"),
                         int8_all_reduce(t, "pod")),
              mesh=pod, in_specs=(P("pod"),), out_specs=(P("pod"), P("pod")),
              check_rep=False)
b, i = f(jnp.asarray(inp["xs"]))
res["bf16"], res["int8"] = np.asarray(b), np.asarray(i)
for mode in ("bf16", "int8"):
    g = compressed_grad_reduce({"w": jnp.asarray(inp["g"])}, pod, "pod", mode)
    res["tree_" + mode] = np.asarray(g["w"])
data = jax.make_mesh((4,), ("data",))
e = jax.device_put(jnp.asarray(inp["e"]), NamedSharding(data, P(None, "data")))
w = jax.device_put(jnp.asarray(inp["w8"]), NamedSharding(data, P("data")))
jck.save_checkpoint(ckpt_dir, 2, {"e": e, "w": w,
                                  "b": jnp.asarray(inp["b"])})
np.savez(out, **res)
print("REFERENCE_OK")
"""


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, B, D)).astype(np.float32)
    r2 = np.random.default_rng(1)
    return {"w": w, "x": x,
            "xs": r2.standard_normal((4, 8)).astype(np.float32),
            "g": r2.standard_normal((3, 8)).astype(np.float32),
            "e": r2.standard_normal((6, 8)).astype(np.float32),
            "w8": r2.standard_normal((8, 3)).astype(np.float32),
            "b": r2.standard_normal(5).astype(np.float32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's pipeline, collectives and a sharded checkpoint on
    4 XLA CPU devices, in a subprocess (the device count is fixed before
    JAX starts)."""
    tmp = tmp_path_factory.mktemp("ref4")
    inp = _inputs()
    out = str(tmp / "out.npz")
    np.savez(out + ".in.npz", **inp)
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, out, str(tmp / "ckpt")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"}, cwd=str(ROOT))
    assert "REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    return inp, dict(np.load(out)), str(tmp / "ckpt")


# -- query-batch serving ------------------------------------------------------

#: closed-loop rounds (``None`` closes one): 16 BM queries (bucket 16),
#: 5 SSSP (bucket 8), then both families interleaved with a bad source
STREAM = ([("reach", s) for s in range(0, 120, 8)] + [("reach", 3)]
          + [("reach", None)]
          + [("sssp", s) for s in (0, 4, 9, 17, 33)] + [("sssp", None)]
          + [(f, s) for s in (5, 6, 7) for f in ("reach", "sssp")]
          + [("reach", 10_000), ("reach", None)])
MAX_BATCH = 16


def _serve_inputs():
    g = jdata.erdos_renyi(120, 3.0, seed=2)
    h = g.sparse_adjacency().as_np()
    buf = (h.coords, h.values, h.nnz, h.shape, "bool")
    ss = Sssp()
    return (buf, 120), (ss.g.edges, ss.g.weights, ss.n, 4, 48), ss


def _one_device_and_reference():
    bm, ss_in, ss = _serve_inputs()
    port = worker.serve_stream(DatalogServer(max_batch=MAX_BATCH,
                                             warm_answers=0), bm, ss_in,
                               STREAM)
    jsrv = JServer(max_batch=MAX_BATCH, warm_answers=0)
    jdb, _ = bm_dbs()
    jsrv.register("reach", jmk_bm, jdb)
    jsrv.register("sssp", ss.jmk, ss.jdb)
    delivered = []
    for fam, s in STREAM:
        if s is None:
            while jsrv.pending():
                delivered.extend(jsrv.step())
        else:
            jsrv.submit(fam, s)
    while jsrv.pending():
        delivered.extend(jsrv.step())
    ref = ([(r.family, r.source, None if r.error else np.asarray(r.result),
             r.iters, r.error) for r in delivered], dict(jsrv.stats), None)
    return port, ref


def _assert_served_alike(got, want, *, exact_errors=True):
    (gd, gs), (wd, ws) = got[:2], want[:2]
    assert [(f, s) for f, s, *_ in gd] == [(f, s) for f, s, *_ in wd]
    for (f, s, y, it, err), (_, _, wy, wit, werr) in zip(gd, wd):
        assert (err is None) == (werr is None), (f, s, err, werr)
        if err is None:
            assert y.dtype == wy.dtype and np.array_equal(y, wy), (f, s)
            assert it == wit, (f, s)
        elif exact_errors:
            assert err.split(":")[0] == werr.split(":")[0]
    assert counters(gs) == counters(ws)


@pytest.fixture(scope="module")
def served():
    return _one_device_and_reference()


def test_one_device_server_matches_the_reference(served):
    port, ref = served
    _assert_served_alike(port, ref)
    assert port[1]["served"] == 27 and port[1]["failed"] == 1


def test_data_mesh_of_one_rank_serves_as_one_device(served):
    server = DatalogServer(max_batch=MAX_BATCH, warm_answers=0,
                           mesh=mesh_mod.make_datalog_mesh(1, device="cpu"))
    assert server.rules == rules.make_rules(server.mesh, "datalog")
    bm, ss_in, _ = _serve_inputs()
    got = worker.serve_stream(server, bm, ss_in, STREAM)
    _assert_served_alike(got, served[0])
    assert got[2] == served[0][2] == [16, 8, 4, 4]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``{d: each rank's results}`` of spawned worlds of 2, 3 and 4
    ranks: every rank serves the stream; in the 4-rank world the
    collectives and the pipeline run too."""
    bm, ss_in, _ = _serve_inputs()
    out = {}
    for d in (2, 3, 4):
        cases = {"serve": ("serve", (bm, ss_in, STREAM, MAX_BATCH))}
        if d == 4:
            inp = _inputs()
            cases["coll"] = ("collectives", (
                inp["xs"], {"w": np.broadcast_to(inp["g"], (4, 3, 8)).copy()}))
            cases["pipe"] = ("pipeline", (inp["w"], inp["x"]))
        out[d] = mesh_mod.spawn_world(
            worker.run_cases, d, cases, device="cpu",
            workdir=str(tmp_path_factory.mktemp(f"world{d}")))
    return out


@pytest.mark.parametrize("d", [2, 3, 4])
def test_data_mesh_server_serves_as_one_device(worlds, served, d):
    """Every rank delivers the one-device server's answers, counts and
    counters, in its order; each rank ran its block of rows where the
    bucket divides d (16 and 8 rows), and the whole batch where it does
    not."""
    for r in worlds[d]:
        _assert_served_alike(r["serve"][:2], served[0][:2])
        assert r["serve"][2] == [b // d if b % d == 0 else b
                                 for b in served[0][2]]


def test_collectives_equal_the_reference(worlds, reference):
    """bf16: the four bf16 payloads summed in bf16 (XLA and gloo may
    round the partial sums in another order: within two bf16 roundings
    of the sum's magnitude); int8: the int32 sum is exact, the scales'
    mean may round in another order (1e-6 relative)."""
    ranks = worlds[4]
    inp, ref, _ = reference
    xs = inp["xs"]
    bound = 2 * 2.0 ** -8 * np.abs(xs).sum(0)
    for r, res in enumerate(ranks):
        got = res["coll"]
        assert got["bf16"].dtype == np.float32
        assert np.all(np.abs(got["bf16"] - ref["bf16"][r]) <= bound)
        np.testing.assert_allclose(got["int8"], ref["int8"][r], rtol=1e-6,
                                   atol=1e-7)
        g = inp["g"]
        gb = 2 * 2.0 ** -8 * 4 * np.abs(g) / 4
        assert np.all(np.abs(got["tree_bf16"]["w"] - ref["tree_bf16"])
                      <= gb + 1e-7)
        np.testing.assert_allclose(got["tree_int8"]["w"], ref["tree_int8"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got["gather"],
                                      np.concatenate(list(xs))[None])
        np.testing.assert_allclose(got["scatter"],
                                   xs.sum(0)[None, 2 * r:2 * r + 2],
                                   rtol=1e-6)


def test_pipeline_equals_the_reference_and_the_stack(worlds, reference):
    ranks = worlds[4]
    inp, ref, _ = reference
    seq = inp["x"]
    for s in range(S):
        seq = np.tanh(seq @ inp["w"][s])
    for res in ranks:
        np.testing.assert_allclose(res["pipe"], ref["pipe"], **PIPE_TOL)
        np.testing.assert_allclose(res["pipe"], seq, **PIPE_TOL)


def test_port_reads_a_checkpoint_the_reference_sharded_over_4(reference):
    """Keys sliced by four devices, a column split and a row split: read
    whole and, at W = 2 and 4, in blocks."""
    inp, _, ckpt_dir = reference
    keys = np.load(os.path.join(ckpt_dir, "step_2", "shards_h0.npz")).files
    assert "['e']|0:-1,2:4" in keys and "['w']|6:8,0:-1" in keys
    like = {"b": torch.zeros(5), "e": torch.zeros(6, 8),
            "w": torch.zeros(8, 3)}
    whole = ck.load_checkpoint(ckpt_dir, 2, like)
    for k in like:
        np.testing.assert_array_equal(whole[k].numpy(), inp[
            "w8" if k == "w" else k])
    specs = {"b": P(None), "e": P(None, "data"), "w": P("data", None)}
    for w in (2, 4):
        parts = []
        for r in range(w):
            m = types.SimpleNamespace(axis_names=("data",),
                                      shape={"data": w}, coords={"data": r})
            target = {k: torch.zeros(tuple(
                s.stop - s.start for s in sh.block_slices(
                    tuple(v.shape), specs[k], m)))
                for k, v in like.items()}
            parts.append(ck.load_checkpoint(ckpt_dir, 2, target,
                                            shardings=specs, mesh=m))
        np.testing.assert_array_equal(
            torch.cat([p["e"] for p in parts], 1).numpy(), inp["e"])
        np.testing.assert_array_equal(
            torch.cat([p["w"] for p in parts], 0).numpy(), inp["w8"])
        assert all(np.array_equal(p["b"].numpy(), inp["b"]) for p in parts)
