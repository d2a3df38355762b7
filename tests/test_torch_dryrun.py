"""The dry-run tools (ROADMAP A8) against the JAX package:
``launch.workloads``, ``launch.dryrun``, ``launch.datalog_dryrun`` and
``launch.hillclimb``.

(a) Every abstract input of ``workloads`` for the ten architectures and
    four shapes has the reference's shape and dtype (the port's cache
    tree carries no position tensors: its ``pos`` is an int); the skip
    rule and ``windowed_len`` agree.
(b) On the production meshes, each of rank 0's arguments has the shape
    of the reference's block of it (``NamedSharding.shard_shape`` of
    ``repro.launch.dryrun.build_cell``, run in one subprocess: the
    reference module forces 512 XLA devices at import; it lowers
    nothing).  Two kinds of leaf differ by design and are compared by
    their bytes a rank: a kv head replicated over a wider model axis
    (the port holds whole heads, ``M / n_kv`` times the reference's
    block), and the decode cache, whose heads the port splits where the
    reference's ``"decode"`` rules split the sequence (ROADMAP C).
(c) The meta count of a step equals the CPU count of the same step,
    FLOPs, bytes and collectives, on a fake ``(2, 2)`` world and at
    ``(1, 1)`` (``dryrun.calibrate(device="cpu")``).
(d) CC's loop (``datalog_dryrun``) at n = 256 equals the reference's
    ``cc_original_step``/``cc_optimized_step`` iterated 8 times, bit
    for bit, on one rank and on a spawned gloo world at ``(2, 2)``.
(e) The rows the port refuses at the production mesh (``long_500k`` on
    the six full-attention architectures, as the reference's skip rule
    says), the fourteen cells of the four architectures whose heads the
    16-wide model axis lays out unevenly or replicated (MiniCPM-2B,
    StarCoder2-7B, Llama-4-Maverick, Whisper-base: ``sharding.
    head_split``), and Zamba2-2.7B's and Whisper-base's ``decode_32k``
    on both meshes (Whisper's is the reference's ``test_dryrun`` cell).
"""

import contextlib
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.launch import workloads as jwl
from repro_torch import configs
from repro_torch.distributed import sharding as sh
from repro_torch.launch import datalog_dryrun as dd
from repro_torch.launch import dryrun
from repro_torch.launch import hillclimb
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import workloads as wl
from repro_torch.models import transformer as T

import torch_dryrun_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the architectures whose heads the production mesh's 16-wide model axis
#: lays out in uneven or replicated whole heads (rank 0's blocks are not
#: the reference's even cut inside heads, so (b) leaves them out; (e)
#: counts them)
QUERY_HEADS = {"minicpm-2b", "starcoder2-7b",
               "llama4-maverick-400b-a17b", "whisper-base"}
#: the reference's long_500k skips (tests/test_dryrun.py::test_skip_rules)
FULL_ATTENTION = {"minicpm-2b", "llama3-405b", "mistral-large-123b",
                  "deepseek-moe-16b", "whisper-base",
                  "llava-next-mistral-7b"}
RUNS = [a for a in configs.list_archs() if a not in QUERY_HEADS]
#: (b)'s cells: train_4k and decode_32k single of every architecture the
#: port runs, and two multi-pod cells
SHARD_CELLS = ([(a, s, "single") for a in RUNS
                for s in ("train_4k", "decode_32k")]
               + [("llama3-405b", "train_4k", "multi"),
                  ("zamba2-2.7b", "decode_32k", "multi")])


@pytest.fixture(scope="module", autouse=True)
def no_world_left():
    """The fake worlds of this file end with it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jdtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


# -- (a) workloads -----------------------------------------------------------


def _kv_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _kv_paths(v, prefix + (k,))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def _ref_leaf(tree, path):
    for k in path:
        if isinstance(tree, tuple):
            k = {"k": 0, "v": 1}[k]       # the reference's cross tuple
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", configs.list_archs())
def test_every_workload_input_has_the_reference_shape_and_dtype(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for name, w in wl.WORKLOADS.items():
        jw = jwl.WORKLOADS[name]
        assert (w.seq_len, w.global_batch, w.kind) == (
            jw.seq_len, jw.global_batch, jw.kind)
        assert wl.skip_reason(cfg, w) == jwl.skip_reason(jcfg, jw)
        for s in (1024, 4096, 32768, w.seq_len):
            assert wl.windowed_len(cfg, s) == jwl.windowed_len(jcfg, s)
        fns = {"train": (wl.batch_specs, jwl.batch_specs),
               "prefill": (wl.prefill_specs, jwl.prefill_specs),
               "decode": (wl.decode_specs, jwl.decode_specs)}[w.kind]
        got, want = fns[0](cfg, w), fns[1](jcfg, jw)
        assert set(got) == set(want), (arch, name)
        for key in got:
            if key != "cache":
                assert tuple(got[key].shape) == want[key].shape
                assert got[key].device.type == "meta"
                assert _jdtype(got[key]) == str(want[key].dtype), key
                continue
            assert got["cache"]["pos"] == 0
            n = 0
            for path, t in _kv_paths(got["cache"]):
                ref = _ref_leaf(want["cache"], path)
                assert tuple(t.shape) == ref.shape, (arch, name, path)
                assert _jdtype(t) == str(ref.dtype), (arch, name, path)
                n += 1
            # the reference's other leaves are positions, the port's int
            extra = [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(want["cache"])[0]]
            assert len(extra) - n == sum("pos" in p or "[2]" in p
                                         for p in extra)


# -- (b) rank 0's blocks against the reference's shard shapes ----------------


_REFERENCE = r"""
import json, sys
import jax
from repro.launch import dryrun as D
out = {}
for arch, shape, mesh in json.loads(sys.argv[1]):
    built, reason = D.build_cell(arch, shape, mesh == "multi")
    step, args, in_sh = built[0], built[1], built[2]
    leaves = jax.tree_util.tree_flatten_with_path(args)[0]
    shards = jax.tree.leaves(in_sh)
    out[f"{arch}|{shape}|{mesh}"] = {
        jax.tree_util.keystr(p): list(s.shard_shape(x.shape))
        for (p, x), s in zip(leaves, shards)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_shards():
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(SHARD_CELLS)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _flat(args) -> dict:
    out = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}[{k!r}]")
        elif isinstance(node, torch.Tensor):
            out[key] = node
    for i, a in enumerate(args):
        walk(a, f"[{i}]")
    return out


@pytest.mark.parametrize("arch, shape, mesh_kind", SHARD_CELLS)
def test_rank0_blocks_have_the_reference_shard_shapes(reference_shards, arch,
                                                      shape, mesh_kind):
    multi = mesh_kind == "multi"
    dryrun.fake_world(512 if multi else 256)
    mesh = mesh_mod.make_production_mesh(multi_pod=multi, device="cpu")
    built, reason = dryrun.build_cell(arch, shape, mesh)
    assert built is not None, reason
    got = _flat(built[1])
    want = reference_shards[f"{arch}|{shape}|{mesh_kind}"]
    cfg = configs.get(arch)
    rep = sh.head_split(cfg.n_heads, cfg.n_kv_heads, 16).kv_rep
    for key, ref in want.items():
        if key not in got:
            # positions: the port's cache and optimizer step are ints
            assert key.endswith("['pos']") or key == "[1]['step']", key
            continue
        t = got[key]
        kv = "['wk']" in key or "['wv']" in key
        cache = "['cache']" in key and key[-5:] in ("['k']", "['v']")
        if cache:      # heads split where the reference splits the sequence
            assert t.numel() == int(np.prod(ref)) * rep, (key, t.shape, ref)
        elif kv and rep > 1:    # one whole head a rank, rep ranks a head
            assert t.numel() == int(np.prod(ref)) * rep, (key, t.shape, ref)
            assert t.shape[-1] == cfg.hd
        else:
            assert list(t.shape) == ref, (key, list(t.shape), ref)
    assert set(got) <= set(want)


# -- (c) the meta count is the device's --------------------------------------

COUNT_CELLS = [("xlstm-125m", "train_4k", dict(remat="none")),
               ("zamba2-2.7b", "prefill_32k", {}),
               ("zamba2-2.7b", "decode_32k", {}),
               ("llama3-405b", "train_4k", {}),
               ("deepseek-moe-16b", "train_4k", {}),
               ("whisper-base", "decode_32k", {})]


def _same_count(a: dict, b: dict):
    for key in ("flops", "bytes_accessed", "collectives", "kernels"):
        assert a[key] == b[key], key
    assert a["memory"]["argument_bytes"] == b["memory"]["argument_bytes"]
    assert a["flops"] > 0


@pytest.mark.parametrize("arch, shape, kw", COUNT_CELLS)
def test_the_meta_count_is_the_cpu_count_at_one_rank(arch, shape, kw):
    out = dryrun.calibrate(configs.get(arch, smoke=True), shape,
                           device="cpu", batch=4, seq=32, **kw)
    _same_count(out["meta"], out["device"])
    assert out["predicted_peak_bytes"] == (
        out["meta"]["memory"]["argument_bytes"]
        + out["meta"]["memory"]["temp_bytes"])


@pytest.mark.parametrize("arch, shape, kw", COUNT_CELLS)
def test_the_meta_count_is_the_cpu_count_on_a_fake_2x2_world(arch, shape,
                                                            kw):
    dryrun.fake_world(4)
    mesh = mesh_mod.make_host_mesh(2, device="cpu")
    rows = []
    for dev in ("meta", "cpu"):
        built, reason = dryrun.build_cell(configs.get(arch, smoke=True),
                                          shape, mesh, device=dev, batch=4,
                                          seq=32, **kw)
        fn, args, cfg, w = built
        rows.append(dryrun._row(dryrun.stage(fn, args, warm=dev == "cpu"),
                                cfg, w))
    _same_count(*rows)
    assert rows[0]["collectives"]["total_bytes"] > 0


def test_the_reference_flags_without_counterpart_are_refused():
    for flag, value in (("--attn", "online"), ("--scan", "chunked"),
                        ("--moe-buf", "expert_data")):
        with pytest.raises(ValueError, match="no counterpart|B4|B5|own"):
            dryrun.main(["--arch", "xlstm-125m", "--shape", "train_4k",
                         flag, value])


# -- (d) CC's loop -------------------------------------------------------------

N, ITERS = 256, 8


def _graph():
    rng = np.random.default_rng(5)
    return rng.random((N, N)) < 1.5 / N


def _reference_cc(e, variant):
    from repro.launch import datalog_dryrun as jd
    if variant == "original":
        step, tc = jd.cc_original_step(N), jnp.eye(N, dtype=bool)
        for _ in range(ITERS):
            tc, labels = step(jnp.asarray(e), tc)
        return np.asarray(labels)
    step, cc = jd.cc_optimized_step(N), jnp.arange(N, dtype=jnp.float32)
    for _ in range(ITERS):
        cc = step(jnp.asarray(e), cc)
    return np.asarray(cc)


@contextlib.contextmanager
def _one_gloo_rank():
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield mesh_mod.make_host_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def cc_world(tmp_path_factory):
    e = _graph()
    cases = {v: (e, v, ITERS) for v in ("original", "optimized")}
    ranks = mesh_mod.spawn_world(
        worker.run_cases, 4, cases, device="cpu",
        mesh_fn=functools.partial(mesh_mod.make_host_mesh, 2),
        workdir=str(tmp_path_factory.mktemp("cc")))
    return e, ranks


@pytest.mark.parametrize("variant", ["original", "optimized"])
def test_cc_loop_is_the_reference_bit_for_bit(cc_world, variant):
    e, ranks = cc_world
    want = _reference_cc(e, variant)
    assert len(np.unique(want)) > 1
    with _one_gloo_rank() as mesh:
        one = dd.cc_loop(torch.from_numpy(e), variant, mesh, N, ITERS)
    np.testing.assert_array_equal(one.numpy(), want)
    got = np.full(N, np.nan, np.float32)
    for r in ranks:
        (lo, hi), labels = r[variant]
        if not np.isnan(got[lo:hi]).all():       # replicas over "model"
            np.testing.assert_array_equal(got[lo:hi], labels)
        got[lo:hi] = labels
    np.testing.assert_array_equal(got, want)


def test_the_optimized_cc_moves_less_than_the_original():
    """Counted on meta at n = 65,536 on ``(16, 16)``: the optimized
    variant's bytes and collective bytes a rank an iteration are below
    the original's; the products go to B2 ``tc_bool`` and ``stream``."""
    orig = dd.run(65536, "original", False, iters=2)
    opt = dd.run(65536, "optimized", False, iters=2)
    assert opt["bytes_accessed"] < orig["bytes_accessed"]
    assert opt["collective_bytes"] < orig["collective_bytes"]
    assert orig["kernels"] == {"semiring_matmul/tc_bool": 2}
    assert opt["kernels"] == {"semiring_matmul/stream": 2}


# -- (e) the production rows ---------------------------------------------------


@pytest.mark.parametrize("arch", configs.list_archs())
def test_the_refused_production_rows(arch):
    """``long_500k`` on each of the six full-attention architectures is
    ``skipped`` on both meshes with the reference's reason; no other
    cell of the architecture is refused (its skip rule and its model
    axis accept it)."""
    T.check_model_axis(configs.get(arch), 16)
    for shape, w in wl.WORKLOADS.items():
        if not (shape == "long_500k" and arch in FULL_ATTENTION):
            assert wl.skip_reason(configs.get(arch), w) is None
            continue
        for mesh_kind in ("single", "multi"):
            row = dryrun.run_cell(arch, shape, mesh_kind)
            assert row["status"] == "skipped", row
            assert "sub-quadratic" in row["reason"]


#: (e)'s newly counted cells: every cell of the four architectures on the
#: single mesh but the two full-attention ones' long_500k, and Whisper's
#: decode_32k (the reference's own cell) on the multi-pod mesh
HEAD_CELLS = ([(a, s, "single") for a in sorted(QUERY_HEADS)
               for s in wl.WORKLOADS
               if not (s == "long_500k" and a in FULL_ATTENTION)]
              + [("whisper-base", "decode_32k", "multi")])


@pytest.mark.parametrize("arch, shape, mesh_kind", HEAD_CELLS)
def test_the_uneven_head_rows_count(arch, shape, mesh_kind):
    """Each cell of the four architectures builds and counts: FLOPs,
    bytes, collectives and memory; its row names the heads rank 0 holds
    (the most any rank does) and the fewest any rank holds."""
    row = dryrun.run_cell(arch, shape, mesh_kind)
    assert row["status"] == "ok", row.get("error")
    assert row["flops"] > 0 and row["bytes_accessed"] > 0
    assert row["collectives"]["total_bytes"] > 0
    assert row["memory"]["argument_bytes"] > 0
    cfg = configs.get(arch)
    split = sh.head_split(cfg.n_heads, cfg.n_kv_heads, 16)
    heads = row["heads"]
    assert heads["rank0"] == {"q": split.q[0][1], "kv": split.kv[0][1]}
    assert heads["fewest"]["q"] == min(n for _, n in split.q)
    assert heads["rank0"]["q"] >= heads["fewest"]["q"] >= 1


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_zamba2_decode_cell(mesh_kind):
    row = dryrun.run_cell("zamba2-2.7b", "decode_32k", mesh_kind)
    assert row["status"] == "ok", row.get("error")
    assert row["flops"] > 0
    assert row["collectives"]["total_bytes"] > 0
    assert row["memory"]["argument_bytes"] > 0
    priced = hillclimb.terms(row)
    assert priced["collective_s"] > 0 and "infiniband" in priced["links"]
