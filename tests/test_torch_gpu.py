"""The port's CUDA kernels on the card, held against their plain
PyTorch versions, and the main path on the card against the same path
on the CPU.

Every case needs a CUDA device and skips without one: the hand-written
kernels have no CPU or interpret mode.  This file imports no JAX, so it
runs on a GPU machine that has only PyTorch::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: bool/trop/maxplus/nat exact; real ``atol = rtol = 1e-4``
(B3's atomics and the plain version sum in different orders); B4 and B5
``max |err| <= 1e-4 · max(1, max |plain|)`` (float kernels summing in
another order than their plain versions).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core import semiring as sr_mod
from repro_torch.core.program import run_program
from repro_torch.datalog import datasets, programs
from repro_torch.kernels import coo_segment, coo_spmm, ref, semiring_matmul
from repro_torch.sparse import fixpoint as fx
from repro_torch.sparse.coo import SparseRelation

ALL = ("bool", "trop", "maxplus", "nat", "real")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


def assert_match(got: torch.Tensor, want: torch.Tensor, sr_name: str):
    assert got.shape == want.shape and got.dtype == want.dtype
    if sr_name == "real":
        torch.testing.assert_close(got.cpu(), want.cpu(), atol=1e-4,
                                   rtol=1e-4)
    else:
        assert torch.equal(got.cpu(), want.cpu()), sr_name


def _relation(n, sr_name, seed, device):
    g = datasets.powerlaw(n, 4, seed=seed)
    edges = g.edges
    if sr_name == "maxplus":  # acyclic, so longest paths converge
        edges = np.sort(edges, axis=1)
        edges = edges[edges[:, 0] != edges[:, 1]]
    w = np.random.default_rng(seed).integers(1, 5, len(edges))
    if sr_name == "bool":
        w = np.ones(len(edges), bool)
    return SparseRelation.from_coo(edges, w, (n, n), sr_name, device=device)


def _values(rng, shape, sr_name, live=0.3):
    sr = sr_mod.get(sr_name, lib="np")
    mask = rng.random(shape) < live
    if sr_name == "bool":
        return torch.from_numpy(mask)
    x = np.full(shape, sr.zero, sr.dtype)
    x[mask] = rng.integers(0, 5, int(mask.sum()))
    return torch.from_numpy(x)


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("b", [None, 8])
def test_segment_kernel_vs_plain(cuda, sr_name, b):
    rng = np.random.default_rng(3)
    m, n = 5000, 300
    vals = _values(rng, (m,) if b is None else (m, b), sr_name).to(cuda)
    ids = torch.from_numpy(rng.integers(0, n + 3, m).astype(np.int32)
                           ).to(cuda)       # n.. emulate padding sentinels
    before = coo_segment.segment_reduce_cuda.launches
    got = coo_segment.segment_reduce(sr_name, vals, ids, n)
    assert coo_segment.segment_reduce_cuda.launches == before + 1
    assert_match(got, ref.segment_reduce_ref(sr_mod.get(sr_name), vals,
                                             ids, n), sr_name)


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("b", [1, 8, 300])
@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_kernel_vs_plain(cuda, sr_name, b, transpose):
    rel = _relation(500, sr_name, seed=1, device=cuda)
    plan = coo_spmm.plan_geometry(rel, transpose=transpose)
    x = _values(np.random.default_rng(b), (500, b), sr_name, 0.1).to(cuda)
    before = coo_spmm.spmm_cuda.launches
    got = coo_spmm.spmm(plan, x)
    assert coo_spmm.spmm_cuda.launches == before + 1
    p = plan.on(cuda)
    assert_match(got, ref.coo_spmm_ref(sr_mod.get(sr_name), p["src"],
                                       p["w"], p["dst"], x, plan.n_out),
                 sr_name)


@pytest.mark.parametrize("sr_name", ALL)
@pytest.mark.parametrize("shape", [(1, 300, 300), (130, 70, 60),
                                   (256, 512, 128)])
def test_matmul_kernel_vs_plain(cuda, sr_name, shape):
    m, k, n = shape
    rng = np.random.default_rng(1)
    a = _values(rng, (m, k), sr_name, 0.6).to(cuda)
    b = _values(rng, (k, n), sr_name, 0.6).to(cuda)
    before = semiring_matmul.semiring_matmul_cuda.launches
    got = semiring_matmul.semiring_matmul(sr_name, a, b)
    assert semiring_matmul.semiring_matmul_cuda.launches == before + 1
    assert_match(got, ref.semiring_matmul_ref(sr_mod.get(sr_name), a, b),
                 sr_name)


def test_wrappers_reject_what_kernels_do_not_take(cuda):
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        coo_segment.segment_reduce("trop", torch.ones(4, device=cuda).bool(),
                                   ids, 2)
    with pytest.raises(ValueError):
        coo_segment.segment_reduce("trop", torch.ones(3, 4, device=cuda).t(),
                                   ids, 2)
    with pytest.raises(TypeError):
        coo_segment.segment_reduce("trop", torch.ones(4, device=cuda),
                                   ids.long(), 2)


@pytest.mark.parametrize("sr_name", ["bool", "trop", "maxplus"])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_fixpoint_on_card_matches_cpu(cuda, sr_name, backend):
    """Values and per-row counts of the batched fixpoint on the card
    (B3 or B1 advancing Δ) equal the CPU run (the plain versions)."""
    rel = _relation(2000, sr_name, seed=4, device="cpu")
    rng = np.random.default_rng(2)
    srn = sr_mod.get(sr_name, lib="np")
    init = np.full((16, 2000), srn.zero, srn.dtype)
    init[np.arange(16), rng.integers(0, 2000, 16)] = srn.one
    init = torch.from_numpy(init)
    want, wit = fx.fixpoint(rel, init, backend=backend)
    got, it = fx.fixpoint(rel.to(cuda), init.to(cuda), backend=backend)
    assert_match(got, want, sr_name)
    assert torch.equal(it.cpu(), wit)
    one, one_it = fx.fixpoint(rel.to(cuda), init[0].to(cuda),
                              backend=backend)
    assert_match(one, got[0], sr_name)
    assert one_it == int(it[0])


@pytest.mark.parametrize("kind", ["bm", "cc"])
@pytest.mark.parametrize("which", ["original", "optimized"])
def test_run_program_on_card_matches_cpu(cuda, kind, which):
    """BM/CC Π₁ and Π₂ on a dense graph (E stays dense: B2 joins) and
    Π₂ on a sparse one (B3), card against CPU."""
    bench = programs.bm(a=0) if kind == "bm" else programs.cc()
    prog = getattr(bench, which)
    g = datasets.erdos_renyi(160, 0.4 * 160, seed=1)
    graphs = [(bench.make_db(g, device="cpu"), bench.make_db(g, device=cuda))]
    if which == "optimized":
        p = datasets.powerlaw(3000, 4, seed=0)
        graphs.append(tuple(engine.Database(
            bench.original.schema, {"id": p.n},
            {"E": p.sparse_adjacency(device=d), "V": p.vertex_set(device=d)},
            d) for d in ("cpu", cuda)))
    for cpu_db, gpu_db in graphs:
        want, wst = run_program(prog, cpu_db)
        got, st = run_program(prog, gpu_db)
        assert got.device.type == "cuda"
        assert_match(got, want, prog.outputs[-1].body.semiring)
        assert st.iterations == wst.iterations


# --------------------------------------------------------------------------
# B4 ssm_scan, B5 flash_attention and the Zamba2 serving path
# --------------------------------------------------------------------------
#
# B4 and B5 are float kernels that sum in another order than their plain
# versions (B4: a serial FMA walk against a doubling scan; B5: an online
# softmax over key tiles against one softmax), so they are held to
# max |err| <= 1e-4 · max(1, max |plain|).


def assert_float_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.parametrize("shape", [(2, 1, 8), (3, 97, 160), (2, 300, 80),
                                   (1, 1000, 33)])
def test_ssm_scan_kernel_vs_plain(cuda, shape):
    from repro_torch.kernels import ssm_scan
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    a = torch.rand(shape, generator=g, device=cuda) * 0.5 + 0.5
    b = torch.randn(shape, generator=g, device=cuda)
    before = ssm_scan.ssm_scan_cuda.launches
    got = ssm_scan.ssm_scan(a, b)
    assert ssm_scan.ssm_scan_cuda.launches == before + 1
    assert_float_close(got, ref.ssm_scan_ref(a, b))
    assert_float_close(got, ref.ssm_scan_sequential(a, b))


#: (b, tq, tk, hq, hkv, d, causal, window, chunk, q_offset)
FLASH_CASES = {
    "prefill-d80": (2, 128, 128, 4, 4, 80, True, None, None, 0),
    "ragged-d80": (2, 100, 100, 4, 4, 80, True, None, None, 0),
    "full-gqa2-d64": (1, 70, 130, 8, 4, 64, False, None, None, 0),
    "decode-d80": (3, 1, 37, 4, 4, 80, True, None, None, 36),
    "decode-gqa4-d32": (2, 1, 545, 8, 2, 32, True, None, None, 544),
    "window-d80": (1, 200, 200, 4, 2, 80, True, 48, None, 0),
    "chunk-d32": (1, 150, 150, 4, 1, 32, True, None, 64, 0),
    "chunk-full-d128": (1, 90, 90, 2, 2, 128, False, None, 32, 0),
    "offset-prefill-d80": (2, 20, 84, 4, 4, 80, True, None, None, 64),
    "masked-rows-d80": (1, 3, 32, 4, 4, 80, True, 4, None, 60),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_kernel_vs_plain(cuda, case):
    from repro_torch.kernels import flash_attention as fa
    b, tq, tk, hq, hkv, d, causal, window, chunk, q_off = FLASH_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(len(case))
    q = torch.randn((b, tq, hq, d), generator=g, device=cuda)
    k = torch.randn((b, tk, hkv, d), generator=g, device=cuda)
    v = torch.randn((b, tk, hkv, d), generator=g, device=cuda)
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_off)
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.flash_attention_cuda.launches == before + 1
    want = ref.attention_ref(q, k, v, **kw)
    assert_float_close(got, want)
    if case == "masked-rows-d80":   # rows past Tk + window see no key
        assert torch.equal(got, torch.zeros_like(got))


def test_flash_attention_kernel_reads_strided_cache_views(cuda):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(1)
    ck = torch.randn((2, 64, 4, 80), generator=g, device=cuda)
    cv = torch.randn((2, 64, 4, 80), generator=g, device=cuda)
    q = torch.randn((2, 1, 4, 80), generator=g, device=cuda)
    k, v = ck[:, :41], cv[:, :41]
    assert not k.is_contiguous()
    got = fa.flash_attention(q, k, v, q_offset=40)
    assert_float_close(got, ref.attention_ref(q, k.contiguous(),
                                              v.contiguous(), q_offset=40))


def test_scan_and_attention_wrappers_reject_what_kernels_do_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan
    x = torch.ones(2, 4, 8, device=cuda)
    with pytest.raises(TypeError):
        ssm_scan.ssm_scan(x.double(), x.double())
    with pytest.raises(ValueError):
        ssm_scan.ssm_scan(x.transpose(0, 1), x.transpose(0, 1))
    q = torch.ones(1, 2, 2, 160, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.ones(1, 2, 3, 8, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    kv = torch.ones(1, 2, 8, 3, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, kv, kv)


def test_serve_batch_on_card_matches_cpu(cuda):
    """Zamba2 smoke serving on the card (B4 in prefill, B5 in every
    shared-attention application) against the same weights on the CPU:
    equal tokens, close logits, and the kernels' launch counts."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    arch = "zamba2-2.7b"
    cfg = configs.get(arch, smoke=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, n) for n in (7, 20, 13)]
    runs = {}
    for dev, p in (("cpu", params), (cuda, on_card)):
        reqs = [serve.Request(pr, max_new=6) for pr in prompts]
        ops.reset_launch_counts()
        stats = serve.serve_batch(arch, reqs, t_max=32, device=dev, params=p)
        runs[str(dev)] = (np.array([r.out for r in reqs]),
                          stats["last_logits"], ops.launch_counts())
    cpu_tok, cpu_logits, cpu_counts = runs["cpu"]
    tok, logits, counts = runs["cuda"]
    assert all(v == 0 for v in cpu_counts.values())
    n_seg = cfg.n_layers // cfg.hybrid_attn_every
    assert counts["ssm_scan"] == cfg.n_layers          # one prefill
    assert counts["flash_attention"] == n_seg * (1 + 6)
    assert np.array_equal(tok, cpu_tok)
    assert_float_close(logits.cpu(), cpu_logits)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}
