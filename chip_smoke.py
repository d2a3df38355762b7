#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold each of
its hand-written CUDA kernels against its plain PyTorch version.

Run from the root of a checkout, on a machine with an NVIDIA GPU and
``nvcc`` (``/usr/local/cuda``)::

    python3 chip_smoke.py

It builds ``src/repro_torch/csrc/*.cu`` into ``build/repro_torch/`` and
runs four phases; any failure exits non-zero:

1. kernels — B1 ``coo_spmm`` (𝔹 through its ``words_bool`` path, trop
   and nat through ``lanes_f32``; with the hub row alone and the torch
   round the planner prices it against), B3 ``coo_segment`` for bool,
   trop and nat through both its paths (``runs`` over a segment plan,
   ``scatter`` on unsorted ids) at 5% and 100% live and on the hub row
   alone, and B2 ``semiring_matmul`` at the FGH phase's
   shapes (4096³ in bool, nat and trop; 1×4096×4096 in bool and trop;
   256×4096×4096 in bool), against their plain versions on the card at
   the main path's shapes, each timed beside its plain version, a
   PyTorch library call where one computes the same function, and its
   bound;
2. latency — ``run_program`` of BM and CC Π₂ on ``powerlaw(81_306, 11)``
   (≈1.79M directed edges, the scale of SNAP ego-Twitter), checked
   against a scipy BFS and scipy connected components; every B3 launch
   must go through its ``runs`` path;
3. batched serving — ``plan_program(objective="throughput")`` +
   ``compile_batched`` for BM and CC with B = 256 sources; every row
   must equal its single-source answer and iteration count; every B1
   launch of BM must go through its ``words_bool`` path and of CC
   through ``lanes_f32``; B3 must not launch here, nor in phases 4–5;
4. FGH — BM Π₁ against Π₂ on the dense ``erdos_renyi(4096, 0.4·4096)``
   (E stays dense, so Π₁'s joins and Π₂'s vector rounds run on B2);
   equal answers; every Π₁ join must go through B2's ``tc_bool`` path
   and every Π₂ round through its ``stream`` path.  BFS reaches every
   node of that graph, so Π₁ = Π₂ = BFS is also checked on the sparse
   ``erdos_renyi(4096, 1.5, seed=3)``, where it reaches 58%;
5. lm_serve — ``serve_batch("zamba2-2.7b", smoke=False)``: Zamba2-2.7B
   at its published widths (54 Mamba2 layers, d_model 2560, 32 heads of
   80, vocab 32000; 2.40 B parameters, f32, random weights from a seeded
   generator on the card), B = 8 prompts of 128–512 tokens left-padded
   to 512, 32 greedy tokens each.  Every request must emit 32 tokens in
   the vocabulary; a full forward without cache over prompt + generated
   tokens must give the decode path's last logits; B4 ``ssm_scan`` must
   launch 54 times (the prefill) and B5 ``flash_attention`` 3 times per
   forward, the prefill's through its ``prefill_tc`` path and every
   decode step's through ``decode_split``.

Phase 1 also holds B4 and B5 against their plain versions at this
path's shapes (B4 (8, 512, 5120); B5 prefill 8×512 queries, decode 1
query over 544 cached keys and the full forward's 8×544 queries, 32
heads of 80).

The last lines of standard output are the ``kernels`` JSON line, the
card's name and power limit, and the result line.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result,
without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

#: the card's published peaks used for the bounds (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_SIMT_FLOPS = 67e12
INT8_TC_OPS = 1979e12
TF32_TC_FLOPS = 495e12

N_POWERLAW, M_ATTACH = 81_306, 11
N_DENSE = 4096
#: the fgh phase's second graph: erdos_renyi(N_DENSE, SPARSE_DEG,
#: seed=SPARSE_SEED), where BFS from node 0 reaches 58% of the nodes
SPARSE_DEG, SPARSE_SEED = 1.5, 3
BATCH = 256
#: B2's shapes as (semiring, rows): Π₁'s joins (4096³), Π₂'s one-row
#: vector_dense rounds (1×4096×4096) and the batched vector_dense pack
#: (256×4096×4096); k = n = N_DENSE throughout
B2_SHAPES = (("bool", N_DENSE), ("nat", N_DENSE), ("trop", N_DENSE),
             ("bool", 1), ("trop", 1), ("bool", BATCH))

LM_ARCH = "zamba2-2.7b"
LM_BATCH, LM_PROMPT, LM_MAX_NEW, LM_T_MAX = 8, (128, 512), 32, 1024
#: the published widths: layers, d_model, heads, head dim, vocab
LM_WIDTHS = (54, 2560, 32, 80, 32000)
#: B4/B5 are float kernels summing in another order than their plain
#: versions; held to max |err| <= FLOAT_TOL · max(1, max |plain|)
FLOAT_TOL = 1e-4
#: decode path vs full forward, over 54 layers of f32 products whose
#: summation order differs (cuBLAS picks other kernels for 8 rows than
#: for 8 × 544): max |err| <= LOGIT_TOL · max(1, max |logits|)
LOGIT_TOL = 1e-4


def log(*args) -> None:
    print(*args, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    log(f"built {lib_path.relative_to(ROOT)} in {build_s:.1f} s")

    dev = torch.device("cuda")
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "power": nvidia_smi(), "build_s": build_s}
    data = make_data(dev)
    report["graphs"] = data["meta"]
    kernels = phase_kernels(dev, data) + phase_lm_kernels(dev)
    main_path = {}
    main_path["latency"] = phase_latency(dev, data)
    main_path["batched"] = phase_batched(dev, data)
    main_path["fgh"] = phase_fgh(dev, data)
    main_path["lm_serve"] = phase_lm_serve(dev, data)
    report["profile"] = phase_profile(data)
    for k in kernels:
        k["launches"] = sum(p["launches"][k["name"]]
                            for p in main_path.values())
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main "
                                 f"path")
    report["kernels"] = kernels
    report["main_path"] = main_path
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    top = ("name", "route", "source", "replaces", "launches", "max_abs_err",
           "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    detail = ("by_semiring", "by_shape")
    log(json.dumps({"kernels": [
        {**{key: k[key] for key in top},
         "library_call": k["library_call"],
         "bound_gathered_ms": k.get("bound_gathered_ms"),
         **{key: k[key] for key in detail if key in k}} for k in kernels]}))
    log(report["power"])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


def make_data(dev):
    import numpy as np
    import torch
    from repro_torch.datalog import datasets

    t0 = time.perf_counter()
    g = datasets.powerlaw(N_POWERLAW, M_ATTACH, seed=0)
    e = g.sparse_adjacency(device=dev)
    gd = datasets.erdos_renyi(N_DENSE, 0.4 * N_DENSE, seed=1)
    s = time.perf_counter() - t0
    meta = {"powerlaw": {"n": g.n, "edges": int(e.nnz)},
            "erdos_renyi": {"n": gd.n, "edges": int(len(gd.edges))},
            "generate_s": s}
    log(f"graphs: powerlaw n={g.n} nnz={e.nnz}; erdos_renyi n={gd.n} "
        f"edges={len(gd.edges)} ({s:.1f} s)")
    torch.manual_seed(0)
    return {"g": g, "E": e, "gd": gd, "meta": meta,
            "rng": np.random.default_rng(0)}


def csr_host(n, edges):
    import numpy as np
    from scipy import sparse
    return sparse.csr_matrix((np.ones(len(edges), np.int8),
                              (edges[:, 0], edges[:, 1])), shape=(n, n))


def bfs_reach(csr, src):
    import numpy as np
    from scipy.sparse import csgraph
    order = csgraph.breadth_first_order(csr, src, directed=True,
                                        return_predecessors=False)
    out = np.zeros(csr.shape[0], bool)
    out[order] = True
    return out


def cc_min_labels(csr):
    import numpy as np
    from scipy.sparse import csgraph
    k, labels = csgraph.connected_components(csr, directed=False)
    lo = np.full(k, np.inf)
    np.minimum.at(lo, labels, np.arange(csr.shape[0], dtype=np.float64))
    return lo[labels].astype(np.float32)


# --------------------------------------------------------------------------
# timing and comparison
# --------------------------------------------------------------------------


def time_ms(fn, reps: int, warmup: int = 1, hide_host: bool = False
            ) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls.

    ``hide_host``: the device first sleeps ≈0.1 ms per call, so the
    host has enqueued every call before the first one runs and the time
    is the kernels' own, not the wrapper's Python (for launches shorter
    than their enqueue)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(int(reps * 2e5))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int) -> float:
    """Median device time of one call of ``fn`` after a 64 MB write has
    evicted the 50 MB L2 (host enqueue hidden as in ``time_ms``)."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(int(4e5))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def max_abs_err(got, want) -> float:
    import torch
    a, b = got.float(), want.float()
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def frontier(rng, shape, name, live=0.05):
    """A random Δ in the semiring: ~``live`` of it non-0̄, small ints."""
    import numpy as np
    from repro_torch.core import semiring as sr_mod
    sr = sr_mod.get(name, lib="np")
    mask = rng.random(shape) < live
    if name == "bool":
        return mask
    x = np.full(shape, sr.zero, sr.dtype)
    x[mask] = rng.integers(0, 4, int(mask.sum()))
    return x


def cast_relation(rel, name):
    """The power-law operator in semiring ``name`` (bool → 1̄ per edge)."""
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.sparse.coo import SparseRelation
    if name == "bool":
        return rel
    sr = sr_mod.get(name)
    vals = sr.from_bool(rel.values) if name != "nat" else \
        rel.values.to(torch.float32)
    return SparseRelation(rel.coords, vals, rel.nnz, rel.shape, name)


# --------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------------


SEMIRINGS = ("bool", "trop", "nat")


def phase_kernels(dev, data):
    import torch
    results = [kernel_b3(dev, data), kernel_b1(dev, data),
               kernel_b2(dev, data)]
    for k in results:
        key = "by_semiring" if "by_semiring" in k else "by_shape"
        by = k[key]
        # bool (B2: bool 4096³), or the kernel's own pick
        head = by[k["head"]] if "head" in k else next(iter(by.values()))
        k.update(route="cuda", max_abs_err=max(v["max_abs_err"]
                                               for v in by.values()),
                 ms=head["ms"], plain_ms=head["plain_ms"],
                 bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                 library_ms=head["library_ms"],
                 library_call=head["library_call"])
        if "bound_gathered_ms" in head:
            k["bound_gathered_ms"] = head["bound_gathered_ms"]
        for name, v in by.items():
            extra = ""
            if "scatter" in v:             # B3: both paths
                sc, hub = v["scatter"], v["hub_row"]
                extra = (f" [runs; cold L2 {v['cold_ms']:.4f} ms, with host "
                         f"{v['host_ms']:.4f} ms; scatter {sc['ms']:.4f} ms, "
                         f"cold {sc['cold_ms']:.4f}, with host "
                         f"{sc['host_ms']:.4f}, bound "
                         f"{v['scatter_bound_ms']:.4f}; hub row runs "
                         f"{hub['runs_ms']:.4f} / scatter "
                         f"{hub['scatter_ms']:.4f} ms; live "
                         f"{v['live_share']:.3f}]")
            elif "path" in v:
                extra = (f" [{v['path']}; cold L2 {v['cold_ms']:.4f} ms, "
                         f"with host {v['host_ms']:.4f} ms")
                if "library_bf16_ms" in v:
                    extra += f"; bf16 library {v['library_bf16_ms']} ms"
                if "hub_row_ms" in v:
                    extra += (f"; hub row {v['hub_row_ms']:.4f} ms; "
                              f"gathered-bytes bound "
                              f"{v['bound_gathered_ms']:.4f} ms; by_path "
                              f"{v['by_path']}")
                extra += "]"
            log(f"{k['name']:>16} {name:>5}: {v['ms']:.4f} ms kernel, "
                f"{v['plain_ms']:.4f} ms plain, library "
                f"{v['library_ms']} ms, bound {v['bound_ms']:.4f} ms "
                f"({v['bound_by']}), max|err| {v['max_abs_err']}{extra}")
    torch.cuda.synchronize()
    return results


def _check(name, kernel, got, want):
    err = max_abs_err(got, want)
    if err != 0.0:
        raise AssertionError(f"{kernel}/{name}: kernel disagrees with its "
                             f"plain version (max |err| {err})")
    return err


def _bound(nbytes: float, ops: float = 0.0, flops: float = FP32_SIMT_FLOPS):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


#: B3's payload densities: the kernels phase's 5%-live frontier and a
#: 100%-live one, the shape of CC's first round on the latency path
B3_LIVE = (("5%", 0.05), ("100%", 1.0))
#: the dense 𝔹 payload: a 100%-live 𝔹 frontier sets every row that has
#: an in-edge, an answer that cannot fail a kernel.  So the entries of
#: the B3_DEAD_ROWS share of rows with the fewest in-edges stay 0̄, and
#: B3_DENSE_BOOL of the rest are 1̄
B3_DEAD_ROWS, B3_DENSE_BOOL = 0.4, 0.9


def b3_payloads(dev, data):
    """B3's inputs on the latency path's shape: (nnz,) payloads by dst
    over the power-law operator (vspm: ids = coords[:, 1]), each the ⊗
    of the edge values with a frontier gathered at the source.  Yields
    ``(key, semiring, vals, ids, n)``; ``ids`` is a column of its own
    (not the relation's memoized one, whose plan the latency phase
    builds)."""
    import torch
    from repro_torch.core import semiring as sr_mod
    rel, rng = data["E"], data["rng"]
    n = rel.shape[1]
    ids = rel.coords[:, 1].to(torch.int32).contiguous()
    src = rel.col(0)
    for name in SEMIRINGS:
        sr = sr_mod.get(name)
        w = cast_relation(rel, name).values
        for key, live in B3_LIVE:
            if name == "bool" and live == 1.0:
                deg = torch.bincount(ids.long(), minlength=n)
                rank = torch.argsort(deg + torch.rand(n, device=dev))
                dead = torch.zeros(n, dtype=torch.bool, device=dev)
                dead[rank[:int(B3_DEAD_ROWS * n)]] = True
                live_e = torch.from_numpy(rng.random(ids.shape[0])
                                          < B3_DENSE_BOOL).to(dev)
                vals = w & live_e & ~dead[ids.long()]
            else:
                x = torch.from_numpy(frontier(rng, (n,), name, live)).to(dev)
                if live == 1.0:            # nat's draws include its 0̄
                    x = torch.where(sr.live(x), x, sr.one)
                vals = sr.mul(w, x.index_select(0, src))
            yield f"{name} {key}", name, vals.contiguous(), ids, n


def _b3_launch(path, coo_segment, name, vals, ids, n, plan, sorted_vals):
    if path == "runs":
        return lambda: coo_segment.segment_reduce_cuda(name, sorted_vals,
                                                       ids, n, plan)
    return lambda: coo_segment.segment_reduce_cuda(name, vals, ids, n)


def kernel_b3(dev, data):
    """B3 at the latency path's shape, both paths against the plain
    version at 5% and 100% live and on the hub row alone: ``runs`` over
    a segment plan of the ids (payload in plan order), ``scatter`` on
    the unsorted ids.  Times are device times with the host's enqueue
    hidden, beside the L2-flushed time and the time with the host."""
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_segment, ref
    by, plan = {}, None
    paths0 = dict(coo_segment.segment_reduce_cuda.by_path)
    for key, name, vals, ids, n in b3_payloads(dev, data):
        sr = sr_mod.get(name)
        if plan is None:
            (plan, plan_ms) = wall(lambda: coo_segment.plan_segment(ids, n))
        sorted_vals = vals.index_select(0, plan.order).contiguous()
        want = ref.segment_reduce_ref(sr, vals, ids, n)
        if name == "bool":
            _assert_mixed(f"coo_segment/{key}", want)
        entry = dict(shape={"m": int(vals.shape[0]), "n": n, "lanes": 1},
                     live_share=float(sr.live(vals).float().mean()),
                     true_share=(float(want.float().mean())
                                 if name == "bool" else None))
        for path in coo_segment.PATHS:
            fn = _b3_launch(path, coo_segment, name, vals, ids, n, plan,
                            sorted_vals)
            paths = dict(coo_segment.segment_reduce_cuda.by_path)
            err = _check(f"{key} {path}", "coo_segment", fn(), want)
            paths[path] += 1
            if coo_segment.segment_reduce_cuda.by_path != paths:
                raise AssertionError(f"coo_segment/{key}: by_path "
                                     f"{coo_segment.segment_reduce_cuda.by_path}"
                                     f", expected one more {path}")
            entry[path] = dict(max_abs_err=err,
                               ms=time_ms(fn, 20, hide_host=True),
                               cold_ms=time_cold_ms(fn, 10),
                               host_ms=time_ms(fn, 20))
        reduce = sr_mod.SCATTER_REDUCE[name]
        lib_vals = vals.to(torch.uint8) if name == "bool" else vals
        ids64 = ids.long()

        def library():
            out = torch.full((n,), 0 if name == "bool" else sr.zero,
                             dtype=lib_vals.dtype, device=dev)
            return out.scatter_reduce_(0, ids64, lib_vals, reduce,
                                       include_self=True)
        if max_abs_err(library(), want) != 0.0:
            raise AssertionError(f"scatter_reduce_ yardstick disagrees "
                                 f"({key})")
        isz = vals.element_size()
        it = plan.items
        out_bytes = n * isz
        runs_bytes = plan.m_live * isz + 8 * it.n_items + out_bytes
        scatter_bytes = vals.shape[0] * (isz + 4) + out_bytes
        bound, by_what = _bound(runs_bytes)
        entry.update(
            path="runs", max_abs_err=max(entry[p]["max_abs_err"]
                                         for p in coo_segment.PATHS),
            ms=entry["runs"]["ms"], cold_ms=entry["runs"]["cold_ms"],
            host_ms=entry["runs"]["host_ms"],
            plain_ms=time_ms(lambda: ref.segment_reduce_ref(
                sr, vals, ids, n), 5),
            library_ms=time_ms(library, 20, hide_host=True),
            library_call="Tensor.scatter_reduce_",
            bound_ms=bound, bound_by=by_what, bytes=runs_bytes,
            scatter_bound_ms=_bound(scatter_bytes)[0],
            scatter_bytes=scatter_bytes)
        by[key] = entry
    hub = kernel_b3_hub(dev, data)
    for key, v in by.items():
        v["hub_row"] = hub[key.split()[0]]
    by_path = {k: v - paths0[k]
               for k, v in coo_segment.segment_reduce_cuda.by_path.items()}
    log(f"     coo_segment by_path in the kernels phase {by_path}")
    return {"name": "coo_segment", "by_path": by_path,
            "source": "src/repro_torch/csrc/coo_segment.cu",
            "replaces": "src/repro/kernels/coo_segment.py:38",
            "head": "trop 100%", "plan_ms": plan_ms,
            "plan": dict(items=plan.items.n_items,
                         split_rows=plan.items.n_split,
                         partials=plan.n_part,
                         max_item_entries=plan.items.max_edges),
            "by_semiring": by}


def kernel_b3_hub(dev, data):
    """The hub row alone: the power-law operator's largest in-degree, its
    entries only, reduced into all n rows (the other rows' 0̄ written
    too).  Checked against the plain version on a 5%-live payload, and
    with the only non-0̄ entry in the last item of the hub's split row."""
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_segment, ref
    rel, rng = data["E"], data["rng"]
    n = rel.shape[1]
    col = rel.coords[:, 1].long()
    deg = torch.bincount(col, minlength=n)
    hub = int(torch.argmax(deg))
    on_hub = torch.nonzero(col == hub).flatten()
    ids = torch.full((on_hub.shape[0],), hub, dtype=torch.int32, device=dev)
    plan = coo_segment.plan_segment(ids, n)
    it = plan.items
    k = int(torch.nonzero(it.fold_row == hub)[0])
    last_item = int(torch.nonzero(it.dst == ~(int(it.fold_seg[k + 1]) - 1))[0])
    planted = int(it.edge[last_item + 1]) - 1
    out = {}
    for name in SEMIRINGS:
        sr = sr_mod.get(name)
        x = torch.from_numpy(frontier(rng, (n,), name)).to(dev)
        w = cast_relation(rel, name).values
        vals = sr.mul(w, x.index_select(0, rel.col(0)))[on_hub].contiguous()
        sorted_vals = vals.index_select(0, plan.order).contiguous()
        want = ref.segment_reduce_ref(sr, vals, ids, n)
        one = sr.zeros(vals.shape, dev)
        one[planted] = sr.one
        want_one = sr.zeros((n,), dev)
        want_one[hub] = sr.one
        entry = dict(hub=hub, entries=int(ids.shape[0]), items=it.n_items,
                     hub_items=int(it.fold_seg[k + 1] - it.fold_seg[k]))
        for path in coo_segment.PATHS:
            fn = _b3_launch(path, coo_segment, name, vals, ids, n, plan,
                            sorted_vals)
            _check(f"{name} hub row {path}", "coo_segment", fn(), want)
            planted_fn = _b3_launch(path, coo_segment, name, one, ids, n,
                                    plan, one)
            _check(f"{name} hub row, one live entry in its last item "
                   f"({path})", "coo_segment", planted_fn(), want_one)
            entry[f"{path}_ms"] = time_ms(fn, 20, hide_host=True)
        out[name] = entry
    return out


def kernel_b1(dev, data):
    """The batched path's fused advance: (n, 256) frontiers over the
    power-law operator's dst-sorted plan (transpose: Δ ⊗ E), through the
    path plan_spmm picks (𝔹: words_bool; trop, nat: lanes_f32).  The 𝔹
    frontier is 5% live, so the answer is mixed (checked: 20–80% true)."""
    import numpy as np
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_spmm, ref
    from repro_torch.sparse.coo import SparseRelation
    rng = data["rng"]
    by = {}
    for name in SEMIRINGS:
        sr = sr_mod.get(name)
        rel = cast_relation(data["E"], name)
        plan = coo_spmm.plan_geometry(rel, transpose=True)
        path, geo = coo_spmm.plan_spmm(plan, BATCH)
        p = plan.on(dev)
        x = torch.from_numpy(frontier(rng, (plan.n_in, BATCH), name)).to(dev)
        paths = dict(coo_spmm.spmm_cuda.by_path)
        got = coo_spmm.spmm_cuda(plan, x)
        launched = {k: v - paths[k]
                    for k, v in coo_spmm.spmm_cuda.by_path.items()}
        if launched != {k: int(k == path) for k in paths}:
            raise AssertionError(f"coo_spmm/{name}: launched {launched}, "
                                 f"expected one {path}")
        want = ref.coo_spmm_ref(sr, p["src"], p["w"], p["dst"], x, plan.n_out)
        if name == "bool":
            _assert_mixed(f"coo_spmm/{name}", want)
        err = _check(name, "coo_spmm", got, want)

        def kernel():
            return coo_spmm.spmm_cuda(plan, x)
        library_ms, library_call = None, None
        if name == "nat":  # (+, ×): one torch.sparse.mm computes it
            counts = torch.bincount(p["dst"].long(), minlength=plan.n_out)
            crow = torch.zeros(plan.n_out + 1, dtype=torch.int64,
                               device=dev)
            crow[1:] = torch.cumsum(counts, 0)
            a = torch.sparse_csr_tensor(crow, p["src"].long(), p["w"],
                                        size=(plan.n_out, plan.n_in))
            if max_abs_err(torch.sparse.mm(a, x), want) != 0.0:
                raise AssertionError("torch.sparse.mm yardstick disagrees")
            library_ms = time_ms(lambda: torch.sparse.mm(a, x), 20,
                                 hide_host=True)
            library_call = "torch.sparse.mm (CSR)"
        torch_round_ms = None
        if name in ("bool", "trop"):   # SpmmKernelModel's calibration
            from repro_torch.sparse import contract
            if max_abs_err(contract.spmm(rel, x, transpose=True),
                           want) != 0.0:
                raise AssertionError("torch round disagrees")
            torch_round_ms = time_ms(
                lambda: contract.spmm(rel, x, transpose=True), 5)
        # the hub row alone (its edges only): the power-law's largest
        # in-degree, cut into items, plus every other row's 0̄
        degrees = torch.bincount(p["dst"].long(), minlength=plan.n_out)
        hub = int(torch.argmax(degrees))
        on_hub = plan.dst == hub
        hub_rel = SparseRelation.from_coo(
            np.stack([plan.src[on_hub], plan.dst[on_hub]], axis=1),
            plan.w[on_hub], rel.shape, name, device=dev)
        hub_plan = coo_spmm.plan_geometry(hub_rel, transpose=True)
        hub_want = ref.coo_spmm_ref(sr, *(hub_plan.on(dev)[k] for k in
                                          ("src", "w", "dst")), x,
                                    plan.n_out)
        _check(f"{name} hub row", "coo_spmm",
               coo_spmm.spmm_cuda(hub_plan, x), hub_want)
        hub_ms = time_ms(lambda: coo_spmm.spmm_cuda(hub_plan, x), 20,
                         hide_host=True)
        isz = x.element_size()
        it = geo.items
        idx_bytes = (4 + p["w"].element_size()) * plan.nnz \
            + 8 * it.n_items + 8 * it.n_split
        out_bytes = plan.n_out * BATCH * isz
        nbytes = idx_bytes + plan.n_in * BATCH * isz + out_bytes
        bound, by_what = _bound(nbytes)
        row_bytes = geo.row_len * 4
        if path == "words_bool":   # pack, round on words, unpack
            gathered = (plan.n_in * (BATCH + row_bytes) + idx_bytes
                        + plan.nnz * row_bytes
                        + 2 * it.n_part * row_bytes
                        + plan.n_out * (2 * row_bytes + BATCH))
        else:                      # indices once a slab
            gathered = (idx_bytes * geo.grid[1] + plan.nnz * row_bytes
                        + 2 * it.n_part * row_bytes + out_bytes)
        by[name] = dict(
            shape={"nnz": plan.nnz, "n": plan.n_out, "lanes": BATCH,
                   "rows": len(plan.udst),
                   "max_row_edges": int(degrees.max())},
            path=path,
            geometry=dict(items=it.n_items, split_rows=it.n_split,
                          partials=it.n_part, row_len=geo.row_len,
                          vec=geo.vec, slab=geo.slab, grid=list(geo.grid)),
            by_path=launched,
            true_share=(float(want.float().mean()) if name == "bool"
                        else None),
            hub_row_ms=hub_ms, hub_items=hub_plan.items().n_items,
            max_abs_err=err,
            ms=time_ms(kernel, 20, hide_host=True),
            torch_round_ms=torch_round_ms,
            cold_ms=time_cold_ms(kernel, 10),
            host_ms=time_ms(kernel, 20),
            plain_ms=time_ms(lambda: ref.coo_spmm_ref(
                sr, p["src"], p["w"], p["dst"], x, plan.n_out), 3),
            library_ms=library_ms, library_call=library_call,
            bound_ms=bound, bound_by=by_what, bytes=nbytes,
            gathered_bytes=gathered,
            bound_gathered_ms=gathered / HBM_BYTES_PER_S * 1e3)
    return {"name": "coo_spmm", "source": "src/repro_torch/csrc/coo_spmm.cu",
            "replaces": "src/repro/kernels/coo_spmm.py:214",
            "by_semiring": by}


def _one_hot(m, n, hot, dev):
    import torch
    a = torch.zeros((m, n), dtype=torch.bool, device=dev)
    a[torch.arange(m, device=dev), torch.as_tensor(hot, device=dev)] = True
    return a


def _assert_mixed(name, want):
    """A 𝔹 answer a wrong kernel could match only by luck: 20–80% true."""
    share = float(want.float().mean())
    if not 0.2 < share < 0.8:
        raise AssertionError(f"{name}: saturated check ({share:.3f} of the "
                             f"plain answer true)")


def kernel_b2(dev, data):
    """The FGH phase's products on the dense Erdős–Rényi E (4096², 40%
    dense): Π₁'s joins E ⊕.⊗ R (4096³; bool, and nat/trop on 40%-live
    relations), Π₂'s one-row rounds Δ ⊕.⊗ E (1×4096×4096; bool, trop)
    and the batched vector_dense pack (256 rows, bool), each through
    the path plan_matmul picks.

    The 𝔹 operands are the main path's own, chosen so the answer is
    mixed (checked: 20–80% true): Π₂'s Δ is one-hot (a row of E comes
    out), swept over every K split of the stream geometry for m = 1 and
    spread over all of K for the 256-row pack; Π₁'s R has density
    1/(0.4·4096), about one hit a sum."""
    import numpy as np
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import ref, semiring_matmul
    rng = data["rng"]
    gd = data["gd"]
    n = gd.n
    adj = np.zeros((n, n), bool)
    adj[gd.edges[:, 0], gd.edges[:, 1]] = True
    e_bool = torch.from_numpy(adj).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    by = {}
    for name, m in B2_SHAPES:
        sr = sr_mod.get(name)
        key = f"{name} {m}x{n}x{n}"
        path, geo = semiring_matmul.plan_matmul(name, m, n, n)
        if name == "bool":
            if m == n:      # Π₁: E ⊕.⊗ a sparse 0/1 relation
                a = e_bool
                b = torch.from_numpy(rng.random((n, n))
                                     < 1 / (0.4 * n)).to(dev)
            else:           # Π₂: one-hot Δ rows ⊕.⊗ E
                a = _one_hot(m, n, np.linspace(0, n - 1, m).round()
                             .astype(np.int64), dev)
                b = e_bool
        else:
            live = 0.4 if m == n else 0.05
            a = torch.from_numpy(frontier(rng, (m, n), name, live=live)
                                 ).to(dev)
            b = torch.from_numpy(frontier(rng, (n, n), name, live=0.4)
                                 ).to(dev)
        if name == "bool" and m == 1:
            # one hot K row in each split of the stream geometry
            kps = geo.k_per_split
            for s in range(geo.splits):
                hot = min(n - 1, s * kps + (7 * s) % kps)
                a1 = _one_hot(1, n, [hot], dev)
                want = ref.semiring_matmul_ref(sr, a1, b)
                _assert_mixed(f"semiring_matmul/{key}", want)
                _check(f"{key} hot {hot}", "semiring_matmul",
                       semiring_matmul.semiring_matmul_cuda(name, a1, b),
                       want)
        got = semiring_matmul.semiring_matmul_cuda(name, a, b)
        want = ref.semiring_matmul_ref(sr, a, b)
        if name == "bool":
            _assert_mixed(f"semiring_matmul/{key}", want)
        err = _check(key, "semiring_matmul", got, want)

        def kernel():
            return semiring_matmul.semiring_matmul_cuda(name, a, b)
        small = m <= semiring_matmul.M_STREAM
        reps = 50 if small else (20 if m < n else 5)
        entry = dict(
            shape={"m": m, "k": n, "n": n}, path=path, max_abs_err=err,
            ms=time_ms(kernel, reps, hide_host=True),
            cold_ms=time_cold_ms(kernel, 10),
            host_ms=time_ms(kernel, reps),
            plain_ms=time_ms(lambda: ref.semiring_matmul_ref(sr, a, b),
                             2 if m == n else 5),
            library_ms=None, library_call=None, library_bf16_ms=None)
        if name in ("bool", "nat"):  # the f32 dot; bool also in bf16
            a32, b32 = a.float(), b.float()
            lib = torch.matmul(a32, b32)
            if max_abs_err(lib > 0.5 if name == "bool" else lib,
                           want) != 0.0:
                raise AssertionError("torch.matmul yardstick disagrees")
            entry.update(library_ms=time_ms(lambda: torch.matmul(a32, b32),
                                            reps, hide_host=small),
                         library_call="torch.matmul (f32, TF32 off)")
            if name == "bool":
                a16, b16 = a.bfloat16(), b.bfloat16()
                if max_abs_err(torch.matmul(a16, b16) > 0.5, want) != 0.0:
                    raise AssertionError("bf16 yardstick disagrees")
                entry["library_bf16_ms"] = time_ms(
                    lambda: torch.matmul(a16, b16), reps, hide_host=small)
                entry["library_bf16_call"] = "torch.matmul (bf16 0/1)"
            del a32, b32, lib
        if path == "tc_bool":  # B as a .t() view: no transpose inside
            b_kmajor = b.t().contiguous().t()
            entry["k_major_ms"] = time_ms(
                lambda: semiring_matmul.semiring_matmul_cuda(
                    name, a, b_kmajor), reps)
            del b_kmajor
        ops = 2.0 * m * n * n
        isz = a.element_size()
        nbytes = float(isz * (m * n + n * n + m * n))
        bound, by_what = _bound(nbytes, ops, INT8_TC_OPS
                                if path == "tc_bool" else FP32_SIMT_FLOPS)
        entry.update(bound_ms=bound, bound_by=by_what, ops=ops,
                     bytes=nbytes)
        if name in ("trop", "maxplus") and path == "tile_f32":
            # add, then min/max: two SIMT instructions per (i, j, k)
            entry["simt_issue_floor_ms"] = 2 * ops / FP32_SIMT_FLOPS * 1e3
        if name == "bool":
            entry["true_share"] = float(want.float().mean())
        by[key] = entry
    return {"name": "semiring_matmul",
            "source": "src/repro_torch/csrc/semiring_matmul.cu",
            "replaces": "src/repro/kernels/semiring_matmul.py:35",
            "by_shape": by}


# --------------------------------------------------------------------------
# phases 2-4: the main path
# --------------------------------------------------------------------------


class Counted:
    """Launch counts of one main-path phase: zeroed on entry, read on
    exit."""

    def __enter__(self):
        from repro_torch.kernels import ops
        import torch
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import (coo_segment, flash_attention, ops,
                                         semiring_matmul)
        import torch
        torch.cuda.synchronize()
        self.counts = ops.launch_counts()
        self.b3_paths = dict(coo_segment.segment_reduce_cuda.by_path)
        self.b2_paths = dict(semiring_matmul.semiring_matmul_cuda.by_path)
        self.b5_paths = dict(flash_attention.flash_attention_cuda.by_path)
        return False


def wall(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _dbs(dev, data):
    from repro_torch.core import engine
    from repro_torch.datalog import programs
    g, e = data["g"], data["E"]
    out = {}
    for kind, bench in (("bm", programs.bm(a=0)), ("cc", programs.cc())):
        out[kind] = engine.Database(
            bench.original.schema, {"id": g.n},
            {"E": e, "V": g.vertex_set(device=dev)}, dev)
    return out


def _no_b3(phase, counts):
    """B3 is the latency path's kernel; the other phases launch none."""
    if counts["coo_segment"]:
        raise AssertionError(f"{phase}: B3 coo_segment launched "
                             f"{counts['coo_segment']} times")


def phase_latency(dev, data):
    """BM and CC Π₂, one query each, through run_program."""
    import numpy as np
    from repro_torch.core.program import run_program
    from repro_torch.datalog import programs
    g = data["g"]
    dbs = data.setdefault("dbs", _dbs(dev, data))
    csr = csr_host(g.n, g.edges)
    out = {}
    with Counted() as c:
        for kind, prog in (("bm", programs.bm(a=0).optimized),
                           ("cc", programs.cc().optimized)):
            (x, st), first_ms = wall(lambda: run_program(prog, dbs[kind]))
            times = [wall(lambda: run_program(prog, dbs[kind]))[1]
                     for _ in range(5)]
            got = x.cpu().numpy()
            want = bfs_reach(csr, 0) if kind == "bm" else cc_min_labels(csr)
            if not np.array_equal(got, want):
                raise AssertionError(f"latency {kind}: answer differs from "
                                     f"the scipy oracle")
            data.setdefault("warm", {})[f"latency_{kind}"] = \
                (lambda p=prog, d=dbs[kind]: run_program(p, d))
            out[kind] = dict(runner=st.plan.strata[0].runner,
                             iterations=st.iterations, first_ms=first_ms,
                             ms=sorted(times)[len(times) // 2],
                             all_ms=times)
            log(f"latency {kind}: {out[kind]['runner']} "
                f"{st.iterations} rounds, first {first_ms:.1f} ms, median "
                f"{out[kind]['ms']:.2f} ms, matches scipy")
    out["launches"] = c.counts
    out["b3_paths"] = c.b3_paths
    log(f"latency launches {c.counts}; B3 paths {c.b3_paths}")
    n_b3 = c.counts["coo_segment"]
    if n_b3 <= 0:
        raise AssertionError("latency: B3 coo_segment never launched")
    if c.b3_paths != {"runs": n_b3, "scatter": 0}:
        raise AssertionError(f"latency: B3's {n_b3} launches went "
                             f"{c.b3_paths}, not all through runs")
    return out


def phase_batched(dev, data):
    """B = 256 sources through plan_program(throughput) + compile_batched,
    each row held against its single-source run."""
    import numpy as np
    import torch
    from repro_torch.core import planner
    from repro_torch.datalog import programs
    from repro_torch.kernels import coo_spmm
    from repro_torch.sparse import fixpoint as fx
    g, rng = data["g"], data["rng"]
    dbs = data.setdefault("dbs", _dbs(dev, data))
    sources = rng.choice(g.n, BATCH, replace=False)
    out, runs, b1 = {}, {}, {}
    b1_path = {"bm": "words_bool", "cc": "lanes_f32"}
    with Counted() as c:
        for kind in ("bm", "cc"):
            paths0 = dict(coo_spmm.spmm_cuda.by_path)
            launches0 = coo_spmm.spmm_cuda.launches
            prog = programs.bm(a=0).optimized if kind == "bm" else \
                programs.cc().optimized
            db = dbs[kind]
            plan = planner.plan_program(prog, db, objective="throughput")
            runner = plan.strata[0].runner
            if runner != "sparse_frontier_pallas":
                raise AssertionError(f"batched {kind}: planner picked "
                                     f"{runner}")
            edges = planner.materialize_edges(plan, db)
            run = planner.compile_batched(plan)
            if kind == "bm":
                init = torch.stack([planner.source_init(
                    plan, programs.bm(a=int(s)).optimized, db)
                    for s in sources])
            else:  # CC restricted to a random 1% seed set per row
                base = planner.source_init(plan, prog, db)
                seeds = torch.from_numpy(
                    rng.random((BATCH, g.n)) < 0.01).to(dev)
                init = torch.where(seeds, base, torch.full_like(
                    base, float("inf")))
            (x, it), first_ms = wall(lambda: run(edges, init))
            (x, it), ms = wall(lambda: run(edges, init))
            runs[kind] = (edges, init, x, it)
            data.setdefault("warm", {})[f"batched_{kind}"] = \
                (lambda r=run, e=edges, i=init: r(e, i))
            out[kind] = dict(runner=runner, first_ms=first_ms, ms=ms,
                             per_source_ms=ms / BATCH,
                             rounds_max=int(it.max()))
            b1[kind] = dict(
                launches=coo_spmm.spmm_cuda.launches - launches0,
                by_path={k: v - paths0[k] for k, v in
                         coo_spmm.spmm_cuda.by_path.items()})
    out["launches"] = c.counts
    out["b1_paths"] = b1
    log(f"batched launches {c.counts}; B1 paths {b1}")
    if c.counts["coo_spmm"] <= 0:
        raise AssertionError("batched: B1 coo_spmm never launched")
    _no_b3("batched", c.counts)
    # every B1 launch of BM went through words_bool, of CC lanes_f32
    if sum(v["launches"] for v in b1.values()) != c.counts["coo_spmm"]:
        raise AssertionError(f"batched: B1 paths {b1} do not account for "
                             f"{c.counts['coo_spmm']} launches")
    for kind, v in b1.items():
        want = {k: v["launches"] if k == b1_path[kind] else 0
                for k in v["by_path"]}
        if v["launches"] <= 0 or v["by_path"] != want:
            raise AssertionError(f"batched {kind}: B1 launches went "
                                 f"{v['by_path']}, not all "
                                 f"{v['launches']} through "
                                 f"{b1_path[kind]}")
    # every row against its own single-source run (outside the count)
    for kind, (edges, init, x, it) in runs.items():
        single = [fx.fixpoint(edges, init[b]) for b in range(BATCH)]
        ys = torch.stack([s[0] for s in single])
        its = np.asarray([s[1] for s in single], np.int32)
        if not torch.equal(x, ys) or not np.array_equal(
                it.cpu().numpy(), its):
            raise AssertionError(f"batched {kind}: rows differ from their "
                                 f"single-source runs")
        if kind == "bm":
            want = bfs_reach(csr_host(g.n, g.edges), int(sources[0]))
            if not np.array_equal(x[0].cpu().numpy(), want):
                raise AssertionError("batched bm: row 0 differs from BFS")
        log(f"batched {kind}: {out[kind]['runner']} B={BATCH} "
            f"{out[kind]['ms']:.2f} ms ({out[kind]['per_source_ms']:.3f} "
            f"ms/source), rows equal single-source answers and counts")
    return out


def phase_fgh(dev, data):
    """BM Π₁ (dense all-pairs) against Π₂ on the dense Erdős–Rényi graph;
    Π₁'s joins must go through B2's tc_bool path, Π₂'s rounds through
    its stream path.  BFS reaches every node of that graph, so beside it
    Π₁ = Π₂ = BFS is checked on a sparse one whose answer is mixed."""
    import numpy as np
    from repro_torch.core.program import run_program
    from repro_torch.datalog import datasets, programs
    gd = data["gd"]
    bench = programs.bm(a=0)
    db = bench.make_db(gd, device=dev)
    out = {}
    with Counted() as c1:
        (x1, st1), ms1 = wall(lambda: run_program(bench.original, db))
    with Counted() as c2:
        (x2, st2), ms2 = wall(lambda: run_program(bench.optimized, db))
        (x2, st2), ms2_warm = wall(lambda: run_program(bench.optimized, db))
    data.setdefault("warm", {}).update(
        fgh_pi1=lambda: run_program(bench.original, db),
        fgh_pi2=lambda: run_program(bench.optimized, db))
    counts = {k: c1.counts[k] + c2.counts[k] for k in c1.counts}
    out.update(pi1=dict(runner=st1.plan.strata[0].runner,
                        iterations=st1.iterations, ms=ms1,
                        b2_paths=c1.b2_paths),
               pi2=dict(runner=st2.plan.strata[0].runner,
                        iterations=st2.iterations, ms=ms2,
                        warm_ms=ms2_warm, b2_paths=c2.b2_paths),
               launches=counts)
    if st1.plan.strata[0].storage or st2.plan.strata[0].storage:
        raise AssertionError("fgh: the planner re-homed E; it must stay "
                             "dense")
    if not np.array_equal(x1.cpu().numpy(), x2.cpu().numpy()):
        raise AssertionError("fgh: Π₁ and Π₂ answers differ")
    want = bfs_reach(csr_host(gd.n, gd.edges), 0)
    if not np.array_equal(x2.cpu().numpy(), want):
        raise AssertionError("fgh: answer differs from BFS")
    log(f"fgh: Π₁ {out['pi1']['runner']} {st1.iterations} rounds "
        f"{ms1:.1f} ms; Π₂ {out['pi2']['runner']} {st2.iterations} rounds "
        f"{ms2:.1f} ms (warm {ms2_warm:.1f} ms); answers equal, match BFS")
    log(f"fgh launches {counts}; B2 paths Π₁ {c1.b2_paths}, Π₂ "
        f"{c2.b2_paths}")
    if counts["semiring_matmul"] <= 0:
        raise AssertionError("fgh: B2 semiring_matmul never launched")
    _no_b3("fgh", counts)
    for which, c, path in (("Π₁", c1, "tc_bool"), ("Π₂", c2, "stream")):
        n_mm = c.counts["semiring_matmul"]
        if n_mm <= 0 or c.b2_paths[path] != n_mm:
            raise AssertionError(f"fgh: {which}'s {n_mm} B2 products went "
                                 f"{c.b2_paths}, not all through {path}")
    # the same check where BFS reaches part of the graph: erdos_renyi at
    # average degree 1.5 (seed 3: 6,145 edges, 58% reached from node 0)
    gs = datasets.erdos_renyi(N_DENSE, SPARSE_DEG, seed=SPARSE_SEED)
    dbs = bench.make_db(gs, device=dev)
    (y1, s1), ms1s = wall(lambda: run_program(bench.original, dbs))
    (y2, s2), ms2s = wall(lambda: run_program(bench.optimized, dbs))
    want = bfs_reach(csr_host(gs.n, gs.edges), 0)
    share = float(want.mean())
    if not 0.2 < share < 0.8:
        raise AssertionError(f"fgh sparse: saturated check ({share:.3f} of "
                             f"the BFS answer true)")
    if not np.array_equal(y1.cpu().numpy(), want) or \
            not np.array_equal(y2.cpu().numpy(), want):
        raise AssertionError("fgh sparse: Π₁, Π₂ and BFS differ")
    out["sparse"] = dict(n=gs.n, edges=int(len(gs.edges)), true_share=share,
                         pi1_iterations=s1.iterations, pi1_ms=ms1s,
                         pi2_iterations=s2.iterations, pi2_ms=ms2s)
    log(f"fgh sparse: erdos_renyi({gs.n}, {SPARSE_DEG}) {len(gs.edges)} "
        f"edges, {100 * share:.1f}% reached; Π₁ {s1.iterations} rounds "
        f"{ms1s:.1f} ms, Π₂ {s2.iterations} rounds {ms2s:.1f} ms; Π₁ = Π₂ "
        f"= BFS")
    return out


# --------------------------------------------------------------------------
# phase 1, continued: B4 and B5 at the serving path's shapes
# --------------------------------------------------------------------------


def _check_float(name, kernel, got, want):
    """max |err| of a float kernel against its plain version, held to
    FLOAT_TOL · max(1, max |plain|)."""
    import torch
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{kernel}/{name}: non-finite output")
    err = max_abs_err(got, want)
    tol = FLOAT_TOL * max(1.0, float(want.abs().max()))
    if err > tol:
        raise AssertionError(f"{kernel}/{name}: kernel disagrees with its "
                             f"plain version (max |err| {err} > {tol})")
    return err, tol


def phase_lm_kernels(dev):
    """B4 and B5 at the shapes of the lm_serve phase, each timed beside
    its plain version, its library call (B5: SDPA) and its bound."""
    import torch
    results = [kernel_b4(dev), kernel_b5(dev)]
    for k in results:
        by = k["by_shape"]
        head = next(iter(by.values()))
        k.update(route="cuda",
                 max_abs_err=max(v["max_abs_err"] for v in by.values()),
                 ms=head["ms"], plain_ms=head["plain_ms"],
                 bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                 library_ms=head["library_ms"],
                 library_call=head["library_call"])
        for name, v in by.items():
            extra = (f" [cold L2 {v['cold_ms']:.4f} ms, with host "
                     f"{v['host_ms']:.4f} ms]")
            if "path" in v:
                extra = (f" [{v['path']}: cold L2 {v['cold_ms']:.4f} ms, "
                         f"with host {v['host_ms']:.4f} ms, FP32 SIMT "
                         f"bound {v['bound_simt_ms']:.4f} ms]")
            log(f"{k['name']:>16} {name:>7}: {v['ms']:.4f} ms kernel, "
                f"{v['plain_ms']:.4f} ms plain, library "
                f"{v['library_ms']} ms, bound {v['bound_ms']:.4f} ms "
                f"({v['bound_by']}), max|err| {v['max_abs_err']:.3g} "
                f"(tol {v['tol']:.3g}){extra}")
    torch.cuda.synchronize()
    return results


def _lm_cfg():
    from repro_torch import configs
    return configs.get(LM_ARCH)


def kernel_b4(dev):
    """The Mamba2 prefill scan: (B, T, d_inner) = (8, 512, 5120), a in
    (0, 1) as the sigmoid decay gives it."""
    import torch
    from repro_torch.kernels import ref, ssm_scan
    cfg = _lm_cfg()
    shape = (LM_BATCH, LM_PROMPT[1], cfg.d_inner_mult * cfg.d_model)
    g = torch.Generator(device=dev).manual_seed(4)
    a = torch.sigmoid(torch.randn(shape, generator=g, device=dev) + 2.0)
    b = torch.randn(shape, generator=g, device=dev)
    got = ssm_scan.ssm_scan_cuda(a, b)
    want = ref.ssm_scan_ref(a, b)
    err, tol = _check_float("prefill", "ssm_scan", got, want)
    n = a.numel()
    bound, by_what = _bound(3.0 * n * 4, 2.0 * n)
    def kernel():
        return ssm_scan.ssm_scan_cuda(a, b)
    by = {"prefill": dict(
        shape=dict(zip("BTD", shape)), max_abs_err=err, tol=tol,
        ms=time_ms(kernel, 20, hide_host=True),
        cold_ms=time_cold_ms(kernel, 10), host_ms=time_ms(kernel, 20),
        plain_ms=time_ms(lambda: ref.ssm_scan_ref(a, b), 5),
        library_ms=None,
        library_call="none: no single PyTorch call computes a linear "
                     "recurrence",
        bound_ms=bound, bound_by=by_what, bytes=3.0 * n * 4)}
    return {"name": "ssm_scan", "source": "src/repro_torch/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:29", "by_shape": by}


def kernel_b5(dev):
    """The shared attention block over the written slots of a 1024-slot
    KV cache, as strided views: prefill (8 × 512 queries, causal), the
    last decode step (1 query at position 543 over 544 slots) and the
    full forward of the decode check (8 × 544 queries, causal: ragged
    against the 64-row q tile).  Each shape's bound is in its path's
    unit: prefill_tc's operations at three TF32 tensor-core passes,
    decode_split's bytes; ``bound_simt_ms`` keeps the FP32 SIMT bound
    of the kernel this one replaced."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    cfg = _lm_cfg()
    b, h, d, t = LM_BATCH, cfg.n_heads, cfg.hd, LM_PROMPT[1]
    g = torch.Generator(device=dev).manual_seed(5)
    ck = torch.randn((b, LM_T_MAX, h, d), generator=g, device=dev)
    cv = torch.randn((b, LM_T_MAX, h, d), generator=g, device=dev)
    tk_dec = t + LM_MAX_NEW
    shapes = {"prefill": (torch.randn((b, t, h, d), generator=g, device=dev),
                          ck[:, :t], cv[:, :t], 0),
              "decode": (torch.randn((b, 1, h, d), generator=g, device=dev),
                         ck[:, :tk_dec], cv[:, :tk_dec], tk_dec - 1),
              "full544": (torch.randn((b, tk_dec, h, d), generator=g,
                                      device=dev),
                          ck[:, :tk_dec], cv[:, :tk_dec], 0)}
    by = {}
    for name, (q, k, v, off) in shapes.items():
        tq, tk = q.shape[1], k.shape[1]
        path, geo = fa.plan_attention(b, tq, tk, h, h, d, q_offset=off)
        paths = dict(fa.flash_attention_cuda.by_path)
        got = fa.flash_attention_cuda(q, k, v, q_offset=off)
        paths[path] += 1
        if fa.flash_attention_cuda.by_path != paths:
            raise AssertionError(f"flash_attention/{name}: launched "
                                 f"{fa.flash_attention_cuda.by_path}, "
                                 f"expected one more {path}")
        want = ref.attention_ref(q, k, v, q_offset=off)
        err, tol = _check_float(name, "flash_attention", got, want)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def kernel():
            return fa.flash_attention_cuda(q, k, v, q_offset=off)

        def library():   # causal from 0, or one query that sees every key
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=off == 0)
        lib_err = max_abs_err(library().transpose(1, 2), want)
        if lib_err > tol:
            raise AssertionError(f"SDPA yardstick disagrees ({name}: "
                                 f"{lib_err})")
        visible = sum(min(tk, off + i + 1) for i in range(tq))
        ops = 4.0 * b * h * d * visible
        nbytes = 4.0 * d * (2 * b * tq * h + 2 * b * tk * h)
        if path == "prefill_tc":
            bound, by_what = _bound(nbytes, 3 * ops, TF32_TC_FLOPS)
        else:
            bound, by_what = _bound(nbytes, ops)
        by[name] = dict(
            shape={"B": b, "Tq": tq, "Tk": tk, "Hq": h, "Hkv": h, "D": d,
                   "q_offset": off},
            path=path, grid=list(geo.grid), splits=geo.splits,
            keys_per_split=geo.keys_per_split,
            max_abs_err=err, tol=tol,
            ms=time_ms(kernel, 20, hide_host=True),
            cold_ms=time_cold_ms(kernel, 10),
            host_ms=time_ms(kernel, 20),
            plain_ms=time_ms(lambda: ref.attention_ref(q, k, v,
                                                       q_offset=off), 5),
            library_ms=time_ms(library, 20, hide_host=True),
            library_call="F.scaled_dot_product_attention (f32)",
            bound_ms=bound, bound_by=by_what,
            bound_simt_ms=_bound(nbytes, ops)[0], ops=ops, bytes=nbytes)
    return {"name": "flash_attention",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:32",
            "by_shape": by}


# --------------------------------------------------------------------------
# phase 5: Zamba2-2.7B greedy serving
# --------------------------------------------------------------------------


def phase_lm_serve(dev, data):
    """serve_batch at full width; decode checked against a full forward."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    # full-f32 products, as the reference computes them (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg()
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.vocab)
    if widths != LM_WIDTHS:
        raise AssertionError(f"lm_serve: {LM_ARCH} widths {widths}")
    (params, init_ms) = wall(lambda: T.init_params(cfg, seed=0, device=dev))
    n_tensor = sum(x.numel() for x in _leaves(params))
    rng = data["rng"]
    lengths = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_BATCH)
    lengths[0] = LM_PROMPT[1]          # the batch pads to 512
    prompts = [rng.integers(1, cfg.vocab, n) for n in lengths]

    def run(max_new):
        reqs = [serve.Request(p, max_new) for p in prompts]
        stats = serve.serve_batch(LM_ARCH, reqs, smoke=False,
                                  t_max=LM_T_MAX, device=dev, params=params)
        return reqs, stats
    run(2)                             # warm-up: cuBLAS handles, clocks
    torch.cuda.reset_peak_memory_stats()
    with Counted() as c:
        reqs, stats = run(LM_MAX_NEW)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"lm_serve launches {c.counts}")
    _no_b3("lm_serve", c.counts)
    n_seg = cfg.n_layers // cfg.hybrid_attn_every
    want = {"ssm_scan": cfg.n_layers,
            "flash_attention": n_seg * (1 + LM_MAX_NEW)}
    for name, n in want.items():
        if c.counts[name] != n:
            raise AssertionError(f"lm_serve: {name} launched "
                                 f"{c.counts[name]} times, expected {n}")
    # the prefill's attention on tensor cores, every decode step split-KV
    want_paths = {"prefill_tc": n_seg, "decode_split": n_seg * LM_MAX_NEW}
    log(f"lm_serve B5 paths {c.b5_paths}")
    if c.b5_paths != want_paths:
        raise AssertionError(f"lm_serve: B5 launches went {c.b5_paths}, "
                             f"expected {want_paths}")
    out = np.array([r.out for r in reqs])
    if out.shape != (LM_BATCH, LM_MAX_NEW) or out.min() < 0 \
            or out.max() >= cfg.vocab:
        raise AssertionError(f"lm_serve: tokens {out.shape}, range "
                             f"[{out.min()}, {out.max()}]")
    # a full forward (no cache) over prompt + generated tokens ends where
    # the last decode step did
    padded = np.zeros((LM_BATCH, LM_PROMPT[1]), np.int64)
    for i, p in enumerate(prompts):
        padded[i, LM_PROMPT[1] - len(p):] = p
    full_tokens = torch.from_numpy(np.concatenate([padded, out], 1)).to(dev)
    (full, _), full_ms = wall(lambda: T.forward(params, cfg, full_tokens))
    dec, ref_last = stats["last_logits"], full[:, -1]
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError("lm_serve: non-finite decode logits")
    err = max_abs_err(dec, ref_last)
    tol = LOGIT_TOL * max(1.0, float(ref_last.abs().max()))
    if err > tol:
        raise AssertionError(f"lm_serve: decode logits differ from the full "
                             f"forward (max |err| {err} > {tol})")
    top2 = torch.topk(ref_last, 2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    same = dec.argmax(-1) == ref_last.argmax(-1)
    if not bool(same[clear].all()):
        raise AssertionError("lm_serve: decode argmax differs from the full "
                             "forward where the top-2 margin exceeds tol")
    del full
    res = dict(arch=LM_ARCH, widths=dict(zip(
                   ("layers", "d_model", "heads", "head_dim", "vocab"),
                   widths)),
               param_count=cfg.param_count(), tensor_elements=n_tensor,
               batch=LM_BATCH, prompt_lengths=[int(x) for x in lengths],
               max_new=LM_MAX_NEW, t_max=LM_T_MAX, init_ms=init_ms,
               prefill_ms=stats["prefill_s"] * 1e3,
               decode_ms_per_step=stats["decode_s"] * 1e3 / LM_MAX_NEW,
               tok_per_s=stats["tok_per_s"], full_forward_ms=full_ms,
               logit_max_abs_err=err, logit_tol=tol,
               argmax_checked=int(clear.sum()), peak_mem_gb=peak_gb,
               launches=c.counts, b5_paths=c.b5_paths)
    log(f"lm_serve: {LM_ARCH} {cfg.param_count() / 1e9:.2f} B params "
        f"({n_tensor} tensor elements), B={LM_BATCH} prompts "
        f"{int(lengths.min())}-{int(lengths.max())} → {LM_PROMPT[1]}, "
        f"{LM_MAX_NEW} new: prefill {res['prefill_ms']:.1f} ms, decode "
        f"{res['decode_ms_per_step']:.2f} ms/step, "
        f"{res['tok_per_s']:.1f} tok/s, peak {peak_gb:.1f} GB; decode vs "
        f"full forward max|err| {err:.3g} (tol {tol:.3g}), argmax equal "
        f"on {int(clear.sum())}/{LM_BATCH} clear rows [{nvidia_smi()}]")
    cache = T.init_cache(cfg, LM_BATCH, LM_T_MAX, device=dev)
    prompt_t = full_tokens[:, :LM_PROMPT[1]]
    last, last_pos = full_tokens[:, -1:], LM_PROMPT[1] + LM_MAX_NEW - 1
    data.setdefault("warm", {}).update(
        lm_prefill=lambda: T.forward(params, cfg, prompt_t,
                                     cache={**cache, "pos": 0}),
        lm_decode=lambda: T.decode_step(params, cfg, last,
                                        {**cache, "pos": last_pos}))
    return res


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# --------------------------------------------------------------------------
# where the time goes
# --------------------------------------------------------------------------


def phase_profile(data):
    """One warm call of each main-path cell under ``torch.profiler``:
    device time by kernel, and the device's busy share of the call's
    unprofiled wall time.  A capture is complete when it holds at least
    one event per launch the wrappers counted during the profiled call;
    an incomplete capture is retried (up to 3 times) and flagged."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ours = {"coo_segment": ("segment_runs", "scatter_bool", "scatter_float",
                            "fill_float"),
            "coo_spmm": ("spmm_items", "spmm_fold", "spmm_pack",
                         "spmm_unpack"),
            "semiring_matmul": ("semiring_mm",),
            "ssm_scan": ("ssm_scan_kernel",),
            "flash_attention": ("flash_prefill_tc", "flash_decode_split",
                                "flash_decode_combine")}
    out = {}
    for cell, fn in data["warm"].items():
        fn()
        _, wall_ms = wall(fn)
        for attempt in range(3):
            with Counted() as c, profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            spans, by_name, seen = [], {}, dict.fromkeys(ours, 0)
            kernel_us = dict.fromkeys(ours, 0.0)
            for ev in prof.events():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                lo, hi = ev.time_range.start, ev.time_range.end
                spans.append((lo, hi))
                by_name[ev.name] = by_name.get(ev.name, 0.0) + (hi - lo)
                for k, pats in ours.items():
                    if any(p in ev.name for p in pats):
                        seen[k] += 1
                        kernel_us[k] += hi - lo
            complete = all(seen[k] >= c.counts[k] for k in ours)
            if complete:
                break
        busy, end = 0.0, float("-inf")
        for lo, hi in sorted(spans):
            if hi > end:
                busy += hi - max(lo, end)
                end = hi
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out[cell] = dict(wall_ms=wall_ms, device_busy_ms=busy / 1e3,
                         busy_share=busy / 1e3 / wall_ms,
                         complete=complete, attempts=attempt + 1,
                         device_events=len(spans), launches=c.counts,
                         kernel_ms={k: v / 1e3 for k, v in kernel_us.items()
                                    if v},
                         top=[(name[:90], us / 1e3) for name, us in top])
        log(f"profile {cell}: device busy {busy / 1e3:.3f} ms of "
            f"{wall_ms:.3f} ms ({100 * busy / 1e3 / wall_ms:.0f}%), "
            f"{len(spans)} device events, complete={complete}; ours: "
            f"{ {k: round(v, 4) for k, v in out[cell]['kernel_ms'].items()} }"
            f"; top: " +
            "; ".join(f"{name[:40]} {us / 1e3:.3f} ms"
                      for name, us in top[:3]))
    return out


if __name__ == "__main__":
    sys.exit(main())
