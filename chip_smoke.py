#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold each of
its hand-written CUDA kernels against its plain PyTorch version.

Run from the root of a checkout, on a machine with an NVIDIA GPU and
``nvcc`` (``/usr/local/cuda``)::

    python3 chip_smoke.py

It builds ``src/repro_torch/csrc/*.cu`` into ``build/repro_torch/`` and
runs four phases; any failure exits non-zero:

1. kernels — B1 ``coo_spmm``, B2 ``semiring_matmul`` and B3
   ``coo_segment`` against their plain versions on the card, at the
   main path's shapes, for bool, trop and nat, each timed beside its
   plain version, a PyTorch library call where one computes the same
   function, and its bound;
2. latency — ``run_program`` of BM and CC Π₂ on ``powerlaw(81_306, 11)``
   (≈1.79M directed edges, the scale of SNAP ego-Twitter), checked
   against a scipy BFS and scipy connected components; B3 must launch;
3. batched serving — ``plan_program(objective="throughput")`` +
   ``compile_batched`` for BM and CC with B = 256 sources; every row
   must equal its single-source answer and iteration count; B1 must
   launch;
4. FGH — BM Π₁ against Π₂ on the dense ``erdos_renyi(4096, 0.4·4096)``
   (E stays dense, so Π₁'s joins and Π₂'s vector rounds run on B2);
   equal answers; B2 must launch.

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

N_POWERLAW, M_ATTACH = 81_306, 11
N_DENSE = 4096
BATCH = 256


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
    kernels = phase_kernels(dev, data)
    main_path = {}
    main_path["latency"] = phase_latency(dev, data)
    main_path["batched"] = phase_batched(dev, data)
    main_path["fgh"] = phase_fgh(dev, data)
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
    log(json.dumps({"kernels": [
        {**{key: k[key] for key in top},
         "library_call": k["library_call"],
         "bound_gathered_ms": k.get("bound_gathered_ms"),
         "by_semiring": k["by_semiring"]} for k in kernels]}))
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


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
        by = k["by_semiring"]
        head = by["bool"]
        k.update(route="cuda", max_abs_err=max(v["max_abs_err"]
                                               for v in by.values()),
                 ms=head["ms"], plain_ms=head["plain_ms"],
                 bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                 library_ms=head["library_ms"],
                 library_call=head["library_call"])
        if "bound_gathered_ms" in head:
            k["bound_gathered_ms"] = head["bound_gathered_ms"]
        for name, v in by.items():
            hub = f", hub row {v['hub_row_ms']:.4f} ms" \
                if "hub_row_ms" in v else ""
            log(f"{k['name']:>16} {name:>5}: {v['ms']:.4f} ms kernel, "
                f"{v['plain_ms']:.4f} ms plain, library "
                f"{v['library_ms']} ms, bound {v['bound_ms']:.4f} ms "
                f"({v['bound_by']}), max|err| {v['max_abs_err']}{hub}")
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


def kernel_b3(dev, data):
    """The latency path's SpMV scatter: (nnz,) payloads by dst over the
    power-law operator (vspm: ids = coords[:, 1])."""
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_segment, ref
    rel, rng = data["E"], data["rng"]
    n = rel.shape[1]
    ids = rel.col(1, torch.int32)
    ids64 = ids.long()
    src = rel.col(0)
    by = {}
    for name in SEMIRINGS:
        sr = sr_mod.get(name)
        x = torch.from_numpy(frontier(rng, (n,), name)).to(dev)
        w = cast_relation(rel, name).values
        vals = sr.mul(w, x.index_select(0, src)).contiguous()
        got = coo_segment.segment_reduce_cuda(name, vals, ids, n)
        want = ref.segment_reduce_ref(sr, vals, ids, n)
        err = _check(name, "coo_segment", got, want)
        reduce = sr_mod.SCATTER_REDUCE[name]
        lib_vals = vals.to(torch.uint8) if name == "bool" else vals
        base_dtype = lib_vals.dtype

        def library():
            out = torch.full((n,), 0 if name == "bool" else sr.zero,
                             dtype=base_dtype, device=dev)
            return out.scatter_reduce_(0, ids64, lib_vals, reduce,
                                       include_self=True)
        if max_abs_err(library(), want) != 0.0:
            raise AssertionError(f"scatter_reduce_ yardstick disagrees "
                                 f"({name})")
        nbytes = vals.numel() * vals.element_size() + ids.numel() * 4 \
            + n * got.element_size()
        bound, by_what = _bound(nbytes)
        by[name] = dict(
            shape={"m": int(vals.shape[0]), "n": n, "lanes": 1},
            max_abs_err=err,
            ms=time_ms(lambda: coo_segment.segment_reduce_cuda(
                name, vals, ids, n), 20),
            plain_ms=time_ms(lambda: ref.segment_reduce_ref(
                sr, vals, ids, n), 5),
            library_ms=time_ms(library, 20),
            library_call="Tensor.scatter_reduce_",
            bound_ms=bound, bound_by=by_what, bytes=nbytes)
    return {"name": "coo_segment",
            "source": "src/repro_torch/csrc/coo_segment.cu",
            "replaces": "src/repro/kernels/coo_segment.py:38",
            "by_semiring": by}


def kernel_b1(dev, data):
    """The batched path's fused advance: (n, 256) frontiers over the
    power-law operator's dst-sorted plan (transpose: Δ ⊗ E)."""
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
        p = plan.on(dev)
        x = torch.from_numpy(frontier(rng, (plan.n_in, BATCH), name)).to(dev)
        got = coo_spmm.spmm_cuda(plan, x)
        want = ref.coo_spmm_ref(sr, p["src"], p["w"], p["dst"], x, plan.n_out)
        err = _check(name, "coo_spmm", got, want)
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
            library_ms = time_ms(lambda: torch.sparse.mm(a, x), 10)
            library_call = "torch.sparse.mm (CSR)"
        # the hub row alone (its edges only): the serial work one block
        # does for the power-law's largest in-degree, plus the output fill
        degrees = torch.bincount(p["dst"].long(), minlength=plan.n_out)
        hub = int(torch.argmax(degrees))
        on_hub = plan.dst == hub
        hub_rel = SparseRelation.from_coo(
            np.stack([plan.src[on_hub], plan.dst[on_hub]], axis=1),
            plan.w[on_hub], rel.shape, name, device=dev)
        hub_plan = coo_spmm.plan_geometry(hub_rel, transpose=True)
        hub_ms = time_ms(lambda: coo_spmm.spmm_cuda(hub_plan, x), 10)
        isz = x.element_size()
        idx_bytes = 4 * plan.nnz + 4 * len(plan.udst) \
            + 4 * (len(plan.udst) + 1) + plan.nnz * p["w"].element_size()
        out_bytes = plan.n_out * BATCH * isz
        nbytes = idx_bytes + plan.n_in * BATCH * isz + out_bytes
        bound, by_what = _bound(nbytes)
        gathered = idx_bytes + plan.nnz * BATCH * isz + out_bytes
        by[name] = dict(
            shape={"nnz": plan.nnz, "n": plan.n_out, "lanes": BATCH,
                   "rows": len(plan.udst),
                   "max_row_edges": int(degrees.max())},
            hub_row_ms=hub_ms,
            max_abs_err=err,
            ms=time_ms(lambda: coo_spmm.spmm_cuda(plan, x), 10),
            plain_ms=time_ms(lambda: ref.coo_spmm_ref(
                sr, p["src"], p["w"], p["dst"], x, plan.n_out), 3),
            library_ms=library_ms, library_call=library_call,
            bound_ms=bound, bound_by=by_what, bytes=nbytes,
            bound_gathered_ms=gathered / HBM_BYTES_PER_S * 1e3)
    return {"name": "coo_spmm", "source": "src/repro_torch/csrc/coo_spmm.cu",
            "replaces": "src/repro/kernels/coo_spmm.py:214",
            "by_semiring": by}


def kernel_b2(dev, data):
    """The FGH phase's dense join: E (4096²) ⊕.⊗ a 4096² relation."""
    import numpy as np
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import ref, semiring_matmul
    rng = data["rng"]
    gd = data["gd"]
    n = gd.n
    adj = np.zeros((n, n), bool)
    adj[gd.edges[:, 0], gd.edges[:, 1]] = True
    by = {}
    for name in SEMIRINGS:
        sr = sr_mod.get(name)
        if name == "bool":
            a = torch.from_numpy(adj).to(dev)
            b = torch.from_numpy(rng.random((n, n)) < 0.01).to(dev)
        else:
            a = torch.from_numpy(frontier(rng, (n, n), name, live=0.4)
                                 ).to(dev)
            b = torch.from_numpy(frontier(rng, (n, n), name, live=0.4)
                                 ).to(dev)
        a32, b32 = a.float().contiguous(), b.float().contiguous()
        raw = semiring_matmul.semiring_matmul_cuda(name, a32, b32)
        got = raw > 0.5 if name == "bool" else raw
        want = ref.semiring_matmul_ref(sr, a, b)
        err = _check(name, "semiring_matmul", got, want)
        library_ms, library_call = None, None
        if name in ("bool", "nat"):  # the f32 dot the kernel computes
            torch.backends.cuda.matmul.allow_tf32 = False
            if max_abs_err(torch.matmul(a32, b32), raw) != 0.0:
                raise AssertionError("torch.matmul yardstick disagrees")
            library_ms = time_ms(lambda: torch.matmul(a32, b32), 10)
            library_call = "torch.matmul (f32, TF32 off)"
        ops = 2.0 * n * n * n
        bound, by_what = _bound(3.0 * n * n * 4, ops)
        by[name] = dict(
            shape={"m": n, "k": n, "n": n}, max_abs_err=err,
            ms=time_ms(lambda: semiring_matmul.semiring_matmul_cuda(
                name, a32, b32), 5),
            plain_ms=time_ms(lambda: ref.semiring_matmul_ref(sr, a, b), 2),
            library_ms=library_ms, library_call=library_call,
            bound_ms=bound, bound_by=by_what, ops=ops)
    return {"name": "semiring_matmul",
            "source": "src/repro_torch/csrc/semiring_matmul.cu",
            "replaces": "src/repro/kernels/semiring_matmul.py:35",
            "by_semiring": by}


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
        from repro_torch.kernels import ops
        import torch
        torch.cuda.synchronize()
        self.counts = ops.launch_counts()
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
    log(f"latency launches {c.counts}")
    if c.counts["coo_segment"] <= 0:
        raise AssertionError("latency: B3 coo_segment never launched")
    return out


def phase_batched(dev, data):
    """B = 256 sources through plan_program(throughput) + compile_batched,
    each row held against its single-source run."""
    import numpy as np
    import torch
    from repro_torch.core import planner
    from repro_torch.datalog import programs
    from repro_torch.sparse import fixpoint as fx
    g, rng = data["g"], data["rng"]
    dbs = data.setdefault("dbs", _dbs(dev, data))
    sources = rng.choice(g.n, BATCH, replace=False)
    out, runs = {}, {}
    with Counted() as c:
        for kind in ("bm", "cc"):
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
    out["launches"] = c.counts
    log(f"batched launches {c.counts}")
    if c.counts["coo_spmm"] <= 0:
        raise AssertionError("batched: B1 coo_spmm never launched")
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
    """BM Π₁ (dense all-pairs) against Π₂ on the dense Erdős–Rényi graph."""
    import numpy as np
    from repro_torch.core.program import run_program
    from repro_torch.datalog import programs
    gd = data["gd"]
    bench = programs.bm(a=0)
    db = bench.make_db(gd, device=dev)
    out = {}
    with Counted() as c:
        (x1, st1), ms1 = wall(lambda: run_program(bench.original, db))
        (x2, st2), ms2 = wall(lambda: run_program(bench.optimized, db))
        (x2, st2), ms2_warm = wall(lambda: run_program(bench.optimized, db))
    data.setdefault("warm", {}).update(
        fgh_pi1=lambda: run_program(bench.original, db),
        fgh_pi2=lambda: run_program(bench.optimized, db))
    out.update(pi1=dict(runner=st1.plan.strata[0].runner,
                        iterations=st1.iterations, ms=ms1),
               pi2=dict(runner=st2.plan.strata[0].runner,
                        iterations=st2.iterations, ms=ms2,
                        warm_ms=ms2_warm),
               launches=c.counts)
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
    log(f"fgh launches {c.counts}")
    if c.counts["semiring_matmul"] <= 0:
        raise AssertionError("fgh: B2 semiring_matmul never launched")
    return out



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
    ours = {"coo_segment": ("scatter_bool", "scatter_float"),
            "coo_spmm": ("spmm_bool", "spmm_float"),
            "semiring_matmul": ("semiring_mm",)}
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
            for ev in prof.events():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                lo, hi = ev.time_range.start, ev.time_range.end
                spans.append((lo, hi))
                by_name[ev.name] = by_name.get(ev.name, 0.0) + (hi - lo)
                for k, pats in ours.items():
                    seen[k] += any(p in ev.name for p in pats)
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
                         top=[(name[:90], us / 1e3) for name, us in top])
        log(f"profile {cell}: device busy {busy / 1e3:.3f} ms of "
            f"{wall_ms:.3f} ms ({100 * busy / 1e3 / wall_ms:.0f}%), "
            f"{len(spans)} device events, complete={complete}; top: " +
            "; ".join(f"{name[:40]} {us / 1e3:.3f} ms"
                      for name, us in top[:3]))
    return out


if __name__ == "__main__":
    sys.exit(main())
