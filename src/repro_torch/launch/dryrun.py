"""Multi-pod dry run on the meta device (counterpart of
``repro/launch/dryrun.py``).

For every (architecture × workload shape × mesh) cell: stage one rank's
step on the ``meta`` device (shapes and dtypes, no storage, no GPU) in a
fake world of the production mesh's ranks, count it op by op, and
report what the rank holds and moves.

* **The world.** ``torch.distributed``'s ``fake`` backend (it ships with
  torch, ``torch.testing._internal.distributed.fake_pg``) at 256 ranks
  (``single``, ``(16, 16)`` over ``("data", "model")``) or 512
  (``multi``, ``(2, 16, 16)`` with ``"pod"``), this process rank 0
  (``launch.mesh.make_production_mesh``).  Collectives run on meta
  tensors and move nothing; the count reads their result bytes under
  the reference's names (``all-gather``, ``reduce-scatter``, …).
* **The step.** ``train``: rank 0's parameter blocks, AdamW (or the
  optimizer asked for) and its rows of the global batch, through
  ``steps.make_sharded_train_step`` with the reference's defaults
  (``remat="full"``, ``accum_steps=1``).  ``prefill`` and ``decode``:
  the model-axis prefill and serve step on blocks, each layer gathered
  over ``"data"`` where it runs (the reference's ``"embed"`` rule splits
  the weights over ``"data"`` in serving too), the batch and the cache
  split over ``"data"`` as the reference's ``"cache_batch"`` rule does
  (``decode_32k``: 128 / 16 = 8 rows a rank), a decode step writing the
  cache's last slot (a full cache).
* **The count.** ``launch.hlo_cost``'s op-by-op count (a dot's
  ``2·|result|·|contracted|``, an elementwise or reduce op's
  ``|result|``, each operand and result's bytes; B1–B5 one op each, with
  their bounds' operations and bytes, ``kernels/costing.py``) and a
  count of live storages (views share one), each freed when its last
  reference goes, as ``collectives.STATS["gathered_peak_bytes"]``
  counts: ``argument_bytes`` the rank's inputs, ``temp_bytes`` the most
  bytes alive at once beyond them, ``output_bytes`` the outputs that do
  not alias an input.  The reference's ``xla_flops`` (XLA's own count,
  a loop body once) and ``generated_code_bytes`` have no counterpart:
  there is no compiled program.
* **The row**: the reference's keys — ``status``, ``flops``,
  ``bytes_accessed``, ``collectives{bytes, counts, total_bytes}``,
  ``memory{argument_bytes, output_bytes, temp_bytes}``, ``params_b``,
  ``active_params_b``, ``tokens``, ``wall_s`` — per rank; and, for a
  model with attention, ``heads``: the query and kv heads rank 0 holds
  (the most any rank holds, since ``sharding.head_split`` gives the
  first ranks the extra heads) and the fewest any rank holds.  A cell
  the port refuses is ``status: "skipped"`` with the reason
  (``workloads.skip_reason``'s, or ``check_model_axis``'s).

The flags ``--attn``, ``--scan`` and ``--moe-buf`` pick XLA lowerings
the reference has and the port does not: its attention is kernel B5,
its scan kernel B4, and an MoE layer's buffer is its rank's own; any
value but the reference's default is refused with that reason.

``--calibrate`` checks the count against a real step: the cell (at
``--batch``/``--seq`` small enough for one card) is staged on meta at
mesh ``(1, 1)``, then the same step runs on ``--device`` (default the
GPU; it raises without one) under the same count, and both rows are
printed with the device's peak memory and milliseconds.  On the card
the run's world is a real one-rank NCCL world; on the CPU a fake one,
so that its collectives take the card's code path (gloo's reduce-
scatter is an all-reduce).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-2.7b \\
      --shape decode_32k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out rows.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --calibrate \\
      --arch xlstm-125m --shape train_4k --batch 8 --seq 1024 --remat none
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

from repro_torch import configs
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import costing
from repro_torch.launch import hlo_cost
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import workloads as wl_mod
from repro_torch.launch.rules import make_rules
from repro_torch.models import transformer as T
from repro_torch.optimizer import OptConfig
from repro_torch.optimizer.optimizers import tree_leaves, tree_like

META = torch.device("meta")
#: the reference's flags with no counterpart here: their one value the
#: port's step is, and why no other
NO_COUNTERPART = {
    "attn": ("chunked", "the port's attention is kernel B5 (flash "
             "attention, one kernel for every mask); XLA's chunked, online "
             "and bf16 lowerings have no counterpart"),
    "scan": ("assoc", "the port's recurrence is kernel B4 (one pass over "
             "T); XLA's associative and chunked scans have no "
             "counterpart"),
    "moe_buf": ("expert", "an MoE layer's dispatch buffer is its rank's "
                "own (experts split over \"model\"); there is no buffer "
                "layout to pick"),
}


def fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks in this process, this
    process rank 0 (one made already of another size, or a real one, is
    destroyed first)."""
    if dist.is_initialized():
        if (dist.get_world_size() == world and
                dist.get_backend() == "fake"):
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _storages(tree) -> list:
    out, seen = [], set()
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                out.append(st)
    return out


class StagedCount(hlo_cost._CountMode):
    """``hlo_cost``'s op-by-op count, and the bytes of the storages the
    step makes while they live: ``peak`` the most alive at once.
    ``known`` are the step's arguments' storages, never counted."""

    def __init__(self, known):
        super().__init__()
        self.known = weakref.WeakSet(known)
        self.made = weakref.WeakSet()
        self.live = self.peak = 0
        self._lock = threading.Lock()

    def _free(self, n: int) -> None:
        with self._lock:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for st in _storages(out):
            if st in self.known or st in self.made:
                continue
            n = st.nbytes()
            self.made.add(st)
            with self._lock:
                self.live += n
                self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)
        return out


@dataclasses.dataclass
class Staged:
    """One staged call: its count and memory."""

    cost: hlo_cost.Cost
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    ms: float | None = None
    device_peak_bytes: int | None = None


def stage(fn, args: tuple, *, warm: bool = True) -> Staged:
    """Run ``fn(*args)`` once (``warm``) to build what it caches and load
    its kernels, then once more under :class:`StagedCount`; on a CUDA
    argument also the device's peak memory over the counted call
    (``torch.cuda.max_memory_allocated``, reset first), less what the
    card held before the call beyond the arguments (the library's
    workspaces, the warm call's leftovers): the step's own peak,
    arguments included; and the milliseconds of a third call, outside
    the count (whose dispatch mode costs host time a op)."""
    if warm:
        fn(*args)
    known = _storages(args)
    cuda = any(st.device.type == "cuda" for st in known)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    mode = StagedCount(known)
    with costing.open_count(mode), mode:
        out = fn(*args)
    ms = peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()        # a third call, not counted
        fn(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    arg_ids = {id(st) for st in known}
    out_bytes = sum(st.nbytes() for st in _storages(out)
                    if id(st) not in arg_ids)
    args_n = sum(st.nbytes() for st in known)
    if cuda:        # the step's own: its arguments and what it allocates
        peak = peak - base + args_n
    return Staged(mode.cost, args_n, out_bytes, mode.peak, ms, peak)


def _check_flags(kw: dict) -> None:
    for flag, (want, why) in NO_COUNTERPART.items():
        if kw.get(flag, want) != want:
            raise ValueError(f"--{flag.replace('_', '-')} "
                             f"{kw[flag]!r}: {why}")


def _specs(cfg, full: dict, mesh, rules: dict, replicate_small: int):
    """The parameters' specs; with ``replicate_small`` a leaf of fewer
    bytes is replicated (the reference's rule: no gather a step)."""
    specs = sh.tree_specs(T.param_specs(cfg), full, mesh, rules)
    if not replicate_small:
        return specs
    return tree_like(specs, [
        sh.P(*(None,) * len(s), fused=s.fused)
        if p.numel() * p.element_size() < replicate_small else s
        for s, p in zip(tree_leaves(specs), tree_leaves(full))])


def _rows(mesh, rules: dict, n: int) -> tuple[int, object]:
    """A rank's rows of a batch of ``n`` under the ``"cache_batch"`` (or
    ``"batch"``) rule, and the axes it is split over (None: whole)."""
    spec = sh.spec_for(("cache_batch",), (n,), mesh, rules)
    axis = spec[0]
    return n // sh.axis_size(mesh, axis), axis


def build_cell(arch, shape: str, mesh, *, opt_kind: str = "adamw",
               remat: str = "full", accum_steps: int = 1,
               embed_spec: str = "vocab", replicate_small: int = 0,
               donate: bool = False, device=META, batch: int | None = None,
               seq: int | None = None, **flags):
    """``((fn, args, cfg, wl), None)`` — the staged step of the cell on
    ``mesh`` with every input on ``device`` — or ``(None, reason)`` for
    a cell the port refuses.  ``arch`` is a name or a ``ModelConfig``
    (a smoke config).  ``batch`` and ``seq`` override the
    workload's global batch and sequence length (a cell cut to fit one
    card).  ``donate`` is accepted for the reference's command line: a
    cache here is updated in place anyway."""
    _check_flags(flags)
    cfg = configs.get(arch) if isinstance(arch, str) else arch
    wl = wl_mod.WORKLOADS[shape]
    wl = dataclasses.replace(wl, global_batch=batch or wl.global_batch,
                             seq_len=seq or wl.seq_len)
    reason = wl_mod.skip_reason(cfg, wl)
    if reason:
        return None, reason
    try:
        T.check_model_axis(cfg, mesh.shape.get("model", 1))
    except ValueError as e:
        return None, str(e)
    rules = make_rules(mesh, wl.kind)
    if embed_spec == "embedcol":
        rules["vocab"] = ["data"]     # shard tables on d, gather stays local
    elif embed_spec == "replicated":
        rules["vocab"] = None
    full = T.init_params(cfg, dtype=torch.bfloat16, device=device)
    specs = _specs(cfg, full, mesh, rules, replicate_small)
    blocks = steps_mod.param_blocks(full, specs, mesh)
    del full
    rows, bax = _rows(mesh, rules, wl.global_batch)

    def on(tree):
        return _realize(tree, torch.device(device), cfg)

    if wl.kind == "train":
        step, opt_init = steps_mod.make_sharded_train_step(
            cfg, OptConfig(kind=opt_kind), mesh, specs, remat=remat,
            accum_steps=accum_steps)
        state = opt_init(blocks)
        data = on(wl_mod.batch_specs(cfg, wl, rows))
        return (step, (blocks, state, data), cfg, wl), None
    with sh.use_rules(mesh, rules):
        spec_fn = (wl_mod.prefill_specs if wl.kind == "prefill" else
                   wl_mod.decode_specs)
        data = spec_fn(cfg, wl, rows)
    data = on(data)
    if wl.kind == "decode":
        data["cache"]["pos"] = wl.seq_len - 1      # a full cache
    step = (steps_mod.make_prefill_step(cfg) if wl.kind == "prefill" else
            steps_mod.make_serve_step(cfg))
    gatherer = steps_mod.layer_gatherer(cfg, mesh, specs)

    def serve(params, inputs):
        with torch.no_grad(), sh.use_rules(mesh, rules, batch_axis=bax), \
                sh.use_gatherer(gatherer):
            return step(params, inputs)
    return (serve, (blocks, data), cfg, wl), None


def _realize(tree: dict, device: torch.device, cfg, _in_cache=False
             ) -> dict:
    """``tree`` (meta inputs) itself on the meta device; elsewhere the
    same shapes and dtypes on ``device`` with values: ids drawn within
    the vocabulary, embeddings small normals, a cache zero (seed 0)."""
    if device.type == "meta":
        return tree
    gen = torch.Generator(device="cpu").manual_seed(0)

    def one(t, in_cache):
        if in_cache:
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        if not t.dtype.is_floating_point:
            return torch.randint(0, cfg.vocab, t.shape, generator=gen,
                                 dtype=t.dtype).to(device)
        return (torch.randn(t.shape, generator=gen) * 0.02).to(
            device=device, dtype=t.dtype)

    def walk(node, in_cache):
        if isinstance(node, dict):
            return {k: walk(v, in_cache or k == "cache")
                    for k, v in node.items()}
        return one(node, in_cache) if isinstance(node, torch.Tensor) \
            else node
    return walk(tree, False)


def run_cell(arch: str, shape: str, mesh_kind: str, **kw) -> dict:
    """The cell's row on the production mesh (a fake world of 256 or
    512 ranks on the meta device)."""
    t0 = time.time()
    row = {"arch": arch, "shape": shape, "mesh": mesh_kind, **kw}
    try:
        multi = mesh_kind == "multi"
        fake_world(512 if multi else 256)
        mesh = mesh_mod.make_production_mesh(multi_pod=multi, device="cpu")
        built, reason = build_cell(arch, shape, mesh, **kw)
        if built is None:
            row.update(status="skipped", reason=reason)
            return row
        fn, args, cfg, wl = built
        row.update(status="ok", **_row(stage(fn, args, warm=False), cfg,
                                       wl))
        if not cfg.attention_free:
            row["heads"] = _heads_row(cfg, mesh.shape["model"])
    except Exception as e:  # noqa: BLE001 — report the failure in the row
        row.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    row["wall_s"] = round(time.time() - t0, 1)
    return row


def _heads_row(cfg, m: int) -> dict:
    """The query and kv heads rank 0 holds on a model axis of ``m``
    (the most any rank holds: the rank staged here), the fewest any rank
    holds, and the ranks that share each head (``sharding.head_split``)."""
    split = sh.head_split(cfg.n_heads, cfg.n_kv_heads, m)
    return {"rank0": {"q": split.q[0][1], "kv": split.kv[0][1]},
            "fewest": {"q": min(n for _, n in split.q),
                       "kv": min(n for _, n in split.kv)},
            "q_rep": split.q_rep, "kv_rep": split.kv_rep}


def _row(s: Staged, cfg, wl) -> dict:
    c = s.cost
    out = dict(
        flops=c.flops, bytes_accessed=c.bytes,
        collectives={"bytes": c.per_collective,
                     "counts": c.collective_counts,
                     "total_bytes": c.collective_bytes,
                     "by_group": c.collective_spans},
        memory={"argument_bytes": s.argument_bytes,
                "output_bytes": s.output_bytes,
                "temp_bytes": s.temp_bytes},
        kernels=c.kernels,
        params_b=cfg.param_count(), active_params_b=cfg.active_param_count(),
        tokens=wl.global_batch * wl.seq_len)
    if s.ms is not None:
        out.update(ms=s.ms, device_peak_bytes=s.device_peak_bytes)
    return out


def calibrate(arch, shape: str, *, device=None, **kw) -> dict:
    """The cell at mesh ``(1, 1)`` staged on meta, then the same step on
    ``device`` (default the GPU) under the same count: ``{"meta": row,
    "device": row}``, the device row with its ms and peak memory, and
    ``predicted_peak_bytes``, the meta count's arguments plus its
    temporaries."""
    from repro_torch.device import resolve
    dev = resolve(device)
    fake_world(1)
    mesh = mesh_mod.make_host_mesh(1, device="cpu")
    built, reason = build_cell(arch, shape, mesh, **kw)
    if built is None:
        raise ValueError(f"{arch} {shape}: {reason}")
    fn, args, cfg, wl = built
    meta = _row(stage(fn, args, warm=False), cfg, wl)
    del built, fn, args
    if dev.type == "cuda":
        dist.destroy_process_group()
        mesh = mesh_mod.make_host_mesh(1, device=dev)   # a real NCCL rank
    built, _ = build_cell(arch, shape, mesh, device=dev, **kw)
    fn, args, cfg, wl = built
    real = _row(stage(fn, args), cfg, wl)
    return {"arch": arch, "shape": shape, "meta": meta, "device": real,
            "predicted_peak_bytes": meta["memory"]["argument_bytes"]
            + meta["memory"]["temp_bytes"]}


def all_cells(meshes=("single", "multi"), out: str | None = None,
              **kw) -> list[dict]:
    """Every architecture × shape × mesh, in this process (a meta step
    holds no memory), each row printed as it comes."""
    rows = []
    for mesh_kind in meshes:
        for arch in configs.list_archs():
            for shape in wl_mod.WORKLOADS:
                row = run_cell(arch, shape, mesh_kind, **kw)
                rows.append(row)
                print(json.dumps({k: v for k, v in row.items()
                                  if k != "trace"}), flush=True)
                if out:
                    with open(out, "w") as f:
                        json.dump(rows, f, indent=1)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--out", default=None)
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--attn", default="chunked",
                    choices=["chunked", "online", "bf16"])
    ap.add_argument("--moe-buf", default="expert",
                    choices=["expert", "expert_data"])
    ap.add_argument("--scan", default="assoc", choices=["assoc", "chunked"])
    ap.add_argument("--embed-spec", default="vocab",
                    choices=["vocab", "embedcol", "replicated"])
    ap.add_argument("--replicate-small", type=int, default=0)
    ap.add_argument("--donate", action="store_true",
                    help="accepted for the reference's command line: the "
                         "port's cache is updated in place anyway")
    ap.add_argument("--calibrate", action="store_true",
                    help="stage the cell on meta at mesh (1, 1), then run "
                         "the same step on --device under the same count")
    ap.add_argument("--device", default=None, choices=[None, "cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the workload's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: the workload's)")
    args = ap.parse_args(argv)
    kw = dict(opt_kind=args.opt, remat=args.remat, accum_steps=args.accum,
              embed_spec=args.embed_spec,
              replicate_small=args.replicate_small, donate=args.donate,
              attn=args.attn, scan=args.scan, moe_buf=args.moe_buf)
    _check_flags(kw)
    if args.calibrate:
        out = calibrate(args.arch, args.shape, device=args.device,
                        batch=args.batch, seq=args.seq, **kw)
        print(json.dumps(out), flush=True)
        return out
    if args.all:
        return all_cells(tuple(args.meshes.split(",")), args.out, **kw)
    row = run_cell(args.arch, args.shape, args.mesh, batch=args.batch,
                   seq=args.seq, **kw)
    print(json.dumps({k: v for k, v in row.items() if k != "trace"}),
          flush=True)
    if row.get("status") == "error":
        print(row.get("trace", ""), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([row], f, indent=1)
    return row


if __name__ == "__main__":
    main()
