"""End-to-end training loop (counterpart of ``repro/launch/train.py``):
config → data pipeline → train step (loss, gradient, optimizer update in
place) → checkpoint manager (async, resumable) → heartbeats → per-step
log.

The config, the schedule (``cfg.schedule``: WSD or cosine, warmup
``max(steps // 20, 5)``), AdamW's defaults, each family's data and the
checkpoint cadence (every ``max(steps // 4, 25)`` steps and at the end)
are the reference's.  The weights are random from a seeded
``torch.Generator`` (the reference's distributions, not its numbers).
With ``ckpt_dir`` a run resumes from the directory's latest checkpoint
(the port's or the reference's), and its data iterator starts at the
restored step, so a resumed run equals an uninterrupted one bit for
bit (the reference's resumed iterator starts again at batch 0).  On the
CPU the bit-for-bit claims need a fixed intra-op thread count and MKL
pinned (``MKL_DYNAMIC=FALSE``, ``MKL_CBWR``): an MKL GEMM whose threads
or code path change between runs, as they may under load, sums in
another order.

On a world of W ranks (every rank calls ``train`` after
``init_process_group``; ``launch.mesh.spawn_world`` starts W local
ranks), with ``model_parallel`` above one, or with ``mesh=`` given, the
run is sharded: the mesh is ``make_host_mesh(model_parallel)``, ``(W /
M, M)`` over ``("data", "model")``, under ``make_rules(mesh,
"train")``; each rank draws the seeded weights leaf by leaf and keeps
its blocks (``T.init_param_blocks``), the parameters and the optimizer's
state are held in blocks on ``"data"`` and computed on tensor parallel
over ``"model"`` (``steps.make_sharded_train_step``; MoE with its
experts split over ``"model"`` and capacity reckoned over the global
batch), each ``"data"`` row of ranks reads its own host stream,
checkpoints are sharded (one shard file a rank; a resume may run at
another W or M), and each rank writes its own heartbeat.  At W = 1 it
equals the unsharded run bit for bit.  A ``model_parallel`` that does
not divide the world raises the mesh's error.  With ``accum_steps`` > 1
at W > 1 each rank's micro-batches are its shares of the global
batch's (``steps.micro_batches``).  Like every entry point it runs on
the GPU unless ``device="cpu"`` is passed::

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 50 --seq 64 --device cpu --ckpt build/ckpt/xlstm
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --full --seq 1024 --steps 300          # on a GPU

``--model-parallel M`` needs M ranks: ``spawn_world`` (gloo; several
ranks may share one card) or one process a card over NCCL.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, make_train_iterator
from repro_torch.data.pipeline import host_and_count
from repro_torch.device import resolve
from repro_torch.distributed.fault_tolerance import FTConfig, HeartbeatWriter
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_host_mesh, run_cli
from repro_torch.models import transformer as T
from repro_torch.optimizer import OptConfig, cosine_schedule, wsd_schedule
from repro_torch.optimizer.optimizers import tree_leaves


def data_config(cfg, *, batch: int, seq: int, seed: int) -> DataConfig:
    """The reference's data for ``cfg``'s family: VLM batches carry 32
    stub patch embeddings, an encoder-decoder ``seq`` encoder frames and
    ``max(seq // 4, 16)`` decoder tokens."""
    if cfg.family == "encdec":
        return DataConfig(seq_len=max(seq // 4, 16), global_batch=batch,
                          vocab=cfg.vocab, seed=seed,
                          embeds_dim=cfg.d_model, enc_len=seq)
    vlm = cfg.family == "vlm"
    return DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                      seed=seed, embeds_dim=cfg.d_model if vlm else 0,
                      n_embeds=32 if vlm else 0)


def train(arch: str | configs.ModelConfig, *, steps: int = 100,
          batch: int = 8, seq: int = 256, lr: float = 3e-4,
          smoke: bool = True, ckpt_dir: str | None = None,
          model_parallel: int = 1, log_every: int = 10, seed: int = 0,
          accum_steps: int = 1, remat: str = "none",
          heartbeat_dir: str | None = None, device=None,
          dtype=torch.float32, history: list | None = None, mesh=None,
          optimizer: str = "adamw"):
    """Train ``arch`` up to step ``steps``, from the latest checkpoint in
    ``ckpt_dir`` if there is one; returns ``(params, losses)``, the
    losses of the steps this call ran.  ``arch``: a registered
    architecture's name (its smoke config unless ``smoke=False``) or a
    ``ModelConfig`` trained as given; ``optimizer``: ``"adamw"`` (the
    reference's launcher's) or ``"adafactor"``.  Sharded on a world of
    more than one rank, with ``model_parallel`` above one or with
    ``mesh`` (a ``ShardMesh``; the module's docstring), where ``params``
    is the full tree gathered from the blocks at the end.

    ``history``, when given, receives one dict a step that ran:
    ``step``, ``loss``, ``grad_norm`` and ``ms`` (the step's host-clock
    time up to the read of its loss, which waits for the device)."""
    dev = resolve(device)
    cfg = (configs.get(arch, smoke=smoke) if isinstance(arch, str)
           else arch)
    if mesh is None and (host_and_count()[1] > 1 or model_parallel > 1):
        mesh = make_host_mesh(model_parallel, device=dev)
    elif mesh is not None and model_parallel not in (
            1, mesh.shape.get("model", 1)):
        raise ValueError(f"train: model_parallel={model_parallel} and a "
                         f"mesh of {mesh.shape}")
    sched = (wsd_schedule if cfg.schedule == "wsd" else cosine_schedule)(
        lr, warmup=max(steps // 20, 5), total=steps)
    opt_cfg = OptConfig(kind=optimizer, lr=sched)
    specs = shardings = None
    if mesh is None:
        params = T.init_params(cfg, seed, dtype, dev)
        step_fn, opt_init = steps_mod.make_train_step(
            cfg, opt_cfg, remat=remat, accum_steps=accum_steps)
        for p in tree_leaves(params):
            p.requires_grad_(True)
    else:
        from repro_torch.launch.rules import make_rules
        params, specs = T.init_param_blocks(
            cfg, mesh, make_rules(mesh, "train"), seed, dtype, dev)
        step_fn, opt_init = steps_mod.make_sharded_train_step(
            cfg, opt_cfg, mesh, specs, remat=remat, accum_steps=accum_steps)
    opt_state = opt_init(params)
    if mesh is not None:
        shardings = {"params": specs,
                     "opt": steps_mod.state_specs(opt_state, specs)}
    rank = host_and_count()[0]
    say = print if rank == 0 else (lambda *a, **k: None)

    mgr = CheckpointManager(ckpt_dir, every=max(steps // 4, 25),
                            mesh=mesh) if ckpt_dir else None
    start = 0
    if mgr:     # in place: the leaves stay the run's, with no second copy
        restored, start = mgr.restore_latest(
            {"params": params, "opt": opt_state}, shardings, inplace=True)
        if restored is not None:
            say(f"resumed from step {start}")
    hb = HeartbeatWriter(FTConfig(heartbeat_dir), rank) \
        if heartbeat_dir else None
    data = make_train_iterator(
        data_config(cfg, batch=batch, seq=seq, seed=seed), device=dev,
        start_step=start, sharding=mesh)

    losses = []
    t0 = time.time()
    for step in range(start, steps):
        t_step = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, next(data))
        losses.append(float(metrics["loss"]))
        if history is not None:
            history.append(dict(
                step=step, loss=losses[-1],
                ms=(time.perf_counter() - t_step) * 1e3,
                grad_norm=float(metrics["grad_norm"])))
        if hb:
            hb.beat(step)
        if mgr:
            mgr.maybe_save(step + 1, {"params": params, "opt": opt_state},
                           shardings=shardings)
        if step % log_every == 0 or step == steps - 1:
            dt = (time.time() - t0) / (step - start + 1)
            say(f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"{dt*1e3:.0f} ms/step", flush=True)
    if mgr:
        if start < steps:       # a later checkpoint is not saved as `steps`
            mgr.maybe_save(steps, {"params": params, "opt": opt_state},
                           force=True, shardings=shardings)
        mgr.wait()
    if mesh is None:
        return params, losses
    if host_and_count()[1] > 1:
        # rank 0 renames the last checkpoint into place: every rank
        # returns once it is there
        torch.distributed.barrier()
    return steps_mod.gather_params(params, specs, mesh), losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="full published config (default: smoke config)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: saves there, and resumes "
                         "from its latest checkpoint")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=T.REMAT)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    kw = dict(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
              smoke=not args.full, ckpt_dir=args.ckpt,
              model_parallel=args.model_parallel, accum_steps=args.accum,
              remat=args.remat, device=args.device)
    losses = run_cli(_cli_rank, args.model_parallel, args.arch, kw,
                     device=args.device)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


def _cli_rank(mesh, arch, kw):
    return train(arch, mesh=mesh, **kw)[1]


if __name__ == "__main__":
    main()
