"""The rank side of ``tests/test_torch_mesh.py`` and
``tests/test_torch_data_parallel.py``: one function a case, run on
every rank of a spawned gloo world.

Imported by the spawned ranks, so it imports the port and numpy only
(no JAX): the test process builds every input with the reference's own
code, hands the ranks numpy buffers, and holds what each rank returns
against the reference.  :func:`run_cases` runs a whole batch in one
world, so the process start-up is paid once per world.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.datalog import datasets as pdata
from repro_torch.datalog import programs
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.pipeline import run_pipeline
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.datalog_serve import DatalogServer
from repro_torch.launch.mesh import make_datalog_mesh, make_mesh
from repro_torch.launch.rules import make_rules
from repro_torch.models import transformer as T
from repro_torch.optimizer import OptConfig
from repro_torch.optimizer.optimizers import tree_leaves, tree_like
from repro_torch.sparse.coo import SparseRelation


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def t_tree(tree):
    if isinstance(tree, dict):
        return {k: t_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


# -- training -----------------------------------------------------------------


def case_train(mesh, arch, kw):
    """``train`` on the world (data parallel: it makes its own host
    mesh); the losses, the gathered parameters and the bytes of this
    rank's moments."""
    hist = []
    params, losses = train_mod.train(arch, device="cpu", log_every=100,
                                     history=hist, **kw)
    return losses, np_tree(params), [h["grad_norm"] for h in hist]


def case_step(mesh, arch, batches, lr):
    """``make_sharded_train_step`` fed this rank's rows of each global
    batch in ``batches`` (the ``"data"`` block); the global losses and
    norms and the final full parameters."""
    cfg = configs.get(arch, smoke=True)
    params = T.init_params(cfg, 0, torch.float32, "cpu")
    specs = sh.tree_specs(T.param_specs(cfg), params, mesh,
                          make_rules(mesh, "train"))
    step_fn, init = steps.make_sharded_train_step(
        cfg, OptConfig(lr=lr), mesh, specs, remat="none")
    blocks = steps.param_blocks(params, specs, mesh)
    state = init(blocks)
    out = []
    with sh.use_rules(mesh, make_rules(mesh, "train")):
        for b in batches:
            rows = {k: sh.put(torch.from_numpy(v), ("batch",))
                    for k, v in b.items()}
            blocks, state, m = step_fn(blocks, state, rows)
            out.append((float(m["loss"]), float(m["grad_norm"])))
    moments = sum(x.numel() * x.element_size()
                  for x in tree_leaves(state["m"]) + tree_leaves(state["v"]))
    return out, np_tree(steps.gather_params(blocks, specs, mesh)), \
        moments


def case_save(mesh, path, step, tree, logical):
    """Every rank saves its blocks of ``tree`` (laid out by the logical
    tree under the ``"train"`` rules) as checkpoint ``step``."""
    rules = make_rules(mesh, "train")
    full = t_tree(tree)
    specs = sh.tree_specs(logical, full, mesh, rules)
    blocks = tree_like(full, [
        x[sh.block_slices(tuple(x.shape), s, mesh)].clone()
        for x, s in zip(tree_leaves(full), tree_leaves(specs))])
    save_checkpoint(path, step, blocks, shardings=specs, mesh=mesh)
    return [str(s) for s in tree_leaves(specs)]


# -- collectives and the pipeline ---------------------------------------------


def case_collectives(mesh, xs, tree):
    """The reductions of this rank's ``xs[rank]`` over ``"data"``."""
    r = mesh.coords["data"]
    x = torch.from_numpy(xs[r])
    mine = {k: torch.from_numpy(v[r]) for k, v in tree.items()}
    return {"bf16": collectives.bf16_all_reduce(x, mesh, "data").numpy(),
            "int8": collectives.int8_all_reduce(x, mesh, "data").numpy(),
            "tree_bf16": np_tree(collectives.compressed_grad_reduce(
                mine, mesh, "data", "bf16")),
            "tree_int8": np_tree(collectives.compressed_grad_reduce(
                mine, mesh, "data", "int8")),
            "gather": collectives.all_gather(x[None], mesh, "data",
                                             1).numpy(),
            "scatter": collectives.reduce_scatter(x[None], mesh, "data",
                                                  1).numpy()}


def _tanh_stage(params, x):
    return torch.tanh(x @ params[0][0])   # [0]: this stage's (1, D, D)


def case_pipeline(mesh, w, x):
    """``run_pipeline`` over a ``("stage",)`` mesh of the world."""
    stages = make_mesh((w.shape[0],), ("stage",), device="cpu")
    return run_pipeline(stages, _tanh_stage, (torch.from_numpy(w),),
                        torch.from_numpy(x), n_stages=w.shape[0],
                        n_micro=x.shape[0]).numpy()


# -- query-batch serving ------------------------------------------------------


def bm_db(buf, n):
    coords, values, nnz, shape, semiring = buf
    rel = SparseRelation.from_buffers(coords, values, nnz, shape, semiring,
                                      device="cpu")
    from repro_torch.core import engine
    return engine.Database(programs.bm(a=0).original.schema, {"id": n},
                           {"E": rel, "V": torch.ones(n, dtype=torch.bool)},
                           "cpu")


def serve_stream(server, bm, ss, stream):
    """Register BM and SSSP, submit ``stream`` (``(family, source)``, a
    ``None`` source closing a closed-loop round) and serve it; the
    delivered requests in order, the counters, and the rows of each
    batched fixpoint compiled (a rank's block on a data mesh)."""
    buf, n = bm
    server.register("reach", lambda a: programs.bm(a=a).optimized,
                    bm_db(buf, n))
    edges, weights, n_ss, wmax, dmax = ss
    server.register(
        "sssp", lambda a: programs.sssp(a=a, wmax=wmax, dmax=dmax).optimized,
        programs.sssp(a=0, wmax=wmax, dmax=dmax).make_db(
            pdata.Graph(n_ss, edges, weights), device="cpu"))
    delivered = []
    for fam, source in stream:
        if source is None:
            while server.pending():
                delivered.extend(server.step())
        else:
            server.submit(fam, source)
    while server.pending():
        delivered.extend(server.step())
    return ([(r.family, r.source,
              None if r.error else r.result.numpy(), r.iters, r.error)
             for r in delivered], dict(server.stats),
            [key[1] for key in server._compiled.keys()])


def case_serve(mesh, bm, ss, stream, max_batch):
    """``DatalogServer`` on ``make_datalog_mesh()`` over the world."""
    server = DatalogServer(max_batch=max_batch, warm_answers=0,
                           mesh=make_datalog_mesh(device="cpu"))
    return serve_stream(server, bm, ss, stream)


CASES = {"train": case_train, "step": case_step, "save": case_save,
         "collectives": case_collectives, "pipeline": case_pipeline,
         "serve": case_serve}


def run_cases(mesh, cases: dict) -> dict:
    """Run ``{name: (case, args)}`` on this rank: ``{name: result}``."""
    return {name: CASES[case](mesh, *args)
            for name, (case, args) in cases.items()}


# -- on the card (tests/test_torch_gpu.py) ------------------------------------


def case_card(mesh, x, w, xs, edges, n, sources):
    """The data axis on CUDA tensors over gloo (several ranks on one
    card): the compressed reductions of this rank's ``x[rank]``, GPipe
    over a ``("stage",)`` mesh of the world, and the data-mesh server
    against a one-device server on the card (with its B1 launches)."""
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    dev = mesh.device
    r = mesh.coords["data"]
    mine = torch.from_numpy(x[r]).to(dev)
    out = {"bf16": collectives.bf16_all_reduce(mine, mesh, "data").cpu(),
           "int8": collectives.int8_all_reduce(mine, mesh, "data").cpu(),
           "tree": {m: np_tree(collectives.compressed_grad_reduce(
               {"g": mine}, mesh, "data", m)) for m in ("bf16", "int8")}}
    stages = make_mesh((w.shape[0],), ("stage",), device=dev)
    out["pipe"] = run_pipeline(
        stages, _tanh_stage, (torch.from_numpy(w).to(dev),),
        torch.from_numpy(xs).to(dev), n_stages=w.shape[0],
        n_micro=xs.shape[0]).cpu()
    g = pdata.Graph(n, edges)
    db = engine.Database(programs.bm(a=0).original.schema, {"id": n},
                         {"E": g.sparse_adjacency(device=dev),
                          "V": g.vertex_set(device=dev)}, dev)
    answers = []
    for m in (None, make_datalog_mesh(device=dev)):
        server = DatalogServer(max_batch=len(sources), warm_answers=0,
                               mesh=m)
        server.register("reach", lambda a: programs.bm(a=a).optimized, db)
        ops.reset_launch_counts()
        reqs = [server.submit("reach", s) for s in sources]
        server.run_until_idle()
        answers.append(([r.result.cpu() for r in reqs],
                        [r.iters for r in reqs], dict(server.stats),
                        ops.launch_counts()["coo_spmm"],
                        [key[1] for key in server._compiled.keys()]))
    out["serve"] = answers
    return out


CASES["card"] = case_card
