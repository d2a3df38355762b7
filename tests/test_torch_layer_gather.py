"""ZeRO-3 one layer at a time (ROADMAP A7c-2, 1c): the sharded train
step gathers each layer's ``"data"`` blocks just before the layer runs
and reduce-scatters its gradient as the backward leaves it.

* W = 1 (a one-rank mesh in this process): ``make_sharded_train_step``
  equals the unsharded ``make_train_step`` bit for bit, for each
  family's smoke config (dense, a VLM with ``-1`` labels, DeepSeek's
  MoE, Llama 4's pair-blocks, xLSTM, Zamba2's shared block, Whisper's
  encoder and cross-attention), under ``remat`` ``"none"``, ``"full"``
  and ``"selective"`` and with ``accum_steps=2``.
* W = 2 and ``(2, 2)`` (spawned gloo worlds, the rank side in
  ``tests/torch_model_axis_worker.py``): two AdamW steps against the
  reference's ``make_train_step`` on the whole batch, without a mesh,
  within 1e-4 (losses, grad norms, each step's parameter update, masked
  as ``tests/test_torch_model_axis.py`` masks it).
* Gathered bytes: ``collectives.STATS["gathered_peak_bytes"]``, the most
  bytes of gathered parameters alive at once in a step, is at most the
  leaves outside the stacks plus the largest layer (computed from the
  specs), which the whole tree exceeds for every config held to it.
* The hooks of ``collectives.reshard_after_forward``: a layer's gathered
  weights are gone when the forward ends, and saved views of them (a
  fused ``w_in``'s halves) come back equal in the backward.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.optimizer import optimizers as jopt
from repro.optimizer import schedules as jsched
from repro_torch import configs
from repro_torch.data import pipeline as pipe
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_host_mesh, spawn_world
from repro_torch.launch.rules import make_rules
from repro_torch.models import transformer as T
from repro_torch.optimizer import OptConfig, cosine_schedule
from repro_torch.optimizer import optimizers as opt

import torch_model_axis_worker as worker
from torch_lm_pairs import Model

#: one smoke config a family
FAMILIES = {"dense": "llama3-405b", "vlm": "llava-next-mistral-7b",
            "moe": "deepseek-moe-16b",
            "moe_pairs": "llama4-maverick-400b-a17b", "ssm": "xlstm-125m",
            "hybrid": "zamba2-2.7b", "encdec": "whisper-base"}
#: (remat, accum_steps) of the W = 1 runs
MODES = {"none": ("none", 1), "full": ("full", 1),
         "selective": ("selective", 1), "accum2": ("full", 2)}
BATCH, SEQ, STEPS = 4, 16, 2
#: the schedule of ``tests/test_torch_model_axis.py``'s worlds
LR, WARMUP, TOTAL = 3e-3, 2, 10
TOL = dict(atol=1e-4, rtol=1e-4)
#: a gradient entry below this share of its leaf's largest is masked
#: from the parameter check (``tests/test_torch_model_axis.py``'s)
GRAD_TOL = 1e-4
MASKED_SHARE = 0.15
#: the worlds' runs: archs, and the world's remat and accum_steps
W2_ARCHS = ("xlstm-125m", "zamba2-2.7b", "llava-next-mistral-7b",
            "whisper-base", "deepseek-moe-16b")
WORLDS = {"2x1": (2, 1, ("none", 1)), "2x2": (4, 2, ("full", 1)),
          "2x1_accum": (2, 1, ("none", 2))}
ACCUM_ARCHS = ("xlstm-125m",)


def _batches(cfg, seed=3):
    """``STEPS`` global batches; a VLM's first two rows have all but
    three labels masked (-1), so its ranks hold unequal label counts."""
    it = pipe.synthetic_stream(train_mod.data_config(
        cfg, batch=BATCH, seq=SEQ, seed=seed))
    out = []
    for _ in range(STEPS):
        b = dict(next(it))
        if cfg.family == "vlm":
            b["labels"] = b["labels"].copy()
            b["labels"][: BATCH // 2, 3:] = -1
        out.append(b)
    return out


def _mesh_blocks(cfg, mesh):
    params = T.init_params(cfg, 0, torch.float32, "cpu")
    specs = sh.tree_specs(T.param_specs(cfg), params, mesh,
                          make_rules(mesh, "train"))
    return specs, steps.param_blocks(params, specs, mesh)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", FAMILIES)
def test_one_rank_sharded_step_is_the_unsharded_step_bit_for_bit(family,
                                                                 mode):
    """W = 1: every gather and reduce-scatter is a copy, and two steps'
    losses, grad norms and parameters equal the unsharded step's bit for
    bit; the gathered bytes stay within the bound."""
    cfg = configs.get(FAMILIES[family], smoke=True)
    remat, accum = MODES[mode]
    mesh = make_host_mesh(device="cpu")
    params = T.init_params(cfg, 0, torch.float32, "cpu")
    for p in opt.tree_leaves(params):
        p.requires_grad_(True)
    plain, init0 = steps.make_train_step(cfg, OptConfig(lr=LR), remat=remat,
                                         accum_steps=accum)
    state0 = init0(params)
    specs, blocks = _mesh_blocks(cfg, mesh)
    sharded, init1 = steps.make_sharded_train_step(
        cfg, OptConfig(lr=LR), mesh, specs, remat=remat, accum_steps=accum)
    state1 = init1(blocks)
    bound, _ = steps.layer_gatherer(cfg, mesh, specs).bound(blocks)
    for b in _batches(cfg):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        params, state0, m0 = plain(params, state0, tb)
        collectives.reset_stats()
        blocks, state1, m1 = sharded(blocks, state1, tb)
        stats = collectives.reset_stats()
        assert float(m0["loss"]) == float(m1["loss"])
        assert float(m0["grad_norm"]) == float(m1["grad_norm"])
        assert stats["calls"] > 0
        assert 0 < stats["gathered_peak_bytes"] <= bound
    for (path, a), c in zip(opt.tree_paths(params), opt.tree_leaves(
            steps.gather_params(blocks, specs, mesh))):
        assert torch.equal(a.detach(), c), path


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid", "encdec",
                                    "moe"])
def test_the_whole_tree_exceeds_the_gathered_bound(family):
    """The bound the gathered bytes are held to is below what a gather of
    the whole tree at once holds, so a step that gathered it would fail
    the gates; a one-rank step's peak is within the bound."""
    cfg = configs.get(FAMILIES[family], smoke=True)
    mesh = make_host_mesh(device="cpu")
    specs, blocks = _mesh_blocks(cfg, mesh)
    bound, whole = steps.layer_gatherer(cfg, mesh, specs).bound(blocks)
    assert bound < whole
    step, init = steps.make_sharded_train_step(cfg, OptConfig(lr=LR), mesh,
                                               specs, remat="none")
    state = init(blocks)
    b = {k: torch.from_numpy(v) for k, v in _batches(cfg)[0].items()}
    collectives.reset_stats()
    step(blocks, state, b)
    assert 0 < collectives.reset_stats()["gathered_peak_bytes"] <= bound


def test_a_layers_gathered_weights_go_with_its_forward():
    """``remat="none"`` under the step's hooks: after the forward only
    the leaves outside the stacks are still gathered; the backward
    gathers each layer again (one gather a leaf, however many views of
    it were saved: the fused ``w_in``'s value and gate halves) and gives
    the blocks the unsharded gradients bit for bit; nothing stays
    gathered after it."""
    cfg = configs.get("xlstm-125m", smoke=True)
    mesh = make_host_mesh(device="cpu")
    specs, blocks = _mesh_blocks(cfg, mesh)
    leaves = [b.detach().requires_grad_(True) for b in opt.tree_leaves(blocks)]
    params = opt.tree_like(blocks, leaves)
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg)[0].items()}
    gatherer = steps.layer_gatherer(cfg, mesh, specs)
    resident = gatherer.gathered_bytes(blocks)["resident"]
    collectives.reset_stats()
    with sh.use_rules(mesh, make_rules(mesh, "train"), batch_axis="data"), \
            sh.use_gatherer(gatherer), collectives.reshard_after_forward():
        loss, _ = T.loss_fn(params, cfg, batch)
    assert 0 < collectives._live["bytes"] <= resident
    forward_calls = collectives.STATS["calls"]
    grads = torch.autograd.grad(loss, leaves)
    assert collectives._live["bytes"] == 0
    split = [sh.stacked(names)
             for (path, s), names in zip(opt.tree_paths(specs),
                                         opt.tree_leaves(T.param_specs(cfg)))
             if steps.data_dim(s) is not None]
    # each split stacked leaf: one gather again and one reduce-scatter a
    # layer; each resident leaf one reduce-scatter
    n_split, n_res = sum(split), len(split) - sum(split)
    assert collectives.STATS["calls"] - forward_calls == \
        2 * n_split * cfg.n_layers + n_res
    full = T.init_params(cfg, 0, torch.float32, "cpu")
    ref_leaves = [p.requires_grad_(True) for p in opt.tree_leaves(full)]
    want = torch.autograd.grad(T.loss_fn(full, cfg, batch)[0], ref_leaves)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_without_a_gatherer_a_layer_is_its_blocks():
    tree = {"w": torch.ones(3, 4)}
    assert sh.current_gatherer() is None
    assert sh.gather_layer("stack", tree) is tree
    assert sh.gather_layer("embed", tree) is tree


def test_a_stacked_leaf_split_on_its_layer_axis_is_refused():
    g = sh.LayerGatherer(make_host_mesh(device="cpu"),
                         {"stack": {"w": sh.P("data", None)}},
                         {"stack": {"w": ("layers", "embed")}})
    with pytest.raises(ValueError, match="layer axis"):
        g.gather("stack", {"w": torch.ones(4)})


@pytest.mark.parametrize("family", FAMILIES)
def test_the_specs_decide_what_stays_gathered(family):
    """A leaf led by ``"layers"`` is a stack's and gathered one layer at
    a time, not resident; every other split leaf is resident: the same
    choice the bound prices (its resident bytes are those leaves')."""
    cfg = configs.get(FAMILIES[family], smoke=True)
    mesh = make_host_mesh(device="cpu")
    specs, blocks = _mesh_blocks(cfg, mesh)
    logical = T.param_specs(cfg)
    tops = {path[0]: sh.stacked(names)
            for path, names in opt.tree_paths(logical)}
    assert {k for k, v in tops.items() if not v} <= {
        "embed", "lm_head", "out_norm", "enc_norm", "shared_attn"}
    assert any(tops.values())
    gatherer = steps.layer_gatherer(cfg, mesh, specs)
    kept = 0
    with sh.use_gatherer(gatherer):
        for key, stack in tops.items():
            tree = blocks[key]
            if stack:
                tree = T._layers(tree)[0]
            for (path, g), (_, s) in zip(
                    opt.tree_paths({key: sh.gather_layer(key, tree)}),
                    opt.tree_paths({key: specs[key]})):
                if steps.data_dim(s) is None:
                    continue
                assert g.gathered_from.resident is not stack, path
                kept += 0 if stack else g.numel() * g.element_size()
    assert kept == gatherer.gathered_bytes(blocks)["resident"]


# -- the worlds ---------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    return {a: Model.build(a) for a in W2_ARCHS}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_steps(m, accum):
    """The reference's jitted AdamW step on the whole batch: each step's
    params, loss and grad norm, and the gradient at the params it starts
    from (the micro-batches' mean with ``accum`` > 1, for the mask)."""
    ocfg = jopt.OptConfig(lr=jsched.cosine_schedule(LR, WARMUP, TOTAL))
    step_fn, init = jsteps.make_train_step(m.jcfg, ocfg, remat="none",
                                           accum_steps=accum)
    step_fn = jax.jit(step_fn)
    from repro.models import transformer as JT
    grad_fn = jax.jit(jax.grad(lambda p, b: JT.loss_fn(p, m.jcfg, b)[0]))
    params, state = m.jparams, init(m.jparams)
    out, losses, norms, grads = [_np(params)], [], [], []
    for b in _batches(m.cfg):
        micro = [{k: jnp.asarray(np.split(v, accum)[i]) for k, v in b.items()}
                 for i in range(accum)]
        gs = [_np(grad_fn(params, mb)) for mb in micro]
        grads.append(jax.tree.map(lambda *g: np.mean(np.stack(g), 0), *gs))
        params, state, met = step_fn(params, state,
                                     {k: jnp.asarray(v) for k, v in b.items()})
        out.append(_np(params))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return out, losses, norms, grads


@pytest.fixture(scope="module")
def run(models, tmp_path_factory):
    """The spawned worlds (in a thread) and the reference's steps:
    ``({world: ranks}, {(arch, accum): reference})``."""
    tmp = tmp_path_factory.mktemp("gather")
    out = {}

    def worlds():
        try:
            for name, (w, m, (remat, accum)) in WORLDS.items():
                archs = ACCUM_ARCHS if accum > 1 else W2_ARCHS
                cases = {a: ("gather_steps", (
                    a, _np(models[a].jparams), _batches(models[a].cfg),
                    (LR, WARMUP, TOTAL), remat, accum)) for a in archs}
                out[name] = spawn_world(
                    worker.run_cases, w, cases, device="cpu",
                    mesh_fn=functools.partial(make_host_mesh, m),
                    workdir=str(tmp))
        except BaseException as e:          # raised in the test process
            out["error"] = e
    th = threading.Thread(target=worlds)
    th.start()
    try:
        refs = {(a, 1): _reference_steps(models[a], 1) for a in W2_ARCHS}
        refs.update({(a, 2): _reference_steps(models[a], 2)
                     for a in ACCUM_ARCHS})
    finally:
        th.join()
    if "error" in out:
        raise out["error"]
    return out, refs


def _check_world(ranks, ref):
    ref_params, ref_losses, ref_norms, ref_grads = ref
    lr = jsched.cosine_schedule(LR, WARMUP, TOTAL)
    for r in ranks:
        got, _ = r
        unknown = {}
        before = ref_params[0]
        for i, (loss, norm, params, _) in enumerate(got):
            np.testing.assert_allclose(loss, ref_losses[i], **TOL)
            np.testing.assert_allclose(norm, ref_norms[i], **TOL)
            for path, p in opt.tree_paths(params):
                d_got = p - np.asarray(opt.tree_at(before, path))
                d_want = (np.asarray(opt.tree_at(ref_params[i + 1], path))
                          - np.asarray(opt.tree_at(ref_params[i], path)))
                g = np.abs(np.asarray(opt.tree_at(ref_grads[i], path)))
                unknown[path] = unknown.get(path, False) | (
                    (g > 0) & (g < GRAD_TOL * g.max()))
                keep = ~unknown[path]
                np.testing.assert_allclose(
                    d_got[keep], d_want[keep], rtol=0,
                    atol=0.01 * float(lr(i + 1)),
                    err_msg=f"step {i + 1} {'/'.join(path)}")
            before = params
        masked = sum(int(u.sum()) for u in unknown.values())
        total = sum(u.size for u in unknown.values())
        assert masked < MASKED_SHARE * total, (masked, total)
    for a, b in zip(opt.tree_leaves(ranks[0][0][-1][2]),
                    opt.tree_leaves(ranks[-1][0][-1][2])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [w for w in WORLDS if "accum" not in w])
@pytest.mark.parametrize("arch", W2_ARCHS)
def test_sharded_steps_match_the_reference_step(run, world, arch):
    """W = 2 (``remat="none"``: the backward gathers each layer again)
    and ``(2, 2)`` (``remat="full"``: the recompute gathers it again):
    two AdamW steps against the reference's step on the whole batch;
    every rank ends with the same parameters."""
    worlds, refs = run
    _check_world([r[arch] for r in worlds[world]], refs[(arch, 1)])


@pytest.mark.parametrize("arch", ACCUM_ARCHS)
def test_accumulated_micro_batches_match_the_reference(run, arch):
    """W = 2 with ``accum_steps=2``: each micro-batch's layer gradients
    reduce-scattered and added in f32 in micro-batch order, against the
    reference's ``make_train_step(accum_steps=2)``."""
    worlds, refs = run
    _check_world([r[arch] for r in worlds["2x1_accum"]], refs[(arch, 2)])


@pytest.mark.parametrize("world", list(WORLDS))
def test_gathered_bytes_stay_within_one_layer_past_the_resident_leaves(
        run, world):
    """On every rank of every world, each step's most gathered bytes
    alive at once are at most the leaves outside the stacks plus the
    largest layer (gathered sizes, from the rank's specs), and below the
    whole tree's."""
    worlds, _ = run
    for r in worlds[world]:
        for arch, (got, (bound, whole)) in r.items():
            assert bound < whole, arch
            for *_, peak in got:
                assert 0 < peak <= bound, (arch, peak, bound)
