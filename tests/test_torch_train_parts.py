"""The training slice's parts against the JAX package: the loss, the LR
schedules, gradient clipping, AdamW and Adafactor, and the data streams.

The same numpy inputs, made from a seed, go through both packages.
Tolerance: f32 ``atol = rtol = 1e-4`` unless a case says otherwise (the
schedules: the port evaluates them in double precision, the reference
in float32); the data streams are equal bit for bit.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import layers as JL
from repro.optimizer import optimizers as jopt
from repro.optimizer import schedules as jsched
from repro_torch import configs
from repro_torch.data import pipeline as pipe
from repro_torch.launch.train import data_config
from repro_torch.models import layers as L
from repro_torch.optimizer import optimizers as opt
from repro_torch.optimizer import schedules as sched

TOL = dict(atol=1e-4, rtol=1e-4)


# -- the loss ----------------------------------------------------------------


def _ce_inputs(seed=0, vocab=50, vp=64):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((3, 7, vp))).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    labels[0, :3] = -1                       # unlabeled positions
    labels[1, 2] = vocab                     # a padded id
    labels[2, 5] = vp - 1
    return logits, labels, vocab


def test_cross_entropy_matches_reference_over_the_padded_vocab():
    logits, labels, vocab = _ce_inputs()
    want, jgrad = jax.value_and_grad(
        lambda x: JL.cross_entropy(x, jnp.asarray(labels), vocab))(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = L.cross_entropy(x, torch.from_numpy(labels), vocab)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    (g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), **TOL)
    # masked rows get no gradient; the padded columns of valid rows do
    assert not g[0, :3].any() and not g[1, 2].any() and not g[2, 5].any()
    assert g[0, 3, vocab:].abs().sum() > 0


def test_cross_entropy_with_no_valid_label_is_zero():
    logits, labels, vocab = _ce_inputs(1)
    labels[:] = -1
    got = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          vocab)
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), vocab)
    assert float(got) == float(want) == 0.0


# -- schedules ---------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("cosine", (3e-4, 5, 40)), ("cosine", (1e-3, 0, 10)),
    ("wsd", (3e-4, 5, 40)), ("wsd", (1e-2, 3, 17)),
])
def test_schedule_values(name, args):
    mine = getattr(sched, f"{name}_schedule")(*args)
    ref = getattr(jsched, f"{name}_schedule")(*args)
    total = args[2]
    for step in range(total + 6):
        np.testing.assert_allclose(mine(step), float(ref(step)), rtol=1e-5,
                                   atol=1e-12, err_msg=f"step {step}")
        assert isinstance(mine(step), float)


# -- clipping and the optimizers --------------------------------------------

#: a 2-D leaf, a stacked 3-D leaf (L, d, f) and a 1-D leaf
SHAPES = {"w": (6, 5), "stack": {"w3": (3, 4, 5), "bias": (7,)}}


def _tree(rng, shapes, scale=1.0):
    return {k: _tree(rng, v, scale) if isinstance(v, dict) else
            (scale * rng.standard_normal(v)).astype(np.float32)
            for k, v in shapes.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else
            torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close_trees(got, want):
    """Every leaf of the port's tree against the reference tree's leaf
    at the same path."""
    for path, x in opt.tree_paths(got):
        np.testing.assert_allclose(x.numpy(),
                                   np.asarray(opt.tree_at(want, path)),
                                   **TOL, err_msg=str(path))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm(max_norm):
    g = _tree(np.random.default_rng(0), SHAPES)
    jg, jnorm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                         max_norm)
    tg, tnorm = opt.clip_by_global_norm(_torch_tree(g), max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), **TOL)
    _close_trees(tg, jg)
    if max_norm > float(jnorm):               # no clipping: unchanged
        _close_trees(tg, g)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("lr", ["const", "cosine"])
def test_optimizer_three_updates_match(kind, lr):
    rng = np.random.default_rng(1)
    params = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES, scale) for scale in (0.3, 2.0, 0.05)]
    jlr = 1e-2 if lr == "const" else jsched.cosine_schedule(1e-2, 2, 6)
    tlr = 1e-2 if lr == "const" else sched.cosine_schedule(1e-2, 2, 6)
    jcfg = jopt.OptConfig(kind=kind, lr=jlr)
    tcfg = opt.OptConfig(kind=kind, lr=tlr)
    assert dataclasses.astuple(dataclasses.replace(jcfg, lr=0)) == \
        dataclasses.astuple(dataclasses.replace(tcfg, lr=0))
    jinit, jupd = jopt.make_optimizer(jcfg)
    tinit, tupd = opt.make_optimizer(tcfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jinit(jp)
    tp = _torch_tree(params)
    ts = tinit(tp)
    for g in grads:
        jp, js, jn = jupd(jp, jax.tree.map(jnp.asarray, g), js)
        tp2, ts2, tn = tupd(tp, _torch_tree(g), ts)
        assert tp2 is tp and ts2 is ts            # in place
        np.testing.assert_allclose(float(tn), float(jn), **TOL)
        _close_trees(tp, jp)
    assert ts["step"] == int(js["step"]) == 3
    if kind == "adamw":
        _close_trees(ts["m"], js["m"])
        _close_trees(ts["v"], js["v"])
    else:
        _close_trees(ts["f"], js["f"])
        assert ts["f"]["stack"]["w3"]["r"].shape == (3, 4)
        assert ts["f"]["stack"]["w3"]["c"].shape == (3, 5)
        assert set(ts["f"]["stack"]["bias"]) == {"v"}


def test_optimizer_keeps_bf16_params_with_f32_state():
    rng = np.random.default_rng(2)
    params = {"w": torch.from_numpy(_tree(rng, {"w": (4, 3)})["w"]
                                    ).to(torch.bfloat16)}
    init, upd = opt.make_optimizer(opt.OptConfig(lr=1e-2))
    state = init(params)
    assert state["m"]["w"].dtype == torch.float32
    before = params["w"].clone()
    upd(params, {"w": torch.ones(4, 3, dtype=torch.bfloat16)}, state)
    assert params["w"].dtype == torch.bfloat16
    assert not torch.equal(params["w"], before)


def test_unknown_optimizer_kind():
    with pytest.raises(KeyError):
        opt.make_optimizer(opt.OptConfig(kind="sgd"))


# -- data --------------------------------------------------------------------


def _same_batches(mine, ref, n=3):
    for _ in range(n):
        a, b = next(mine), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("start_step", [0, 7])
def test_synthetic_stream_equals_reference(start_step):
    kw = dict(seq_len=24, global_batch=4, vocab=300, seed=5)
    _same_batches(pipe.synthetic_stream(pipe.DataConfig(**kw),
                                        start_step=start_step),
                  jpipe.synthetic_stream(jpipe.DataConfig(**kw),
                                         start_step=start_step))


def test_synthetic_stream_two_hosts_equal_reference():
    kw = dict(seq_len=16, global_batch=6, vocab=100, seed=1)
    for host in (0, 1):
        _same_batches(pipe.synthetic_stream(pipe.DataConfig(**kw), host, 2),
                      jpipe.synthetic_stream(jpipe.DataConfig(**kw), host, 2))
    a = next(pipe.synthetic_stream(pipe.DataConfig(**kw), 0, 2))
    b = next(pipe.synthetic_stream(pipe.DataConfig(**kw), 1, 2))
    assert a["tokens"].shape == (3, 16)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_file_stream_equals_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 1000, 5000).astype(
        np.int32).tofile(path)
    kw = dict(seq_len=32, global_batch=4, vocab=1000, kind="file",
              path=str(path))
    _same_batches(pipe.file_stream(pipe.DataConfig(**kw), start_step=2),
                  jpipe.file_stream(jpipe.DataConfig(**kw), start_step=2))


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-base",
                                  "xlstm-125m"])
def test_family_data_equals_reference_train_loop(arch):
    """The port's per-family DataConfig is the reference training loop's
    (``repro/launch/train.py:51-59``): the VLM's stub patches and the
    enc-dec's encoder frames come out the same."""
    cfg = configs.get(arch, smoke=True)
    jcfg = jconfigs.get(arch, smoke=True)
    batch, seq, seed = 2, 32, 4
    jd = jpipe.DataConfig(
        seq_len=seq, global_batch=batch, vocab=jcfg.vocab, seed=seed,
        embeds_dim=jcfg.d_model if jcfg.family == "vlm" else 0,
        n_embeds=32 if jcfg.family == "vlm" else 0,
        enc_len=seq if jcfg.family == "encdec" else 0)
    if jcfg.family == "encdec":
        jd = jpipe.DataConfig(seq_len=max(seq // 4, 16), global_batch=batch,
                              vocab=jcfg.vocab, seed=seed,
                              embeds_dim=jcfg.d_model, enc_len=seq)
    mine = data_config(cfg, batch=batch, seq=seq, seed=seed)
    assert dataclasses.asdict(mine) == dataclasses.asdict(jd)
    _same_batches(pipe.synthetic_stream(mine), jpipe.synthetic_stream(jd), 2)
    keys = set(next(pipe.synthetic_stream(mine)))
    want = {"tokens", "labels"} | ({"embeds"} if cfg.family == "vlm" else
                                   {"embeds", "enc_embeds"}  # 0 patches
                                   if cfg.family == "encdec" else set())
    assert keys == want


def test_train_iterator_puts_batches_on_the_device():
    dcfg = pipe.DataConfig(seq_len=8, global_batch=2, vocab=50, seed=2)
    it = pipe.make_train_iterator(dcfg, device="cpu", start_step=3)
    ref = jpipe.synthetic_stream(jpipe.DataConfig(**dataclasses.asdict(
        dcfg)), start_step=3)
    for _ in range(2):
        got, want = next(it), next(ref)
        for k in want:
            assert isinstance(got[k], torch.Tensor)
            assert got[k].device.type == "cpu" and got[k].is_contiguous()
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_train_iterator_refuses_sharding_and_defaults_to_the_gpu(
        monkeypatch):
    """A layout that would give a rank other ranks' rows (a global batch
    of 2 over 3 data ranks is replicated by ``spec_for``) raises."""
    dcfg = pipe.DataConfig(seq_len=8, global_batch=2, vocab=50)
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 3, "model": 1},
                                 coords={"data": 1, "model": 0})
    with pytest.raises(ValueError, match="other ranks' rows"):
        pipe.make_train_iterator(dcfg, device="cpu", sharding=mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        pipe.make_train_iterator(dcfg)
