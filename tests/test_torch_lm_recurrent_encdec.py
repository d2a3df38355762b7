"""Port parity for the ``ssm`` family (xLSTM-125M: mLSTM layers with
sLSTM gating at ``slstm_layers``) and the ``encdec`` family
(Whisper-base: a non-causal encoder, cross-attention in every decoder
layer over K/V projected once at prefill).

The same numpy inputs, made from a seed, go through the JAX package and
the port on the CPU, with the reference's weights carried across: each
model's full forward (Whisper's over seeded encoder embeddings), its
greedy serving (prefill + 8 decode steps; Whisper's prefill gets zero
encoder embeddings, as the reference's ``serve_batch`` gives it) against
the reference's loop without a mesh, and decode against a full forward.
Tolerance: ``atol = rtol = 1e-4``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from torch_lm_pairs import (Model, check_decode_matches_forward,
                            check_serving, close, port_cfg, smoke_jcfg, t)

XLSTM, WHISPER = "xlstm-125m", "whisper-base"


@pytest.fixture(scope="module")
def xlstm():
    return Model.build(XLSTM)


@pytest.fixture(scope="module")
def whisper():
    return Model.build(WHISPER)


def _enc(m, b=2, te=14, seed=12):
    return np.random.default_rng(seed).standard_normal(
        (b, te, m.cfg.d_model)).astype(np.float32)


# --------------------------------------------------------------------------
# xLSTM
# --------------------------------------------------------------------------


def test_slstm_flags_and_state_match_reference():
    jcfg = smoke_jcfg(XLSTM, n_layers=5, slstm_layers=(1, 4))
    cfg = port_cfg(jcfg)
    assert T._slstm_flags(cfg, 5) == \
        np.asarray(JT._slstm_flags(jcfg, 5)).tolist() == \
        [False, True, False, False, True]
    close(ssm.init_recurrent_state(cfg, 3),
          jssm.init_recurrent_state(jcfg, 3))


def test_xlstm_full_forward_matches_reference(xlstm):
    toks = np.random.default_rng(8).integers(0, xlstm.cfg.vocab, (2, 40))
    jl, _ = xlstm.jax_forward(toks)
    tl, none = T.forward(xlstm.params, xlstm.cfg, t(toks))
    assert none is None and tl.shape == (2, 40, xlstm.cfg.padded_vocab)
    close(tl, jl)


def test_xlstm_serve_batch_matches_reference(xlstm):
    check_serving(xlstm, [5, 30, 17])


def test_xlstm_decode_matches_full_forward(xlstm):
    check_decode_matches_forward(xlstm)


def test_xlstm_decode_keeps_state_per_layer(xlstm):
    cache = T.init_cache(xlstm.cfg, 2, 8, device="cpu")
    assert set(cache) == {"pos", "state"}
    toks = t(np.arange(10).reshape(2, 5))
    _, cache = T.forward(xlstm.params, xlstm.cfg, toks, cache=cache)
    assert cache["pos"] == 5
    assert bool((cache["state"].abs().sum((1, 2)) > 0).all())


# --------------------------------------------------------------------------
# Whisper
# --------------------------------------------------------------------------


def test_whisper_full_forward_matches_reference(whisper):
    toks = np.random.default_rng(8).integers(0, whisper.cfg.vocab, (2, 9))
    enc = _enc(whisper)
    jl, _ = whisper.jax_forward(toks, enc=enc)
    tl, none = T.forward(whisper.params, whisper.cfg, t(toks),
                         enc_embeds=t(enc))
    assert none is None and tl.shape == (2, 9, whisper.cfg.padded_vocab)
    close(tl, jl)


def test_whisper_serve_batch_matches_reference(whisper):
    check_serving(whisper, [5, 16, 9])


def test_whisper_decode_matches_full_forward(whisper):
    """Cross K/V projected once at prefill and kept in the cache; every
    decode step attends over them (Tq = 1, Tk = 14)."""
    check_decode_matches_forward(whisper, enc=t(_enc(whisper)))


def test_whisper_prefill_fills_the_cross_cache(whisper):
    cfg = whisper.cfg
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    assert cache["cross"] is None
    enc = t(_enc(whisper))
    _, new = T.forward(whisper.params, cfg, t(np.ones((2, 3), np.int64)),
                       enc_embeds=enc, cache=cache)
    assert cache["cross"] is None and new["pos"] == 3
    shape = (cfg.n_layers, 2, enc.shape[1], cfg.n_kv_heads, cfg.hd)
    assert tuple(new["cross"]["k"].shape) == shape
    # decode needs no encoder input once the cross K/V are cached
    step, _ = T.decode_step(whisper.params, cfg,
                            t(np.ones((2, 1), np.int64)), new)
    assert step.shape == (2, 1, cfg.padded_vocab)
    with pytest.raises(ValueError, match="enc_embeds"):
        T.forward(whisper.params, cfg, t(np.ones((2, 3), np.int64)))


def test_whisper_encoder_is_not_causal(whisper):
    """Changing the last encoder frame moves the first decoder
    position's logits (every frame is visible to every query)."""
    enc = _enc(whisper)
    toks = t(np.ones((2, 4), np.int64))
    a, _ = T.forward(whisper.params, whisper.cfg, toks, enc_embeds=t(enc))
    enc[:, -1] += 1.0
    b, _ = T.forward(whisper.params, whisper.cfg, toks, enc_embeds=t(enc))
    assert not torch.allclose(a[:, 0], b[:, 0])
    jb, _ = whisper.jax_forward(np.ones((2, 4), np.int32), enc=enc)
    close(b, jnp.asarray(jb))
