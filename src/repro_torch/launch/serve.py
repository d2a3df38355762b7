"""Batched serving loop: prefill + greedy decode (counterpart of
``repro/launch/serve.py``).

A batch of requests is left-padded with token 0 to its longest prompt,
prefilled in one forward pass that fills the KV and recurrent caches,
then decoded one token per request per step, greedily.  Any registered
architecture is served; an encoder-decoder's prefill gets zero encoder
embeddings of the prompt's length, as the reference's does.

With ``model_parallel`` above one (or a ``mesh``) every rank of a
``(data, model)`` host mesh calls ``serve_batch`` with the same
arguments: the model runs tensor parallel over ``"model"`` under the
``"decode"`` rules (each rank holds its blocks of the weights, its kv
heads and recurrent channels of the cache, its columns of the logits),
the greedy argmax runs over every rank's columns, and every rank
produces the same tokens (rank 0 reports).  Every ``"data"`` rank
serves the whole batch.  An MoE model keeps each rank's experts on the
rank (``models/moe.py``).  A rank builds only its blocks of the seeded
weights (``T.init_param_blocks``), so its peak is its share of the
model.  Without a mesh there are no sharding rules, as the reference's
``constrain`` is a no-op without one.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --full   # on a GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --model-parallel 2 \
        --device cpu         # two local gloo ranks (or one card's)
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve
from repro_torch.distributed import sharding as sh
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_host_mesh, run_cli
from repro_torch.launch.rules import make_rules
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Request:
    prompt: np.ndarray        # (T,) int
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_batch(model: str | configs.ModelConfig, requests: list[Request],
                *, smoke: bool = True, t_max: int = 512,
                model_parallel: int = 1, seed: int = 0,
                dtype=torch.float32, device=None,
                params: dict | None = None, mesh=None) -> dict:
    """Serve ``requests`` to completion; each request's tokens land in
    ``r.out``.  ``model``: a registered architecture's name (its smoke
    config unless ``smoke=False``) or a ``ModelConfig`` served as given
    (a cut of a registered one's depth or experts, say).  ``params``
    (e.g. from ``T.params_from_reference``; the full tree) replaces the
    seeded random weights.  ``model_parallel`` above one makes
    ``make_host_mesh(model_parallel)``; ``mesh`` gives one (the module's
    docstring).  On a mesh each rank draws the seeded weights leaf by
    leaf and keeps its blocks (``T.init_param_blocks``), so it never
    holds the whole tree; given ``params``, it holds them whole until
    its blocks are cut.

    Returns the prefill and decode times (device-synchronized host
    clock), decode tokens/s and ``last_logits``, the final decode
    step's ``(B, padded_vocab)`` logits (every rank's columns)."""
    cfg = (configs.get(model, smoke=smoke) if isinstance(model, str)
           else model)
    dev = resolve(device)
    if mesh is None and model_parallel > 1:
        mesh = make_host_mesh(model_parallel, device=dev)
    b = len(requests)
    plen = max(len(r.prompt) for r in requests)
    max_new = max(r.max_new for r in requests)
    if plen + max_new > t_max:
        raise ValueError(f"prompt {plen} + {max_new} new tokens exceed "
                         f"t_max {t_max}")
    prompts = np.zeros((b, plen), np.int64)
    for i, r in enumerate(requests):
        prompts[i, plen - len(r.prompt):] = r.prompt  # left-pad
    scope = contextlib.nullcontext()
    if mesh is not None:
        if params is None:
            params, rules = rank_blocks(cfg, mesh, seed, dtype, dev)
        else:
            params, rules = rank_params(cfg, params, mesh)
        scope = sh.use_rules(mesh, rules)
    elif params is None:
        params = T.init_params(cfg, seed, dtype, dev)
    with scope:
        return _serve(cfg, params, requests, prompts, t_max, dtype, dev)


def serve_rules(cfg: configs.ModelConfig, mesh) -> dict:
    """The rules a mesh serves under: ``"decode"``'s, the weights split
    over ``"model"`` only, so every ``"data"`` rank serves the whole
    batch.  A hand-driven ``T.forward``/``T.decode_step`` on the blocks
    runs inside ``sharding.use_rules(mesh, rules)``."""
    T.check_model_axis(cfg, mesh.shape.get("model", 1))
    return {**make_rules(mesh, "decode"), "embed": None}


def rank_params(cfg: configs.ModelConfig, params: dict, mesh):
    """This rank's blocks of the full tree ``params`` and the rules
    (:func:`serve_rules`)."""
    rules = serve_rules(cfg, mesh)
    specs = sh.tree_specs(T.param_specs(cfg), params, mesh, rules)
    return steps_mod.param_blocks(params, specs, mesh), rules


def rank_blocks(cfg: configs.ModelConfig, mesh, seed: int = 0,
                dtype=torch.float32, device=None):
    """This rank's blocks of ``T.init_params(cfg, seed, dtype, device)``,
    built without the whole tree, and the rules (:func:`serve_rules`)."""
    rules = serve_rules(cfg, mesh)
    blocks, _ = T.init_param_blocks(cfg, mesh, rules, seed, dtype, device)
    return blocks, rules


def _serve(cfg, params, requests, prompts, t_max, dtype, dev) -> dict:
    b, plen = prompts.shape
    max_new = max(r.max_new for r in requests)
    cache = T.init_cache(cfg, b, t_max, dtype, dev)
    tokens = torch.from_numpy(prompts).to(dev)

    enc = None
    if cfg.family == "encdec":
        enc = torch.zeros((b, plen, cfg.d_model), dtype=dtype, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = T.forward(params, cfg, tokens, enc_embeds=enc,
                              cache=cache)
    tok = L.vocab_argmax(logits[:, -1])
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(max_new):
        emitted = tok.tolist()
        for i, r in enumerate(requests):
            if len(r.out) < r.max_new:
                r.out.append(emitted[i])
        logits, cache = T.decode_step(params, cfg, tok[:, None], cache)
        tok = L.vocab_argmax(logits[:, -1])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"prefill_s": t_prefill, "decode_s": t_decode,
            "decode_steps": max_new,
            "tok_per_s": b * max_new / max(t_decode, 1e-9),
            "last_logits": L.gather_vocab(logits[:, -1])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b",
                    choices=configs.list_archs())
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the smoke config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--t-max", type=int, default=512)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = configs.get(args.arch, smoke=not args.full)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len)
               for _ in range(args.batch)]
    stats, out = run_cli(_cli_rank, args.model_parallel, args, prompts,
                         device=args.device)
    print(f"prefill {stats['prefill_s'] * 1e3:.1f} ms, "
          f"decode {stats['tok_per_s']:.1f} tok/s")
    print("sample:", out[0][:10])


def _cli_rank(mesh, args, prompts):
    reqs = [Request(p, args.max_new) for p in prompts]
    stats = serve_batch(args.arch, reqs, smoke=not args.full,
                        t_max=args.t_max, device=args.device, mesh=mesh)
    stats.pop("last_logits")
    return stats, [r.out for r in reqs]


if __name__ == "__main__":
    main()
