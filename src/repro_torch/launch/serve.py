"""Batched serving loop: prefill + greedy decode (counterpart of
``repro/launch/serve.py``).

A batch of requests is left-padded with token 0 to its longest prompt,
prefilled in one forward pass that fills the KV and recurrent caches,
then decoded one token per request per step, greedily.  Any registered
architecture is served; an encoder-decoder's prefill gets zero encoder
embeddings of the prompt's length, as the reference's does.  On one
card there is no mesh and no sharding rules: the reference's
``distributed/sharding.constrain`` is a no-op without a mesh and has no
counterpart here.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --full   # on a GPU
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve
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
                *, smoke: bool = True, t_max: int = 512, seed: int = 0,
                dtype=torch.float32, device=None,
                params: dict | None = None) -> dict:
    """Serve ``requests`` to completion; each request's tokens land in
    ``r.out``.  ``model``: a registered architecture's name (its smoke
    config unless ``smoke=False``) or a ``ModelConfig`` served as given
    (a cut of a registered one's depth or experts, say).  ``params``
    (e.g. from ``T.params_from_reference``) replaces the seeded random
    weights.

    Returns the prefill and decode times (device-synchronized host
    clock), decode tokens/s and ``last_logits``, the final decode
    step's ``(B, padded_vocab)`` logits."""
    cfg = (configs.get(model, smoke=smoke) if isinstance(model, str)
           else model)
    dev = resolve(device)
    b = len(requests)
    plen = max(len(r.prompt) for r in requests)
    max_new = max(r.max_new for r in requests)
    if plen + max_new > t_max:
        raise ValueError(f"prompt {plen} + {max_new} new tokens exceed "
                         f"t_max {t_max}")
    prompts = np.zeros((b, plen), np.int64)
    for i, r in enumerate(requests):
        prompts[i, plen - len(r.prompt):] = r.prompt  # left-pad
    if params is None:
        params = T.init_params(cfg, seed, dtype, dev)
    cache = T.init_cache(cfg, b, t_max, dtype, dev)
    tokens = torch.from_numpy(prompts).to(dev)

    enc = None
    if cfg.family == "encdec":
        enc = torch.zeros((b, plen, cfg.d_model), dtype=dtype, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = T.forward(params, cfg, tokens, enc_embeds=enc,
                              cache=cache)
    tok = logits[:, -1].argmax(-1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(max_new):
        emitted = tok.tolist()
        for i, r in enumerate(requests):
            if len(r.out) < r.max_new:
                r.out.append(emitted[i])
        logits, cache = T.decode_step(params, cfg, tok[:, None], cache)
        tok = logits[:, -1].argmax(-1)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"prefill_s": t_prefill, "decode_s": t_decode,
            "decode_steps": max_new,
            "tok_per_s": b * max_new / max(t_decode, 1e-9),
            "last_logits": logits[:, -1]}


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
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = configs.get(args.arch, smoke=not args.full)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab, args.prompt_len),
                    args.max_new) for _ in range(args.batch)]
    stats = serve_batch(args.arch, reqs, smoke=not args.full,
                        t_max=args.t_max, device=args.device)
    print(f"prefill {stats['prefill_s'] * 1e3:.1f} ms, "
          f"decode {stats['tok_per_s']:.1f} tok/s")
    print("sample:", reqs[0].out[:10])


if __name__ == "__main__":
    main()
