"""Deterministic, host-sharded data pipeline (counterpart of
``repro/data/pipeline.py``).

The streams are the reference's, in numpy, and give its batches bit for
bit: batch ``step`` of host ``host`` is a pure function of ``(seed,
step, host)``, so a restart never replays or skips data.  Sources: a
synthetic LM stream (zipfian tokens with local repetition), a
memory-mapped int32 token file, and stub frontend embeddings for the
VLM and encoder-decoder families.  A background thread keeps a small
queue of host batches ahead of the step; :func:`make_train_iterator`
then copies each batch to the device.

The host index and count are the ``torch.distributed`` rank and world
size when a process group exists (else 0 and 1), where the reference
reads ``jax.process_index()``.  Assembling one global array from every
host's slice (the reference's ``sharding=``) waits for the sharding
slice (ROADMAP A7c).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve

Batch = dict


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    kind: str = "synthetic"     # synthetic | file
    path: str | None = None
    embeds_dim: int = 0         # >0: attach stub frontend embeddings
    n_embeds: int = 0
    enc_len: int = 0            # >0: encoder-decoder (enc_embeds)


def _rng_for(cfg: DataConfig, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host]))


def _synth_tokens(rng, n, seq, vocab):
    # zipfian marginals + local repetition structure (so loss can move)
    base = rng.zipf(1.3, size=(n, seq)).astype(np.int64) % vocab
    rep = rng.integers(0, 2, (n, seq)) == 0
    shifted = np.roll(base, 1, axis=1)
    return np.where(rep, shifted, base).astype(np.int32)


def synthetic_stream(cfg: DataConfig, host: int = 0,
                     n_hosts: int = 1, start_step: int = 0) -> Iterator[Batch]:
    per_host = cfg.global_batch // n_hosts
    step = start_step
    while True:
        rng = _rng_for(cfg, step, host)
        toks = _synth_tokens(rng, per_host, cfg.seq_len + 1, cfg.vocab)
        batch: Batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.embeds_dim:
            batch["embeds"] = rng.standard_normal(
                (per_host, cfg.n_embeds, cfg.embeds_dim)).astype(np.float32)
        if cfg.enc_len:
            batch["enc_embeds"] = rng.standard_normal(
                (per_host, cfg.enc_len, cfg.embeds_dim or 64)
            ).astype(np.float32)
        yield batch
        step += 1


def file_stream(cfg: DataConfig, host: int = 0, n_hosts: int = 1,
                start_step: int = 0) -> Iterator[Batch]:
    """Memory-mapped int32 token file; deterministic strided addressing."""
    data = np.memmap(cfg.path, dtype=np.int32, mode="r")
    n_seq = (len(data) - 1) // cfg.seq_len
    per_host = cfg.global_batch // n_hosts
    step = start_step
    while True:
        rng = _rng_for(cfg, step, host)
        idx = rng.integers(0, n_seq, per_host)
        toks = np.stack([
            data[i * cfg.seq_len:(i + 1) * cfg.seq_len + 1] for i in idx])
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        step += 1


class _Prefetcher:
    def __init__(self, it: Iterator[Batch], depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False

        def fill():
            for item in it:
                if self._stop:
                    return
                self.q.put(item)

        self.t = threading.Thread(target=fill, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop = True


def host_and_count() -> tuple[int, int]:
    """(index, count) of this process among the hosts feeding a step:
    ``torch.distributed``'s rank and world size, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_train_iterator(cfg: DataConfig, *, device=None, sharding=None,
                        start_step: int = 0, prefetch: int = 2
                        ) -> Iterator[Batch]:
    """This host's batches, each array a tensor on ``device`` (``cuda``
    by default, as every entry point; integer arrays stay int32)."""
    if sharding is not None:
        raise NotImplementedError(
            "make_train_iterator: sharding= assembles a global batch "
            "across hosts, which waits for the sharding slice (ROADMAP "
            "A7c)")
    dev = resolve(device)
    host, n_hosts = host_and_count()
    src = (file_stream if cfg.kind == "file" else synthetic_stream)(
        cfg, host=host, n_hosts=n_hosts, start_step=start_step)
    it = _Prefetcher(src, prefetch)
    return ({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in b.items()} for b in it)
