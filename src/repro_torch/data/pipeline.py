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
reads ``jax.process_index()``.  On a mesh (``sharding=``) they are the
rank's index along the ``"data"`` axis and its size: the global batch
is the hosts' streams in host order, and each rank's batch is its host
stream, which is its block of the global batch on ``"data"``
(``launch.rules.batch_logical``).  A layout that would need another
rank's rows (a global batch the data axis does not divide) raises.
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


def data_host(cfg: DataConfig, mesh) -> tuple[int, int]:
    """(index, count) of the host stream a rank of ``mesh`` reads: its
    block of the global batch under the ``"train"`` rules.  Raises when
    the batch would not be split over ``"data"``, or a dimension would
    be split over another axis (a rank would need other ranks' rows)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.rules import batch_logical, make_rules
    rules = make_rules(mesh, "train")
    shape = (cfg.global_batch, cfg.seq_len)
    spec = sh.spec_for(batch_logical("tokens"), shape, mesh, rules)
    axes = sh.entry_axes(spec[0])
    if "data" not in axes or any(sh.entry_axes(e) for e in spec[1:]):
        raise ValueError(
            f"make_train_iterator: a global batch of {cfg.global_batch} "
            f"laid out {spec} on {mesh.shape} is not one block of rows a "
            f"rank; each rank would need other ranks' rows")
    return sh.block_index(spec[0], mesh), sh.axis_size(mesh, spec[0])


def make_train_iterator(cfg: DataConfig, *, device=None, sharding=None,
                        start_step: int = 0, prefetch: int = 2
                        ) -> Iterator[Batch]:
    """This host's batches, each array a tensor on ``device`` (``cuda``
    by default, as every entry point; integer arrays stay int32).
    ``sharding``: a :class:`~repro_torch.launch.mesh.ShardMesh`, whose
    ``"data"`` axis picks the host stream (:func:`data_host`)."""
    dev = resolve(device)
    host, n_hosts = (host_and_count() if sharding is None
                     else data_host(cfg, sharding))
    src = (file_stream if cfg.kind == "file" else synthetic_stream)(
        cfg, host=host, n_hosts=n_hosts, start_step=start_step)
    it = _Prefetcher(src, prefetch)
    return ({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in b.items()} for b in it)
