"""Workload shapes × architectures: abstract inputs for the dry run
(counterpart of ``repro/launch/workloads.py``).

Shapes: ``train_4k`` (train), ``prefill_32k`` (inference prefill),
``decode_32k`` / ``long_500k`` (one new token against a ``seq_len`` KV
cache; these stage the serve step, not the train step).

The reference returns ``jax.ShapeDtypeStruct`` stand-ins; here every
input is a tensor on the ``meta`` device: a shape and a dtype, no
storage.  bf16 stands where the reference has bf16.  Token ids are
int32, as the reference's (the model takes them as indices either way).
The cache tree is the port's own (``T.init_cache(..., device="meta")``),
so it is what the port allocates: its ``pos`` is a Python int, where the
reference keeps an int32 scalar and a per-layer vector, and Whisper's
cross K/V are ``{"k", "v"}`` without the reference's position vector
(the port's keys are at ``arange(Te)`` always).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


WORKLOADS = {
    "train_4k": Workload("train_4k", 4096, 256, "train"),
    "prefill_32k": Workload("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Workload("decode_32k", 32768, 128, "decode"),
    "long_500k": Workload("long_500k", 524288, 1, "decode"),
}


def skip_reason(cfg: ModelConfig, wl: Workload) -> str | None:
    if wl.name == "long_500k" and not cfg.subquadratic():
        return ("pure full attention (no window/chunk/recurrence in the "
                "published config) — long_500k needs sub-quadratic "
                "attention; DESIGN.md §Shape skip rules")
    return None


def _vlm_split(cfg: ModelConfig, seq: int) -> tuple[int, int]:
    n_patch = min(1024, seq // 4)
    return n_patch, seq - n_patch


def _dec_len(cfg: ModelConfig, seq: int) -> int:
    # enc-dec training: encoder consumes seq frames, decoder seq//8 tokens
    return max(seq // 8, 64)


def batch_specs(cfg: ModelConfig, wl: Workload, batch: int | None = None
                ) -> dict:
    """Abstract train batch (train kind) of ``batch`` rows (default the
    workload's global batch)."""
    b, s = batch or wl.global_batch, wl.seq_len
    tok = torch.int32
    if cfg.family == "vlm":
        n_patch, n_text = _vlm_split(cfg, s)
        return {"tokens": _spec((b, n_text), tok),
                "labels": _spec((b, n_text), tok),
                "embeds": _spec((b, n_patch, cfg.d_model), torch.bfloat16)}
    if cfg.family == "encdec":
        dl = _dec_len(cfg, s)
        return {"tokens": _spec((b, dl), tok), "labels": _spec((b, dl), tok),
                "enc_embeds": _spec((b, s, cfg.d_model), torch.bfloat16)}
    return {"tokens": _spec((b, s), tok), "labels": _spec((b, s), tok)}


def prefill_specs(cfg: ModelConfig, wl: Workload, batch: int | None = None
                  ) -> dict:
    b, s = batch or wl.global_batch, wl.seq_len
    if cfg.family == "vlm":
        n_patch, n_text = _vlm_split(cfg, s)
        return {"tokens": _spec((b, n_text), torch.int32),
                "embeds": _spec((b, n_patch, cfg.d_model), torch.bfloat16),
                "cache": cache_specs(cfg, b, s)}
    if cfg.family == "encdec":
        dl = _dec_len(cfg, s)
        return {"tokens": _spec((b, dl), torch.int32),
                "enc_embeds": _spec((b, s, cfg.d_model), torch.bfloat16),
                "cache": cache_specs(cfg, b, s)}
    return {"tokens": _spec((b, s), torch.int32),
            "cache": cache_specs(cfg, b, s)}


def decode_specs(cfg: ModelConfig, wl: Workload, batch: int | None = None
                 ) -> dict:
    b, s = batch or wl.global_batch, wl.seq_len
    return {"tokens": _spec((b, 1), torch.int32),
            "cache": cache_specs(cfg, b, s, with_cross=True)}


def cache_specs(cfg: ModelConfig, batch: int, t_max: int,
                with_cross: bool = False) -> dict:
    """The port's cache tree on the meta device (``T.init_cache``, bf16
    K/V, f32 recurrent state): this rank's block of it under the active
    rules (``sharding.use_rules``), the whole cache without.  An
    enc-dec decode cache (``with_cross``) carries the encoder's K/V over
    ``t_max`` frames."""
    tree = T.init_cache(cfg, batch, t_max, torch.bfloat16, device=META)
    if cfg.family == "encdec" and with_cross:
        kv = tree["layers"]["k"]
        shape = (cfg.n_layers, batch, t_max) + tuple(kv.shape[-2:])
        tree["cross"] = {"k": _spec(shape, torch.bfloat16),
                         "v": _spec(shape, torch.bfloat16)}
    return tree


def windowed_len(cfg: ModelConfig, s: int) -> int:
    """Decode cache length actually needed: sliding-window archs keep a
    rolling window (StarCoder2: 4096) instead of the full context."""
    if cfg.window is not None and cfg.family in ("dense",):
        return min(s, cfg.window)
    return s
