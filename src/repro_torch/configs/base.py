"""Model configuration schema + registry (copy of ``repro/configs/base.py``).

Every registered architecture has a function returning the exact
published config and a reduced ``smoke`` config of the same family
(small widths and layers, tiny vocab) for CPU tests.  Pure data: the
port keeps its own copy so that it never imports the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0          # shared (always-on) experts
    every: int = 1             # MoE layer every N layers (others dense)
    first_dense: int = 0       # leading dense layers (deepseek)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 → d_model // n_heads
    moe: MoEConfig | None = None
    # attention variants
    rope_theta: float = 1e4
    window: int | None = None          # sliding window (StarCoder2)
    chunk: int | None = None           # chunked attention (Llama 4)
    global_every: int = 0              # every Nth layer full-attn (Llama 4)
    # ssm / hybrid
    ssm_state: int = 0
    d_inner_mult: int = 2              # ssm inner expansion
    hybrid_attn_every: int = 0         # shared attn block every N (Zamba2)
    slstm_layers: tuple[int, ...] = () # sLSTM-gated positions (xLSTM)
    # encoder-decoder
    encoder_layers: int = 0
    # modality frontend stub: 'audio' | 'vision' | None
    frontend: str | None = None
    tie_embeddings: bool = False
    mlp_gated: bool = True             # SwiGLU (3 mats) vs GELU (2 mats)
    norm_eps: float = 1e-5
    # schedule hint (minicpm: WSD)
    schedule: str = "cosine"
    # vocab padded up for even sharding: logical vocab used by the
    # embedding/logits; the data pipeline uses ``vocab``.
    vocab_pad_to: int = 256

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab + p - 1) // p * p

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm" and self.hybrid_attn_every == 0

    def subquadratic(self) -> bool:
        return (self.family in ("ssm", "hybrid") or self.window is not None
                or self.chunk is not None)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hq, hk, hd = self.n_heads, self.n_kv_heads, self.hd
        nm = 3 if self.mlp_gated else 2
        attn = d * hq * hd + 2 * d * hk * hd + hq * hd * d
        mlp = nm * d * f
        n_emb = v * d * (1 if self.tie_embeddings else 2)
        total = n_emb
        for i in range(self.n_layers):
            if self.family in ("ssm", "hybrid") and not self._is_attn_layer(i):
                di = self.d_inner_mult * d
                total += 2 * d * di + di * d + 2 * d * self.n_heads
                if self.family == "ssm":       # mLSTM q,k readout
                    total += 2 * d * di
                continue
            total += attn + 2 * d
            total += self._ffn_params(i)
        for _ in range(self.encoder_layers):
            total += attn + mlp + 2 * d
        if self.hybrid_attn_every:
            total += attn + mlp  # one shared block
        return int(total)

    def _is_attn_layer(self, i: int) -> bool:
        if self.family == "hybrid" and self.hybrid_attn_every:
            return False  # shared attn blocks live outside the layer stack
        return self.family not in ("ssm",)

    def _ffn_params(self, i: int) -> int:
        d = self.d_model
        nm = 3 if self.mlp_gated else 2
        if self.moe is None:
            return nm * d * self.d_ff
        m = self.moe
        if i < m.first_dense or (i % m.every) != (m.every - 1):
            return nm * d * self.d_ff
        routed = m.n_experts * nm * d * m.d_ff_expert
        shared = m.n_shared * nm * d * m.d_ff_expert
        return routed + shared + d * m.n_experts

    def active_param_count(self) -> int:
        """Parameters a token passes through: the routed experts count
        ``top_k`` of ``n_experts``."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        for i in range(self.n_layers):
            if i < m.first_dense or (i % m.every) != (m.every - 1):
                continue
            nm = 3 if self.mlp_gated else 2
            routed_all = m.n_experts * nm * d * m.d_ff_expert
            routed_active = m.top_k * nm * d * m.d_ff_expert
            total -= routed_all - routed_active
        return int(total)


ARCH_REGISTRY: dict[str, Callable[[bool], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        ARCH_REGISTRY[name] = fn
        return fn
    return deco


def get(name: str, smoke: bool = False) -> ModelConfig:
    return ARCH_REGISTRY[name](smoke)


def list_archs() -> list[str]:
    return sorted(ARCH_REGISTRY)


# import the arch modules so they register (keep at bottom)
from repro_torch.configs import (  # noqa: E402,F401
    deepseek_moe_16b, llama3_405b, llama4_maverick_400b_a17b,
    llava_next_mistral_7b, minicpm_2b, mistral_large_123b, starcoder2_7b,
    whisper_base, xlstm_125m, zamba2_2_7b)
