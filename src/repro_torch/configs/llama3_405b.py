"""Llama-3.1-405B — dense GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig, register


@register("llama3-405b")
def build(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig("llama3-405b-smoke", "dense", n_layers=2,
                           d_model=256, n_heads=8, n_kv_heads=2, d_ff=832,
                           vocab=512, rope_theta=5e5)
    return ModelConfig("llama3-405b", "dense", n_layers=126, d_model=16384,
                       n_heads=128, n_kv_heads=8, d_ff=53248, vocab=128256,
                       head_dim=128, rope_theta=5e5)
