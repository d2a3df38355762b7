"""Zamba2-2.7B — Mamba2 backbone + shared attention block applied
periodically [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, register


@register("zamba2-2.7b")
def build(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig("zamba2-smoke", "hybrid", n_layers=4,
                           d_model=128, n_heads=4, n_kv_heads=4, d_ff=512,
                           vocab=512, ssm_state=16, hybrid_attn_every=2)
    return ModelConfig("zamba2-2.7b", "hybrid", n_layers=54, d_model=2560,
                       n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
                       ssm_state=64, hybrid_attn_every=18)
