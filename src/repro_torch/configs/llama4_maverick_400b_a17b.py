"""Llama-4-Maverick 400B-A17B — MoE 128e top-1 + shared expert, chunked
attention (8k) with periodic global layers (iRoPE) [hf:meta-llama/Llama-4]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("llama4-maverick-400b-a17b")
def build(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig("llama4-maverick-smoke", "moe", n_layers=2,
                           d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                           vocab=512, chunk=64, global_every=4,
                           moe=MoEConfig(n_experts=4, top_k=1,
                                         d_ff_expert=256, n_shared=1,
                                         every=2, capacity_factor=8.0))
    return ModelConfig("llama4-maverick-400b-a17b", "moe", n_layers=48,
                       d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
                       vocab=202048, head_dim=128, chunk=8192,
                       global_every=4,
                       moe=MoEConfig(n_experts=128, top_k=1,
                                     d_ff_expert=8192, n_shared=1, every=2))
