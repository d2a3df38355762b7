"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed top-6, first
layer dense [arXiv:2401.06066]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("deepseek-moe-16b")
def build(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig("deepseek-moe-smoke", "moe", n_layers=3,
                           d_model=128, n_heads=4, n_kv_heads=4, d_ff=320,
                           vocab=512,
                           moe=MoEConfig(n_experts=8, top_k=2,
                                         d_ff_expert=64, n_shared=2,
                                         first_dense=1,
                                         capacity_factor=8.0))
    return ModelConfig("deepseek-moe-16b", "moe", n_layers=28, d_model=2048,
                       n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
                       moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                                     n_shared=2, first_dense=1))
