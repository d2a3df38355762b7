"""Mistral-Large-2407 (123B) — dense GQA [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.configs.base import ModelConfig, register


@register("mistral-large-123b")
def build(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig("mistral-large-123b-smoke", "dense", n_layers=2,
                           d_model=192, n_heads=6, n_kv_heads=2, d_ff=448,
                           vocab=512)
    return ModelConfig("mistral-large-123b", "dense", n_layers=88,
                       d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
                       vocab=32768, head_dim=128)
