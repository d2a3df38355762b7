"""MiniCPM-2B — dense LM with WSD schedule [arXiv:2404.06395; hf]."""
from repro_torch.configs.base import ModelConfig, register


@register("minicpm-2b")
def build(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig("minicpm-2b-smoke", "dense", n_layers=2,
                           d_model=128, n_heads=4, n_kv_heads=4, d_ff=320,
                           vocab=512, tie_embeddings=True, schedule="wsd")
    return ModelConfig("minicpm-2b", "dense", n_layers=40, d_model=2304,
                       n_heads=36, n_kv_heads=36, d_ff=5760, vocab=122753,
                       tie_embeddings=True, schedule="wsd")
