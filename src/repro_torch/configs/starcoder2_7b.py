"""StarCoder2-7B — GQA + RoPE + sliding-window 4096 [arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig, register


@register("starcoder2-7b")
def build(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig("starcoder2-7b-smoke", "dense", n_layers=2,
                           d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                           vocab=512, window=64, mlp_gated=False)
    return ModelConfig("starcoder2-7b", "dense", n_layers=32, d_model=4608,
                       n_heads=36, n_kv_heads=4, d_ff=18432, vocab=49152,
                       window=4096, mlp_gated=False)
