"""LLaVA-NeXT (Mistral-7B backbone) — anyres vision frontend is a STUB
(input_specs provides precomputed patch embeddings)
[hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from repro_torch.configs.base import ModelConfig, register


@register("llava-next-mistral-7b")
def build(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig("llava-next-smoke", "vlm", n_layers=2,
                           d_model=128, n_heads=4, n_kv_heads=2, d_ff=384,
                           vocab=512, frontend="vision")
    return ModelConfig("llava-next-mistral-7b", "vlm", n_layers=32,
                       d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
                       vocab=32000, frontend="vision")
