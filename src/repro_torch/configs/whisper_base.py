"""Whisper-base — encoder-decoder; conv frontend is a STUB (input_specs
provides precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-base")
def build(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig("whisper-base-smoke", "encdec", n_layers=2,
                           d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                           vocab=512, encoder_layers=2, frontend="audio", mlp_gated=False)
    return ModelConfig("whisper-base", "encdec", n_layers=6, d_model=512,
                       n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865,
                       encoder_layers=6, frontend="audio", mlp_gated=False)
