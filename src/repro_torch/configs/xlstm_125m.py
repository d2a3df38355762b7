"""xLSTM-125M — sLSTM + mLSTM recurrent blocks [arXiv:2405.04517].

Attention-free: the per-layer recurrence h_t = a_t⊙h_{t-1} + b_t runs
through kernel B4 (kernels/ssm_scan.py) in prefill; sLSTM positions use
exponential-gating modulation on the same stacked parameterization."""
from repro_torch.configs.base import ModelConfig, register


@register("xlstm-125m")
def build(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig("xlstm-125m-smoke", "ssm", n_layers=2,
                           d_model=128, n_heads=4, n_kv_heads=4, d_ff=0,
                           vocab=512, ssm_state=16, slstm_layers=(1,))
    return ModelConfig("xlstm-125m", "ssm", n_layers=12, d_model=768,
                       n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
                       ssm_state=64, slstm_layers=(1, 4, 7, 10),
                       tie_embeddings=True)
