"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks,
ssm_state=64 [arXiv:2411.15242; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="zamba2",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
)
