"""internvl2-76b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings) + llama3-70b-class LLM backbone [arXiv:2404.16821; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128, rope_theta=500_000.0,
    vis_tokens=256,
)
