"""gemma2-2b [dense] — local+global alternating attention, logit softcaps,
sandwich norms, tied embeddings [arXiv:2408.00118; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    d_ff=9216, vocab=256000, head_dim=256,
    attn_softcap=50.0, final_softcap=30.0,
    local_window=4096, alt_local_global=True,
    sandwich_norm=True, gelu_mlp=True,
)
