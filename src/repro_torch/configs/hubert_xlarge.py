"""hubert-xlarge [audio] — encoder-only, wav2vec2-arch backbone; the CNN
frame frontend is a STUB (input_specs provides frame embeddings)
[arXiv:2106.07447; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504, head_dim=80,
    causal=False, gelu_mlp=True, embed_inputs=True,
)
