"""zamba2-7b [hybrid] — Zamba2-7B-Instruct at its published widths: 81
Mamba2 layers (112 heads of 64, state 64, two B/C groups), 13 of them
hybrid, each running one of two alternating shared blocks (attention on
the 7168-wide concatenation of the hidden state and the embedding, 32 heads
of 224; a GELU MLP of 14336 with a rank-128 adapter a call) before its
Mamba layer [arXiv:2411.15242; hf Zyphra/Zamba2-7B-Instruct config.json].
Not one of the assigned architectures (``ARCH_IDS``): the benchmark's."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="zamba2",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=224, rope_theta=10_000.0,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    shared_blocks=2, adapter_rank=128, ssm_groups=2, norm_eps=1e-5,
)
