"""Model configuration shared by every architecture family.

Configs store the *published* logical dimensions; tensor-parallel padding
(zero q-heads, replicated kv-heads, −inf-routed experts, masked vocab rows)
is computed at model-build time from the mesh's model-axis size so that
smoke tests (tp=1) run the exact published config (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


def pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | rwkv6 | zamba2 | encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # attention options
    qk_norm: bool = False                 # qwen3
    attn_softcap: float = 0.0             # gemma2
    final_softcap: float = 0.0            # gemma2
    local_window: int = 0                 # gemma2 alternating local/global
    alt_local_global: bool = False
    causal: bool = True                   # False for encoders
    rope_theta: float = 10_000.0
    sandwich_norm: bool = False           # gemma2 pre+post norms
    gelu_mlp: bool = False                # gemma2 / hubert MLPs

    # MoE options
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_int8_dispatch: bool = False   # quantize dispatch-buffer collectives

    # SSM / RWKV options
    ssm_state: int = 0                    # zamba2 mamba2 state size
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    attn_every: int = 0                   # zamba2: shared attn every N blocks
    # zamba2's published layer list (Zamba2-7B, ``models/zamba2.py``): the
    # ids of its hybrid layers, each running a shared block on the hidden
    # state concatenated with the embedding before its Mamba layer; () keeps
    # the uniform ``attn_every`` groups of zamba2-2.7b as the port runs it
    hybrid_layer_ids: tuple = ()
    shared_blocks: int = 1                # alternating blocks (num_mem_blocks)
    adapter_rank: int = 0                 # each hybrid call's MLP adapter
    ssm_groups: int = 1                   # B/C groups (mamba_ngroups)
    norm_eps: float = 1e-6                # zamba2's RMS norms

    # modality stub (vlm / audio): input is precomputed embeddings
    vis_tokens: int = 0                   # internvl2 patch-embedding prefix
    embed_inputs: bool = False            # hubert: frames arrive as embeddings

    # numerics
    dtype: str = "bfloat16"
    remat: bool = True
    kv_int8: bool = False   # int8-quantized KV cache (per-token/head scales)

    def __post_init__(self):
        # a list from a JSON file: a tuple keeps the config hashable
        object.__setattr__(self, "hybrid_layer_ids",
                           tuple(self.hybrid_layer_ids))
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(1, self.n_heads))

    # -- tensor-parallel padding -------------------------------------------------
    def padded(self, tp: int) -> "PaddedDims":
        return PaddedDims(
            n_heads=pad_to(self.n_heads, tp) if self.n_heads else 0,
            n_kv_heads=pad_to(self.n_kv_heads, tp) if self.n_kv_heads else 0,
            vocab=pad_to(self.vocab, tp),
            n_experts=pad_to(self.n_experts, tp) if self.n_experts else 0,
            rwkv_heads=pad_to(self.d_model // self.rwkv_head_dim, tp)
            if self.family == "rwkv6" else 0,
            ssm_heads=pad_to(self.ssm_expand * self.d_model
                             // self.ssm_head_dim, tp)
            if self.family == "zamba2" else 0,
        )

    def params_dense(self) -> int:
        """Approximate dense parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, l = self.d_model, self.n_layers
        hd = self.head_dim
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        if self.family == "rwkv6":
            attn = 6 * d * d // 1  # r,k,v,w(lora),g,o approx
        if self.family == "zamba2" and self.hybrid_layer_ids:
            return self._zamba2_params()
        if self.family == "zamba2":
            din = self.ssm_expand * d
            attn = d * din * 2 + din * d + 2 * din * self.ssm_state
        mlp = 3 * d * self.d_ff if not self.gelu_mlp else 2 * d * self.d_ff
        if self.n_experts:
            mlp = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        emb = self.vocab * d * 2  # embed + unembed
        return l * (attn + mlp) + emb

    def _zamba2_params(self) -> int:
        """Every parameter of zamba2's published form (``models/zamba2.py``):
        each layer's Mamba2 mixer, the shared blocks (attention on the
        2d-wide concatenation, the MLP), each hybrid call's linear and MLP
        adapter, the tied embedding."""
        d, f, r = self.d_model, self.d_ff, self.adapter_rank
        din = self.ssm_expand * d
        heads = din // self.ssm_head_dim
        bc = 2 * self.ssm_groups * self.ssm_state
        conv = din + bc
        mamba = (d * (2 * din + bc + heads) + 4 * conv + conv + 3 * heads
                 + din + din * d + d)
        qkv = 2 * d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        block = (qkv + self.n_heads * self.head_dim * d + 3 * d * f
                 + 2 * d + d)
        hybrid = d * d + d * r + r * 2 * f
        return (self.n_layers * mamba + self.shared_blocks * block
                + len(self.hybrid_layer_ids) * hybrid + self.vocab * d + d)

    def params_active(self) -> int:
        """Active params per token (= N for dense; routed subset for MoE)."""
        if not self.n_experts:
            return self.params_dense()
        d, l = self.d_model, self.n_layers
        hd = self.head_dim
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        mlp = self.top_k * 3 * d * self.moe_d_ff + d * self.n_experts
        emb = self.vocab * d * 2
        return l * (attn + mlp) + emb


@dataclass(frozen=True)
class PaddedDims:
    n_heads: int
    n_kv_heads: int
    vocab: int
    n_experts: int
    rwkv_heads: int = 0
    ssm_heads: int = 0


@dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell."""

    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=2, d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128, vocab=256, head_dim=16 if cfg.n_heads else 0,
        vis_tokens=4 if cfg.vis_tokens else 0,
    )
    if cfg.n_experts:
        # generous capacity: smoke tests check prefill/decode equivalence,
        # which token dropping would break
        base.update(n_experts=4, top_k=2, moe_d_ff=32, capacity_factor=4.0)
    if cfg.family == "rwkv6":
        base.update(rwkv_head_dim=16)
    if cfg.family == "zamba2":
        base.update(ssm_state=8, ssm_head_dim=16, attn_every=2,
                    n_heads=4, n_kv_heads=4)
    if cfg.hybrid_layer_ids:      # the published form keeps its shape
        base.update(n_layers=4, attn_every=0, hybrid_layer_ids=(1, 3),
                    adapter_rank=4)
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
