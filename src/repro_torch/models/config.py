"""Model configuration (one dataclass covers every assigned architecture).

A plain-Python copy of the reference's ``ModelConfig`` (same fields and
defaults, so a config means the same model in both packages).  The
port's ``configs`` registry lists the architectures it can serve; smoke
tests use ``reduced()`` copies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "transformer"   # transformer | rwkv6 | hymba | whisper
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    act: str = "silu"             # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # gemma-style details
    scale_embed: bool = False     # multiply embeddings by sqrt(d_model)
    norm_plus_one: bool = False   # RMSNorm weight stored as (1 + w)

    # --- MoE ---
    n_experts: int = 0            # 0 = dense
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # --- MLA (minicpm3) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- hybrid / SSM (rwkv6, hymba) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    sliding_window: int = 0       # 0 = full attention
    global_layers: Tuple[int, ...] = ()   # hymba: full-attn layer ids
    n_meta_tokens: int = 0
    wkv_chunk: int = 64
    decay_lora: int = 64          # rwkv6 data-dependent decay lora rank

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0          # frames after the conv stub

    # --- multimodal stub ---
    n_visual_tokens: int = 0      # internvl: patch embeds prepended

    # --- posit integration (the paper's technique) ---
    weight_posit: Optional[str] = None    # None | 'posit16' | 'posit8'
    kv_posit: Optional[str] = None
    paged_attn_kernel: str = "gather"     # paged decode: 'gather' (plain
                                          # torch) | 'fused' (CUDA
                                          # block-table walk, posit
                                          # decode in-kernel)
    grad_compress: Optional[str] = None   # cross-pod gradient posit
    posit_exact_linear: bool = False      # dense() via quire-exact pgemm
                                          # (numerics audits; slow)

    # --- distribution / memory policy ---
    compute_dtype: str = "float32"        # activations: float32 | bfloat16
    seq_shard_activations: bool = False   # Megatron-SP style constraint
    fsdp: bool = False                    # shard params/opt over 'data' too
    batch_axes: Tuple[str, ...] = ("data",)   # mesh axes carrying batch
    remat: str = "layer"                  # none | layer
    causal_skip: str = "mask"             # mask | cond (skip future blocks)
    grad_accum: int = 1                   # microbatches per train step
    loss_chunk: int = 2048                # vocab-loss sequence chunking
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_dim(self) -> int:
        if self.mla:
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16, d_ff=128, vocab=256,
            loss_chunk=64, attn_chunk_q=16, attn_chunk_kv=32, wkv_chunk=8,
        )
        if self.is_moe:
            small.update(n_experts=4, top_k=2, d_ff_expert=32)
        if self.mla:
            small.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                         qk_rope_dim=8, v_head_dim=16, head_dim=16)
        if self.family == "rwkv6":
            small.update(n_heads=4, head_dim=16, decay_lora=8)
        if self.family == "hymba":
            small.update(ssm_state=4, ssm_heads=4, ssm_head_dim=16,
                         sliding_window=16, global_layers=(0,),
                         n_meta_tokens=4)
        if self.family == "whisper":
            small.update(encoder_layers=2, encoder_seq=32)
        if self.n_visual_tokens:
            small.update(n_visual_tokens=8)
        small.update(overrides)
        return dataclasses.replace(self, **small)
