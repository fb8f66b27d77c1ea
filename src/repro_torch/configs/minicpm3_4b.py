"""minicpm3-4b [dense]: MLA [hf:openbmb/MiniCPM3-4B; hf].

62L d_model=2560 40H (kv=40 after latent decompression) d_ff=6400
vocab=73448.  Multi-head latent attention: q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v_head=64 -- the cache stores only the 288-wide
latent per token.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="transformer",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=96,                  # qk_nope + qk_rope (bookkeeping only)
    d_ff=6400,
    vocab=73448,
    act="silu",
    rope_theta=10000.0,
    mla=True,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    compute_dtype="bfloat16",
    grad_compress="posit16",
    grad_accum=4,
    seq_shard_activations=True,
    fsdp=True,
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
