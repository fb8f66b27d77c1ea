"""phi3-medium-14b [dense]: RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="transformer",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab=100352,
    act="silu",
    rope_theta=10000.0,
    compute_dtype="bfloat16",
    grad_compress="posit16",
    grad_accum=4,
    fsdp=True,
    seq_shard_activations=True,
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
