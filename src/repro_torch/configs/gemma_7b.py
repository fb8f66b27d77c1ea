"""gemma-7b [dense]: GeGLU, head_dim=256 [arXiv:2403.08295; hf].

28L d_model=3072 16H (GQA kv=16 = MHA) d_ff=24576 vocab=256000.
Gemma details: embeddings scaled by sqrt(d); RMSNorm stores (1 + w);
tied unembedding.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="transformer",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    act="gelu",
    rope_theta=10000.0,
    tie_embeddings=True,
    scale_embed=True,
    norm_plus_one=True,
    compute_dtype="bfloat16",
    grad_compress="posit16",
    grad_accum=4,
    fsdp=True,
    seq_shard_activations=True,
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
