"""internvl2-1b [vlm]: InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The vision
frontend is a stub: the caller passes 256 precomputed patch embeddings
per sample (``visual``), which take the front of the text sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="transformer",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    act="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,          # internlm2-1.8b ties embeddings
    n_visual_tokens=256,
    compute_dtype="bfloat16",
    grad_compress="posit16",
    grad_accum=4,
    seq_shard_activations=True,
)

# full attention: no long-context shape
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
