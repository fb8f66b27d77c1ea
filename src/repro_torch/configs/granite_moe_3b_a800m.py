"""granite-moe-3b-a800m [moe] [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

32L d_model=1536 24H (GQA kv=8) d_ff=512 per expert, vocab=49155,
MoE 40 experts top-8 (experts sharded over the 'model' axis).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="transformer",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    act="silu",
    rope_theta=10000.0,
    n_experts=40,
    top_k=8,
    d_ff_expert=512,
    compute_dtype="bfloat16",
    grad_compress="posit16",
    grad_accum=4,
    seq_shard_activations=True,
    fsdp=True,
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
