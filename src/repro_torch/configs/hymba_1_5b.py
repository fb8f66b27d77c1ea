"""hymba-1.5b [hybrid]: parallel attn+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 ssm_state=16.  SWA (1024)
everywhere except 3 global layers {0, 15, 31}; 128 meta tokens.
Sub-quadratic -> runs the long_500k cell (SWA ring caches + 3 full
global caches, sequence-sharded).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hymba",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    act="silu",
    rope_theta=10000.0,
    ssm_state=16,
    ssm_heads=25,
    ssm_head_dim=64,
    sliding_window=1024,
    global_layers=(0, 15, 31),
    n_meta_tokens=128,
    wkv_chunk=64,                 # scalar decay: (C,C) ratios are cheap
    compute_dtype="bfloat16",
    grad_compress="posit16",
    grad_accum=4,
    seq_shard_activations=True,
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
