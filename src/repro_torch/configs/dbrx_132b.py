"""dbrx-132b [moe]: 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 per expert vocab=100352,
MoE 16e top-4.  Serving cells *require* the paper's posit compression:
bf16 weights (264 GB) + bf16 32k-cache do not fit 16 GB/chip at TP=16;
posit8 weights + posit8 KV do (EXPERIMENTS.md §Dry-run).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="transformer",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    act="silu",
    rope_theta=500000.0,
    n_experts=16,
    top_k=4,
    d_ff_expert=10752,
    compute_dtype="bfloat16",
    grad_compress="posit16",
    grad_accum=8,
    fsdp=True,
    seq_shard_activations=True,
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")

# serving memory policy (see module docstring)
SERVE_OVERRIDES = dict(weight_posit="posit8", kv_posit="posit8")
