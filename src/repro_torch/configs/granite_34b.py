"""granite-34b [dense]: llama-arch code model, MQA [arXiv:2405.04324; hf].

88L d_model=6144 48H (GQA kv=1 -> MQA; KV replicated under TP)
d_ff=24576 vocab=49152.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="transformer",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    act="silu",
    rope_theta=10000.0,
    compute_dtype="bfloat16",
    grad_compress="posit16",
    grad_accum=8,
    fsdp=True,
    seq_shard_activations=True,   # 88 layers: activations must seq-shard
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
