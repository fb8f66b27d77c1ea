"""rwkv6-7b [ssm]: Finch, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.  64 heads of 64
(d_att = d_model).  O(1) recurrent state -> runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="rwkv6",
    n_layers=32,
    d_model=4096,
    n_heads=64,                   # d_att / head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    decay_lora=64,
    wkv_chunk=16,                 # bounds the (C,C,N) ratio tensor
    compute_dtype="bfloat16",
    grad_compress="posit16",
    grad_accum=4,
    fsdp=True,
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
