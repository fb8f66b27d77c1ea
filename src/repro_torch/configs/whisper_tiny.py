"""whisper-tiny [audio]: enc-dec, conv frontend stub [arXiv:2212.04356].

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865; encoder sees 1500
precomputed frame embeddings (the conv frontend is a STUB per the
assignment).  decode_32k runs mechanically (far beyond whisper's 448
context — noted in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="whisper",
    n_layers=4,                   # decoder layers
    encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    compute_dtype="bfloat16",
    grad_compress="posit16",
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
