"""qwen2-vl-72b [vlm]: 80L d8192 64H (GQA kv=8) ff29568 vocab152064.
M-RoPE realized as RoPE over collapsed position ids; dynamic-resolution
vision frontend is a STUB — input_specs() supplies precomputed patch
embeddings for a 1024-token vision prefix.  [arXiv:2409.12191; hf]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064, act="silu",
    qkv_bias=True, rope_theta=1000000.0, vision_prefix=1024)
