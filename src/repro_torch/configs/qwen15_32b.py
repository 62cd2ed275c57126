"""qwen1.5-32b [dense]: 64L d5120 40H (kv=40) ff27392 vocab152064.
QKV bias.  [hf:Qwen/Qwen1.5 family; hf]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=27392, vocab=152064, act="silu",
    qkv_bias=True, rope_theta=1000000.0,
    # 40-head full-MHA KV at 32k x 128 is 5.5 TB in bf16 (21.5 GiB/chip
    # even context+batch sharded) — store the cache in float8_e4m3
    kv_dtype="f8")
