"""mamba2-2.7b [ssm]: 64L d2560 (attn-free) vocab50280, ssm_state=128.
SSD (state-space duality); expand=2 -> d_inner 5120, head_dim 64 -> 80
heads, 1 group, conv4.  [arXiv:2405.21060]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280, tie_embeddings=True,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64)
