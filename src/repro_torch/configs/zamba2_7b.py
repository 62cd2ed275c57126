"""zamba2-7b [hybrid]: 81 mamba2 layers d3584 + ONE shared attention+MLP
block (32H kv=32, ff 14336) applied every 6 layers; ssm_state=64.
Per-application LoRA of the shared block omitted (DESIGN.md).
[arXiv:2411.15242]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
    act="silu", tie_embeddings=True, attn_every=6,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64)
