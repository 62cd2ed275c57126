"""granite-moe-3b-a800m [moe]: 32L d1536 24H (GQA kv=8) expert_ff=512
vocab49155, MoE 40 experts top-8.  [hf:ibm-granite granite-3.0 family; hf]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155, act="silu",
    n_experts=40, top_k=8, rope_theta=10000.0,
    # E=40 doesn't divide the 16-way model axis, so experts run f-sharded;
    # group 512 keeps the (gs, E, C) dispatch tensors within 16 GB/chip
    moe_group=512)
