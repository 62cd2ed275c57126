"""glm4-9b [dense]: 40L d4096 32H (GQA kv=2) ff13696 vocab151552.
RoPE + SwiGLU.  [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab=151552, act="silu",
    rope_theta=10000.0)
