"""granite-34b [dense]: 88L d6144 48H (MQA kv=1) ff24576 vocab49152.
Code model; GPTBigCode-style plain-GELU MLP (2 matrices — matches the 34B
parameter count).  [arXiv:2405.04324; hf]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense", n_layers=88, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152, act="gelu",
    rope_theta=10000.0)
