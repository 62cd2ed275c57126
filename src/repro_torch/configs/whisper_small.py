"""whisper-small [audio/enc-dec]: 12+12L d768 12H ff3072 vocab51865.
Conv frontend is a STUB — input_specs() supplies precomputed frame
embeddings (B, 1500, 768).  Sinusoidal positions on both sides (the
reference uses learned decoder positions; documented deviation).
[arXiv:2212.04356]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec", n_layers=12, enc_layers=12,
    d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865,
    act="gelu", tie_embeddings=True, rope_theta=0.0, enc_ctx=1500,
    norm_eps=1e-5)
