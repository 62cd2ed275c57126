"""Inference-tier kernels: kernel F (bits -> sampled token ids) with its
plain version and the two-pass oracle."""
from repro_torch.inference.kernels.gumbel_argmax import (  # noqa: F401
    argmax_first, fused_argmax, fused_argmax_plain, gumbel_scores,
    twopass_argmax)
