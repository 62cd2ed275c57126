"""ThundeRiNG on PyTorch and CUDA: the generator's main path for one GPU.

Module paths mirror ``repro`` one for one (``repro/core/engine.py`` is
``repro_torch/core/engine.py``).  Plain tensor code is PyTorch; the block
generators are hand-written CUDA kernels (``csrc/``) built at first use.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
