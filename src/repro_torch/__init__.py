"""ThundeRiNG on PyTorch and CUDA: the generator's main path for one GPU.

Module paths mirror ``repro`` one for one (``repro/core/engine.py`` is
``repro_torch/core/engine.py``).  Plain tensor code is PyTorch; the block
generators are hand-written CUDA kernels (``csrc/``) built at first use.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch as _torch

# Settle the CPU's vector math before any of the port's CPU code runs.
# ATen computes float log / exp / sqrt / sin / cos on the CPU through
# MKL's vector math library (VML), which sets itself up on its first
# call.  When that first call is split over several intra-op threads,
# the threads race through the set-up and some compute their chunk
# differently from every later call (up to 1770 ULP in ``exp``): a
# served log-stage block could then differ from its own replay.  One
# VML call of 64 elements, below ATen's grain and so on this thread
# alone, completes the set-up for every VML function of the process
# (``tools/cpu_math_race.py`` measures it).
_torch.exp(_torch.ones(64))
