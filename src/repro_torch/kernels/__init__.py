"""Kernels and their oracles: plain torch oracles (``ref``), the nvcc
build of ``csrc/`` (``build``), the CUDA kernels with their launch wrappers
and plain versions - block generators (``thundering_block``), Monte-Carlo
pi and option pricing (``mc``), fused dropout (``fused_dropout``) - and the
public entry points over them (``ops``)."""
