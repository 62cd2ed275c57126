"""Block-generation kernels: plain oracles (``ref``) and the CUDA kernels
with their launch wrappers (``thundering_block``)."""
