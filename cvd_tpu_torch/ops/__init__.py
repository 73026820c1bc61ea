"""Ops with a plain PyTorch version (CPU tensors) and a hand-written Hopper
kernel (CUDA tensors): epi_flash (K1, K2), temporal_attn (K3), norms (K4),
ln_matmul (K5). Importing this package builds nothing."""
