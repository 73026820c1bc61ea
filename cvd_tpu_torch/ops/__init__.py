"""Ops with a plain PyTorch version and a hand-written Hopper kernel: epi_flash
(K1, K2), temporal_attn (K3), norms (K4), ln_matmul (K5). A CUDA tensor
launches the kernel (or the wrapper raises); a tensor on a device of
``PLAIN_DEVICES`` takes the plain version: the CPU, and ``meta``, on which
``utils/flops.py`` counts a UNet call without allocating it. Importing this
package builds nothing."""

PLAIN_DEVICES = ("cpu", "meta")
