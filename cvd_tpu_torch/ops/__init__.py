"""Ops with a plain PyTorch version and a hand-written Hopper kernel: epi_flash
(K1, K2), temporal_attn (K3), norms (K4), ln_matmul (K5). A CUDA tensor
launches the kernel (or the wrapper raises); a tensor on a device of
``PLAIN_DEVICES`` takes the plain version: the CPU, and ``meta``, on which
``utils/flops.py`` counts a UNet call without allocating it. Importing this
package builds nothing."""

PLAIN_DEVICES = ("cpu", "meta")


def counted_wrappers() -> dict:
    """The op wrappers that launch the kernels, by name: each carries its
    count of launches, ``launches`` (one added where it launches its
    kernel, and nowhere else)."""
    from cvd_tpu_torch.ops import epi_flash, ln_matmul, norms, temporal_attn

    return {"epi_flash_attention": epi_flash.epi_flash_attention,
            "flash_attention": epi_flash.flash_attention,
            "temporal_flash_attention": temporal_attn.temporal_flash_attention,
            "group_norm": norms.group_norm,
            "layer_norm_matmul": ln_matmul.layer_norm_matmul,
            "epi_flash_attention_bwd": epi_flash.epi_flash_attention_bwd,
            "flash_attention_bwd": epi_flash.flash_attention_bwd,
            "temporal_flash_attention_bwd": temporal_attn.temporal_flash_attention_bwd}
