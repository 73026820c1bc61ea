"""Why the port's FLOP count of a UNet call differs from the JAX package's,
op class by op class (both counted on the CPU; no device is involved).

    JAX_PLATFORMS=cpu python tests/torch_flop_accounting.py [B F L ...]

The port (``cvd_tpu_torch.utils.flops``) counts matrix products and
convolutions with ``FlopCounterMode`` at their nominal size. ``cvd_tpu``
(``cvd_tpu.utils.flops``) reads XLA's cost analysis of the lowered UNet, which
counts a convolution's taps that fall inside the input only (not the padding)
and one FLOP per element of every elementwise op, convert and reduction.
This script splits both counts:

* port: products (``addmm``, ``mm``, ``bmm``), convolutions at their nominal
  size and with XLA's rule of taps inside the input (``_ConvTaps``);
* JAX: the products (``dot``) and convolutions of the lowered HLO, each
  counted as XLA counts it (``_hlo_products``), and the rest of the cost
  analysis's total: elementwise ops, converts and reductions.

If the two models do the same products, the port's products equal the
JAX dots exactly and its convolutions under XLA's rule equal the JAX
convolutions exactly; what is left is XLA's elementwise count.
"""
from __future__ import annotations

import math
import os
import re
import sys
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PRODUCTS = ("aten.addmm", "aten.mm", "aten.bmm", "aten.baddbmm",
            "aten._scaled_dot_product_efficient_attention",
            "aten._scaled_dot_product_flash_attention")


def _inside_taps(out: int, inp: int, kernel: int, stride: int, pad: int, dilation: int) -> int:
    """(output position, kernel tap) pairs of one axis whose input lies
    inside the input, as XLA's cost analysis counts them."""
    return sum(0 <= o * stride - pad + k * dilation < inp
               for o in range(out) for k in range(kernel))


class _ConvTaps(TorchDispatchMode):
    """Sums the FLOPs of every ``aten.convolution``: nominal, and XLA's."""

    def __init__(self):
        super().__init__()
        self.nominal = self.inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            x, w, _, stride, padding, dilation, _, _, groups = args
            per_tap = 2 * x.shape[0] * w.shape[0] * (x.shape[1] // groups)
            self.nominal += per_tap * math.prod(w.shape[2:]) * math.prod(out.shape[2:])
            self.inside += per_tap * math.prod(
                _inside_taps(out.shape[2 + d], x.shape[2 + d], w.shape[2 + d], stride[d],
                             padding[d], dilation[d]) for d in range(w.ndim - 2))
        return out


def port_counts(batch: int, frames: int, latent: int) -> Dict[str, int]:
    from torch.utils.flop_counter import FlopCounterMode

    from cvd_tpu_torch.utils.flops import _unet_call

    unet, inputs = _unet_call(batch, frames, latent, bf16=True)
    counter, taps = FlopCounterMode(display=False), _ConvTaps()
    with counter, taps, torch.no_grad():
        unet(*inputs)
    ops = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    assert set(ops) <= set(PRODUCTS) | {"aten.convolution"}, ops
    return {"total": sum(ops.values()), "products": sum(ops.get(k, 0) for k in PRODUCTS),
            "conv": ops.get("aten.convolution", 0), "conv_inside": taps.inside,
            "conv_check": taps.nominal}


_DEF = re.compile(r"^\s*(?:ROOT )?([\w.\-]+) = [a-z0-9]+\[([0-9,]*)\]")


def _dims(text: str):
    return [int(d) for d in text.split(",") if d]


def _hlo_products(hlo: str) -> Dict[str, int]:
    """The FLOPs of the ``dot`` and ``convolution`` instructions of an HLO
    module's text, as XLA's cost analysis counts them: 2 x the output's
    elements x the contracted size; for a convolution, x the input features
    of a group x the (output, tap) pairs inside the input of each spatial
    axis."""
    shapes = {}
    for line in hlo.splitlines():
        m = _DEF.match(line)
        if m:
            shapes[m.group(1)] = _dims(m.group(2))
    dots = convs = 0
    for line in hlo.splitlines():
        m = _DEF.match(line)
        if not m:
            continue
        out = shapes[m.group(1)]
        if " dot(" in line:
            lhs = re.search(r" dot\(([\w.\-]+),", line).group(1)
            contract = _dims(re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", line).group(1))
            dots += 2 * math.prod(out) * math.prod(shapes[lhs][d] for d in contract)
        elif " convolution(" in line:
            x = shapes[re.search(r" convolution\(([\w.\-]+),", line).group(1)]
            xl, _, ol = re.search(r"dim_labels=(\w+)_(\w+)->(\w+)", line).groups()
            window = re.search(r"window=\{([^}]*)\}", line).group(1)
            size = [int(v) for v in re.search(r"size=([0-9x]+)", window).group(1).split("x")]
            pads = re.search(r"pad=([0-9_x\-]+)", window)
            pads = ([int(v.split("_")[0]) for v in pads.group(1).split("x")] if pads
                    else [0] * len(size))
            strides = re.search(r"stride=([0-9x]+)", window)
            strides = ([int(v) for v in strides.group(1).split("x")] if strides
                       else [1] * len(size))
            groups = re.search(r"feature_group_count=(\d+)", line)
            groups = int(groups.group(1)) if groups else 1
            taps = math.prod(
                _inside_taps(out[ol.index(str(d))], x[xl.index(str(d))], size[d], strides[d],
                             pads[d], 1) for d in range(len(size)))
            convs += (2 * out[ol.index("b")] * out[ol.index("f")]
                      * (x[xl.index("f")] // groups) * taps)
    return {"dots": dots, "conv": convs}


def jax_counts(batch: int, frames: int, latent: int) -> Dict[str, int]:
    """cvd_tpu's ``unet_apply_flops`` lowering, split into its products,
    convolutions and the rest."""
    import jax
    import jax.numpy as jnp

    from cvd_tpu.models.epi import EpiConditioning
    from cvd_tpu.models.unet import UNet3DConditionModel, UNetConfig
    from cvd_tpu.pipelines.common import abstract_param_shapes

    cfg = UNetConfig(dtype=jnp.bfloat16)
    unet = UNet3DConditionModel(cfg)
    shapes = abstract_param_shapes(unet_config=cfg, latent_size=latent, video_length=frames)
    S = jax.ShapeDtypeStruct
    ch = cfg.block_out_channels
    args = (shapes["unet"], S((batch, frames, latent, latent, 4), jnp.float32),
            S((), jnp.int32), S((batch, 77, cfg.cross_attention_dim), jnp.float32),
            [S((batch, frames, latent // 2 ** i, latent // 2 ** i, ch[i]), jnp.bfloat16)
             for i in range(4)],
            EpiConditioning(F_mats=S((batch * frames, 3, 3), jnp.float32),
                            video_length=frames, rand_slope_ff=False, use_flash_kernel=False))
    lowered = jax.jit(lambda p, lat, t, text, pf, cond: unet.apply(p, lat, t, text, pf, cond)
                      ).lower(*args)
    total = int(lowered.cost_analysis()["flops"])
    parts = _hlo_products(lowered.compiler_ir("hlo").as_hlo_text())
    return {"total": total, **parts, "rest": total - parts["dots"] - parts["conv"]}


def main(shapes):
    for batch, frames, latent in shapes:
        p, j = port_counts(batch, frames, latent), jax_counts(batch, frames, latent)
        print(f"B{batch} F{frames} L{latent}: port {p['total']:,} (products {p['products']:,}, "
              f"convolutions {p['conv']:,}, of which taps inside the input {p['conv_inside']:,}); "
              f"cvd_tpu {j['total']:,} (dots {j['dots']:,}, convolutions {j['conv']:,}, "
              f"elementwise, converts and reductions {j['rest']:,}); port above by "
              f"{p['total'] / j['total'] - 1:.2%}")


if __name__ == "__main__":
    import jax

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    jax.config.update("jax_platforms", "cpu")
    nums = [int(a) for a in sys.argv[1:]] or [2, 2, 8, 2, 4, 8, 2, 2, 16]
    main([tuple(nums[i:i + 3]) for i in range(0, len(nums), 3)])
