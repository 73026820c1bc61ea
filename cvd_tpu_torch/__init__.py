"""cvd_tpu_torch — collaborative video diffusion in PyTorch and CUDA.

A port of ``cvd_tpu`` (JAX/Flax/Pallas) to PyTorch on an NVIDIA H100. The
subpackages mirror the JAX package's, module for module:

  geometry/    camera & epipolar math (numpy on the host, torch on device)
  data/        the pose-file validation dataset, RealEstate10K, the loader
  ops/         attention / norm ops: a plain PyTorch version of each, and a
               hand-written Hopper kernel (csrc/, Triton) for CUDA tensors,
               forward and backward
  models/      nn.Modules: UNet3D, motion / epi modules, pose encoder, VAE,
               CLIP text encoder
  schedulers/  DDIM
  pipelines/   the simple 2-view sampler, the N-view sampler
  parallel/    meshes of torchrun processes and the sharded attention ops
               (``--sharded``)
  train/       losses, train state, checkpoints, the epi training step
  io/          checkpoint import (SD1.5 folder, motion module, epi and pose
               adaptor checkpoints; their key manifests), model config,
               LoRA fusion, tokenizer, Flax param tree -> state dict
  cli/         ``python -m cvd_tpu_torch.cli.inference``,
               ``.cli.inference_advanced``, ``.cli.train``, ``.cli.build
               --validate-ckpts`` and ``.cli.merge_lora``

The package imports torch and numpy only: never jax, flax or cvd_tpu.
"""

__version__ = "0.1.0"
