"""cvd_tpu_torch imports torch and numpy only: never jax, flax or cvd_tpu,
and ``safetensors`` / ``transformers`` / ``matplotlib`` / ``imageio`` (which a
GPU machine may lack) only inside the functions that need them."""
import os
import subprocess
import sys

import cvd_tpu_torch

_CHECK = r"""
import importlib, pkgutil, sys
import cvd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cvd_tpu_torch.__path__, "cvd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "cvd_tpu"))
assert not bad, bad
assert "triton" not in sys.modules, "triton must be imported only at kernel launch"
lazy = sorted(m for m in sys.modules
              if m.split(".")[0] in ("safetensors", "transformers", "matplotlib", "imageio"))
assert not lazy, lazy
for new in ("io.manifests", "io.torch_io", "io.checkpoints", "io.model_config", "io.lora",
            "io.tokenizer", "cli.build", "cli.merge_lora", "pipelines.pab",
            "models.sparse_controlnet", "data.latents_cache", "utils.visualize",
            "data.webvid", "data.remote", "io.ldm_convert", "cli.eval_parity",
            "schedulers.inversion", "utils.flops", "utils.profiling", "data.extract_frames",
            "parallel", "parallel.mesh", "parallel.shard_ops"):
    assert "cvd_tpu_torch." + new in names, new
# the port's own copy of the PAB schedules, not a re-export of cvd_tpu's
assert sys.modules["cvd_tpu_torch.pipelines.pab"].__file__.endswith(
    "cvd_tpu_torch/pipelines/pab.py")
print(len(names))
"""


def test_port_imports_no_jax_flax_or_cvd_tpu():
    root = os.path.dirname(os.path.dirname(os.path.abspath(cvd_tpu_torch.__file__)))
    # a fresh interpreter, with the repo alone on PYTHONPATH
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _CHECK], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[-1]) >= 42, out.stdout
