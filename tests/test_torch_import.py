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


def test_models_import_no_tracing():
    """A UNet call is handed its sublayer timer by its caller: no module of
    ``cvd_tpu_torch.models`` imports ``cvd_tpu_torch.utils.tracing``."""
    import ast

    models = os.path.join(os.path.dirname(os.path.abspath(cvd_tpu_torch.__file__)), "models")
    banned = "cvd_tpu_torch.utils.tracing"
    files = sorted(f for f in os.listdir(models) if f.endswith(".py"))
    assert "unet.py" in files
    for name in files:
        with open(os.path.join(models, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                got = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = (node.module or "") if not node.level else ".".join(
                    ["cvd_tpu_torch", "models"][:3 - node.level] + [node.module or ""]).rstrip(".")
                got = [base] + [f"{base}.{a.name}" for a in node.names]
            else:
                continue
            assert not [g for g in got if g == banned or g.startswith(banned + ".")], (name, got)
