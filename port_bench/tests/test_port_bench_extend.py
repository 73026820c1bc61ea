"""A later change adds a configuration, a cell, a per-layer metric and a
kernel family by adding files and BENCHMARK.json entries alone: in a copy
of the tree with one of each added, the command finds and runs them, and
no file that was there changes. The configuration is of the architecture
the tree has, or of one that the copy adds as a file: ``two_text``, whose
text conditioning is two encoders joined along the width, in the
reference and in the program alike."""
import hashlib
import json
import os
import shutil

import pytest

from port_bench.lib import count, names
from port_bench.tests import test_port_bench_counts
from port_bench.tests.helpers import run_cell

EXTRA_METRIC = '''"""extra_ops: how many of the reference's ops a request of the cell holds
that the kernel family kernels/extra_family.json takes in."""
from port_bench.lib import names, work
from port_bench.lib.readers import unit_work


def read(rec, ctx):
    fam = names.kernel_family("extra_family")
    return float(sum(r["count"] for r in unit_work(ctx)["ops"] if work.selects(fam, r)))
'''


TWO_TEXT = '''"""Architecture ``two_text``: ``cvd_sd15`` with a second text encoder
(the configuration's ``clip_2`` group), its states joined along the width
to the first's, as SDXL joins CLIP-L's and OpenCLIP bigG's; the two
widths sum to the UNet's ``cross_attention_dim``."""
import torch

from port_bench.lib import names

base = names.architecture("cvd_sd15")


class Joined(torch.nn.Module):
    def __init__(self, first, second):
        super().__init__()
        self.first, self.second = first, second

    def forward(self, ids):
        return torch.cat([self.first(ids), self.second(ids)], dim=-1)


def reference(config, device, vae_encoder=False):
    from port_bench.reference import model

    mods = base.reference(config, "meta", vae_encoder)
    with torch.device("meta"):
        mods["clip"] = Joined(mods["clip"], model.CLIPTextEncoder(config["clip_2"]))
    if torch.device(device).type != "meta":
        mods = mods.to_empty(device=device)
    return mods.requires_grad_(False)


def program(config, device, vae_encoder=False, unet_dtype=None):
    from cvd_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder

    modules = base.program(config, device, vae_encoder, unet_dtype)
    with torch.device("meta"):
        second = CLIPTextEncoder(CLIPTextConfig(**config["clip_2"]))
    dtype = next(modules.clip.parameters()).dtype
    second = second.to_empty(device=device).to(dtype).eval().requires_grad_(False)
    modules.clip = Joined(modules.clip, second)
    return modules


request_parts = base.request_parts
train_step_parts = base.train_step_parts
reference_request = base.reference_request
reference_steps = base.reference_steps
'''
CLIP_2 = {"vocab_size": 49408, "hidden_size": 16, "num_layers": 1, "num_heads": 2,
          "intermediate_size": 32, "max_position_embeddings": 77, "layer_norm_eps": 1e-05}


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d and not d.split(os.sep)[-1].startswith("."):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


@pytest.mark.parametrize("arch", ["cvd_sd15", "two_text"])
def test_add_by_files(tmp_path, monkeypatch, arch):
    src = names.BENCH_DIR
    dst = tmp_path / "port_bench"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(".cache", ".data",
                                                            "__pycache__"))
    before = _digests(dst)
    cfg = names.config("tiny-cpu")
    cfg["name"] = "tiny-extra"
    cfg["clip"] = dict(cfg["clip"], num_layers=1)
    if arch == "two_text":
        (dst / "architectures" / "two_text.py").write_text(TWO_TEXT)
        cfg["architecture"] = arch
        cfg["clip_2"] = CLIP_2
        cfg["unet"] = dict(cfg["unet"], cross_attention_dim=cfg["clip"]["hidden_size"]
                           + CLIP_2["hidden_size"])
    (dst / "configs" / "tiny-extra.json").write_text(json.dumps(cfg))
    cell = dict(names.cell("tiny-pair"), config="tiny-extra")
    (dst / "workloads" / "tiny-extra-pair.json").write_text(json.dumps(cell))
    (dst / "metrics" / "extra_ops.py").write_text(EXTRA_METRIC)
    (dst / "kernels" / "extra_family.json").write_text(json.dumps(
        {"patterns": ["nothing_on_the_cpu"], "op": "attention",
         "where": {"scope": ["unet"], "kind": ["epi"]}}))
    mix = names.traffic("tiny-pair")
    monkeypatch.setattr(names, "BENCH_DIR", str(dst))      # the copy's files, by name
    parts = count.unit_parts(cfg, "request", mix["frames"], mix["size"], mix["steps"])
    (dst / "work" / "tiny-extra.tiny-pair.json").write_text(json.dumps(
        {"config": "tiny-extra", "traffic": "tiny-pair", "unit": "request", "parts": parts}))
    bench = json.load(open(os.path.join(src, "tests", "data", "tiny_benchmark.json")))
    bench["configs"].append(dict(bench["configs"][0], name="tiny-extra",
                                 file="port_bench/configs/tiny-extra.json"))
    bench["workloads"].append({"name": "tiny-extra-pair", "config": "tiny-extra",
                               "traffic": "tiny-pair", "chips": 1, "why": "added by files"})
    bench["per_layer"].append({"name": "extra_ops", "unit": "ops", "better": "lower",
                               "source": "device_trace", "layer": "kernels",
                               "moves": "request_s", "workloads": ["tiny-extra-pair"]})
    bench["end_to_end"][0]["workloads"].append("tiny-extra-pair")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, line, err = run_cell("tiny-extra-pair", seconds=1, trace=1,
                             bench=str(tmp_path / "BENCHMARK.json"), root=str(tmp_path))
    assert rc == 0, err[-3000:]
    # two epi attentions in each of the UNet's 20 epi modules, 2 calls a request
    assert line["metrics"]["extra_ops"]["value"] == 2 * 20 * 2
    assert {"build_s", "capture_s"} <= set(line["metrics"])
    assert line["correct"] is True, err[-3000:]
    test_port_bench_counts.test_stored_work_is_the_reference_count("tiny-extra-pair")
    clip = next(p for p in parts if p["name"] == "clip")
    one = next(p for p in count.unit_parts(dict(cfg, architecture="cvd_sd15"), "request",
                                           mix["frames"], mix["size"], mix["steps"])
               if p["name"] == "clip")
    # the second encoder's work is counted where the architecture has one
    assert (clip["flops"] > one["flops"]) == (arch == "two_text")
    after = _digests(dst)
    assert {k: after[k] for k in before} == before
