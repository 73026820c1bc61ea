"""SparseCtrl (``cvd_tpu_torch.models.sparse_controlnet``) against cvd_tpu's,
through the files both packages load, and the 2-view CLI's options and
outputs against cvd_tpu's, on the CPU in f32.

The file is the thing compared: the port's tiny ``SparseControlNetModel``
(the smoke widths), every tensor drawn (``random_init_``, so every zero
convolution is nonzero: a zero one proves nothing), written with its own
``state_dict()`` names, which are the released file's, plus the motion
modules' ``pos_encoder.pe`` buffers the released files carry. cvd_tpu reads
it with its own loader (``cli.build.load_sparse_controlnet``: a strict import
over a ``jax.eval_shape`` zeros tree, no Flax init), the port with
``cli.build.load_sparse_controlnet``. Residuals agree to 1e-5 * max(1,
max |ref|) (f32 in both, summation order only).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_checkpoints import model_args  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")
TOL = 1e-5
B, Fr, S = 1, 2, 8   # videos, frames, latent size
LAYOUTS = {"pyramid": (False, "top level"), "simplified": (True, "state_dict")}


def close(got, want, what):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    err = float(np.max(np.abs(got - want)))
    limit = TOL * max(1.0, float(np.max(np.abs(want))))
    assert err <= limit, f"{what}: max err {err:.3g} > {limit:.3g}"


def tiny_state(simplified, seed=0):
    """A seeded tiny SparseCtrl state in the released file's names, with the
    motion modules' ``pos_encoder.pe`` buffers."""
    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.models.layers import temporal_positional_encoding
    from cvd_tpu_torch.models.sparse_controlnet import SparseControlNetModel
    from cvd_tpu_torch.pipelines.common import random_init_

    model = SparseControlNetModel(SMOKE_UNET, 4 if simplified else 3,
                                  use_simplified_condition_embedding=simplified)
    random_init_(model, torch.Generator().manual_seed(seed))
    state = dict(model.state_dict())
    for key, w in list(state.items()):
        if ".motion_modules." in key and key.endswith("attention_blocks.0.to_q.weight"):
            pe = temporal_positional_encoding(SMOKE_UNET.motion_pe_max_len, w.shape[0])
            state[key.replace("to_q.weight", "pos_encoder.pe")] = pe
    return state


def write(state, path, container):
    torch.save(state if container == "top level" else {"state_dict": state, "epoch": 3}, path)
    return str(path)


def inputs(simplified, seed=1):
    rng = np.random.default_rng(seed)
    H, c = (S, 4) if simplified else (8 * S, 3)
    return dict(sample=rng.standard_normal((B, Fr, S, S, 4)).astype(np.float32),
                timesteps=np.array([421]),
                text=rng.standard_normal((B, 7, 24)).astype(np.float32),
                cond=rng.standard_normal((B, Fr, H, H, c)).astype(np.float32),
                mask=(rng.random((B, Fr, H, H, 1)) > 0.5).astype(np.float32))


def port_model(path, simplified):
    from cvd_tpu_torch.cli.build import SMOKE_UNET, load_sparse_controlnet

    return load_sparse_controlnet(path, SMOKE_UNET, simplified, torch.device("cpu"),
                                  torch.float32)


def port_run(model, x, scale):
    t = torch.from_numpy
    with torch.no_grad():
        return model(t(x["sample"]), t(x["timesteps"]), t(x["text"]), t(x["cond"]), t(x["mask"]),
                     conditioning_scale=scale)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sparsectrl_from_a_file_matches_jax(layout, tmp_path):
    """Both layouts (the pyramid at the file's top level, the simplified one
    under ``state_dict``): every down residual and the mid residual."""
    from tiny import TINY_UNET

    from cvd_tpu.cli.build import load_sparse_controlnet as jax_load

    simplified, container = LAYOUTS[layout]
    path = write(tiny_state(simplified), tmp_path / "sparsectrl.ckpt", container)
    jm, params = jax_load(path, TINY_UNET, simplified=simplified)
    x = inputs(simplified)
    down_w, mid_w = jax.jit(lambda p, a: jm.apply(
        p, a["sample"], a["timesteps"], a["text"], a["cond"], a["mask"],
        conditioning_scale=0.7))(params, jax.tree_util.tree_map(jnp.asarray, x))
    down, mid = port_run(port_model(path, simplified), x, 0.7)
    assert len(down) == len(down_w) == 12
    for i, (got, want) in enumerate(zip(down, down_w)):
        close(got, want, f"{layout} down residual {i}")
        assert float(got.abs().max()) > 1e-3, f"residual {i} is zero"
    close(mid, mid_w, f"{layout} mid residual")


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("container", ["top level", "state_dict"])
def test_every_parameter_comes_from_the_file(layout, container, tmp_path):
    simplified = LAYOUTS[layout][0]
    state = tiny_state(simplified, seed=2)
    model = port_model(write(state, tmp_path / "s.ckpt", container), simplified)
    params = dict(model.named_parameters())
    assert set(params) == {k for k in state if "pos_encoder" not in k}
    assert all(torch.equal(p, state[n]) for n, p in params.items())
    assert not model.training and not any(p.requires_grad for p in params.values())


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_sparsectrl_import_is_strict(fault, tmp_path):
    state = tiny_state(False)
    key = "controlnet_down_blocks.3.weight"
    if fault == "extra":
        state["controlnet_down_blocks.99.weight"] = state[key]
    elif fault == "missing":
        del state[key]
    else:
        state[key] = state[key][:, :1]
    with pytest.raises(KeyError, match="controlnet_down_blocks"):
        port_model(write(state, tmp_path / "s.ckpt", "top level"), False)


def test_fresh_sparsectrl_residuals_are_zero():
    """Under ``default_init_`` the zero convolutions give zero residuals, as
    the reference's zero-initialized output projections."""
    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.models.sparse_controlnet import SparseControlNetModel
    from cvd_tpu_torch.pipelines.common import default_init_

    model = SparseControlNetModel(SMOKE_UNET)
    default_init_(model, torch.Generator().manual_seed(0), model.zero_initialized())
    down, mid = port_run(model, inputs(False), 1.0)
    assert not mid.any() and not any(r.any() for r in down)


def test_build_modules_and_validate_ckpts_take_the_sparsectrl_file(tmp_path, capsys):
    """``--controlnet_ckpt`` beside random weights is refused (it would be
    ignored; a build from files with it: tests/test_torch_build.py);
    ``--validate-ckpts`` checks the file of each layout against the
    SD1.5-wide model and fails on a missing key."""
    from cvd_tpu_torch.cli import build
    from cvd_tpu_torch.io import manifests as M

    with pytest.raises(ValueError, match="controlnet_ckpt"):
        build.build_modules(model_args({}, random_weights=True,
                                       controlnet_ckpt="/nonexistent/c.ckpt"),
                            torch.device("cpu"))
    # --validate-ckpts on a file from the manifest (zeros), each layout
    for simplified in (False, True):
        state = {k: torch.zeros(s) for k, s in
                 M.animatediff_sparsectrl_manifest(simplified).items()}
        path = write(state, tmp_path / f"v{int(simplified)}.ckpt", "top level")
        ns = model_args({}, controlnet_ckpt=path, controlnet_simplified_embedding=simplified)
        assert build.validate_ckpts(ns) == 0
        assert "[validate-ckpts] sparsectrl: " in capsys.readouterr().out
    del state["controlnet_mid_block.bias"]
    ns = model_args({}, controlnet_ckpt=write(state, tmp_path / "bad.ckpt", "top level"),
                    controlnet_simplified_embedding=True)
    assert build.validate_ckpts(ns) == 1


# ------------------------------------------------------------- the 2-view CLI

def _value(action):
    """An argument string for an option that takes one."""
    if action.choices:
        return str(list(action.choices)[0])
    if action.type is int:
        return "1"
    if action.type is float:
        return "0.5"
    return "x"


def _required(parser):
    return [s for a in parser._actions if a.required for s in (a.option_strings[0], _value(a))]


@pytest.mark.parametrize("entry", ["inference", "inference_advanced"])
def test_every_cvd_tpu_option_parses_in_the_port(entry):
    """Every option string of cvd_tpu's parser is taken by the port's (the
    port's only extra is ``--device``): a command line written for cvd_tpu
    parses."""
    import importlib

    theirs = importlib.import_module(f"cvd_tpu.cli.{entry}").build_parser()
    mine = importlib.import_module(f"cvd_tpu_torch.cli.{entry}").build_parser()
    base = _required(theirs)
    strings = [(s, a) for a in theirs._actions for s in a.option_strings if s not in ("-h", "--help")]
    assert len(strings) > 30
    for s, action in strings:
        argv = base + [s] + ([] if action.nargs == 0 else [_value(action)])
        mine.parse_args(argv)
    ours = {s for a in mine._actions for s in a.option_strings}
    assert ours - {s for s, _ in strings} - {"-h", "--help"} == {"--device"}


def test_no_lora_validation_and_scan_layers_are_no_ops_and_sharded_is_refused(tmp_path,
                                                                              monkeypatch):
    """--sharded runs over torchrun's processes: without their environment
    it is refused, naming torchrun, before anything is read or written."""
    from cvd_tpu_torch.cli import inference
    from cvd_tpu_torch.parallel.mesh import TORCHRUN_ENV

    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    args = inference.build_parser().parse_args([
        "--caption_file", "c.json", "--pose_file_0", "a", "--pose_file_1", "b",
        "--no_lora_validation", "--no-scan_layers", "--sharded", "--random-weights",
        "--out_root", str(tmp_path / "out")])
    assert args.no_lora_validation and args.scan_layers is False
    with pytest.raises(RuntimeError, match="--sharded needs the environment torchrun sets"):
        inference.main(args)
    assert not (tmp_path / "out").exists()


def test_save_trajectory_without_matplotlib_raises_first(monkeypatch, tmp_path):
    from cvd_tpu_torch.cli import inference
    from cvd_tpu_torch.utils import visualize

    monkeypatch.setattr(visualize, "have_matplotlib", lambda: False)
    args = inference.build_parser().parse_args([
        "--caption_file", "/nonexistent.json", "--pose_file_0", "a", "--pose_file_1", "b",
        "--save_trajectory", "--random-weights", "--device", "cpu",
        "--out_root", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="matplotlib"):
        inference.main(args)


def test_cli_outputs_match_cvd_tpus(tmp_path, monkeypatch):
    """The port's CLI at the smoke widths with ``--save_trajectory``; then
    cvd_tpu's ``main`` with its model stood in by one that returns the port's
    videos (a Flax init of the tiny model takes minutes on a CPU): the two
    side-by-side videos (gifs where imageio has no ffmpeg plugin), the
    per-view videos and the
    poses it writes equal the port's, read back with imageio; the PNGs and
    the run log exist."""
    imageio = pytest.importorskip("imageio", reason="the outputs are read back with imageio")

    import cvd_tpu.cli.build as jax_build
    import cvd_tpu.pipelines.simple as jax_simple
    from cvd_tpu.cli import inference as jax_inference
    from cvd_tpu.io.tokenizer import HashTokenizer
    from cvd_tpu_torch.cli import inference

    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps({"captions": ["a quiet room"]}))
    common = ["--image_height", "64", "--image_width", "64", "--video_length", "2",
              "--num_inference_steps", "2", "--caption_file", str(prompts),
              "--pose_file_0", os.path.join(ASSETS, "pose_files", "example_dolly.txt"),
              "--pose_file_1", os.path.join(ASSETS, "pose_files", "example_arc.txt"),
              "--save_trajectory", "--random-weights"]
    mine = tmp_path / "port"
    (rec,) = inference.main(inference.build_parser().parse_args(
        common + ["--device", "cpu", "--out_root", str(mine)]))
    videos = rec["videos"]

    class Stand:
        def __init__(self, *a, **k):
            pass

        def __call__(self, *a, **k):
            return jnp.asarray(videos)

    monkeypatch.setattr(jax_build, "build_modules", lambda *a, **k: (None, HashTokenizer()))
    monkeypatch.setattr(jax_simple, "SimplePipeline", Stand)
    theirs = tmp_path / "jax"
    jax_inference.main(jax_inference.build_parser().parse_args(
        common + ["--out_root", str(theirs)]))

    def frames(path):
        return np.stack(imageio.mimread(path))

    for name in ("horizontal", "vertical", "0", "1"):
        got, want = (frames(os.path.join(root, "0", "vids", f"{name}.gif"))
                     for root in (mine, theirs))
        assert got.shape == want.shape and np.array_equal(got, want), name
    assert frames(os.path.join(mine, "0", "vids", "horizontal.gif")).shape[1:3] == (64, 128)
    assert frames(os.path.join(mine, "0", "vids", "vertical.gif")).shape[1:3] == (128, 64)
    for v in range(2):
        np.testing.assert_array_equal(np.load(mine / "0" / "poses" / f"ret_c2w_{v}.npy"),
                                      np.load(theirs / "0" / "poses" / f"ret_c2w_{v}.npy"))
        assert (mine / "0" / "poses" / f"pose_img_{v}.png").stat().st_size > 0
    log = (mine / "log_p0.txt").read_text()
    assert "a quiet room" in log and "horizontal" in log
