"""One process of the port's data-parallel training or sharded sampling on
the CPU (gloo), for tests/test_torch_multihost.py and tests/test_torch_mesh.py.
Run as ``torchrun`` would start it, with RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT set:

    python tests/torch_dist_worker.py step|run|world_of_one OUT.pt
    python tests/torch_dist_worker.py mesh_ops|mesh_samplers|mesh_clis OUT.pt IN.pt

``step``: one step of the smoke-width UNet on this rank's folded pair with
the noise and timesteps pinned (``pinned_step``), the gradients averaged
over the group, then AdamW: saves the averaged gradients and the new
trainable weights. ``run``: ``cli.train.run`` with ``multihost`` on
in-memory posed and unposed sources: saves the losses, kinds and trainable
weights. ``world_of_one``: the same run as a world of one, and again
without ``multihost``: saves both losses.

``mesh_ops``: for each mesh shape of IN.pt's ``meshes``, each shard-op case
of its ``cases`` on this rank's block, gathered back to the global tensor.
``mesh_samplers``: the bundle of IN.pt, and each of its sampler ``cases``
on each mesh: the final latents (every rank's own); each rank also runs
every world-th case unsharded. ``mesh_clis``: the two
sampling CLIs with ``--sharded --device cpu`` and IN.pt's arguments, in the
one process group (the out root is made per rank): their records.
"""
import os
import random
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
torch.set_num_threads(1)

Fr, S = 2, 8


def pair_batch(pairs):
    """The folded device batch of the given pairs (video-major rows: the
    first videos of every pair, then the second ones) and its pinned noise
    and timesteps."""
    rows = [(p, v) for v in (0, 1) for p in pairs]

    def stack(key, shape, scale=1.0, ints=False):
        out = []
        for p, v in rows:
            rng = np.random.default_rng([key, p, v])
            out.append(rng.integers(0, 1000, shape) if ints
                       else (rng.standard_normal(shape) * scale).astype(np.float32))
        return torch.from_numpy(np.stack(out))

    batch = {"latents": stack(0, (Fr, S, S, 4)), "text_ids": stack(1, (77,), ints=True),
             "plucker": stack(2, (Fr, 8 * S, 8 * S, 6)),
             "F_mats": stack(3, (Fr, 3, 3), scale=1e-3)}
    return batch, stack(4, (Fr, S, S, 4)), stack(5, (), ints=True)


def pinned_step(modules, state, pairs, distributed):
    """loss_and_grads on ``pairs`` with pinned draws (horizontal first-frame
    lines), the gradients averaged where ``distributed``; -> (loss, grads)."""
    from cvd_tpu_torch.train.train_step import all_reduce_gradients, loss_and_grads

    batch, noise, timesteps = pair_batch(pairs)
    loss, _ = loss_and_grads(state, batch, modules, noise=noise, timesteps=timesteps,
                             rand_slope_ff=False, remat=False, F_mat_size=8 * S)
    if distributed:
        all_reduce_gradients(state)
    return float(loss), {n: p.grad.clone() for n, p in
                         zip(state.trainable, state.trainable_params())}


def modules_and_state():
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.train.state import create_train_state

    m = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                               generator=torch.Generator().manual_seed(0), random_full=True)
    return m, create_train_state(m.unet, learning_rate=1e-3)


class Posed:
    def __init__(self, n=4):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(int(i))
        return {"pixel_values": rng.uniform(-1, 1, (2 * Fr, 64, 64, 3)).astype(np.float32),
                "text": f"posed {i}",
                "plucker_embedding": rng.standard_normal((2 * Fr, 64, 64, 6)).astype(np.float32),
                "F_mats": (rng.standard_normal((2 * Fr, 3, 3)) * 1e-3).astype(np.float32)}


class Unposed:
    def __init__(self, n=4):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        from cvd_tpu_torch.data.webvid import homography_pair

        rng = np.random.default_rng(50 + int(i))
        frames = rng.uniform(-1, 1, (Fr, 64, 64, 3)).astype(np.float32)
        return {**homography_pair(frames, random.Random(int(i))), "text": f"unposed {i}"}


def training_run(out_dir, multihost):
    from cvd_tpu_torch.cli import train

    cfg = dict(random_weights=True, device="cpu", sample_size=64, sample_n_frames=Fr,
               max_train_steps=4, checkpointing_steps=2, num_workers=1, logger_interval=1,
               global_seed=7, learning_rate=1e-3, output_dir=out_dir)
    return train.run(cfg, sources=[("posed", Posed(), 0.5), ("unposed", Unposed(), 0.5)],
                     multihost=multihost)


def _mesh_op(case, mesh):
    """One shard-op case on this rank's block of the global inputs ->
    the output all-gathered to the global tensor."""
    from cvd_tpu_torch.parallel import shard_ops as so
    from cvd_tpu_torch.parallel.mesh import constrain, gather

    kind, F = case["kind"], case.get("video_length")
    if kind == "temporal":
        q, k, v = (constrain(case[n], mesh, "rows", None, "frames") for n in "qkv")
        out = so.sharded_temporal_flash(q, k, v, case["mask"], case["heads"], mesh,
                                        so.frame_offset(mesh, q.shape[2]))
        return gather(out, mesh, "rows", None, "frames")

    def rows(x):
        return so.local_rows(x, mesh, F)

    def unrows(x):
        return gather(x.reshape((-1, F // mesh.shape["frames"]) + x.shape[1:]), mesh,
                      "rows", "frames").reshape((-1,) + x.shape[1:])

    if kind == "epi":
        out = so.sharded_epi_flash(*(rows(case[n]) for n in "qkv"), rows(case["lines"]),
                                   case["coords"], rows(case["band"]), rows(case["alpha"]),
                                   case["heads"], case["kv_index"], F, mesh)
    elif kind == "spatial":
        out = so.sharded_spatial_flash(*(rows(case[n]) for n in "qkv"), case["heads"], mesh)
    elif kind == "partner":
        out = so.sharded_partner_tokens(rows(case["x"]), case["kv_index"], F, mesh)
    else:
        out = so.extended_context(rows(case["x"]), mesh, F // mesh.shape["frames"])
    return unrows(out)


def _replaying(partners, noises):
    """An AdvancedPipeline that draws the given pairings and noises."""
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline

    class Replaying(AdvancedPipeline):
        def draw_pairing(self, generator, num_views):
            return partners.pop(0).clone()

        def draw_noise(self, generator, shape):
            return noises.pop(0).clone()

    return Replaying


def mesh_bundles(spec):
    """-> {"plain": the bundle of ``spec``'s state dicts, "extended": the same
    weights with spatial extended attention}, in float64 (the samplers'
    parity bar is below float32's summation-order noise after guided
    steps)."""
    import dataclasses

    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.models.unet import UNet3DConditionModel
    from cvd_tpu_torch.pipelines.common import PipelineModules

    m = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                               dtype=torch.float64)
    for name in ("unet", "vae", "clip", "pose_encoder"):
        getattr(m, name).load_state_dict(spec[name], strict=True)
    ext = UNet3DConditionModel(dataclasses.replace(SMOKE_UNET, spatial_extended_attention=True))
    ext.load_state_dict(spec["unet"], strict=True)
    return {"plain": m, "extended": dataclasses.replace(m, unet=ext.to(torch.float64).eval())}


def run_sampler(bundles, case, mesh=None):
    """One sampler case (``tests/test_torch_mesh.py``'s ``SAMPLERS``) ->
    its final latents."""
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    kw = dict(case["call"])
    m = bundles[case.get("bundle", "plain")]
    if case["pipeline"] == "simple":
        pipe = SimplePipeline(m, F_mat_size=case["F_mat_size"], rand_slope_ff=False, mesh=mesh)
    else:
        cls = _replaying(list(case["partners"]), list(case["noises"]))
        pipe = cls(m, F_mat_size=case["F_mat_size"], rand_slope_ff=False, fix_firstframe=True,
                   accumulate_batched=case["batched"], mesh=mesh)
    return pipe(**kw, decode=False)


def main(mode, out, inp=None):
    if mode.startswith("mesh"):
        import torch.distributed as dist

        from cvd_tpu_torch.parallel.mesh import create_mesh, init_distributed

        spec = torch.load(inp, weights_only=False)
        # one group for the whole process: the CLIs reuse it
        init_distributed("cpu", "--sharded", "tests/torch_dist_worker.py")
        if mode == "mesh_clis":
            try:
                results = mesh_clis(spec, os.path.dirname(out))
            finally:
                dist.destroy_process_group()
            torch.save(results, out)
            return
        bundles = mesh_bundles(spec["bundle"]) if mode == "mesh_samplers" else None
        results = {}
        if bundles is not None:
            # the unsharded references, shared out over the ranks
            rank, world = dist.get_rank(), dist.get_world_size()
            with torch.no_grad():
                for i, (name, case) in enumerate(spec["cases"].items()):
                    if i % world == rank:
                        results[("unsharded", name)] = run_sampler(bundles, case)
        try:
            for shape in spec["meshes"]:
                mesh = create_mesh(shape, ("rows", "frames"))
                for name, case in spec["cases"].items():
                    with torch.no_grad():
                        results[(tuple(shape), name)] = (
                            _mesh_op(case, mesh) if bundles is None
                            else run_sampler(bundles, case, mesh))
        finally:
            dist.destroy_process_group()
        torch.save(results, out)
    elif mode == "step":
        import torch.distributed as dist

        from cvd_tpu_torch.parallel.mesh import init_distributed

        rank, world, _ = init_distributed("cpu")
        try:
            modules, state = modules_and_state()
            loss, grads = pinned_step(modules, state, [rank], distributed=True)
            state.apply_gradients()
            weights = {n: p.detach().clone() for n, p in
                       zip(state.trainable, state.trainable_params())}
        finally:
            dist.destroy_process_group()
        torch.save({"loss": loss, "grads": grads, "weights": weights, "world": world}, out)
    elif mode == "run":
        res = training_run(os.path.join(os.path.dirname(out), "run"), multihost=True)
        state = res["state"]
        torch.save({"losses": res["losses"], "kinds": res["kinds"], "rank": res["rank"],
                    "world": res["world_size"],
                    "weights": {n: p.detach().clone() for n, p in
                                zip(state.trainable, state.trainable_params())}}, out)
    else:
        base = os.path.dirname(out)
        one = training_run(os.path.join(base, "one"), multihost=True)
        plain = training_run(os.path.join(base, "plain"), multihost=False)
        torch.save({"multihost": one["losses"], "plain": plain["losses"],
                    "world": one["world_size"]}, out)


def mesh_clis(spec, base):
    """Both sampling CLIs with ``--sharded --device cpu`` and ``spec``'s
    arguments, each under its own out root below ``base``."""
    from cvd_tpu_torch.cli import inference, inference_advanced

    out = {}
    for name, cli in (("inference", inference), ("inference_advanced", inference_advanced)):
        args = cli.build_parser().parse_args(
            spec[name] + ["--sharded", "--device", "cpu", "--out_root",
                          os.path.join(base, name)])
        out[name] = cli.main(args)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:])
