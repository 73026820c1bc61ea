"""One process of the port's data-parallel training on the CPU (gloo), for
tests/test_torch_multihost.py. Run as ``torchrun`` would start it, with
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set:

    python tests/torch_dist_worker.py step|run|world_of_one OUT.pt

``step``: one step of the smoke-width UNet on this rank's folded pair with
the noise and timesteps pinned (``pinned_step``), the gradients averaged
over the group, then AdamW: saves the averaged gradients and the new
trainable weights. ``run``: ``cli.train.run`` with ``multihost`` on
in-memory posed and unposed sources: saves the losses, kinds and trainable
weights. ``world_of_one``: the same run as a world of one, and again
without ``multihost``: saves both losses.
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


def main(mode, out):
    if mode == "step":
        import torch.distributed as dist

        from cvd_tpu_torch.cli.train import init_distributed

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


if __name__ == "__main__":
    main(*sys.argv[1:])
