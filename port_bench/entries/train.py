"""Entry kind ``train``: epi fine-tuning steps through the program's
``TrainProgram`` (one captured graph a step), fed by the program's
RealEstate10K reader and loader as its training CLI feeds them (thread
workers, one folded pair a step, the null-text draw, the batch fold), with
no validation, checkpoint or sanity dump. A mix with ``held: n`` draws the
loader's first n pairs in set-up and cycles them: a loader that keeps up.

Set-up: the synthetic RealEstate10K root (made once per checkout), the
seeded weights, the train state, the loader, and the cell's first steps
(the first one eager and then captured): the steps the check follows. The
window runs steps until ``--seconds`` have passed; ``step_s`` is its time
over its steps, each with its draw from the loader and the sync the CLI
makes after a step. Then the check: the float32 reference takes the same
first steps from the same weights, batches and draws.
"""
from __future__ import annotations

import itertools
import random
import statistics
import time

import numpy as np

from port_bench.lib import names, port, runtime
from port_bench.lib.context import Context, Record, check, mean
from port_bench.lib.trace import Tracer, span
from port_bench.traffic import generate


def fold_batch(batch: dict, texts, n_frames: int) -> dict:
    """The training CLI's fold of a loader batch: each [b, 2F, ...] array to
    the pair's [2b, F, ...] (video-major), the token ids once per video."""
    import torch

    def fold(x):
        return torch.from_numpy(np.concatenate([x[:, :n_frames], x[:, n_frames:]], axis=0))

    moments = ("latent_mean", "latent_logvar") if "latent_mean" in batch else ("pixel_values",)
    geometry = (("plucker_embedding", "F_mats") if "plucker_embedding" in batch
                else ("H_mats", "warped_masks"))
    return {"text_ids": torch.from_numpy(np.concatenate([generate.tokenize(texts)] * 2, axis=0)),
            **{("plucker" if k == "plucker_embedding" else k): fold(batch[k])
               for k in moments + geometry}}


def _endless(loader):
    while True:
        yield from loader


class Trainer:
    """The program's side: the train state, its program, the loader."""

    def __init__(self, ctx: Context):
        import torch
        from cvd_tpu_torch.data.loader import DataLoader
        from cvd_tpu_torch.data.realestate10k import RealEstate10KPoseFolded
        from cvd_tpu_torch.train.program import TrainProgram
        from cvd_tpu_torch.train.state import create_train_state

        self.ctx = ctx
        cfg, mix, dev = ctx.config, ctx.mix, ctx.device
        self.root = generate.re10k_root(mix)
        t = time.perf_counter()
        modules = port.build_modules(cfg, ctx.seed, dev, vae_encoder=True,
                                     unet_dtype=torch.float32)
        opt = cfg["optimizer"]
        state = create_train_state(
            modules.unet, learning_rate=opt["learning_rate"], adam_beta1=opt["adam_beta1"],
            adam_beta2=opt["adam_beta2"], adam_epsilon=opt["adam_epsilon"],
            adam_weight_decay=opt["adam_weight_decay"], max_grad_norm=opt["max_grad_norm"],
            scheduler=opt["lr_scheduler"], warmup_steps=opt["lr_warmup_steps"],
            frozen_dtype=port.dtype(cfg["dtype"]))
        runtime.sync(dev)
        self.build_s = time.perf_counter() - t
        self.program = TrainProgram(state, modules, capture=True,
                                    F_mat_size=cfg["epi_F_mat_size"], remat=opt["remat"],
                                    epi_loss_weight=opt["epi_loss_weight"])
        self.data_seed = data_seed(ctx)
        dataset = RealEstate10KPoseFolded(root_path=self.root,
                                          sample_stride=mix["sample_stride"],
                                          sample_n_frames=mix["frames"],
                                          sample_size=mix["size"], seed=self.data_seed)
        self.loader = DataLoader(dataset, batch_size=mix["batch_size"],
                                 num_workers=mix["num_workers"], worker_type=mix["worker_type"],
                                 seed=self.data_seed)
        self.source = _endless(self.loader)
        self.it = self.source
        if mix.get("held"):   # the loader's first pairs, drawn now and cycled
            if mix["held"] < ctx.cell["run"]["checked_steps"]:
                raise ValueError("held pairs: at least one for each checked step")
            held = [next(self.source) for _ in range(mix["held"])]
            self.source.close()
            self.it = itertools.cycle(held)
        self.pyrng = random.Random(self.data_seed)
        self.generator = torch.Generator(device=dev).manual_seed(ctx.stream("steps"))

    def step(self):
        """One step -> (its losses, seconds waiting for the loader, texts)."""
        t0 = time.perf_counter()
        with span("loader"):
            batch = next(self.it)
        waited = time.perf_counter() - t0
        texts = ["" if self.pyrng.random() < self.ctx.mix["null_text_ratio"] else t
                 for t in batch["text"]]
        with span("fold"):
            folded = fold_batch(batch, texts, self.ctx.mix["frames"])
        with span("step"):
            m = self.program.step(folded, self.generator)
            runtime.sync(self.ctx.device)
        return m, waited, texts

    def trainable(self) -> dict:
        st = self.program.state
        return dict(zip(st.trainable, st.trainable_params()))

    def first_gradients(self) -> dict:
        """{key: norm} of the first step's clipped gradient, as AdamW got it:
        its first moment after one step over (1 - beta1)."""
        st = self.program.state
        b1 = self.ctx.config["optimizer"]["adam_beta1"]
        return {k: float(st.optimizer.state[p]["exp_avg"].norm()) / (1 - b1)
                for k, p in self.trainable().items()}

    def close(self) -> None:
        self.source.close()


def data_seed(ctx: Context) -> int:
    """The seed of the loader's epochs, the reader's frame draws and the
    null-text draws (one, as the training CLI has one)."""
    return ctx.stream("data") % 2 ** 31


def setup_steps(trainer: Trainer, n: int) -> dict:
    """The first ``n`` steps, with what the check reads of them: losses,
    the first gradient's norms, the weights after the last (on the host)."""
    import torch

    out = {"loss": [], "texts": []}
    for i in range(n):
        m, _, texts = trainer.step()
        out["loss"].append(m["loss"])
        out["texts"].append(texts)
        if i == 0:
            out["grad"] = trainer.first_gradients()
    # a copy on every device: the window goes on writing the parameters
    out["weights"] = {k: p.detach().to("cpu", torch.float32, copy=True)
                      for k, p in trainer.trainable().items()}
    return out


def reference_steps(ctx: Context, first: dict, precision: str = "f32",
                    half_batch: bool = False) -> dict:
    """The reference's first steps from the same weights, batches and draws:
    {"loss", "grad": norms, "change": norms of each weight's change after the
    steps, "program_change": the same of the program's weights}."""
    import torch

    from port_bench.reference import data, ops

    mix, dev, cfg = ctx.mix, ctx.device, ctx.config
    n = len(first["loss"])
    root = generate.re10k_root(mix)
    batches = []
    for draw, texts in zip(data.first_draws(root, data_seed(ctx), mix["frames"],
                                            mix["sample_stride"], n), first["texts"]):
        pair = data.folded_pair(draw, mix["frames"], mix["size"])
        b = {k: torch.from_numpy(pair[k]).to(dev) for k in ("pixel_values", "plucker", "F_mats")}
        b["text_ids"] = torch.from_numpy(np.concatenate([generate.tokenize(texts)] * 2)).to(dev)
        if half_batch:
            b = {k: v[:1] for k, v in b.items()}
        batches.append(b)
    arch = names.architecture(cfg["architecture"])
    mods = port.reference_modules(cfg, ctx.seed, dev, vae_encoder=True)
    try:
        gen = torch.Generator(device=dev).manual_seed(ctx.stream("steps"))
        with runtime.exact_float32(), ops.precision(precision):
            out = arch.reference_steps(mods, cfg, batches, gen, port.dtype(cfg["dtype"]))
        start, end = out["start"], out["end"]
        return {"loss": out["loss"],
                "grad": {k: float(g.norm()) for k, g in out["grad"].items()},
                "change": {k: float((end[k] - start[k]).norm()) for k in start},
                "program_change": {k: float((w.to(dev) - start[k]).norm())
                                   for k, w in first["weights"].items()}}
    finally:
        del mods
        runtime.free(dev)


def numbers(program: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap, and by the
    worst leaf the gap of the first gradient's norm and of the change's norm
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger; leaves whose reference gradient is under a
    thousandth of the median leaf's are left out."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(program["loss"], ref["loss"]))
    med_g = statistics.median(ref["grad"].values())
    keep = [k for k, g in ref["grad"].items() if g >= 1e-3 * med_g]

    def gaps(p: dict, r: dict) -> list:
        med = statistics.median(r[k] for k in keep)
        return [abs(p[k] - r[k]) / max(r[k], med) for k in keep]

    return {"loss_rel": loss, "grad_gap": max(gaps(program["grad"], ref["grad"])),
            "change_gap": max(gaps(ref["program_change"], ref["change"]))}


def run(ctx: Context) -> Record:
    rec = Record()
    dev = ctx.device
    trainer = Trainer(ctx)
    rec.readings["build_s"] = trainer.build_s
    first = setup_steps(trainer, ctx.cell["run"]["checked_steps"])
    rec.readings["capture_s"] = trainer.program.stats["capture_s"]

    run_cfg = ctx.cell["run"]
    skip, traced = run_cfg["trace_skip"], run_cfg["traced_steps"]
    tracer = Tracer(ctx.trace, ctx.work_dir, dev)
    waits = []
    t_win = time.perf_counter()
    rec.e2e["setup_s"] = t_win - ctx.t_start
    i = 0
    while True:
        if i == skip:
            tracer.start()
        rec.attempted += 1
        try:
            _, waited, _ = trainer.step()
            waits.append(waited)
        except Exception:  # noqa: BLE001 - a failed step is counted and reported
            import traceback

            traceback.print_exc()
            rec.failed += 1
        i += 1
        if i == skip + traced:
            tracer.stop()
            rec.traced_units = traced
        if time.perf_counter() - t_win >= ctx.seconds:
            break
    t_end = time.perf_counter()
    tracer.stop()
    rec.traced_units = rec.traced_units or max(0, i - skip)
    rec.trace = tracer.summary
    rec.e2e["step_s"] = (t_end - t_win) / i
    rec.peak_bytes = runtime.peak_bytes(dev)
    rec.readings["data_wait_ms"] = 1e3 * mean(waits)
    trainer.close()
    del trainer
    runtime.free(dev)
    found = numbers(first, reference_steps(ctx, first))
    for name, limit in ctx.cell["limits"].items():
        rec.checks[name] = check(found[name], limit)
    return rec


def calibrate(ctx: Context, control: bool = True) -> dict:
    """The check's readings on the run's seed, with no window: the program's
    first steps against the reference's; with ``control`` also the float8
    reference's and the half-batch fault's (planted in the reference)."""
    trainer = Trainer(ctx)
    first = setup_steps(trainer, ctx.cell["run"]["checked_steps"])
    trainer.close()
    del trainer
    runtime.free(ctx.device)
    ref = reference_steps(ctx, first)
    out = {"seed": ctx.seed, **numbers(first, ref)}
    if control:
        for name, kw in (("control", {"precision": "fp8"}), ("half_batch", {"half_batch": True})):
            other = reference_steps(ctx, first, **kw)
            as_program = {"loss": other["loss"], "grad": other["grad"],
                          "weights": None}
            r2 = dict(ref, program_change=other["change"])
            out.update({f"{name}.{k}": v for k, v in numbers(as_program, r2).items()})
    return out
