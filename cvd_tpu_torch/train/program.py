"""The training step as a replayed CUDA graph: the counterpart of cvd_tpu's
``make_jitted_train_step`` (``cvd_tpu/train/train_step.py:156-219``, the
single-device branch: ``jax.jit(step, donate_argnums=(0,))``).

cvd_tpu compiles its whole step (encode or the latents-cache posterior
draw, the noise, timesteps and slopes, ``add_noise``, the frozen CLIP and
pose encoder, the UNet forward and backward, the loss, clipping and the
AdamW update) into one XLA program per static key. Here ``TrainProgram``
captures the port's step body (``train_step.StepBody``) into one CUDA graph
per static key and replays it:

* **The key**: the batch kind (posed, or unposed with ``H_mats`` /
  ``warped_masks``), which of ``latents`` / ``latent_mean`` +
  ``latent_logvar`` / ``pixel_values`` it carries, every input's shape,
  stride and dtype, ``remat`` with the UNet's ``remat_unit`` and
  ``remat_policy``, whether the auxiliary head is present, and the step's
  settings (``epi_loss_weight``, ``F_mat_size``, ``rand_slope_ff``). A
  hybrid run alternates between two graphs.
* **Static inputs**: before each replay the batch is copied, from pinned
  host memory and without blocking, into the key's buffers.
* **One generator, one pool, launch counts**: ``utils/graphs.py``'s,
  shared with the samplers' program. The caller's generator ends where an
  eager step leaves it.
* **What outlives a replay lives outside the pool**: the weights, the
  ``.grad`` buffers, AdamW's state, the learning-rate tensor (all made
  with the ``TrainState``, ``train/state.py``) and the body's output
  tensors.
* **The first step of a key is the warm-up**: it runs eagerly on a side
  stream as the run's real step (building the kernels' libraries,
  compiling Triton K4, making the cuBLAS / cuDNN handles), then the step is
  captured, which runs nothing; the key's later steps are replays.
* **Caches see a replay's writes**: a replay runs no Python, so it moves
  no version counter; the program bumps those of every tensor the replay
  wrote (weights, gradients, AdamW's state), which K5's fold cache and a
  sampler's stamp key on. Before a capture it bumps the trainable weights'
  too, so that no fold of a trainable weight is a cache hit while
  capturing (a hit would freeze that fold into the graph). The eager first
  step makes whatever gradient or AdamW state is missing, so none is made
  inside a graph (in its pool, zeroed by every replay).
* **Tracing** (``utils/tracing.py``, where on): host spans ``train.stamp``,
  ``train.fill`` and ``train.replay``; the body's phases, timed by marks a
  capture keeps (``StepBody.phases``), read after each step's results.
* **The stamp**: where the weights, the gradients, AdamW's state and the
  learning rate live, and the frozen weights' version counters; a change
  (a tensor replaced, a ``load_state_dict`` into a frozen module) drops the
  graphs. ``checkpoint.restore`` loads in place and keeps them.

The same body runs eagerly on the CPU, with ``capture=False`` and when a
process group is initialized (``--multihost``: NCCL inside a graph comes
with the sharded program); each reason is logged once. Any other failure to
capture or replay raises.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import torch

from cvd_tpu_torch.pipelines.common import PipelineModules
from cvd_tpu_torch.train.state import TrainState
from cvd_tpu_torch.train.train_step import StepBody
from cvd_tpu_torch.utils import graphs, tracing
from cvd_tpu_torch.utils.graphs import GraphOwner, add_launches, bump_versions, launch_counts

LOG = logging.getLogger(__name__)


class _StepGraph:
    def __init__(self, graph, bufs: Dict[str, torch.Tensor], launches: Dict[str, int]):
        self.graph = graph          # .replay()
        self.bufs = bufs            # the batch's static buffers
        self.launches = launches    # kernel launches a replay makes, by wrapper


class TrainProgram(GraphOwner):
    """Runs training steps of ``state`` (module docstring): replayed CUDA
    graphs on a CUDA device, eagerly on the CPU, with ``capture=False`` or
    under a process group. ``step_kwargs``: ``StepBody``'s settings.

    ``stats`` (over the program's life): ``captured`` (whether the last step
    went through the graphs: a key's first step eagerly, then its capture;
    the later ones replayed), ``steps``, ``captures``, ``capture_s`` (the
    seconds of the captures alone; a key's first step costs an eager step
    besides) and ``launches`` (the kernel launches of the steps, replayed or
    eager, by wrapper)."""

    def __init__(self, state: TrainState, modules: PipelineModules, capture: bool = True,
                 **step_kwargs):
        super().__init__(state.model.conv_in.weight.device, capture, "training steps run", LOG)
        self.state, self.modules = state, modules
        self.body = StepBody(state, modules, **step_kwargs)
        self.graphs: Dict[tuple, _StepGraph] = {}
        self.stats = dict(captured=False, steps=0, captures=0, capture_s=0.0,
                          launches={n: 0 for n in launch_counts()})

    def eager_reason(self) -> Optional[str]:
        """Why the next step runs eagerly (None: it goes through the graphs);
        each reason is logged once."""
        if not self.capture:
            why = ("capture=False" if self.device.type == "cuda" or not self.requested
                   else f"a {self.device.type} device")
        elif torch.distributed.is_available() and torch.distributed.is_initialized():
            why = "a process group (--multihost)"
        else:
            return None
        self.say_eager(why)
        return why

    def key(self, batch: Dict[str, torch.Tensor]) -> tuple:
        b, cfg = self.body, self.state.model.config
        return (("posed" if "plucker" in batch else "unposed"),
                tuple((name, tuple(t.shape), t.stride(), t.dtype)
                      for name, t in sorted(batch.items())),
                b.remat, cfg.remat_unit, cfg.remat_policy, cfg.additional_channel > 0,
                b.epi_loss_weight, b.F_mat_size, b.rand_slope_ff)

    def step(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, float]:
        """One optimization step on ``batch`` (``train_step``'s keys, host or
        device tensors; pinned draws as ``noise`` / ``timesteps`` /
        ``slope``) -> {"loss", "epi_loss", "grad_norm"}. Where tracing is on
        (``utils/tracing.py``), the step's phases are read after its
        results, as device spans."""
        if self.eager_reason() is None:
            self._graph_step(batch, generator)
        else:
            self._eager(lambda: self.body(batch, generator))
            self.stats["captured"] = False
        self.state.advance()
        self.stats["steps"] += 1
        out = self.body.results()
        self.body.phases.record()
        tracing.next_unit()
        return out

    def _eager(self, fn) -> None:
        before = launch_counts()
        fn()
        for name, n in launch_counts().items():
            self.stats["launches"][name] += n - before[name]

    def _graph_step(self, batch, generator) -> None:
        self.check_generator(generator)
        if generator is None:
            # where an eager step would draw
            generator = torch.cuda.default_generators[self.device.index or 0]
        if any(p.grad is None for p in self.state.trainable_params()):
            self.state.zero_grad()      # gradients a caller freed, made outside any graph
        with tracing.span("train.stamp"):
            written = self.written()
            self.restamp(self._stamp_now(written))
        key = self.key(batch)
        graph = self.graphs.get(key)
        gen = self.take_generator(generator)
        if graph is None:
            self._first_step(key, batch, gen)
        else:
            self._fill(graph.bufs, batch)
            with tracing.span("train.replay"):
                graph.graph.replay()
            add_launches(graph.launches, self.stats["launches"])
            with tracing.span("train.stamp"):
                bump_versions(written)
        self.give_back(gen, generator)
        self.stats["captured"] = True

    def _stamp_now(self, written: List[torch.Tensor]) -> tuple:
        st, m = self.state, self.modules
        ids = {id(p) for p in st.trainable_params()}
        frozen = [t for mod in (st.model, m.vae, m.clip, m.pose_encoder) if mod is not None
                  for t in (*mod.parameters(), *mod.buffers()) if id(t) not in ids]
        return graphs.stamp(frozen), graphs.stamp(written, versions=False)

    def written(self) -> List[torch.Tensor]:
        """What a step writes in place: the trainable weights, their
        gradients, AdamW's state and the learning-rate tensors."""
        params = self.state.trainable_params()
        return [*params, *(p.grad for p in params), *self.state.optimizer_tensors()]

    def _fill(self, bufs, batch) -> None:
        with tracing.span("train.fill"):
            for name, t in batch.items():
                if t.device.type == "cpu" and self.device.type == "cuda":
                    t = t.pin_memory()
                bufs[name].copy_(t, non_blocking=True)

    def _first_step(self, key, batch, gen) -> None:
        """``key``'s first step, eagerly on a side stream, then its capture."""
        bufs = {name: torch.empty_like(t, device=self.device) for name, t in batch.items()}
        self._fill(bufs, batch)
        self._eager(lambda: self.warmup(lambda: self.body(bufs, gen)))
        t0 = time.perf_counter()
        # no fold of a trainable weight may be a cache hit while capturing
        bump_versions(self.state.trainable_params())
        graph, _, launches = self.capture_graph(lambda: self.body(bufs, gen), gen)
        self.graphs[key] = _StepGraph(graph, bufs, launches)
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
