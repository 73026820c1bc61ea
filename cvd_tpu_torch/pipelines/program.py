"""A sampler's denoising as replayed CUDA graphs: the counterpart of the
JAX package's compiled sampling programs (``self._jitted`` in
``cvd_tpu/pipelines/simple.py:76-105`` and ``advanced.py:120-145``, the
chunk programs of ``_call_chunked`` :203-263).

cvd_tpu runs a request's whole sampling as one XLA computation and caches
it by a static key, so the second request reuses the first one's
executable. Here a sampler prepares a request eagerly (text, pose features,
conditioning constants, the initial latents) into a dict of tensors, and
its timestep body runs the UNet calls, the guidance, the DDIM update and
the re-noising of one or more timesteps (a chunk), reading only that dict
and the chunk's timesteps, and writing the latents back in place.

* On a CUDA device a ``SamplingProgram`` captures the body once per static
  key into a CUDA graph and replays it for every chunk of every request.
  The graph reads static buffers: a new request copies its tensors into
  them, the latents are carried from replay to replay in place, and the
  chunk's timesteps are copied into the graph's own buffer before it
  replays. A capture or a replay that fails raises.
* On the CPU, and with ``capture=False``, the same body runs eagerly.

Before each capture the body runs once eagerly on a side stream, on a copy
of the latents (the warm-up: it builds the kernels' libraries, compiles
Triton K4, creates the cuBLAS / cuDNN handles and fills K5's fold cache),
and the generator is put back where it was, so that a captured request
draws exactly the numbers the eager one draws.

The owned generator, the warm-up, the capture with its launch
bookkeeping, the shared pool and the stamp are ``utils/graphs.py``'s, which
the training step's program (``train/program.py``) shares.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from cvd_tpu_torch.utils import graphs
from cvd_tpu_torch.utils.graphs import NO_TIMER, GraphOwner, add_launches, launch_counts

LOG = logging.getLogger(__name__)

# (first timestep's index, stop index, repeats of each timestep): a chunk
Chunk = Tuple[int, int, Tuple[int, ...]]
# body(bufs, timesteps [k], start, repeats, generator, timer) -> UNet calls made
Body = Callable[..., int]

def chunks(repeats: Sequence[int], step_chunk: Optional[int] = None) -> List[Chunk]:
    """The timesteps in chunks of ``step_chunk`` (1 without), each with the
    repeats of its timesteps: a chunk whose repeats differ from the others'
    (the last timestep, taken once with multistep; a ragged last chunk)
    is another graph."""
    k = 1 if step_chunk is None else step_chunk
    if k < 1:
        raise ValueError(f"step_chunk {step_chunk}: a chunk holds at least one timestep")
    n = len(repeats)
    return [(s, min(s + k, n), tuple(repeats[s:s + k])) for s in range(0, n, k)]


def _stamp(modules: Sequence[torch.nn.Module]) -> tuple:
    """Where every weight of ``modules`` lives and how often it was written
    in place (``utils.graphs.stamp``)."""
    return graphs.stamp(t for m in modules for t in (*m.parameters(), *m.buffers()))


class _Graph:
    def __init__(self, graph, timesteps: torch.Tensor, calls: int, launches: Dict[str, int]):
        self.graph = graph
        self.timesteps = timesteps     # [k] int64, filled before each replay
        self.calls = calls             # UNet calls a replay makes
        self.launches = launches       # kernel launches a replay makes, by wrapper


class SamplingProgram(GraphOwner):
    """Runs a sampler's timestep body over a request's chunks: replayed
    CUDA graphs on a CUDA device, eagerly on the CPU or with ``capture=False``.
    ``watch``: the modules the body runs; a write into their weights drops
    the graphs (they are captured again at the next request).

    ``stats`` describes the last ``run``: ``captured``, ``unet_calls`` (the
    body's), ``warmup_calls`` (the warm-ups' UNet calls), ``captures`` and
    ``capture_s`` (the seconds of this run's warm-ups and captures),
    ``launches``: the kernel launches of the denoising loop by wrapper
    (replays, or the eager bodies), and ``warmup_launches``: the warm-ups'
    (counted by the wrappers too)."""

    def __init__(self, device, capture: bool = True, watch: Sequence[torch.nn.Module] = ()):
        super().__init__(device, capture, "sampling runs", LOG)
        self.watch = tuple(watch)
        self.graphs: Dict[tuple, _Graph] = {}
        self.buffers: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self.stats: dict = {}

    def eager_for(self, pab_config, mesh) -> bool:
        """Whether a request runs eagerly on a capturing program: PAB and a
        mesh are not captured yet. Decided from the request's arguments,
        before anything is built; each reason is logged once."""
        reasons = [why for why, on in (("PAB (pab_config)", pab_config is not None),
                                       ("a mesh (--sharded)", mesh is not None)) if on]
        for why in reasons:
            if self.capture:
                self.say_eager(why)
        return bool(reasons)

    def run(self, key: tuple, inputs: Dict[str, torch.Tensor], timesteps: torch.Tensor,
            plan: Sequence[Chunk], body: Body, generator: Optional[torch.Generator],
            timer, eager: bool = False) -> torch.Tensor:
        """Every chunk of ``plan`` through ``body``; ``inputs["latents"]`` is
        the carry. ``timesteps``: the request's [T] int64 timesteps on the
        device. ``key``: what the body's graph depends on besides the
        inputs' shapes and types. Returns the final latents (a tensor of
        the caller's own)."""
        self.stats = dict(captured=self.capture and not eager, unet_calls=0, warmup_calls=0,
                          captures=0, capture_s=0.0, launches={n: 0 for n in launch_counts()},
                          warmup_launches={n: 0 for n in launch_counts()})
        if not self.stats["captured"]:
            for start, stop, reps in plan:
                before = launch_counts()
                self.stats["unet_calls"] += body(inputs, timesteps[start:stop], start, reps,
                                                 generator, timer)
                for name, n in launch_counts().items():
                    self.stats["launches"][name] += n - before[name]
            return inputs["latents"]
        self.check_generator(generator)
        self.restamp(_stamp(self.watch))
        key = key + tuple((name, tuple(t.shape), t.stride(), t.dtype)
                          for name, t in sorted(inputs.items()))
        bufs = self._static(key, inputs)
        gen = self.take_generator(generator)
        for start, stop, reps in plan:
            graph = self.graphs.get(key + (reps,))
            if graph is None:
                graph = self._capture(key + (reps,), bufs, timesteps[start:stop], start, reps,
                                      body, gen)
            graph.timesteps.copy_(timesteps[start:stop])
            with timer.span(graph.calls):
                graph.graph.replay()
            add_launches(graph.launches, self.stats["launches"])
            self.stats["unet_calls"] += graph.calls
        self.give_back(gen, generator)
        return bufs["latents"].clone()

    def _static(self, key: tuple, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The static buffers of ``key``, holding this request's inputs."""
        bufs = self.buffers.get(key)
        if bufs is None:
            bufs = self.buffers[key] = {name: t.clone() for name, t in inputs.items()}
        else:
            for name, t in inputs.items():
                bufs[name].copy_(t)
        return bufs

    def _capture(self, key, bufs, timesteps, start, reps, body, gen) -> _Graph:
        t0 = time.perf_counter()
        ts = timesteps.clone()
        # the warm-up: on a copy of the latents; the generator put back
        scratch = dict(bufs, latents=bufs["latents"].clone())
        state = None if gen is None else gen.get_state()
        calls, launches = self.warmup(lambda: body(scratch, ts, start, reps, gen, NO_TIMER))
        self.stats["warmup_calls"] += calls
        for name, n in launches.items():
            self.stats["warmup_launches"][name] += n
        if gen is not None:
            gen.set_state(state)
        del scratch

        graph, calls, launches = self.capture_graph(
            lambda: body(bufs, ts, start, reps, gen, NO_TIMER), gen)
        out = self.graphs[key] = _Graph(graph, ts, calls, launches)
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
        return out
