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

Random draws. A graph replays its kernels with the random offsets of the
generators registered with it, read at every replay, so each replay draws
new numbers. A graph records, at its capture, how far a replay moves each
registered generator; a generator registered after the capture would not
be moved. So the program owns ONE CUDA generator, registered with every
graph it captures: a request sets it to the caller's generator's state
before its first replay, and the caller's generator takes the program's
state after the last one, which is where an eager request leaves it.

Launch counters. The op wrappers count their launches in Python, and a
replay runs no Python: each graph keeps the counts its capture added (and
takes them back: nothing launched then) and adds them again at every
replay. The warm-up's launches are real and count.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from cvd_tpu_torch.ops import counted_wrappers

LOG = logging.getLogger(__name__)

# (first timestep's index, stop index, repeats of each timestep): a chunk
Chunk = Tuple[int, int, Tuple[int, ...]]
# body(bufs, timesteps [k], start, repeats, generator, timer) -> UNet calls made
Body = Callable[..., int]

NO_TIMER = contextlib.nullcontext()


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


def _counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in counted_wrappers().items()}


def _stamp(modules: Sequence[torch.nn.Module]) -> tuple:
    """Where every weight lives and how often it was written in place: a
    graph reads the storage it was captured with, and what it derived from
    the weights at its capture (K5's folded weights)."""
    return tuple((t.data_ptr(), 0 if t.is_inference() else t._version)
                 for m in modules for t in (*m.parameters(), *m.buffers()))


class _Graph:
    def __init__(self, graph, timesteps: torch.Tensor, calls: int, launches: Dict[str, int]):
        self.graph = graph
        self.timesteps = timesteps     # [k] int64, filled before each replay
        self.calls = calls             # UNet calls a replay makes
        self.launches = launches       # kernel launches a replay makes, by wrapper


class SamplingProgram:
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
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self.watch = tuple(watch)
        self.graphs: Dict[tuple, _Graph] = {}
        self.buffers: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self.generator: Optional[torch.Generator] = None
        self.stats: dict = {}
        self._pool = None
        self._stamp = None
        self._told = set()

    def eager_for(self, pab_config, mesh) -> bool:
        """Whether a request runs eagerly on a capturing program: PAB and a
        mesh are not captured yet. Decided from the request's arguments,
        before anything is built; each reason is logged once."""
        reasons = [why for why, on in (("PAB (pab_config)", pab_config is not None),
                                       ("a mesh (--sharded)", mesh is not None)) if on]
        for why in reasons:
            if self.capture and why not in self._told:
                self._told.add(why)
                LOG.info("sampling runs eagerly, not as CUDA graphs: %s", why)
        return bool(reasons)

    def check_generator(self, generator: Optional[torch.Generator]) -> None:
        """A captured body draws on the card: a host generator's draws
        cannot be replayed."""
        if self.capture and generator is not None and generator.device.type != "cuda":
            raise ValueError(f"a sampler that captures CUDA graphs draws from a CUDA generator, "
                             f"got one on {generator.device}: pass a CUDA generator, or "
                             "construct the sampler with capture=False")

    def run(self, key: tuple, inputs: Dict[str, torch.Tensor], timesteps: torch.Tensor,
            plan: Sequence[Chunk], body: Body, generator: Optional[torch.Generator],
            timer, eager: bool = False) -> torch.Tensor:
        """Every chunk of ``plan`` through ``body``; ``inputs["latents"]`` is
        the carry. ``timesteps``: the request's [T] int64 timesteps on the
        device. ``key``: what the body's graph depends on besides the
        inputs' shapes and types. Returns the final latents (a tensor of
        the caller's own)."""
        self.stats = dict(captured=self.capture and not eager, unet_calls=0, warmup_calls=0,
                          captures=0, capture_s=0.0, launches={n: 0 for n in _counts()},
                          warmup_launches={n: 0 for n in _counts()})
        if not self.stats["captured"]:
            for start, stop, reps in plan:
                before = _counts()
                self.stats["unet_calls"] += body(inputs, timesteps[start:stop], start, reps,
                                                 generator, timer)
                for name, n in _counts().items():
                    self.stats["launches"][name] += n - before[name]
            return inputs["latents"]
        self.check_generator(generator)
        stamp = _stamp(self.watch)
        if stamp != self._stamp:
            self.graphs.clear()
            self._pool = None
            self._stamp = stamp
        key = key + tuple((name, tuple(t.shape), t.stride(), t.dtype)
                          for name, t in sorted(inputs.items()))
        bufs = self._static(key, inputs)
        gen = None
        if generator is not None:
            gen = self._own_generator()
            gen.set_state(generator.get_state())
        for start, stop, reps in plan:
            graph = self.graphs.get(key + (reps,))
            if graph is None:
                graph = self._capture(key + (reps,), bufs, timesteps[start:stop], start, reps,
                                      body, gen)
            graph.timesteps.copy_(timesteps[start:stop])
            with timer.span(graph.calls):
                graph.graph.replay()
            wrappers = counted_wrappers()
            for name, n in graph.launches.items():
                wrappers[name].launches += n
                self.stats["launches"][name] += n
            self.stats["unet_calls"] += graph.calls
        if gen is not None:
            generator.set_state(gen.get_state())
        return bufs["latents"].clone()

    def _own_generator(self) -> torch.Generator:
        if self.generator is None:
            self.generator = torch.Generator(device=self.device)
        return self.generator

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
        # the warm-up: eager, on a side stream, on a copy of the latents; the
        # generator put back where it was
        scratch = dict(bufs, latents=bufs["latents"].clone())
        state = None if gen is None else gen.get_state()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        before = _counts()
        with torch.cuda.stream(side):
            self.stats["warmup_calls"] += body(scratch, ts, start, reps, gen, NO_TIMER)
        torch.cuda.current_stream(self.device).wait_stream(side)
        for name, n in _counts().items():
            self.stats["warmup_launches"][name] += n - before[name]
        if gen is not None:
            gen.set_state(state)
        del scratch

        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        before = _counts()
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            calls = body(bufs, ts, start, reps, gen, NO_TIMER)
        after = _counts()
        wrappers = counted_wrappers()
        for name, n in before.items():     # nothing launched while capturing
            wrappers[name].launches = n
        if self._pool is None:
            self._pool = graph.pool()
        out = self.graphs[key] = _Graph(graph, ts, calls,
                                        {n: after[n] - before[n] for n in before})
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
        return out
