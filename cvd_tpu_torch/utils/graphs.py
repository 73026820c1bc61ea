"""CUDA-graph machinery shared by the two compiled programs of the port: the
samplers' (``pipelines/program.py``) and the training step's
(``train/program.py``), the counterparts of cvd_tpu's jitted sampling and
training programs.

* **The stamp**: where a program's tensors live (and how often the ones
  that nothing should write were written): a graph reads the storage it
  was captured with, so a change drops the graphs.
* **The owned generator**: a graph replays its draws with the offsets of
  the generators registered with it, and moves each by what its capture
  drew; a generator registered after the capture would not move. So a
  program owns ONE CUDA generator, registered with every graph it
  captures, set from the caller's generator before a replay and handed
  back after it, which is where an eager run leaves the caller's.
* **The warm-up**: the body runs once eagerly on a side stream before a
  capture (it builds the kernels' libraries, compiles Triton K4, creates
  the cuBLAS / cuDNN handles, fills the caches a capture must not fill):
  a sampler's on a copy of its latents, a training step's as the key's
  first real step.
* **Capture with launch bookkeeping**: the op wrappers count their launches
  in Python and a replay runs no Python, so a capture's counts are taken
  back (nothing launched then) and kept by the graph, and every replay
  adds them again (``add_launches``); K5's counts by route with them. The
  warm-up's launches are real.
* **One memory pool** for all of a program's graphs: safe because nothing
  that must outlive a replay is allocated while capturing.
* **Eager runs and host generators**: why a program runs eagerly is
  logged once per reason; a capturing program refuses a host generator
  (its draws cannot be replayed).
"""
from __future__ import annotations

import contextlib
import logging
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from cvd_tpu_torch.ops import counted_wrappers

NO_TIMER = contextlib.nullcontext()


def launch_counts() -> Dict[str, int]:
    """The wrappers' launch counts by name, and by ``<name>/<route>`` those of
    a wrapper that counts its launches by route too (K5's ``routes``)."""
    counts = {}
    for name, fn in counted_wrappers().items():
        counts[name] = fn.launches
        for route, n in getattr(fn, "routes", {}).items():
            counts[f"{name}/{route}"] = n
    return counts


def _set_count(name: str, n: int) -> None:
    wrapper, _, route = name.partition("/")
    fn = counted_wrappers()[wrapper]
    if route:
        fn.routes[route] = n
    else:
        fn.launches = n


def add_launches(launches: Dict[str, int], into: Optional[Dict[str, int]] = None) -> None:
    """A replay's launches, added to the wrappers' counts (and to ``into``)."""
    counts = launch_counts()
    for name, n in launches.items():
        _set_count(name, counts[name] + n)
        if into is not None:
            into[name] += n


def stamp(tensors: Iterable[torch.Tensor], versions: bool = True) -> tuple:
    """Where every tensor lives and (``versions``) how often it was written
    in place: a graph reads the storage it was captured with, and what it
    derived from the tensors at its capture (K5's folded weights)."""
    if not versions:
        return tuple(t.data_ptr() for t in tensors)
    return tuple((t.data_ptr(), 0 if t.is_inference() else t._version) for t in tensors)


def bump_versions(tensors: Iterable[torch.Tensor]) -> None:
    """Mark tensors as written in place: a replay writes without moving the
    version counters that caches key on (K5's fold cache, a stamp)."""
    torch.autograd.graph.increment_version(list(tensors))


class GraphOwner:
    """The generator, the memory pool, the capture, the stamp and the log of
    one program. ``capture``: whether to capture at all (only on a CUDA
    device); ``what``: what the program runs, as its messages name it;
    ``log``: its logger."""

    def __init__(self, device, capture: bool, what: str, log: logging.Logger):
        self.device = torch.device(device)
        self.requested = bool(capture)
        self.capture = self.requested and self.device.type == "cuda"
        self.what, self.log = what, log
        self.generator: Optional[torch.Generator] = None
        self.graphs: dict = {}
        self._pool = None
        self._stamp = None
        self._told = set()

    def say_eager(self, why: str) -> None:
        """Log, once per reason, why the program runs eagerly."""
        if why not in self._told:
            self._told.add(why)
            self.log.info("%s eagerly, not as CUDA graphs: %s", self.what, why)

    def check_generator(self, generator: Optional[torch.Generator]) -> None:
        """A captured body draws on the card: a host generator's draws
        cannot be replayed."""
        if self.capture and generator is not None and generator.device.type != "cuda":
            raise ValueError(f"{self.what} as CUDA graphs, which draw from a CUDA generator; "
                             f"got a generator on {generator.device}: pass a CUDA generator, "
                             "or capture=False")

    def restamp(self, stamp: tuple) -> None:
        """Drop the graphs (and their pool) when ``stamp`` is not the last one."""
        if stamp != self._stamp:
            self.graphs.clear()
            self._pool = None
            self._stamp = stamp

    def own_generator(self) -> torch.Generator:
        if self.generator is None:
            self.generator = torch.Generator(device=self.device)
        return self.generator

    def take_generator(self, generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
        """The owned generator at ``generator``'s state (None without one)."""
        if generator is None:
            return None
        gen = self.own_generator()
        gen.set_state(generator.get_state())
        return gen

    @staticmethod
    def give_back(gen: Optional[torch.Generator], generator: Optional[torch.Generator]) -> None:
        if gen is not None:
            generator.set_state(gen.get_state())

    def warmup(self, fn: Callable[[], object]) -> Tuple[object, Dict[str, int]]:
        """fn() eagerly on a side stream -> (its result, the launches it made)."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        before = launch_counts()
        with torch.cuda.stream(side):
            out = fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        return out, {n: c - before[n] for n, c in launch_counts().items()}

    def capture_graph(self, fn: Callable[[], object], gen: Optional[torch.Generator]
                      ) -> Tuple[torch.cuda.CUDAGraph, object, Dict[str, int]]:
        """fn() captured into a graph of the program's pool, ``gen``
        registered with it -> (graph, fn's result, the launches a replay
        makes). The wrappers' counts are left as they were before."""
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        before = launch_counts()
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            out = fn()
        after = launch_counts()
        for name, n in before.items():     # nothing launched while capturing
            _set_count(name, n)
        if self._pool is None:
            self._pool = graph.pool()
        return graph, out, {n: after[n] - before[n] for n in before}
