"""Program tracing (``cvd_tpu_torch/utils/tracing.py``) on the CPU, and the
data loader's counters:

* off, a span is one shared null context that enters no profiler range and
  records nothing;
* on (``enable(True)``, or a profiler recording), spans nest with their
  parents and units, open ``cvd/<name>`` ranges, and ``drain`` clears them;
* the 2-view request path's spans (pose conditioning, ray condition,
  prepare with the text and pose encoders, denoise, decode), one unit a
  request;
* a UNet call given an ``IntervalTimer`` marks its spatial, motion and
  epi sublayers by kind; given none, it marks nothing;
* ``TrainProgram``'s four phases, once a step and in order, within the
  step; its fill, stamp and replay spans where it replays (a replay played
  on the CPU as ``tests/test_torch_train_program.py`` plays it);
* ``DataLoader.stats``: draws, the batches ready, waits and the workers'
  busy time.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("train.encode", "train.forward", "train.backward", "train.optimizer")


@pytest.fixture
def tracing():
    """The module, drained before and after, on only inside the test."""
    from cvd_tpu_torch.utils import tracing as t

    t.enable(False)
    t.drain()
    yield t
    t.enable(False)
    t.drain()


def _named(got, name, kind="spans"):
    return [s for s in got[kind] if s["name"] == name]


def test_off_is_one_null_context_that_enters_nothing(tracing, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not tracing.active()
    a, b = tracing.span("x"), tracing.device_span("y", "cpu")
    assert a is b is tracing.span("z")
    with a:
        with b:
            pass
    tracing.next_unit()
    assert tracing.drain() == {"spans": [], "device": [], "counters": {"units": 0}}


def test_on_spans_nest_with_parents_and_units(tracing):
    tracing.enable(True)
    assert tracing.active()
    with tracing.span("outer"):
        with tracing.span("inner"):
            time.sleep(0.002)

        def in_thread():
            with tracing.span("thread"):
                pass

        other = threading.Thread(target=in_thread)
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    tracing.next_unit()
    with tracing.device_span("dev", "cpu"):
        with tracing.span("child"):
            pass
        tracing.record("measured", 1.5)
    tracing.next_unit()
    got = tracing.drain()
    spans = {s["name"]: s for s in got["spans"]}
    assert [s["name"] for s in got["spans"]] == ["inner", "thread", "outer", "child", "dev"]
    assert spans["inner"]["parent"] == "outer" and spans["outer"]["parent"] is None
    assert spans["thread"]["parent"] is None     # another thread's stack
    assert spans["child"]["parent"] == "dev"
    assert spans["outer"]["unit"] + 1 == spans["dev"]["unit"] == spans["child"]["unit"]
    assert (spans["outer"]["start"] <= spans["inner"]["start"] < spans["inner"]["end"]
            <= spans["outer"]["end"])
    assert spans["inner"]["end"] - spans["inner"]["start"] >= 0.002
    dev = {d["name"]: d for d in got["device"]}
    assert set(dev) == {"dev", "measured"}
    assert dev["measured"] == {"name": "measured", "parent": "dev",
                               "unit": spans["dev"]["unit"], "ms": 1.5}
    host_ms = 1e3 * (spans["dev"]["end"] - spans["dev"]["start"])
    assert dev["dev"]["ms"] == host_ms > 0        # on the CPU, the host span's own time
    assert got["counters"] == {"units": 2}
    assert tracing.drain() == {"spans": [], "device": [], "counters": {"units": 0}}


def test_a_recording_profiler_turns_tracing_on(tracing):
    from torch.profiler import ProfilerActivity, profile

    assert not tracing.active()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.active()
        with tracing.span("profiled"):
            torch.ones(8) @ torch.ones(8)
        tracing.next_unit()
    assert not tracing.active()
    names = {e.name for e in prof.events()}
    assert "cvd/profiled" in names
    got = tracing.drain()
    assert [s["name"] for s in got["spans"]] == ["profiled"]
    assert got["counters"] == {"units": 1}


def _tiny_modules(seed=0, vae_encoder=False):
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules

    return PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                                  generator=torch.Generator().manual_seed(seed),
                                  random_full=True, vae_encoder=vae_encoder)


def test_request_path_spans(tracing):
    """Two 2-view requests as the benchmark's make them: pose files through
    ``ValRealEstate10KPoseFolded``, then ``SimplePipeline`` (2 steps)."""
    from cvd_tpu_torch.data.validation import ValRealEstate10KPoseFolded
    from cvd_tpu_torch.io.tokenizer import HashTokenizer
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    F, S, STEPS = 2, 64, 2
    poses = os.path.join(ROOT, "assets", "pose_files")
    data = ValRealEstate10KPoseFolded(["a room"], os.path.join(poses, "example_dolly.txt"),
                                      os.path.join(poses, "example_arc.txt"),
                                      sample_n_frames=F, sample_size=S)
    tok = HashTokenizer()
    pipe = SimplePipeline(_tiny_modules(), F_mat_size=256)
    tracing.enable(True)
    for _ in range(2):
        sample = data[0]
        pipe(torch.from_numpy(tok(["a room"])), torch.from_numpy(tok(["blurry"])),
             torch.from_numpy(sample["plucker_embedding"]).reshape(2, F, S, S, 6),
             torch.from_numpy(sample["F_mats"]).reshape(2, F, 3, 3),
             num_inference_steps=STEPS, generator=torch.Generator().manual_seed(0))
        assert len(pipe.unet_step_ms) == STEPS
    got = tracing.drain()
    assert got["counters"] == {"units": 2}
    want = {"data.pose_conditioning": None, "geometry.ray_condition": "data.pose_conditioning",
            "sample.prepare": None, "sample.text_encoder": "sample.prepare",
            "sample.pose_encoder": "sample.prepare", "sample.denoise": None,
            "sample.decode": None}
    for name, parent in want.items():
        spans = _named(got, name)
        assert len(spans) == 2, name
        assert [s["parent"] for s in spans] == [parent] * 2, name
        assert spans[1]["unit"] == spans[0]["unit"] + 1, name
    # a request's pose conditioning belongs to the unit its pipeline call ends
    assert (_named(got, "data.pose_conditioning")[0]["unit"]
            == _named(got, "sample.decode")[0]["unit"])
    for name in ("sample.prepare", "sample.decode"):
        assert [d["parent"] for d in _named(got, name, "device")] == [None, None]
        assert all(d["ms"] > 0 for d in _named(got, name, "device"))


def test_a_unet_call_given_a_timer_marks_its_sublayers(tracing, monkeypatch):
    """A UNet call given an ``IntervalTimer`` brackets each spatial
    transformer, motion module and epi module with two marks, named by
    kind, and gives the output it gives without one; a call given none
    makes no mark."""
    from cvd_tpu_torch.models.epi import EpiConditioning
    from cvd_tpu_torch.utils.tracing import IntervalTimer

    m = _tiny_modules()
    unet = m.unet
    B, Fr, S = 4, 2, 8
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        args = (torch.randn(B, Fr, S, S, 4, generator=g), torch.tensor(999),
                torch.randn(B, 77, unet.config.cross_attention_dim, generator=g),
                list(m.pose_encoder(torch.randn(B, Fr, 8 * S, 8 * S, 6, generator=g))),
                EpiConditioning(F_mats=torch.randn(B * Fr, 3, 3, generator=g) * 1e-3,
                                video_length=Fr, F_mat_size=8 * S, slope=torch.tensor([1.1])))
        timer = IntervalTimer("cpu")
        timed = unet(*args, timer=timer)
        timer.mark("left over")             # a second call starts the timer again
        assert torch.equal(unet(*args, timer=timer), timed)
        blocks = [*unet.down_blocks, unet.mid_block, *unet.up_blocks]
        want = {kind: sum(len(getattr(b, attr) or ()) for b in blocks)
                for kind, attr in (("unet.spatial", "attentions"),
                                   ("unet.motion", "motion_modules"),
                                   ("unet.epi", "epi_modules"))}
        assert min(want.values()) > 0
        names = timer.names[:timer.used]
        assert names[1::2] == [None] * (timer.used // 2)
        assert {k: names[0::2].count(k) for k in want} == want
        assert timer.used == 2 * sum(want.values())
        ms = timer.elapsed_ms()
        assert set(ms) == set(want) and all(v > 0 for v in ms.values())
        tracing.enable(True)
        timer.record()
        assert [d["name"] for d in tracing.drain()["device"]] == list(ms)

        def refuse(self, name=None):
            raise AssertionError("a mark was made by a UNet call given no timer")

        monkeypatch.setattr(IntervalTimer, "mark", refuse)
        assert torch.equal(unet(*args), timed)
    assert tracing.drain()["device"] == []


class _Replay:
    """A captured graph on the CPU: replay() runs the captured function."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.mark.parametrize("replayed", [False, True], ids=["eager", "replayed"])
def test_train_program_phases_and_spans(tracing, monkeypatch, replayed):
    from cvd_tpu_torch.train import program as P
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.utils.graphs import launch_counts

    if replayed:   # TrainProgram's capturing branch on the CPU
        monkeypatch.setattr(P.TrainProgram, "capture_graph",
                            lambda self, fn, gen: (_Replay(fn), None, {}))
        monkeypatch.setattr(P.TrainProgram, "warmup",
                            lambda self, fn: (fn(), {n: 0 for n in launch_counts()}))
        monkeypatch.setattr(P.TrainProgram, "check_generator", lambda self, g: None)
    m = _tiny_modules(vae_encoder=True)
    state = create_train_state(m.unet, learning_rate=1e-3)
    prog = P.TrainProgram(state, m, remat=False)
    prog.capture = replayed
    rng = np.random.default_rng(0)
    Fr, S = 2, 8
    batch = {"latents": rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32),
             "text_ids": rng.integers(0, 49408, (2, 77)).astype(np.int64),
             "plucker": rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32),
             "F_mats": (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(1)
    tracing.enable(True)
    for _ in range(3):
        with tracing.span("test.step"):
            prog.step(batch, gen)
    got = tracing.drain()
    assert got["counters"] == {"units": 3}
    steps = _named(got, "test.step")
    phases = [d for d in got["device"] if d["name"].startswith("train.")]
    assert [d["name"] for d in phases] == list(PHASES) * 3
    for k, step in enumerate(steps):
        mine = phases[4 * k:4 * k + 4]
        assert {d["unit"] for d in mine} == {step["unit"]}
        assert all(d["ms"] > 0 and d["parent"] == "test.step" for d in mine)
        assert sum(d["ms"] for d in mine) <= 1e3 * (step["end"] - step["start"])
    host = [s["name"] for s in got["spans"] if s["name"].startswith("train.")]
    if not replayed:
        assert host == []        # eager: no static buffers, stamp or graph
        return
    # the first step fills the key's buffers, runs eagerly and captures;
    # the others fill, replay and mark what the replay wrote
    assert host == (["train.stamp", "train.fill"]
                    + ["train.stamp", "train.fill", "train.replay", "train.stamp"] * 2)
    assert all(s["parent"] == "test.step" for s in got["spans"] if s["name"] in host)


class _Slow:
    """Items that take ``seconds`` each to make."""

    def __init__(self, n, seconds):
        self.n, self.seconds = n, seconds

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.seconds)
        return {"x": np.full((2,), i, np.float32), "text": str(i)}


@pytest.mark.parametrize("worker_type", ["thread", "process"])
def test_loader_stats_count_draws_and_waits(worker_type):
    from cvd_tpu_torch.data.loader import PREFETCH, DataLoader

    loader = DataLoader(_Slow(24, 0.01), batch_size=2, num_workers=3, worker_type=worker_type)
    assert loader.stats == {"draws": 0, "ready": 0, "wait_s": 0.0, "busy_s": 0.0}
    it = iter(loader)
    t0 = time.perf_counter()
    next(it)                                   # nothing is ready at the first ask
    first = time.perf_counter() - t0
    assert loader.stats["draws"] == 1 and loader.stats["ready"] == 0
    assert 0.01 <= loader.stats["wait_s"] <= first
    time.sleep(0.3)                            # the queue fills while the consumer is away
    next(it)
    assert loader.stats["ready"] == PREFETCH
    drawn = 2 + sum(1 for _ in it)
    assert loader.stats["draws"] == drawn == 12
    assert 0 <= loader.stats["ready"] <= PREFETCH * drawn
    # every item's 10 ms, in whichever worker made it
    assert loader.stats["busy_s"] >= 24 * 0.01


def test_loader_busy_time_loses_no_update():
    """More thread workers than cores, a short switch interval: the workers'
    busy seconds still add up to every item's."""
    from cvd_tpu_torch.data.loader import DataLoader

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = DataLoader(_Slow(64, 0.005), batch_size=16,
                            num_workers=4 * (os.cpu_count() or 1))
        t0 = time.perf_counter()
        assert sum(1 for _ in loader) == 4
        assert time.perf_counter() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    assert loader.stats["busy_s"] >= 64 * 0.005
    assert loader.stats["draws"] == 4
