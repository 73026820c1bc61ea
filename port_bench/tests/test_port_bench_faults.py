"""A run with the timed path broken underneath comes out not correct: once
for each fault the cells can have (an answer altered where it is produced;
a training step that leaves its state unchanged; half of the batch left
out, the mean taken over the rest). No cell spans chips, so no exchange
between chips can be left out. The tiny configuration runs on the CPU, so
no look for a card stands in the way."""
import json

import torch

from port_bench import run
from port_bench.tests.helpers import TINY_BENCH


def _run(capsys, workload, seed):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "1",
                   "--benchmark", TINY_BENCH])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_sound_runs_are_correct(capsys):
    assert _run(capsys, "tiny-pair", 31)["correct"] is True
    assert _run(capsys, "tiny-train", 32)["correct"] is True


def test_answer_altered(capsys, monkeypatch):
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    original = SimplePipeline.__call__

    def altered(self, *args, **kwargs):
        videos = original(self, *args, **kwargs)
        videos[1, -1] = 1.0 - videos[1, -1]      # one frame of one view
        return videos

    monkeypatch.setattr(SimplePipeline, "__call__", altered)
    line = _run(capsys, "tiny-pair", 33)
    assert line["correct"] is False and line["failed"] == 0


def test_state_unchanged(capsys, monkeypatch):
    from cvd_tpu_torch.train.state import TrainState

    monkeypatch.setattr(TrainState, "update", lambda self: torch.zeros(()))
    line = _run(capsys, "tiny-train", 34)
    assert line["correct"] is False
    for name in ("grad_gap", "change_gap"):
        assert line["checks"][name]["value"] > line["checks"][name]["limit"]


def test_half_batch(capsys, monkeypatch):
    from cvd_tpu_torch.train.program import TrainProgram

    original = TrainProgram.step

    def half(self, batch, generator=None):
        return original(self, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, generator)

    monkeypatch.setattr(TrainProgram, "step", half)
    line = _run(capsys, "tiny-train", 35)
    assert line["correct"] is False
