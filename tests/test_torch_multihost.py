"""Data loading and data-parallel training of cvd_tpu_torch on the CPU:
``shard_indices`` against cvd_tpu's, process workers against thread
workers, and two gloo processes (started as ``torchrun`` would start them,
tests/torch_dist_worker.py) against one process on both of their pairs.

Every test that forks or starts a process runs under a time limit of its
own: a hung pool or process group fails that test and is killed.
"""
import multiprocessing
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)


@pytest.mark.parametrize("n,epoch,seed,rank,world,shuffle,multiple", [
    (10, 0, 0, 0, 1, True, None), (10, 3, 5, 1, 2, True, 2), (11, 1, 2, 2, 3, True, 2),
    (7, 0, 1, 0, 4, False, None), (64, 2, 9, 3, 4, True, 3)])
def test_shard_indices_match_jax(n, epoch, seed, rank, world, shuffle, multiple):
    from cvd_tpu.data.loader import shard_indices as jax_shard

    from cvd_tpu_torch.data.loader import shard_indices

    got = shard_indices(n, epoch, seed, rank, world, shuffle, multiple)
    np.testing.assert_array_equal(got, jax_shard(n, epoch, seed, rank, world, shuffle, multiple))
    everyone = np.concatenate([shard_indices(n, epoch, seed, r, world, shuffle)
                               for r in range(world)])
    assert sorted(everyone.tolist()) == list(range(n))    # the shards split the epoch


def _within(seconds, fn):
    """fn() in a daemon thread, failing the test if it has not returned
    within ``seconds`` (forked workers left behind are killed)."""
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised in the test
            out["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        for child in multiprocessing.active_children():
            child.kill()
        pytest.fail(f"still running after {seconds} s")
    if "error" in out:
        raise out["error"]
    return out.get("value")


class _Items:
    """Items that carry their index, and a draw of the dataset's rng (as a
    dataset's frame sampling does)."""

    def __init__(self, n=8, tag=0):
        import random

        self.n, self.tag, self.rng = n, tag, random.Random(0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.array([i, self.tag]), "x": np.full((3,), i, np.float32),
                "text": f"item {i}", "draw": np.array([self.rng.random()])}


def test_process_workers_give_the_thread_workers_batches():
    """The port's thread and process workers give cvd_tpu's loader's batches
    (same seed, epochs and shards)."""
    from cvd_tpu.data.loader import DataLoader as JaxLoader

    from cvd_tpu_torch.data.loader import DataLoader

    def epochs(worker_type, **kw):
        loader = DataLoader(_Items(9), batch_size=2, seed=3, num_workers=2,
                            worker_type=worker_type, **kw)
        return [list(loader) for _ in range(2)]

    threads = epochs("thread")
    procs = _within(60, lambda: epochs("process"))
    ref = JaxLoader(_Items(9), batch_size=2, seed=3, num_workers=2)
    for te, je in zip(threads, [list(ref) for _ in range(2)]):
        assert [b["idx"].tolist() for b in te] == [b["idx"].tolist() for b in je]
    assert len(threads[0]) == 4 and [len(e) for e in procs] == [4, 4]
    for te, pe in zip(threads, procs):
        for a, b in zip(te, pe):
            np.testing.assert_array_equal(a["idx"], b["idx"])
            np.testing.assert_array_equal(a["x"], b["x"])
            assert a["text"] == b["text"]
    assert not np.array_equal(threads[0][0]["idx"], threads[1][0]["idx"])   # a new permutation
    # the workers reseed the dataset's rng: each worker's stream is its own
    draws = np.concatenate([b["draw"] for b in procs[0]]).ravel()
    assert len(set(draws.tolist())) == len(draws)
    # a rank's loader serves its shard
    shards = [_within(60, lambda r=r: epochs("process", process_index=r, process_count=2))[0]
              for r in (0, 1)]
    got = sorted(int(i) for s in shards for b in s for i in b["idx"][:, 0])
    assert len(got) == len(set(got)) == 8
    for r in (0, 1):
        want = JaxLoader(_Items(9), batch_size=2, seed=3, process_index=r, process_count=2)
        assert [b["idx"].tolist() for b in shards[r]] == [b["idx"].tolist() for b in want]


def test_an_abandoned_process_epoch_leaves_no_child_and_errors_propagate():
    from cvd_tpu_torch.data.loader import DataLoader

    def abandon():
        loader = DataLoader(_Items(64), batch_size=2, num_workers=2, worker_type="process")
        for _ in range(3):
            it = iter(loader)
            next(it)
            it.close()     # the generator's finally: stop, terminate the pool
        return multiprocessing.active_children()

    assert _within(60, abandon) == []

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise ValueError("boom")

    def broken():
        return next(iter(DataLoader(Broken(), batch_size=2, num_workers=2,
                                    worker_type="process")))

    with pytest.raises(ValueError, match="boom"):
        _within(60, broken)
    assert multiprocessing.active_children() == []


def test_concurrent_process_loaders_serve_their_own_dataset():
    """Hybrid training iterates two loaders side by side: each pool forks
    with its own dataset staged."""
    from cvd_tpu_torch.data.loader import DataLoader

    def both():
        a = iter(DataLoader(_Items(8, tag=1), batch_size=2, num_workers=2,
                            worker_type="process"))
        b = iter(DataLoader(_Items(8, tag=2), batch_size=2, num_workers=2,
                            worker_type="process"))
        tags = [(next(a)["idx"][:, 1].tolist(), next(b)["idx"][:, 1].tolist())
                for _ in range(3)]
        a.close()
        b.close()
        return tags

    assert _within(60, both) == [([1, 1], [2, 2])] * 3


def test_worker_type_is_checked():
    from cvd_tpu_torch.data.loader import DataLoader

    with pytest.raises(ValueError, match="'thread' or 'process'"):
        DataLoader(_Items(), batch_size=2, worker_type="greenlet")


# ---------------------------------------------------- gloo process groups

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(mode, world, tmp_path, seconds=240):
    """``world`` worker processes with torchrun's environment; -> each
    rank's saved result. The group is killed if it outlives ``seconds``."""
    port = _free_port()
    procs, outs = [], []
    for rank in range(world):
        out = tmp_path / f"rank{rank}" / "out.pt"
        out.parent.mkdir(parents=True)
        env = dict(os.environ, PYTHONPATH=ROOT, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_dist_worker.py"), mode, str(out)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=seconds)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{mode}: the process group did not finish within {seconds} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(o, weights_only=False) for o in outs]


def test_two_gloo_processes_give_one_process_gradients_on_both_pairs(tmp_path):
    """Each rank steps on its own pair with pinned noise and timesteps; the
    averaged gradients are those of one process on both pairs, and after
    AdamW both ranks hold the same weights, those of that one process."""
    from torch_dist_worker import modules_and_state, pinned_step

    r0, r1 = _launch("step", 2, tmp_path)
    modules, state = modules_and_state()
    loss, want = pinned_step(modules, state, [0, 1], distributed=False)
    state.apply_gradients()
    assert r0["world"] == r1["world"] == 2
    assert abs((r0["loss"] + r1["loss"]) / 2 - loss) <= 1e-6 * abs(loss)
    ref = torch.cat([g.reshape(-1) for g in want.values()])
    for r in (r0, r1):
        got = torch.cat([r["grads"][n].reshape(-1) for n in want])
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    weights = dict(zip(state.trainable, state.trainable_params()))
    for n in want:
        assert torch.equal(r0["weights"][n], r1["weights"][n]), n
        # Adam's first step moves each weight by about lr * g / |g|: where g is
        # near 0 its summation order shows, so the bar is 1% of that step (lr 1e-3)
        torch.testing.assert_close(r0["weights"][n], weights[n].detach(), rtol=0, atol=1e-5)


def test_multihost_run_on_two_gloo_processes(tmp_path):
    """``run(..., multihost=True)`` under torchrun's environment: both ranks
    draw the same kinds, end with the same weights, and process 0 alone
    writes the config snapshot, the metrics and the checkpoints."""
    r0, r1 = _launch("run", 2, tmp_path)
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)
    assert r0["kinds"] == r1["kinds"] and set(r0["kinds"]) == {"posed", "unposed"}
    assert all(np.isfinite(r0["losses"] + r1["losses"])) and r0["losses"] != r1["losses"]
    for n, w in r0["weights"].items():
        assert torch.equal(w, r1["weights"][n]), n
    lead, other = tmp_path / "rank0" / "run", tmp_path / "rank1" / "run"
    assert (lead / "config.yaml").exists() and (lead / "checkpoints" / "step-4.pt").exists()
    assert (lead / "metrics.jsonl").exists()
    assert not any((other / f).exists() for f in ("config.yaml", "checkpoints",
                                                  "metrics.jsonl"))


def test_a_world_of_one_is_the_run_without_multihost(tmp_path):
    (r,) = _launch("world_of_one", 1, tmp_path)
    assert r["world"] == 1 and len(r["plain"]) == 4
    assert r["multihost"] == r["plain"]     # bit for bit


def test_multihost_needs_torchruns_environment(tmp_path, monkeypatch):
    from cvd_tpu_torch.cli import train

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    cfg = dict(random_weights=True, device="cpu", output_dir=str(tmp_path / "run"))
    path = tmp_path / "c.yaml"
    import yaml

    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--config", str(path), "--multihost"])
