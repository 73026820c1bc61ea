"""The training step as a program of CUDA graphs (``cvd_tpu_torch/train/
program.py``), on the CPU: the body that a graph holds, run over the
program's static buffers as a replay reads them, against the port's eager
``train_step`` (bit for bit) and against cvd_tpu's ``make_jitted_train_step``
with optax AdamW (draws pinned; loss within 1e-5 relative, weights and
AdamW's first moments, the clipped gradients, at >= 60 dB SNR, as in
``tests/test_torch_train.py``); a restore of a file with no AdamW state
under the graphs; the caches a replay must invalidate; the learning-rate tensor against optax's
schedule; resume; and when the program stays eager.

A replay is played on the CPU by standing in for the graph's capture
(``TrainProgram.capture_graph``: capturing runs nothing, replaying runs the
captured body over the same buffers and the program's generator) and for
the side stream of a key's first, eager step; everything else is the
program's own code.
"""
import dataclasses
import logging
import os
import random
import socket
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

torch.set_num_threads(2)

Fr, S = 2, 8        # frames, latent size (64 px)
LR = 1e-3


def _snr_db(got, want):
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def _posed(seed, pixels=True):
    rng = np.random.default_rng(seed)
    out = {"text_ids": rng.integers(0, 49408, (2, 77)).astype(np.int64),
           "plucker": rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32),
           "F_mats": (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)}
    if pixels:
        out["pixel_values"] = rng.uniform(-1, 1, (2, Fr, 8 * S, 8 * S, 3)).astype(np.float32)
    else:
        out["latents"] = rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _unposed(seed):
    from cvd_tpu_torch.data.webvid import random_homography

    rng = np.random.default_rng(seed)
    H = random_homography(random.Random(seed), 8 * S)
    H_mats = np.stack([H] * Fr + [np.linalg.inv(H)] * Fr).astype(np.float32)
    out = {"latents": rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32),
           "text_ids": rng.integers(0, 49408, (2, 77)).astype(np.int64),
           "H_mats": H_mats.reshape(2, Fr, 3, 3),
           "warped_masks": (rng.random((2, Fr, S, S, 1)) > 0.3).astype(np.float32)}
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _modules(seed=0):
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules

    # every tensor drawn: the default initialization makes the epi modules
    # the identity
    return PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                                  generator=torch.Generator().manual_seed(seed),
                                  random_full=True, vae_encoder=True)


def _state(m, **kw):
    from cvd_tpu_torch.train.state import create_train_state

    kw = dict(dict(learning_rate=LR, scheduler="cosine", warmup_steps=1, total_steps=6), **kw)
    return create_train_state(m.unet, **kw)


def _moments(state):
    return [t.clone() for p in state.trainable_params()
            for t in state.optimizer.state[p].values()]


class _Replay:
    """A captured graph on the CPU: replay() runs the captured function."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def replays(monkeypatch):
    """TrainProgram's capturing branch on the CPU: the capture keeps the
    body's closure (over the static buffers and the program's generator),
    a replay runs it; a key's first step runs on the CPU's one stream."""
    from cvd_tpu_torch.train import program as P
    from cvd_tpu_torch.utils.graphs import launch_counts

    monkeypatch.setattr(P.TrainProgram, "capture_graph",
                        lambda self, fn, gen: (_Replay(fn), None, {}))
    monkeypatch.setattr(P.TrainProgram, "warmup",
                        lambda self, fn: (fn(), {n: 0 for n in launch_counts()}))
    monkeypatch.setattr(P.TrainProgram, "check_generator", lambda self, g: None)

    def make(state, m, **kw):
        prog = P.TrainProgram(state, m, **kw)
        prog.capture = True
        return prog

    return make


STEP = dict(F_mat_size=256, remat=True, epi_loss_weight=0.002)


def _assert_same_state(a, b, what):
    for (n, p), q in zip(zip(a.trainable, a.trainable_params()), b.trainable_params()):
        assert torch.equal(p, q), f"{what}: weight {n}"
    for x, y in zip(_moments(a), _moments(b)):
        assert torch.equal(x, y), f"{what}: AdamW state"


def test_the_replayed_body_is_the_eager_step(replays):
    """(a) posed (pixels: the VAE encode's draw in the body), unposed, then
    posed again on other data (the first graph's buffers refilled): losses,
    grad norms, trainable weights, AdamW's state and the generator's state
    after each step bit for bit those of the eager train_step."""
    from cvd_tpu_torch.train.train_step import train_step

    batches = [_posed(1), _unposed(2), _posed(3)]
    ma, mb = _modules(), _modules()
    sa, sb = _state(ma), _state(mb)
    prog = replays(sb, mb, **STEP)
    ga, gb = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    for i, batch in enumerate(batches):
        want = train_step(sa, batch, ma, ga, **STEP)
        got = prog.step(batch, gb)
        assert got == want, f"step {i}"
        assert np.isfinite(got["loss"]) and got["grad_norm"] > 0
        _assert_same_state(sa, sb, f"step {i}")
        assert torch.equal(ga.get_state(), gb.get_state()), f"step {i}: generator"
        assert float(sa.optimizer.param_groups[0]["lr"]) == float(
            sb.optimizer.param_groups[0]["lr"])
    assert prog.stats["captured"] and prog.stats["captures"] == 2 and prog.stats["steps"] == 3
    assert len(prog.graphs) == 2 and sb.step == sa.step == 3
    # the replays read the program's buffers: the third batch is in the first graph's
    posed_graph = prog.graphs[prog.key(batches[2])]
    assert torch.equal(posed_graph.bufs["pixel_values"], batches[2]["pixel_values"])


def test_the_key_covers_what_a_graph_depends_on():
    from cvd_tpu_torch.train.program import TrainProgram

    m = _modules()
    prog = TrainProgram(_state(m), m, **STEP)
    posed, lat = _posed(1), _posed(1, pixels=False)
    keys = {prog.key(posed), prog.key(lat), prog.key(_unposed(2)),
            prog.key(dict(posed, pixel_values=posed["pixel_values"][:, :1])),
            prog.key(dict(posed, text_ids=posed["text_ids"].int()))}
    assert len(keys) == 5
    m.unet.config = dataclasses.replace(m.unet.config, remat_unit="layer")
    assert prog.key(posed) not in keys
    assert prog.key(_posed(5)) == prog.key(_posed(6))
    # a captured step draws on the card: a host generator is refused
    prog.capture = True
    with pytest.raises(ValueError, match="CUDA generator"):
        prog.check_generator(torch.Generator())


# ------------------------------------------------ (b) against cvd_tpu

@pytest.fixture(scope="module")
def jax_run():
    """Two steps of cvd_tpu's make_jitted_train_step (XLA attention,
    horizontal first-frame lines, remat off) with its optax AdamW and cosine
    schedule: the params and first moments after each step, the losses and
    each step's noise / timesteps (one compile: both steps share shapes)."""
    import optax

    from tiny import TINY_CLIP, TINY_UNET, TINY_VAE

    from cvd_tpu.pipelines.common import PipelineModules as JaxModules
    from cvd_tpu.train.state import create_train_state
    from cvd_tpu.train.train_step import make_jitted_train_step

    jm = JaxModules.create(unet_config=TINY_UNET, vae_config=TINY_VAE, clip_config=TINY_CLIP,
                           latent_size=S, video_length=Fr, fast_init=True)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray((np.asarray(a) + rng.standard_normal(a.shape) * 0.02)
                              .astype(np.float32)), jm.unet_params)
    jm = dataclasses.replace(jm, unet_params=params)
    # the step donates its state, whose arrays these are: keep host copies
    init = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), params)
    state = create_train_state(params, learning_rate=LR, scheduler="cosine", warmup_steps=0,
                               total_steps=3)
    step = make_jitted_train_step(jm, rand_slope_ff=False, use_flash_kernel=False, remat=False)
    batch = {k: jnp.asarray(v.numpy()) for k, v in _posed(4, pixels=False).items()}
    out = []
    for seed in (21, 22):
        key = jax.random.key(seed)
        _, eps_key, t_key, _, _ = jax.random.split(key, 5)
        noise = np.asarray(jax.random.normal(eps_key, (2, Fr, S, S, 4), jnp.float32))
        timesteps = np.asarray(jax.random.randint(t_key, (2,), 0, 1000))
        state, metrics = step(state, batch, key)
        mu = _adam_mu(state.opt_state)
        mu = jax.tree_util.tree_map(
            lambda m_, p: np.zeros(p.shape, np.float32) if isinstance(m_, optax.MaskedNode)
            else np.asarray(m_), mu, state.params,
            is_leaf=lambda x: isinstance(x, optax.MaskedNode))
        out.append((float(metrics["loss"]), jax.tree_util.tree_map(np.asarray, state.params),
                    mu, noise, timesteps))
    return jm, init, out


def _adam_mu(tree):
    """optax's first moment (ScaleByAdamState.mu) inside a multi_transform state."""
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        return tree.mu
    children = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for child in children:
        found = _adam_mu(child)
        if found is not None:
            return found
    return None


def test_two_body_steps_match_cvd_tpus_jitted_step(jax_run):
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.train.program import TrainProgram
    from cvd_tpu_torch.train.state import create_train_state

    jm, init, steps = jax_run
    m = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu")
    m.unet.load_state_dict(state_dict_from_flax(init), strict=True)
    m.pose_encoder.load_state_dict(state_dict_from_flax(jm.pose_encoder_params), strict=True)
    m.clip.load_state_dict(state_dict_from_flax(jm.clip_params), strict=True)
    state = create_train_state(m.unet, learning_rate=LR, scheduler="cosine", warmup_steps=0,
                               total_steps=3)
    prog = TrainProgram(state, m, F_mat_size=256, rand_slope_ff=False, remat=False)
    batch = _posed(4, pixels=False)
    for i, (want_loss, want_params, want_mu, noise, timesteps) in enumerate(steps):
        got = prog.step(dict(batch, noise=torch.from_numpy(noise),
                             timesteps=torch.from_numpy(timesteps)))
        assert abs(got["loss"] - want_loss) <= 1e-5 * abs(want_loss), f"step {i + 1}"
        params = dict(m.unet.named_parameters())
        want_w = state_dict_from_flax(want_params)
        want_m = state_dict_from_flax(want_mu)
        w = np.concatenate([params[n].detach().numpy().ravel() for n in state.trainable])
        ref_w = np.concatenate([want_w[n].numpy().ravel() for n in state.trainable])
        mu = np.concatenate([state.optimizer.state[params[n]]["exp_avg"].numpy().ravel()
                             for n in state.trainable])
        ref_mu = np.concatenate([want_m[n].numpy().ravel() for n in state.trainable])
        assert _snr_db(w, ref_w) >= 60.0, f"step {i + 1}: weights {_snr_db(w, ref_w):.1f} dB"
        assert _snr_db(mu, ref_mu) >= 60.0, f"step {i + 1}: moments {_snr_db(mu, ref_mu):.1f}"
        assert np.any(w != np.concatenate([state_dict_from_flax(init)[n].numpy()
                                           .ravel() for n in state.trainable]))
        frozen = [n for n in params if n not in set(state.trainable)]
        assert all(np.array_equal(params[n].detach().numpy(), want_w[n].numpy())
                   for n in frozen)


# ------------------------------------------------ (c) to (f)

def test_a_file_without_adamw_state_restores_the_start_under_the_graphs(replays, tmp_path):
    """(c) A file written before a first step holds no AdamW state (a plain
    torch AdamW's, or a state's whose state was made lazily). Restored into
    a state whose program has stepped and captured: AdamW's live tensors
    are zeroed in place, the graph stays, and two replayed steps are bit for
    bit two eager steps from the start (step counts, hence bias correction,
    go on from 0; moments build up)."""
    from cvd_tpu_torch.train.checkpoint import restore, save
    from cvd_tpu_torch.train.train_step import train_step

    batches = [_posed(1, pixels=False), _posed(3, pixels=False)]
    ma, mb = _modules(), _modules()
    sa, sb = _state(ma), _state(mb)
    path = str(tmp_path / "step-0.pt")
    save(path, sb)
    ckpt = torch.load(path, weights_only=True)
    ckpt["optimizer"]["state"] = {}
    torch.save(ckpt, path)
    prog = replays(sb, mb, **STEP)
    for b in batches:
        prog.step(b, torch.Generator().manual_seed(1))
    pointers = [t.data_ptr() for t in prog.written()]
    restore(path, sb)
    assert sb.step == 0 and sb.lr_scheduler.last_epoch == 0
    assert all(not t.any() for t in _moments(sb))
    ga, gb = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    want = [train_step(sa, b, ma, ga, **STEP) for b in batches]
    got = [prog.step(b, gb) for b in batches]
    assert got == want
    _assert_same_state(sa, sb, "after the restore")
    assert [float(sb.optimizer.state[p]["step"]) for p in sb.trainable_params()[:1]] == [2.0]
    assert prog.stats["captures"] == 1 and prog.stats["steps"] == 4
    assert [t.data_ptr() for t in prog.written()] == pointers


def test_caches_see_a_replays_writes():
    """(d) A write that moves no version counter (what a replay does)
    leaves K5's fold cache and a sampler's stamp stale; the program's bump
    after a replay makes the fold cache refold from the new weights and
    the stamp change. The bump covers every trainable weight, gradient and
    AdamW state tensor."""
    from cvd_tpu_torch.ops.ln_matmul import fold_weights, folded
    from cvd_tpu_torch.pipelines import program as sampling
    from cvd_tpu_torch.train.program import TrainProgram
    from cvd_tpu_torch.utils.graphs import bump_versions

    m = _modules()
    state = _state(m)
    prog = TrainProgram(state, m, **STEP)
    written = {id(t) for t in prog.written()}
    params = state.trainable_params()
    assert all(id(p) in written and id(p.grad) in written for p in params)
    assert all(id(t) in written for s in state.optimizer.state.values() for t in s.values())
    # an epi LayerNorm and its projections (trainable; K5 folds them)
    names = [n for n in state.trainable if "epi_modules" in n and "norm" in n]
    epi = dict(m.unet.named_modules())[names[0].rsplit(".", 2)[0]]
    norm = [mod for mod in epi.modules() if isinstance(mod, torch.nn.LayerNorm)][0]
    proj = [mod for mod in epi.modules() if isinstance(mod, torch.nn.Linear)][0]
    srcs = (norm.weight, norm.bias, [proj.weight], [proj.bias])
    first = folded(*srcs, torch.float32)
    stamp = sampling._stamp([epi])
    with torch.no_grad():
        for t in (norm.weight, norm.bias, proj.weight):
            t.data.mul_(1.5)                     # .data: no version moves, as in a replay
    assert folded(*srcs, torch.float32)[0] is first[0]      # stale without the bump
    assert sampling._stamp([epi]) == stamp
    bump_versions(prog.written())
    again = folded(*srcs, torch.float32)
    want = fold_weights(*srcs, torch.float32)
    assert again[0] is not first[0]
    assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])
    assert sampling._stamp([epi]) != stamp


def test_the_lr_tensor_follows_optaxs_schedule_from_count_0():
    """(e) The learning rate is one 0-dim tensor, refilled in place by the
    schedule after each step: cosine with warmup, counts 0..7, against
    optax's warmup_cosine_decay_schedule."""
    import optax

    m = _modules()
    state = _state(m, warmup_steps=2, total_steps=6)
    lr = state.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dim() == 0
    want = optax.warmup_cosine_decay_schedule(0.0, LR, 2, 6)
    got = []
    for _ in range(8):
        assert state.optimizer.param_groups[0]["lr"] is lr
        got.append(float(lr))
        state.advance()
    np.testing.assert_allclose(got, [float(want(c)) for c in range(8)], rtol=1e-6, atol=0)
    assert got[0] == 0.0 and max(got) == pytest.approx(LR)


def test_a_restore_mid_run_equals_the_unbroken_run(replays, tmp_path):
    """(f) Four replayed steps unbroken, against: two steps, a save, a third
    step, the save restored into the same live state (in place: the graph
    stays, no capture again), then steps three and four again from the
    generator of step two. Bit for bit. The file also reads into a fresh
    state with the same numbers."""
    from cvd_tpu_torch.train.checkpoint import restore, save
    from cvd_tpu_torch.train.state import create_train_state

    batches = [_posed(1, pixels=False), _unposed(2), _posed(3, pixels=False), _unposed(4)]
    ma, mb = _modules(), _modules()
    sa, sb = _state(ma), _state(mb)
    pa, pb = replays(sa, ma, **STEP), replays(sb, mb, **STEP)
    ga, gb = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    want = [pa.step(b, ga) for b in batches]
    got = [pb.step(b, gb) for b in batches[:2]]
    path = str(tmp_path / "step-2.pt")
    save(path, sb, epoch=1)
    at_two = gb.get_state()
    pointers = [t.data_ptr() for t in sb.optimizer_tensors()]
    pb.step(batches[2], gb)
    _, epoch = restore(path, sb)
    assert epoch == 1 and sb.step == 2
    assert [t.data_ptr() for t in sb.optimizer_tensors()] == pointers
    gb.set_state(at_two)
    got += [pb.step(b, gb) for b in batches[2:]]
    assert got == want
    _assert_same_state(sa, sb, "after resume")
    assert pb.stats["captures"] == 2 and sb.step == sa.step == 4
    # the same file into a fresh state
    mc = _modules()
    sc = create_train_state(mc.unet, learning_rate=LR, scheduler="cosine", warmup_steps=1,
                            total_steps=6)
    restore(path, sc)
    ref = torch.load(path, weights_only=True)
    params = dict(mc.unet.named_parameters())
    assert all(torch.equal(params[n], v) for n, v in ref["params"].items())
    assert sc.optimizer.param_groups[0]["capturable"] is False
    assert float(sc.optimizer.param_groups[0]["lr"]) == pytest.approx(
        float(ref["optimizer"]["param_groups"][0]["lr"]))
    for p, i in zip(sc.trainable_params(), ref["optimizer"]["param_groups"][0]["params"]):
        for k, v in ref["optimizer"]["state"][i].items():
            assert torch.equal(sc.optimizer.state[p][k], v)
    assert sc.lr_scheduler.last_epoch == 2


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Said(logging.Handler):
    """The messages of the program's logger (the CLI's logger setup stops
    them propagating to the root, where caplog listens)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_the_program_stays_eager_and_says_so_once(replays):
    """(g) Under a process group (a gloo world of one) a capturing program
    runs its steps eagerly and logs why once; so does a program on the CPU
    and one made with capture=False."""
    import torch.distributed as dist

    from cvd_tpu_torch.train.program import TrainProgram

    m = _modules()
    state = _state(m)
    batch = _posed(1, pixels=False)
    logger = logging.getLogger("cvd_tpu_torch.train.program")
    said, level = _Said(), logger.level
    logger.addHandler(said)
    logger.setLevel(logging.INFO)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        prog = replays(state, m, **STEP)
        for _ in range(2):
            out = prog.step(batch, torch.Generator().manual_seed(0))
            assert np.isfinite(out["loss"])
        assert not prog.stats["captured"] and prog.stats["captures"] == 0
        assert prog.stats["steps"] == 2
        assert said.messages.count("training steps run eagerly, not as CUDA graphs: "
                                   "a process group (--multihost)") == 1
        for kw, why in (({}, "a cpu device"), ({"capture": False}, "capture=False")):
            prog = TrainProgram(state, m, **kw, **STEP)
            assert prog.capture is False
            for _ in range(2):
                assert prog.eager_reason() == why
            assert said.messages.count(
                f"training steps run eagerly, not as CUDA graphs: {why}") == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        logger.removeHandler(said)
        logger.setLevel(level)
