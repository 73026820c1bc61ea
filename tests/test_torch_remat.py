"""The remat units and policies of cvd_tpu_torch's UNet (the JAX package's
``remat_unit`` / ``remat_policy``, cvd_tpu/models/unet.py:106-186), on the
CPU in f32 at the smoke widths with every tensor drawn and the auxiliary
q/k head (its maps come out of a checkpointed unit under both units).

Recomputing in the backward changes no value: every unit x policy gives
the loss of remat off exactly and its trainable gradients to 1e-6
relative. What a policy saves shows in what the backward runs again: the
matrix products and convolutions counted in the backward by a dispatch
mode.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

torch.set_num_threads(2)

Fr, S = 2, 8
UNITS = ("block", "layer")
POLICIES = ("", "dots", "dots_no_batch", "dots_small")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "latents": torch.from_numpy(rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)),
        "text_ids": torch.from_numpy(rng.integers(0, 49408, (2, 77))),
        "plucker": torch.from_numpy(rng.standard_normal((2, Fr, 8 * S, 8 * S, 6))
                                    .astype(np.float32)),
        "F_mats": torch.from_numpy((rng.standard_normal((2, Fr, 3, 3)) * 1e-3)
                                   .astype(np.float32)),
    }


@pytest.fixture(scope="module")
def bundle():
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.train.state import create_train_state

    m = PipelineModules.create(dataclasses.replace(SMOKE_UNET, additional_channel=4),
                               SMOKE_VAE, SMOKE_CLIP, device="cpu",
                               generator=torch.Generator().manual_seed(0), random_full=True)
    return m, create_train_state(m.unet)


def _step(bundle, unit, policy, remat):
    """(loss, the trainable gradients concatenated) of one step of the
    bundle's UNet with ``remat_unit`` / ``remat_policy``."""
    from cvd_tpu_torch.train.train_step import loss_and_grads

    m, state = bundle
    base = m.unet.config
    m.unet.config = dataclasses.replace(base, remat_unit=unit, remat_policy=policy)
    try:
        loss, _ = loss_and_grads(state, _batch(), m, torch.Generator().manual_seed(4),
                                 remat=remat, epi_loss_weight=1.0)
    finally:
        m.unet.config = base
    grads = torch.cat([p.grad.reshape(-1) for p in state.trainable_params()])
    state.optimizer.zero_grad(set_to_none=True)
    return float(loss), grads


@pytest.fixture(scope="module")
def reference(bundle):
    return _step(bundle, "block", "", remat=False)


@pytest.mark.parametrize("unit", UNITS)
@pytest.mark.parametrize("policy", POLICIES)
def test_every_unit_and_policy_gives_the_gradients_of_remat_off(bundle, reference, unit,
                                                                policy):
    loss, grads = _step(bundle, unit, policy, remat=True)
    want_loss, want = reference
    assert loss == want_loss
    assert float((grads - want).abs().max()) <= 1e-6 * float(want.abs().max())


class _Products(TorchDispatchMode):
    """Counts the matrix products and convolutions dispatched while it is on."""

    OPS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.baddbmm.default, torch.ops.aten.convolution.default}

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in self.OPS
        return func(*args, **(kwargs or {}))


def _backward_products(bundle, unit, policy, remat=True):
    """The products the backward of one step runs: its own and the ones a
    unit recomputes."""
    from cvd_tpu_torch.train import train_step as ts

    m, state = bundle
    base = m.unet.config
    m.unet.config = dataclasses.replace(base, remat_unit=unit, remat_policy=policy)
    mode = _Products()
    real = torch.Tensor.backward

    def counted(loss, *a, **kw):
        with mode:
            return real(loss, *a, **kw)

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.Tensor, "backward", counted)
            ts.loss_and_grads(state, _batch(), m, torch.Generator().manual_seed(4), remat=remat,
                              epi_loss_weight=1.0)
    finally:
        m.unet.config = base
        state.optimizer.zero_grad(set_to_none=True)
    return mode.count


@pytest.mark.parametrize("unit", UNITS)
def test_dots_recomputes_fewer_products_than_saving_nothing(bundle, unit, monkeypatch):
    """remat off runs each product's backward only; "" runs every product of
    the forward again on top, "dots" none, "dots_no_batch" the batched
    products and convolutions again, "dots_small" under a limit of 0 bytes
    all of them, as "" does."""
    off = _backward_products(bundle, unit, "", remat=False)
    nothing = _backward_products(bundle, unit, "")
    dots = _backward_products(bundle, unit, "dots")
    no_batch = _backward_products(bundle, unit, "dots_no_batch")
    assert off == dots < no_batch < nothing
    monkeypatch.setenv("CVD_TPU_REMAT_SAVE_MAX_BYTES", "0")
    assert _backward_products(bundle, unit, "dots_small") == nothing
    monkeypatch.setenv("CVD_TPU_REMAT_SAVE_MAX_BYTES", str(2 ** 40))
    assert _backward_products(bundle, unit, "dots_small") == dots


def test_product_bytes_are_the_outputs():
    from cvd_tpu_torch.models.unet import _product_bytes

    aten = torch.ops.aten
    a, b, c = torch.randn(5, 3), torch.randn(3, 7), torch.randn(7)
    x, w = torch.randn(2, 3, 9, 11), torch.randn(4, 3, 3, 3)
    cases = [(aten.mm.default, (a, b)), (aten.addmm.default, (c, a, b)),
             (aten.bmm.default, (torch.randn(2, 5, 3), torch.randn(2, 3, 6))),
             (aten.baddbmm.default, (torch.randn(2, 5, 6), torch.randn(2, 5, 3),
                                     torch.randn(2, 3, 6))),
             (aten.convolution.default, (x, w, None, [2, 1], [1, 0], [1, 1], False, [0, 0], 1)),
             (aten.convolution.default, (x, torch.randn(3, 2, 3, 3), None, [2, 2], [1, 1],
                                         [1, 1], True, [1, 0], 1))]
    for op, args in cases:
        assert _product_bytes(op, args) == op(*args).numel() * 4, op


@pytest.mark.parametrize("field,value", [("remat_unit", "sublayer"), ("remat_policy", "dot"),
                                         ("remat_policy", "everything")])
def test_unknown_remat_values_raise_naming_the_allowed(field, value):
    from cvd_tpu_torch.models.unet import UNetConfig

    with pytest.raises(ValueError, match="expected one of") as e:
        UNetConfig(**{field: value})
    assert value in str(e.value)


@pytest.mark.parametrize("keys", [dict(remat_policy="dots"), dict(remat_unit="layer")])
def test_remat_settings_without_remat_raise(tmp_path, keys):
    """They would do nothing: the config names both."""
    from cvd_tpu_torch.cli import train

    cfg = dict(random_weights=True, device="cpu", output_dir=str(tmp_path / "run"), **keys)
    with pytest.raises(ValueError, match="remat: true"):
        train.run(cfg)
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("unit,policy", [("layer", ""), ("block", "dots_no_batch")])
def test_the_config_keys_reach_the_unet(tmp_path, unit, policy):
    """``remat_unit`` / ``remat_policy`` reach the UNetConfig through
    ``cli.build.unet_options``, and a one-step run takes them."""
    from test_torch_train_extras import _Pairs

    from cvd_tpu_torch.cli import build, train

    args = train._model_args(dict(remat_unit=unit, remat_policy=policy))
    cfg = build.unet_options(args, build.SMOKE_UNET)
    assert (cfg.remat_unit, cfg.remat_policy) == (unit, policy)
    out = train.run(dict(random_weights=True, device="cpu", sample_size=64, sample_n_frames=2,
                         max_train_steps=1, num_workers=1, checkpointing_steps=10, remat=True,
                         remat_unit=unit, remat_policy=policy, do_sanity_check=False,
                         output_dir=str(tmp_path / "run")), sources=[_Pairs()])
    assert (out["modules"].unet.config.remat_unit,
            out["modules"].unet.config.remat_policy) == (unit, policy)
    assert np.isfinite(out["losses"]).all()
