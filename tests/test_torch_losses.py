"""Port training losses vs the JAX package (CPU).

The same numpy measurements, probe b, scaling rates/centers and crop
offsets go to both packages.  Checked: the SURE probe's margin,
``compute_sure_margin``'s rules, ``sure_gaussian_loss_from_outputs``, the
padded scaling transform and its sampling matrices, the stop-gradient on
the transformed branch, and the whole ``proposed`` loss (SURE on a 2B
stacked forward + EI under the scaling transform) of a tiny SwinIR: the
value and every parameter's gradient against ``jax.value_and_grad`` over
the JAX ``Model.apply_fn``, with the JAX grads mapped into the port's
``state_dict`` names by ``jax_params_to_state_dict`` (linear: transposes
and renames).

Tolerances: 1e-6 (abs) for the SURE value on shared model outputs and for
the sampling matrices; 1e-5 for the transform; the tiny SwinIR's loss to
1e-5 relative and its gradients to 2e-5 of each tensor's largest entry
(measured: 2e-6): the models agree to ~1e-6 in their outputs, and SURE's
divergence divides the difference of the two forwards, f(y + tau b) - f(y),
by tau = 1e-2, so the forward's f32 rounding reaches the divergence's
gradient ~100x larger, scaled down again by 2 sigma^2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.losses import compute_sure_margin as jax_margin
from sei_tpu.losses import sure_gaussian_loss_from_outputs as jax_sure
from sei_tpu.models import get_model as jax_get_model
from sei_tpu.ops.scaling import padded_scaling_transform as jax_scaling
from sei_tpu.ops.scaling import scaling_sample_matrix_1d as jax_matrix_1d
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu_torch.losses import (LossConfig, LossDraws, compute_sure_margin, get_loss,
                                  sample_probe, sure_gaussian_loss,
                                  sure_gaussian_loss_from_outputs)
from sei_tpu_torch.models import get_model, jax_params_to_state_dict
from sei_tpu_torch.ops.scaling import padded_scaling_transform, scaling_sample_matrix_1d
from sei_tpu_torch.physics import get_physics
from sei_tpu_torch.rng import make_streams
from sei_tpu_torch.transforms import crop_pair_batch

OVERRIDES = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4, drop_path_rate=0.0)
SIGMA = 5.0 / 255.0


@pytest.fixture(scope="module")
def physics():
    return (jax_get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5),
            get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu"))


def test_sample_probe_margin_and_seed():
    y = torch.zeros(2, 3, 20, 20)
    a = sample_probe(torch.Generator().manual_seed(3), y, margin=4)
    b = sample_probe(torch.Generator().manual_seed(3), y, margin=4)
    assert a.shape == y.shape and torch.equal(a, b)
    inner = a[..., 4:-4, 4:-4]
    assert torch.all(inner != 0)
    assert a.abs().sum() == inner.abs().sum()  # zero outside the margin window
    assert torch.all(sample_probe(torch.Generator().manual_seed(3), y, margin=0) != 0)


@pytest.mark.parametrize("kw", [
    dict(partial_sure=False, sure_margin=None, task="deblurring"),
    dict(partial_sure=True, sure_margin=5, task="deblurring", kernel_shape=(13, 13)),
    dict(partial_sure=True, sure_margin=None, task="deblurring", kernel_shape=(13, 13)),
    dict(partial_sure=True, sure_margin=None, task="deblurring", kernel_shape=(3, 9, 7)),
    dict(partial_sure=True, sure_margin=None, task="sr", partial_sure_sr=True),
    dict(partial_sure=True, sure_margin=None, task="sr"),
    dict(partial_sure=True, sure_margin=None, task="invert_a_tomography_like_filter"),
])
def test_compute_sure_margin_matches_jax(kw):
    assert compute_sure_margin(**kw) == jax_margin(**kw)


@pytest.mark.parametrize("margin,cropped,averaged", [(0, False, False), (6, True, False),
                                                     (6, False, True)])
def test_sure_from_outputs_matches_jax(physics, margin, cropped, averaged):
    jphys, phys = physics
    rng = np.random.default_rng(0)
    y, x_net, x_tau = (rng.random((2, 3, 24, 24)).astype(np.float32) for _ in range(3))
    b = rng.standard_normal(y.shape).astype(np.float32)
    kw = dict(sigma=SIGMA, tau=1e-2, margin=margin, cropped_div=cropped, averaged_cst=averaged)
    want = float(jax_sure(*map(jnp.asarray, (y, x_net, x_tau, b)), jphys.A, **kw))
    got = float(sure_gaussian_loss_from_outputs(*map(torch.from_numpy, (y, x_net, x_tau, b)),
                                                phys.A, **kw))
    assert got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("margin,cropped", [(0, False), (6, True), (6, False)])
def test_sure_with_its_own_probe_matches_the_2b_form(physics, margin, cropped):
    """sure_gaussian_loss draws its probe (mc_divergence) and runs the second
    model evaluation itself; with the same probe it equals the 2B form."""
    _, phys = physics
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.random((2, 3, 24, 24)).astype(np.float32))
    model = lambda img: 0.8 * img + 0.1 * img * img  # noqa: E731
    kw = dict(sigma=SIGMA, tau=1e-2, margin=margin, cropped_div=cropped)
    got = sure_gaussian_loss(torch.Generator().manual_seed(9), y, model(y), model, phys.A, **kw)
    b = sample_probe(torch.Generator().manual_seed(9), y, margin if cropped else 0)
    want = sure_gaussian_loss_from_outputs(y, model(y), model(y + 1e-2 * b), b, phys.A, **kw)
    assert got.item() == pytest.approx(want.item(), abs=1e-7)


def test_scaling_matrices_and_transform_match_jax():
    rng = np.random.default_rng(1)
    rates = np.array([0.75, 0.5, 0.5], np.float32)
    centers = (2 * rng.random((3, 2)) - 1).astype(np.float32)
    for b in range(3):
        want = np.asarray(jax_matrix_1d(24, 24, jnp.asarray(rates[b]), jnp.asarray(centers[b, 0])))
        got = scaling_sample_matrix_1d(24, 24, torch.from_numpy(rates[b:b + 1]),
                                       torch.from_numpy(centers[b:b + 1, 0]))[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    x = rng.random((3, 3, 24, 24)).astype(np.float32)
    want = np.asarray(jax_scaling(jnp.asarray(x), jnp.asarray(rates), jnp.asarray(centers)))
    got = padded_scaling_transform(*map(torch.from_numpy, (x, rates, centers)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the antialiased kind (ported since the resize came): each image resized
    # by its own rate first, the JAX package's lax.switch on rate_idx
    want = np.asarray(jax_scaling(jnp.asarray(x), jnp.asarray(rates), jnp.asarray(centers),
                                  antialias=True, rate_idx=jnp.asarray([0, 1, 1])))
    got = padded_scaling_transform(*map(torch.from_numpy, (x, rates, centers)), antialias=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _draws(rng, b, size, margin):
    probe = rng.standard_normal((b, 3, size, size)).astype(np.float32)
    probe[..., :margin, :] = probe[..., -margin:, :] = 0.0
    probe[..., :, :margin] = probe[..., :, -margin:] = 0.0
    return dict(crop=rng.integers(0, 9, (b, 2)), probe=probe,
                rates=np.array([0.75, 0.5][:b], np.float32),
                centers=(2 * rng.random((b, 2)) - 1).astype(np.float32))


def test_stop_gradient_blocks_the_transform_branch(physics):
    """With stop_gradient the EI target T(f(y)) is a constant: the loss's
    gradient equals that of the loss with the target detached by hand, and
    differs from the loss without stop_gradient."""
    _, phys = physics
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((2, 3, 32, 32)).astype(np.float32))
    y = phys.A(x)
    d = _draws(rng, 2, 24, 6)
    draws = LossDraws(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})
    w = torch.tensor(0.9, requires_grad=True)
    model = lambda img: img * w + 0.01 * img * img  # noqa: E731
    grads = {}
    for sg in (True, False):
        fn = LossConfig(sure_margin=6, crop_size=24, stop_gradient=sg).build(phys.A)
        grads[sg] = torch.autograd.grad(fn(x, y, model, None, draws), w)[0]
    fn = LossConfig(sure_margin=6, crop_size=24, method="sure").build(phys.A)
    sure = fn(x, y, model, None, draws)
    _, yc = crop_pair_batch(x, y, size=24, offsets=draws.crop)
    x_net = model(yc)
    target = padded_scaling_transform(x_net, draws.rates, draws.centers).detach()
    by_hand = sure + torch.mean((model(phys.A(target)) - target) ** 2)
    want = torch.autograd.grad(by_hand, w)[0]
    assert grads[True].item() == pytest.approx(want.item(), rel=1e-6)
    assert abs(grads[False].item() - grads[True].item()) > 1e-6


@pytest.fixture(scope="module")
def tiny_models():
    jmodel = jax_get_model(kind="Proposed", task="deblurring", swinir_overrides=OVERRIDES)
    rng = np.random.default_rng(0)
    jmodel.params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32)),
        jmodel.params)
    model = get_model(device="cpu", swinir_overrides=OVERRIDES)
    model.load_weights(jax.tree_util.tree_map(np.asarray, jmodel.params))
    return jmodel, model


def test_proposed_loss_and_grads_match_jax(physics, tiny_models):
    jphys, phys = physics
    jmodel, model = tiny_models
    crop, margin, b = 24, compute_sure_margin(partial_sure=True, sure_margin=None,
                                              task="deblurring", kernel_shape=(13, 13)), 2
    rng = np.random.default_rng(5)
    x = rng.random((b, 3, 32, 32)).astype(np.float32)
    y = (np.asarray(jphys.A(jnp.asarray(x)))
         + SIGMA * rng.standard_normal(x.shape).astype(np.float32)).astype(np.float32)
    d = _draws(rng, b, crop, margin)
    (i0, j0), (i1, j1) = d["crop"]
    yc = np.stack([y[0, :, i0:i0 + crop, j0:j0 + crop], y[1, :, i1:i1 + crop, j1:j1 + crop]])

    def jax_loss(params):
        f = lambda img: jmodel.apply_fn(params, img)  # noqa: E731  (drop-path rate 0)
        ycj, bj = jnp.asarray(yc), jnp.asarray(d["probe"])
        x_net, x_tau = jnp.split(f(jnp.concatenate([ycj, ycj + bj * 1e-2])), 2)
        loss = jax_sure(ycj, x_net, x_tau, bj, jphys.A, sigma=SIGMA, tau=1e-2, margin=margin,
                        cropped_div=True, averaged_cst=False)
        x2 = jax.lax.stop_gradient(
            jax_scaling(x_net, jnp.asarray(d["rates"]), jnp.asarray(d["centers"])))
        x3 = f(jphys.A(x2))
        return loss + jnp.mean((x3 - x2) ** 2)

    want, jgrads = jax.jit(jax.value_and_grad(jax_loss))(jmodel.params)
    want_sd = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))

    loss_fn = get_loss(method="proposed", physics=phys, crop_size=crop)
    module = model.module.train()
    draws = LossDraws(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})
    module.zero_grad()
    got = loss_fn(torch.from_numpy(x), torch.from_numpy(y), module, None, draws)
    got.backward()
    module.eval()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    named = dict(module.named_parameters())
    assert set(named) == set(want_sd)
    for k, g in want_sd.items():
        rel = np.abs(named[k].grad.numpy() - g.numpy()).max() / max(np.abs(g.numpy()).max(), 1e-6)
        assert rel <= 2e-5, (k, rel)


def test_proposed_draws_from_the_streams(physics):
    """Without explicit draws the loss takes crops, probe and scaling
    parameters from the generators: the same seed gives the same loss."""
    _, phys = physics
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((2, 3, 40, 40)).astype(np.float32))
    y = phys.A(x)
    fn = get_loss(method="proposed", physics=phys, crop_size=24)
    model = lambda img: 0.9 * img  # noqa: E731
    streams = make_streams(3, "cpu")
    assert all(g.device == x.device for g in streams.device_generators())
    before = streams.crop.get_state()
    a = fn(x, y, model, streams)
    assert not torch.equal(streams.crop.get_state(), before)  # the loss crop's offsets
    b = fn(x, y, model, make_streams(3, "cpu"))
    c = fn(x, y, model, make_streams(4, "cpu"))
    assert a.item() == b.item() and a.item() != c.item()


def test_unported_options_raise(physics):
    # every option is ported now: the normal scaling kind still needs its
    # fixed rate (one loss per rate), and unknown names raise
    _, phys = physics
    with pytest.raises(ValueError, match="fixed rate"):
        get_loss(method="proposed", physics=phys, scaling_kind="normal")
    with pytest.raises(ValueError, match="Unknown transforms"):
        get_loss(method="proposed", physics=phys, transforms="Flips")
    with pytest.raises(ValueError, match="Unknown method"):
        get_loss(method="ei-flip", physics=phys)
