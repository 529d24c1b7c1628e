"""The training methods and modes of ROADMAP Queue 1 item 4 against the JAX
package's (CPU).

* CSS and fresh measurements: the port's batch (``sample_train_batch``)
  against the JAX package's physics applied to the same gathered images
  with the same noise and crop: 1e-6.
* The losses on a tiny SwinIR (weights carried across by
  ``models/torch_io``), each against the JAX package's ``get_loss`` with the
  draws its key gives (handed to the port as ``LossDraws``): supervised L1;
  ``proposed`` with ``Rotations+Shifts``, ``Rotations`` and ``Shifts``, in
  its SURE and its ``r2r`` forms; the normal scaling kind's per-rate
  variants (0.75, 0.5; SURE and ``r2r``); ``proposed`` R2R-EI on the CT-like
  task.  The loss to 1e-5 relative, every gradient to 1e-5 of its tensor's
  largest entry (2e-5 for the SURE forms, whose divergence divides the
  f32 difference of two forwards by tau = 1e-2).
* The trainer on the CPU: the sequence of normal-kind variants equals the
  JAX trainer's (its own loop with the step stubbed), both variants run,
  and CSS, fresh measurements and the method aliases train.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.losses import get_loss as jax_get_loss
from sei_tpu.losses import sample_probe as jax_sample_probe
from sei_tpu.models import get_model as jax_get_model
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu.transforms import ScalingTransform as JaxScaling
from sei_tpu_torch.data import build_device_cache, sample_train_batch
from sei_tpu_torch.losses import LossDraws, get_loss, normalize_method
from sei_tpu_torch.models import get_model, jax_params_to_state_dict
from sei_tpu_torch.physics import get_physics
from sei_tpu_torch.rng import make_streams
from sei_tpu_torch.train import Trainer

OVERRIDES = dict(embed_dim=8, depths=(1,), num_heads=(2,), window_size=4, drop_path_rate=0.0)
SIGMA = 5.0 / 255.0
B, SIZE = 2, 32  # at rate 0.5 the normal kind's 16 px still holds the 13 px PSF


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


def _physics(task):
    kw = dict(kernel="Gaussian_R2") if task == "deblurring" else {}
    return (jax_get_physics(task=task, noise_level=5, **kw),
            get_physics(task=task, noise_level=5, device="cpu", **kw))


def _pair(jphys, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.random((B, 3, SIZE, SIZE)).astype(np.float32)
    y = (np.asarray(jphys.A(jnp.asarray(x)))
         + SIGMA * rng.standard_normal(x.shape).astype(np.float32)).astype(np.float32)
    return x, y


def _transform_draws(transforms, key, h, w):
    """The draws of the JAX package's EI transform under ``key``
    (``sei_tpu/transforms/__init__.py:132-161``)."""
    def rotate(k):
        return {"angle": torch.tensor(float(jax.random.randint(k, (), 1, 360)))}

    def shift(k):
        kh, kw = jax.random.split(k)
        return {"shifts": torch.tensor([int(jax.random.randint(kh, (), 0, h)),
                                        int(jax.random.randint(kw, (), 0, w))])}

    if transforms == "Rotations":
        return rotate(key)
    if transforms == "Shifts":
        return shift(key)
    if transforms == "Rotations+Shifts":
        k1, k2 = jax.random.split(key, 2)
        return {**rotate(k1), **shift(k2)}
    if transforms == "Scaling_Transforms":  # the padded kind (the normal kind draws nothing)
        rates, _, centers = JaxScaling().sample_params(key, B)
        return {"rates": torch.from_numpy(np.array(rates)),
                "centers": torch.from_numpy(np.array(centers))}
    raise ValueError(transforms)


def _jax_draws(key, form, transforms, margin, y_shape, normal_rate=None):
    """Every draw of the JAX loss under ``key`` (no loss crop), as LossDraws."""
    h, w = y_shape[-2:]
    if form == "sure":
        k_sure, k_t = jax.random.split(key)
        probe = np.array(jax_sample_probe(k_sure, jnp.zeros(y_shape, jnp.float32), margin))
        d = {"probe": torch.from_numpy(probe)}
    else:  # r2r (sei_tpu/losses/r2r.py:56-69)
        k_r2r, k1, k2, k_t = jax.random.split(key, 4)
        out = (h if normal_rate is None else int(h * normal_rate),
               w if normal_rate is None else int(w * normal_rate))
        d = {"pert": torch.from_numpy(np.array(jax.random.normal(k_r2r, y_shape) * SIGMA)),
             "eps1": torch.from_numpy(np.array(0.5 * SIGMA * jax.random.normal(k1, y_shape))),
             "eps2": torch.from_numpy(np.array(1.5 * SIGMA * jax.random.normal(
                 k2, (*y_shape[:2], *out))))}
    if normal_rate is None:
        d.update(_transform_draws(transforms, k_t, h, w))
    return LossDraws(**d)


def _value_and_grads(model, loss_fn, x, y, draws):
    module = model.module.train()
    module.zero_grad()
    loss = loss_fn(torch.from_numpy(x), torch.from_numpy(y), module, None, draws)
    loss.backward()
    module.eval()
    return loss.item(), {n: p.grad.clone() for n, p in module.named_parameters()}


def _check(jmodel, model, jloss, loss_fn, x, y, draws, grad_rtol):
    key = jax.random.PRNGKey(17)

    def jax_value(params):
        return jloss(key, jnp.asarray(x), jnp.asarray(y), lambda im: jmodel.apply_fn(params, im))

    want, jgrads = jax.jit(jax.value_and_grad(jax_value))(jmodel.params)
    got, grads = _value_and_grads(model, loss_fn, x, y, draws)
    assert got == pytest.approx(float(want), rel=1e-5)
    want_sd = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(grads) == set(want_sd)
    for k, g in want_sd.items():
        rel = float((grads[k] - g).abs().max()) / max(float(g.abs().max()), 1e-6)
        assert rel <= grad_rtol, (k, rel)


def test_supervised_l1_matches_jax(tiny_models):
    jmodel, model = tiny_models
    jphys, phys = _physics("deblurring")
    x, y = _pair(jphys)
    kw = dict(method="supervised", supervised_l1=True, crop_training_pairs=False)
    _check(jmodel, model, jax_get_loss(physics=jphys, **kw), get_loss(physics=phys, **kw),
           x, y, LossDraws(), 1e-5)
    # without the flag supervised is MSE, and CSS and noise2inverse are MSE
    # with it too
    mse = get_loss(physics=phys, method="supervised", crop_training_pairs=False)
    f = lambda im: 0.9 * im  # noqa: E731
    want = mse(torch.from_numpy(x), torch.from_numpy(y), f).item()
    assert want == pytest.approx(float(np.mean((0.9 * y - x) ** 2)), rel=1e-6)
    for method in ("css", "noise2inverse"):
        fn = get_loss(physics=phys, method=method, supervised_l1=True, crop_training_pairs=False)
        assert fn(torch.from_numpy(x), torch.from_numpy(y), f).item() == want


@pytest.mark.parametrize("form,transforms", [("sure", "Rotations+Shifts"),
                                             ("r2r", "Rotations+Shifts"),
                                             ("sure", "Rotations"), ("r2r", "Shifts")])
def test_proposed_with_rotations_and_shifts_matches_jax(tiny_models, form, transforms):
    jmodel, model = tiny_models
    jphys, phys = _physics("deblurring")
    x, y = _pair(jphys)
    kw = dict(method="proposed", transforms=transforms, crop_training_pairs=False,
              sure_alternative="r2r" if form == "r2r" else None)
    loss = get_loss(physics=phys, **kw)
    draws = _jax_draws(jax.random.PRNGKey(17), form, transforms, 6, y.shape)
    _check(jmodel, model, jax_get_loss(physics=jphys, **kw), loss, x, y, draws,
           2e-5 if form == "sure" else 1e-5)


@pytest.mark.parametrize("form,rate", [("sure", 0.75), ("r2r", 0.5)])
def test_normal_rate_variants_match_jax(tiny_models, form, rate):
    jmodel, model = tiny_models
    jphys, phys = _physics("deblurring")
    x, y = _pair(jphys)
    kw = dict(method="proposed", scaling_kind="normal", fixed_normal_rate=rate,
              crop_training_pairs=False, sure_alternative="r2r" if form == "r2r" else None)
    draws = _jax_draws(jax.random.PRNGKey(17), form, None, 6, y.shape, normal_rate=rate)
    _check(jmodel, model, jax_get_loss(physics=jphys, **kw), get_loss(physics=phys, **kw),
           x, y, draws, 2e-5 if form == "sure" else 1e-5)


def test_ct_like_r2r_ei_matches_jax(tiny_models):
    jmodel, model = tiny_models
    jphys, phys = _physics("invert_a_tomography_like_filter")
    x, y = _pair(jphys)
    kw = dict(method="proposed", sure_alternative="r2r", crop_training_pairs=False)
    draws = _jax_draws(jax.random.PRNGKey(17), "r2r", "Scaling_Transforms", 0, y.shape)
    _check(jmodel, model, jax_get_loss(physics=jphys, **kw), get_loss(physics=phys, **kw),
           x, y, draws, 1e-5)


def test_method_aliases_match_jax():
    from sei_tpu.losses import normalize_method as jax_normalize

    for m in ("sup", "ei-shift", "ei-rotate", "css", "noise2inverse", "proposed"):
        assert normalize_method(m, "Scaling_Transforms") == jax_normalize(m, "Scaling_Transforms")


@pytest.fixture(scope="module")
def cache():
    jphys, phys = _physics("deblurring")
    rng = np.random.default_rng(1)
    images = [rng.random((3, h, w)).astype(np.float32) for h, w in ((40, 48), (36, 52), (48, 40))]
    return jphys, phys, build_device_cache(images, phys, seed=0)


@pytest.mark.parametrize("css,fresh", [(True, False), (False, True), (True, True)])
def test_css_and_fresh_batches_match_jax(cache, css, fresh):
    jphys, phys, c = cache
    idx, offsets, size = torch.tensor([2, 0]), torch.tensor([[3, 5], [0, 12]]), 32
    g = torch.Generator().manual_seed(7)
    x, y = sample_train_batch(c, idx, crop_size=size, offsets=offsets, physics=phys, css=css,
                              fresh_measurements=fresh, noise_generator=g)
    # the same noise, drawn again in the order the port draws it
    g = torch.Generator().manual_seed(7)
    xs, ys = c.x[idx].numpy(), c.y[idx].numpy()
    def degrade(v):
        return np.asarray(jphys.A(jnp.asarray(v))) + SIGMA * torch.randn(v.shape, generator=g).numpy()

    if fresh:
        ys = degrade(xs)
    if css:
        xs, ys = ys, degrade(ys)
    for b, (t, l) in enumerate(offsets.tolist()):
        for got, want in ((x, xs), (y, ys)):
            np.testing.assert_allclose(got[b].numpy(), want[b, :, t:t + size, l:l + size],
                                       atol=1e-6, rtol=0)


def test_css_with_sr_raises():
    phys = get_physics(task="sr", sr_factor=2, noise_level=5, device="cpu")
    images = [np.random.default_rng(0).random((3, 32, 32)).astype(np.float32)]
    c = build_device_cache(images, phys, seed=0)
    with pytest.raises(ValueError, match="css with sr"):
        sample_train_batch(c, torch.tensor([0]), crop_size=8, physics=phys, css=True,
                           generator=torch.Generator())


TINY_TRAIN = OVERRIDES


def _trainer(loss_fn, **kw):
    """A tiny SwinIR on 4 images of 40x40, batch 2, 32 px dataset crops."""
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    rng = np.random.default_rng(3)
    images = [rng.random((3, 40, 40)).astype(np.float32) for _ in range(4)]
    model = get_model(device="cpu", swinir_overrides=TINY_TRAIN)
    return Trainer(model, loss_fn, phys, build_device_cache(images, phys, seed=0), batch_size=2,
                   epochs=2, crop_size=32, seed=0, **kw)


def test_normal_variant_sequence_matches_the_jax_trainer(monkeypatch):
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    losses = [get_loss(method="proposed", physics=phys, crop_size=32, scaling_kind="normal",
                       fixed_normal_rate=r) for r in (0.75, 0.5)]
    tr = _trainer(losses[0], normal_rate_losses=losses)
    stats = tr.train(log_every_epoch=False)
    assert stats["steps"] == 4 and np.all(np.isfinite(stats["epoch_losses"]))
    # the JAX trainer's own loop, its step stubbed to record the variant
    from sei_tpu.data import DeviceDataCache as JaxCache
    from sei_tpu.train.trainer import Trainer as JaxTrainer

    jphys = jax_get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    jmodel = jax_get_model(kind="Proposed", task="deblurring", swinir_overrides=TINY_TRAIN)
    z = jnp.zeros((4, 3, 32, 32))
    jcache = JaxCache(x=z, y=z, heights=jnp.full((4,), 32), widths=jnp.full((4,), 32),
                      ids=jnp.arange(4), rate=1)
    jt = JaxTrainer(model=jmodel, loss_fn=None, physics=jphys, cache=jcache, batch_size=2,
                    epochs=2, normal_rate_losses=[None, None])
    seen = []

    def get_step(variant):
        seen.append(variant)
        return lambda state, cache, key: (state, jnp.zeros(()))

    monkeypatch.setattr(jt, "_get_step", get_step)
    jt.train(log_every_epoch=False)
    assert tr.variants == seen and len(seen) == 4 and set(seen) == {0, 1}
    # a second train() starts the sequence again, as the JAX trainer's does
    tr.epochs = 3
    tr.start_epoch = 2
    tr.train(log_every_epoch=False)
    assert tr.variants[4:] == seen[:2]


@pytest.mark.parametrize("mode", ["css", "fresh", "ei-rotate"])
def test_trainer_modes_train_on_cpu(mode):
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    method, transforms = normalize_method("css" if mode == "css" else mode if mode != "fresh"
                                          else "proposed", "Scaling_Transforms")
    loss = get_loss(method=method, transforms=transforms, physics=phys, crop_size=16)
    tr = _trainer(loss, css=mode == "css", fresh_measurements=mode == "fresh")
    streams = make_streams(0, "cpu")
    noise_before = streams.noise.get_state()
    before = {k: v.clone() for k, v in tr.model.module.state_dict().items()}
    stats = tr.train(log_every_epoch=False)
    assert np.all(np.isfinite(stats["epoch_losses"]))
    after = tr.model.module.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    # the noise stream draws only where the step degrades
    moved = not torch.equal(tr.streams.noise.get_state(), noise_before)
    assert moved == (mode in ("css", "fresh"))
