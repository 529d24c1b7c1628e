"""The global-norm gradient clip (``Trainer(clip_norm=...)``, ``SEI_CLIP``)
against optax (CPU).

* ``optim.clip_by_global_norm_`` against ``optax.clip_by_global_norm`` on
  the same gradients, above and below the norm, to rtol 1e-6 (the norm's
  sums run in another order); below it the gradients stay bit for bit.
* Three ``Trainer`` steps of a tiny SwinIR with the clip: the gradients
  each step hands to the clip (recorded before it) go through
  ``optax.chain(optax.clip_by_global_norm(c), <the JAX optimizer>)`` from
  the same starting weights.  The gradients the trainer's optimizer got
  equal optax's clipped ones to rtol 1e-6; the parameters agree to
  ``tests/test_torch_train.py``'s Adam bound, rtol 1e-5 / atol 1e-8: optax
  takes Adam's bias corrections ``1 - b^t`` in f32 (``1 - 0.999`` is off
  by 1.3e-5 there) and PyTorch in f64, so each update differs by ~6e-6 of
  itself, which a weight that three updates carry towards zero shows at
  1e-4 of its value.  Cases: clipped, below the norm (untouched), and with
  a ``trainable_mask`` (the clip's norm over every gradient, frozen ones
  included, as the JAX chain puts it outside the masked optimizer; frozen
  tensors stay bit for bit).
* ``SEI_CLIP`` reaches the trainer when ``clip_norm`` is not given.

The captured clipped step against the eager one, bit for bit, is a GPU
test (``tests/test_torch_gpu.py::test_captured_variants_equal_eager``).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sei_tpu.train.optim import get_lr_schedule as jax_get_lr_schedule
from sei_tpu.train.optim import get_optimizer as jax_get_optimizer
from sei_tpu_torch.data import build_device_cache
from sei_tpu_torch.losses import get_loss
from sei_tpu_torch.models import get_model
from sei_tpu_torch.physics import get_physics
from sei_tpu_torch.train import Trainer
from sei_tpu_torch.train import trainer as trainer_module
from sei_tpu_torch.train.optim import clip_by_global_norm_, trainable_mask

OVERRIDES = dict(embed_dim=12, depths=(2,), num_heads=(2,), window_size=4)
SHAPES = [(3, 5), (7,), (2, 3, 4), (1,)]


@pytest.mark.parametrize("factor", [0.5, 2.0], ids=["clipped", "below_the_norm"])
def test_clip_matches_optax(factor):
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads)))
    c = factor * norm
    tx = optax.clip_by_global_norm(c)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(grads))
    got = [torch.from_numpy(g.copy()) for g in grads]
    got_norm = clip_by_global_norm_(got, c)
    assert float(got_norm) == pytest.approx(norm, rel=1e-6)
    for a, b, g in zip(got, want, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
        if factor > 1:
            assert np.array_equal(a.numpy(), g)


def _images(n):
    rng = np.random.default_rng(1)
    return [rng.random((3, 40, 48)).astype(np.float32) for _ in range(n)]


def _run(clip_norm, masked, monkeypatch):
    """Three steps (6 images, batch 2, one epoch) with the clip; returns the
    names, the starting and final parameters, the gradients each step
    handed to the clip and those it handed on, and the trainer."""
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    cache = build_device_cache(_images(6), phys, seed=0)
    model = get_model(device="cpu", swinir_overrides=OVERRIDES)
    names = [n for n, _ in model.module.named_parameters()]
    start = {n: p.detach().numpy().copy() for n, p in model.module.named_parameters()}
    seen, clipped = [], []

    def spy(grads, max_norm):
        before = [g.detach().clone() for g in grads]
        seen.append(before)
        norm = clip_by_global_norm_(grads, max_norm)
        clipped.append([g.detach().clone() for g in grads])
        if float(norm) < max_norm:  # below the norm: untouched
            assert all(torch.equal(a, b) for a, b in zip(grads, before))
        return norm

    monkeypatch.setattr(trainer_module, "clip_by_global_norm_", spy)
    mask = trainable_mask(model.module) if masked else None
    tr = Trainer(model, get_loss(method="proposed", physics=phys, crop_size=24), phys, cache,
                 batch_size=2, epochs=1, crop_size=32, clip_norm=clip_norm, trainable_mask=mask)
    tr.train(log_every_epoch=False)
    assert len(seen) == 3 and all(len(g) == len(names) for g in seen)
    final = {n: p.detach().numpy() for n, p in model.module.named_parameters()}
    as_dicts = [[dict(zip(names, (g.numpy() for g in gs))) for gs in run] for run in (seen, clipped)]
    return names, start, final, *as_dicts, tr


@pytest.mark.parametrize("clip_norm,masked", [(1e-3, False), (1e6, False), (1e-3, True)],
                         ids=["clipped", "below_the_norm", "clipped_masked"])
def test_clipped_adam_matches_the_optax_chain(clip_norm, masked, monkeypatch):
    names, start, final, grads, clipped, tr = _run(clip_norm, masked, monkeypatch)
    mask = tr.trainable_mask
    schedule = jax_get_lr_schedule("delayed_linear_decay", tr.lr, tr.epochs, tr.steps_per_epoch)
    tx = optax.chain(optax.clip_by_global_norm(clip_norm),
                     jax_get_optimizer(kind="Adam", lr_schedule=schedule, beta2=tr.beta2,
                                       trainable_mask=mask))
    params = {n: jnp.asarray(v) for n, v in start.items()}
    state = tx.init(params)
    clip = optax.clip_by_global_norm(clip_norm)
    for g, handed_on in zip(grads, clipped):
        g = {n: jnp.asarray(v) for n, v in g.items()}
        want, _ = clip.update(g, clip.init(g))
        for n in names:
            np.testing.assert_allclose(handed_on[n], np.asarray(want[n]), rtol=1e-6, atol=0,
                                       err_msg=n)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    norms = [np.sqrt(sum(np.sum(v.astype(np.float64) ** 2) for v in g.values())) for g in grads]
    assert all((n > clip_norm) == (clip_norm < 1) for n in norms)
    for n in names:
        np.testing.assert_allclose(final[n], np.asarray(params[n]), rtol=1e-5, atol=1e-8,
                                   err_msg=n)
        if mask is not None and not mask[n]:
            assert np.array_equal(final[n], start[n])
    if mask is not None:
        assert sum(mask.values()) == 2 and all(not np.array_equal(final[n], start[n])
                                               for n in names if mask[n])


@pytest.mark.parametrize("env,given,want", [(None, None, None), ("0.5", None, 0.5),
                                            ("", None, None), ("0.5", 2.0, 2.0)])
def test_sei_clip_reaches_the_trainer(env, given, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("SEI_CLIP", raising=False)
    else:
        monkeypatch.setenv("SEI_CLIP", env)
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    cache = build_device_cache(_images(2), phys, seed=0)
    tr = Trainer(get_model(device="cpu", swinir_overrides=OVERRIDES),
                 get_loss(method="proposed", physics=phys, crop_size=24), phys, cache,
                 batch_size=2, epochs=1, crop_size=32, clip_norm=given)
    assert tr.clip_norm == want
