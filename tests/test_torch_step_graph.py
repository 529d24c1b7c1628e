"""The training step as one dispatch, on the CPU: the pieces the captured
CUDA graph is built from, against the JAX package, and the dispatch loop.

* Device-side crops (one gather from a (B, 2) offset tensor) equal the
  slices of the images and JAX's ``crop_pair_batch`` (``lax.dynamic_slice``
  under ``vmap``) for the offsets JAX draws from its key (exact).
* The tensor LR schedules (a function of the int64 step counter) equal the
  float schedules rounded to f32 exactly, and the JAX package's optax
  schedules to rel 1e-5 (JAX computes its factor in f32).
* ``scan_steps`` is clamped by the JAX trainer's rule (``gcd`` with the
  steps per epoch), compared with the JAX ``Trainer`` itself.
* A tiny SwinIR trained with two steps per dispatch equals the same run
  with one step per dispatch (same streams), and a run resumed from the
  checkpoint after 2 of 3 epochs equals the uninterrupted 3-epoch run:
  parameters, Adam state, step counter and per-step losses, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.train.optim import get_lr_schedule as jax_schedule
from sei_tpu.train.trainer import Trainer as JaxTrainer
from sei_tpu.transforms.crop import crop_pair_batch as jax_crop_pair_batch
from sei_tpu_torch.data import build_device_cache
from sei_tpu_torch.losses import get_loss
from sei_tpu_torch.models import get_model
from sei_tpu_torch.physics import get_physics
from sei_tpu_torch.train import Trainer
from sei_tpu_torch.train.optim import get_lr_schedule, get_lr_schedule_tensor
from sei_tpu_torch.transforms import crop_pair_batch

OVERRIDES = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4)


def _jax_offsets(key, b, h, w, size):
    """The offsets ``crop_pair_batch`` draws: one key per image
    (``sei_tpu/transforms/crop.py:84-88``), split into row and column keys
    (:47-50)."""
    offs = []
    for k in jax.random.split(key, b):
        ki, kj = jax.random.split(k)
        offs.append((int(jax.random.randint(ki, (), 0, h - size + 1)),
                     int(jax.random.randint(kj, (), 0, w - size + 1))))
    return np.asarray(offs)


@pytest.mark.parametrize("size", [7, 24, 40])
def test_device_crops_match_slices_and_jax(size):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 3, 30, 36)).astype(np.float32)
    y = rng.standard_normal((4, 3, 30, 36)).astype(np.float32)
    key = jax.random.PRNGKey(size)
    jx, jy = jax_crop_pair_batch(jnp.asarray(x), jnp.asarray(y), size=size, key=key)
    xp = np.pad(x, ((0, 0), (0, 0), (0, max(0, size - 30)), (0, max(0, size - 36))))
    offsets = _jax_offsets(key, 4, xp.shape[2], xp.shape[3], size)
    gx, gy = crop_pair_batch(torch.from_numpy(x), torch.from_numpy(y), size=size,
                             offsets=torch.from_numpy(offsets))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jy))
    for b, (t, l) in enumerate(offsets):
        np.testing.assert_array_equal(gx[b].numpy(), xp[b, :, t:t + size, l:l + size])


@pytest.mark.parametrize("kind,epochs,spe", [("delayed_linear_decay", 10, 3),
                                             ("delayed_linear_decay", 3, 2),
                                             ("multi_step_decay", 20, 2),
                                             ("constant", 5, 1)])
def test_tensor_schedules_match_float_and_jax(kind, epochs, spe):
    want = jax_schedule(kind, 1e-4, epochs, spe)
    floats = get_lr_schedule(kind, 1e-4, epochs, spe)
    tensors = get_lr_schedule_tensor(kind, 1e-4, epochs, spe)
    for step in range(0, epochs * spe + 3):
        got = tensors(torch.tensor(step))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert got.item() == float(np.float32(floats(step))), step
        w = want(step) if callable(want) else want
        assert got.item() == pytest.approx(float(w), rel=1e-5, abs=1e-12), step


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("scan,images,batch", [(1, 8, 2), (2, 8, 2), (3, 8, 2), (4, 12, 2),
                                               (8, 12, 4), (5, 3, 8)])
def test_scan_steps_clamp_matches_jax(scan, images, batch):
    want = JaxTrainer(model=None, loss_fn=None, physics=None, cache=_Sized(images),
                      batch_size=batch, epochs=1, scan_steps=scan).scan_steps
    model = get_model(device="cpu", swinir_overrides=OVERRIDES)
    got = Trainer(model, None, None, _Sized(images), batch_size=batch, epochs=1,
                  scan_steps=scan).scan_steps
    assert got == want


@pytest.fixture(scope="module")
def setup():
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    rng = np.random.default_rng(1)
    images = [rng.random((3, 40, 44)).astype(np.float32) for _ in range(4)]
    cache = build_device_cache(images, phys, seed=0)
    return phys, cache, get_loss(method="proposed", physics=phys, crop_size=16)


def _run(setup, *, epochs=3, scan_steps=1, out_dir=None, resume=None, interval=50):
    phys, cache, loss_fn = setup
    model = get_model(device="cpu", swinir_overrides=OVERRIDES)
    tr = Trainer(model, loss_fn, phys, cache, batch_size=2, epochs=epochs, crop_size=24,
                 scan_steps=scan_steps, out_dir=out_dir, checkpoint_interval=interval)
    if resume is not None:
        tr.load_checkpoint(resume)
    losses = []
    tr.train(log_every_epoch=False, on_step=lambda s, loss: losses.append((s, loss.item())))
    return tr, losses


def _state(tr):
    opt = [v.clone() for s in tr.opt.state.values() for v in s.values()]
    return [p.detach().clone() for p in tr.model.module.parameters()] + opt + [tr.step_t.clone()]


def _assert_same(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_two_steps_per_dispatch_equal_one(setup):
    one, losses1 = _run(setup, epochs=2, scan_steps=1)
    two, losses2 = _run(setup, epochs=2, scan_steps=2)
    assert two.scan_steps == 2 and two.step_count == one.step_count == 4
    assert losses2 == losses1 and [s for s, _ in losses1] == [0, 1, 2, 3]
    _assert_same(_state(two), _state(one))


def test_resume_equals_the_uninterrupted_run(setup, tmp_path):
    full, losses = _run(setup, out_dir=str(tmp_path), interval=1)
    resumed, tail = _run(setup, resume=full.checkpoint_path(2))
    assert resumed.start_epoch == 2 and resumed.step_count == full.step_count == 6
    assert tail == losses[4:]
    _assert_same(_state(resumed), _state(full))
    assert int(resumed.step_t) == 6 and resumed.lr_t.item() == full.lr_t.item()
