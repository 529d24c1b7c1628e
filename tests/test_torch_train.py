"""Port training loop pieces vs the JAX package, and the Trainer (CPU).

* LR schedules per optimizer step against ``sei_tpu.train.optim``.
* Three Adam steps (and one SGD step) against optax directly, on the same
  numpy gradients, with the schedule changing the LR between steps (not
  against the trainer's flat-state path, whose own test fails on the
  reference: ROADMAP Queue 3).  Tolerance rtol 1e-5 / atol 1e-8: the same
  update in another f32 operation order (torch divides by
  sqrt(v) / sqrt(1 - b2^t) + eps, optax by sqrt(v / (1 - b2^t)) + eps).
* ``sample_train_batch`` given image indices and crop offsets, against numpy
  slicing of the padded cache; ``build_device_cache`` degradation.
* Drop-path draws from the generator handed down: the same seed gives the
  same masks.
* A ``Trainer`` on ``device="cpu"`` runs two steps of a tiny SwinIR: finite
  loss, every parameter moves, and the checkpoint loads back through
  ``get_model(...).load_weights``.
"""

import numpy as np
import optax
import pytest
import torch

from sei_tpu.train.optim import get_lr_schedule as jax_schedule
from sei_tpu_torch.data import build_device_cache, epoch_indices, image_seed, sample_train_batch
from sei_tpu_torch.losses import get_loss
from sei_tpu_torch.models import get_model
from sei_tpu_torch.models.swinir import RSTB, DropPath
from sei_tpu_torch.physics import get_physics
from sei_tpu_torch.rng import make_streams
from sei_tpu_torch.train import Trainer
from sei_tpu_torch.train.optim import get_lr_schedule, get_lr_schedule_tensor, get_optimizer

OVERRIDES = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4)


@pytest.mark.parametrize("kind,epochs,spe", [("delayed_linear_decay", 10, 3),
                                             ("delayed_linear_decay", 3, 2),
                                             ("multi_step_decay", 20, 2),
                                             ("multi_step_decay", 3, 4),
                                             ("constant", 5, 1)])
def test_lr_schedules_match_jax(kind, epochs, spe):
    want = jax_schedule(kind, 1e-4, epochs, spe)
    got = get_lr_schedule(kind, 1e-4, epochs, spe)
    for step in range(0, epochs * spe + 3):
        w = want(step) if callable(want) else want
        # rel 1e-5: the JAX schedule computes its factor in f32, the port in
        # Python floats (as torch's LinearLR does)
        assert got(step) == pytest.approx(float(w), rel=1e-5, abs=1e-12), step


def _optax_steps(tx, p0, grads):
    p = {"w": np.asarray(p0)}
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update({"w": g}, state, p)
        p = optax.apply_updates(p, updates)
    return np.asarray(p["w"])


@pytest.mark.parametrize("kind", ["Adam", "SGD"])
def test_optimizer_matches_optax(kind):
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal(p0.shape).astype(np.float32) for _ in range(3)]
    # the LR as the trainer feeds it: a tensor rewritten in place from the
    # tensor schedule of the step counter (it moves at step 3)
    schedule = get_lr_schedule_tensor("delayed_linear_decay", 1e-2, 4, 1)
    jsched = jax_schedule("delayed_linear_decay", 1e-2, 4, 1)
    tx = optax.adam(jsched, b1=0.9, b2=0.99) if kind == "Adam" else optax.sgd(jsched)
    want = _optax_steps(tx, p0, grads)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    lr = schedule(torch.tensor(0))
    opt = get_optimizer([w], kind=kind, lr=lr, beta2=0.99)
    for step, g in enumerate(grads):
        lr.copy_(schedule(torch.tensor(step)))
        w.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), want, rtol=1e-5, atol=1e-8)


@pytest.fixture(scope="module")
def cache():
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    rng = np.random.default_rng(1)
    images = [rng.random((3, h, w)).astype(np.float32) for h, w in ((40, 48), (36, 52), (48, 40))]
    return phys, images, build_device_cache(images, phys, seed=0)


def test_build_device_cache(cache):
    phys, images, c = cache
    assert c.x.shape == (3, 3, 48, 52) and c.y.shape == c.x.shape
    assert c.heights.tolist() == [40, 36, 48] and c.widths.tolist() == [48, 52, 40]
    np.testing.assert_array_equal(c.x[1, :, :36, :52].numpy(), images[1])
    assert torch.equal(build_device_cache(images, phys, seed=0).y, c.y)
    assert not torch.equal(build_device_cache(images, phys, seed=1).y, c.y)
    want = phys.randomly_degrade(c.x[2:3], image_seed(0, 2))
    assert torch.equal(c.y[2:3], want)
    noise = c.y - phys.A(c.x)
    assert float(noise.std()) == pytest.approx(phys.sigma, rel=0.05)


def test_sample_train_batch_given_indices_and_offsets(cache):
    _, _, c = cache
    idx = torch.tensor([2, 0])
    offsets = torch.tensor([[3, 5], [0, 12]])
    x, y = sample_train_batch(c, idx, crop_size=32, offsets=offsets)
    for b, (i, (t, l)) in enumerate(zip(idx.tolist(), offsets.tolist())):
        np.testing.assert_array_equal(x[b].numpy(), c.x[i, :, t:t + 32, l:l + 32].numpy())
        np.testing.assert_array_equal(y[b].numpy(), c.y[i, :, t:t + 32, l:l + 32].numpy())
    # MinSizePadding: a crop larger than the images pads them bottom/right
    x, y = sample_train_batch(c, torch.tensor([1]), crop_size=56, offsets=torch.tensor([[0, 0]]))
    assert x.shape == (1, 3, 56, 56) and float(y[0, :, 48:].abs().sum()) == 0.0
    # offsets drawn from the crop stream, on the cache's device, stay inside
    # each image's true region
    g = make_streams(0, c.x.device).crop
    assert g.device == c.x.device and c.heights.device == c.x.device
    for _ in range(20):
        before = g.get_state()
        x, _ = sample_train_batch(c, torch.tensor([1], device=c.x.device), crop_size=32,
                                  generator=g)
        assert float(x.abs().sum()) > 0 and not torch.equal(g.get_state(), before)


def test_epoch_indices_visit_every_image():
    perm = torch.randperm(10, generator=torch.Generator().manual_seed(0))
    seen = torch.cat([epoch_indices(perm, s, 3) for s in range(3)])
    assert len(set(seen.tolist())) == 9
    assert epoch_indices(perm, 0, 12).tolist()[:10] == perm.tolist()  # wraps past n


def test_drop_path_masks_follow_the_generator():
    rstb = RSTB(16, 4, 2, 4, 2.0, drop_paths=(0.1, 0.2, 0.3, 0.4)).train()
    a = rstb._drop_path_masks(8, "cpu", torch.Generator().manual_seed(5))
    b = rstb._drop_path_masks(8, "cpu", torch.Generator().manual_seed(5))
    c = rstb._drop_path_masks(8, "cpu", torch.Generator().manual_seed(6))
    assert a.shape == (4, 2, 8) and torch.equal(a, b) and not torch.equal(a, c)
    keep = torch.tensor(0.6)
    assert torch.all((a[3] == 0) | (a[3] == 1 / keep))  # 0 or 1/keep, nothing else
    dp = DropPath(0.5).train()
    x = torch.ones(16, 3)
    assert torch.equal(dp(x, torch.Generator().manual_seed(1)), dp(x, torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError, match="Generator"):
        rstb._drop_path_masks(8, "cpu")
    with pytest.raises(ValueError, match="Generator"):
        dp(x)
    assert torch.equal(rstb.eval()._drop_path_masks(8, "cpu"), torch.ones(4, 2, 8))


def test_trainer_two_steps_on_cpu(cache, tmp_path):
    phys, images, _ = cache
    c = build_device_cache(images + images[:1], phys, seed=0)
    model = get_model(device="cpu", swinir_overrides=OVERRIDES)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    loss_fn = get_loss(method="proposed", physics=phys, crop_size=24)
    tr = Trainer(model, loss_fn, phys, c, batch_size=2, epochs=1, crop_size=32,
                 out_dir=str(tmp_path), checkpoint_interval=1)
    losses = []
    stats = tr.train(on_step=lambda s, loss: losses.append(float(loss)), log_every_epoch=False)
    assert stats["steps"] == 2 and len(losses) == 2 and np.all(np.isfinite(losses))
    after = model.module.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert (tmp_path / "training.csv").read_text().splitlines()[0] == "Epoch,Training Loss"
    loaded = get_model(device="cpu", swinir_overrides=OVERRIDES)
    loaded.load_weights(torch.load(tr.checkpoint_path(1), weights_only=False))
    assert all(torch.equal(loaded.module.state_dict()[k], after[k]) for k in after)
    first = get_model(device="cpu", swinir_overrides=OVERRIDES)
    first.load_weights(torch.load(tr.checkpoint_path(0), weights_only=False))
    assert all(torch.equal(first.module.state_dict()[k], before[k]) for k in before)
