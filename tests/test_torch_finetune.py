"""Fine-tuning against the JAX package's (CPU).

* ``weights_distance_loss`` on a tiny SwinIR's parameters against the JAX
  package's on the same trees: 1e-6 relative (the tensors are summed in
  another order than the JAX tree's leaves).
* ``trainable_mask`` marks ``conv_last`` only, as ``demo/train.py``'s mask
  does; one masked SGD step (the port's optimizer over the masked
  parameters) against optax's ``masked`` + ``set_to_zero`` chain on the
  same gradients: every frozen parameter bit for bit, the trained ones to
  1e-7 relative.
* ``build_finetuning_cache`` on a folder of PNGs equals ``demo/train.py``'s
  (the same crops from the same numpy generator).
* The trainer on the CPU with SGD, the mask and the distance term: only
  ``conv_last`` moves, the others stay bit for bit, and the first step's
  loss is the plain loss plus the distance (0 at the starting weights).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.losses import weights_distance_loss as jax_weights_distance
from sei_tpu.models import get_model as jax_get_model
from sei_tpu.train.optim import get_optimizer as jax_get_optimizer
from sei_tpu_torch.data import build_finetuning_cache, write_image
from sei_tpu_torch.losses import get_loss, weights_distance_loss
from sei_tpu_torch.models import get_model, jax_params_to_state_dict
from sei_tpu_torch.physics import get_physics
from sei_tpu_torch.train import Trainer
from sei_tpu_torch.train.optim import get_optimizer, trainable_mask

OVERRIDES = dict(embed_dim=8, depths=(1,), num_heads=(2,), window_size=4, drop_path_rate=0.0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trees():
    """A tiny SwinIR's JAX params, a perturbed copy, and both as the port's
    parameter tensors in module order."""
    jmodel = jax_get_model(kind="Proposed", task="deblurring", swinir_overrides=OVERRIDES)
    rng = np.random.default_rng(0)
    base = jax.tree_util.tree_map(np.asarray, jmodel.params)
    moved = jax.tree_util.tree_map(
        lambda v: (v + 0.03 * rng.standard_normal(v.shape)).astype(np.float32), base)
    model = get_model(device="cpu", swinir_overrides=OVERRIDES)
    names = [n for n, _ in model.module.named_parameters()]
    sd_base, sd_moved = jax_params_to_state_dict(base), jax_params_to_state_dict(moved)
    return base, moved, [sd_moved[n] for n in names], [sd_base[n] for n in names], names


@pytest.mark.parametrize("lambd", [1.0, 0.25])
def test_weights_distance_matches_jax(trees, lambd):
    base, moved, params, pretrained, _ = trees
    want = float(jax_weights_distance(moved, base, lambd))
    got = weights_distance_loss(params, pretrained, lambd)
    assert got.dtype == torch.float32 and got.item() == pytest.approx(want, rel=1e-6)
    assert weights_distance_loss(pretrained, pretrained).item() == 0.0
    with pytest.raises(ValueError, match="frozen"):
        weights_distance_loss(params[:-1], pretrained)


def test_masked_sgd_step_matches_optax_masked(trees):
    base, _, _, _, names = trees
    model = get_model(device="cpu", swinir_overrides=OVERRIDES)
    model.load_weights(base)
    mask = trainable_mask(model.module)
    assert sorted(n for n, m in mask.items() if m) == ["conv_last.bias", "conv_last.weight"]
    jmask = jax.tree_util.tree_map_with_path(
        lambda path, _: any(getattr(p, "key", None) == "conv_last" for p in path), base)
    rng = np.random.default_rng(1)
    jgrads = jax.tree_util.tree_map(lambda v: rng.standard_normal(v.shape).astype(np.float32), base)
    tx = jax_get_optimizer(kind="SGD", lr_schedule=1e-2, trainable_mask=jmask)
    params = jax.tree_util.tree_map(jnp.asarray, base)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.tree_util.tree_map(lambda p, u: p + u, params, updates)))
    grads = jax_params_to_state_dict(jgrads)
    named = dict(model.module.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    opt = get_optimizer([p for n, p in named.items() if mask[n]], kind="SGD",
                        lr=torch.tensor(1e-2))
    for n, p in named.items():
        p.grad = grads[n].clone()
    opt.step()
    for n, p in named.items():
        if mask[n]:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-7, atol=0)
            assert not torch.equal(p, before[n])
        else:
            assert torch.equal(p, before[n]) and torch.equal(p.detach(), want[n])


def _demo_train():
    spec = importlib.util.spec_from_file_location("demo_train", os.path.join(REPO, "demo",
                                                                             "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """6 PNGs of measurements, two of them smaller than the 32 px crop."""
    root = tmp_path_factory.mktemp("predictors")
    rng = np.random.default_rng(2)
    for i, (h, w) in enumerate(((40, 48), (36, 36), (28, 44), (48, 30), (40, 40), (33, 39))):
        write_image(str(root / f"{i}.png"), rng.random((3, h, w)))
    return str(root)


def test_finetuning_cache_matches_demo_train(folder):
    want = _demo_train().build_finetuning_cache(folder, 32, np.random.default_rng(5))
    got = build_finetuning_cache(folder, 32, np.random.default_rng(5), device="cpu")
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    assert got.x.shape == got.y.shape and float(got.x.abs().sum()) == 0.0
    assert got.heights.tolist() == [32] * 6 == got.widths.tolist() and got.rate == 1


def test_trainer_fine_tunes_conv_last_only(folder):
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    cache = build_finetuning_cache(folder, 32, np.random.default_rng(0), device="cpu")
    model = get_model(device="cpu", swinir_overrides=OVERRIDES)
    loss = get_loss(method="proposed", physics=phys, crop_size=24)
    mask = trainable_mask(model.module)
    tr = Trainer(model, loss, phys, cache, batch_size=2, epochs=1, lr=1e-2, optimizer="SGD",
                 crop_size=32, seed=0, trainable_mask=mask, weights_distance_lambda=1.0)
    before = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    # the first step's loss: the plain loss (distance 0 at the start), on the
    # same batch and draws
    plain = Trainer(get_model(device="cpu", swinir_overrides=OVERRIDES), loss, phys, cache,
                    batch_size=2, epochs=1, lr=1e-2, optimizer="SGD", crop_size=32, seed=0)
    steps, plain_steps = [], []
    tr.train(log_every_epoch=False, on_step=lambda s, v: steps.append(float(v)))
    plain.train(log_every_epoch=False, on_step=lambda s, v: plain_steps.append(float(v)))
    assert steps[0] == plain_steps[0] and len(steps) == 3
    after = dict(model.module.named_parameters())
    for n, p in after.items():
        assert torch.equal(p, before[n]) != mask[n], n
    dist = weights_distance_loss(model.module.parameters(), before.values()).item()
    assert dist > 0.0
