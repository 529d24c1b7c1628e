"""The port's SR task vs the JAX package's (CPU).

The same numpy inputs, weights and draws go through ``sei_tpu`` and
``sei_tpu_torch``.  Tolerances, each stated where it is checked:

* SR physics: ``A`` (the antialiased resize by 1 / rate), the true adjoint
  and the deprecated adjoint (a plain bicubic upsample) at rtol 1e-5 /
  atol 1e-6; the adjoint identity ``<A x, y> = <x, A^T y>`` to 1e-5
  relative; ``A_dagger`` (50 CG steps) to 1e-4 of its largest value.
* The pixelshuffle head at x2, x3 and x4 (a small SwinIR, the JAX params
  carried across by ``models/torch_io``): rtol = atol = 1e-4, as
  ``tests/test_torch_swinir.py``; ``Upsample`` against
  ``sei_tpu.models.baselines.upsample_model`` at 1e-5 / 1e-6.
* Data: the device cache's padding, true sizes and measurements (noise 0)
  against ``sei_tpu.data.build_device_cache`` (sizes exact, y 1e-5), the
  homogeneous cache's upsampled y (1e-5), and the ratio crops at given
  offsets against ``sei_tpu.transforms.crop`` (exact).
* Losses: ``proposed`` with SURE (with and without ``sure_rate_hotfix`` and
  ``partial_sure_sr``) and R2R-EI on an SR x2 SwinIR, the port given the
  JAX package's draws: the loss to 1e-5 relative, every gradient to 1e-4 of
  its largest entry; the scaling transform at the x2 estimate's 96 px.
* End to end: a tiny SR x2 SwinIR trained one epoch by ``python -m
  sei_tpu_torch.cli.train --device cpu --task sr``, then scored at noise 0
  by ``demo/test.py`` (run in this process, so its compilations use the
  tests' JAX cache) and by ``cli.test``: the same ``PSNR:``/``SSIM:`` to
  0.01 dB and 1e-4; ``Upsample`` on the command line against the JAX
  package's upsample and metrics (1e-3 dB, 1e-5); ``cli.generate_dataset --task sr`` writes the JAX
  package's A(x).
"""

import os
import re
import runpy
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.data import FolderDataset as JaxFolderDataset
from sei_tpu.data import build_device_cache as jax_build_device_cache
from sei_tpu.data.loader import read_image as jax_read_image
from sei_tpu.losses import get_loss as jax_get_loss
from sei_tpu.losses.r2r import r2r_ei_loss as jax_r2r_ei
from sei_tpu.losses.sure import sample_probe as jax_sample_probe
from sei_tpu.metrics import compute_metrics as jax_metrics
from sei_tpu.metrics import quantize_and_clamp as jax_quantize
from sei_tpu.models import swinir_config as jax_swinir_config
from sei_tpu.models.baselines import upsample_model as jax_upsample_model
from sei_tpu.models.torch_io import flax_swinir_to_torch
from sei_tpu.ops.scaling import padded_scaling_transform as jax_scaling
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu.transforms import ScalingTransform as JaxScaling
from sei_tpu.transforms.crop import crop_pair as jax_crop_pair
from sei_tpu_torch.cli import generate_dataset as cli_generate
from sei_tpu_torch.cli import test as cli_test
from sei_tpu_torch.cli import train as cli_train
from sei_tpu_torch.data import (GroundTruthDataset, build_device_cache, sample_train_batch,
                                write_image)
from sei_tpu_torch.evaluate import evaluate
from sei_tpu_torch.losses import LossDraws, compute_sure_margin, get_loss
from sei_tpu_torch.models import get_model, jax_params_to_state_dict, swinir_config
from sei_tpu_torch.models import swinir as tswinir
from sei_tpu_torch.ops.scaling import padded_scaling_transform
from sei_tpu_torch.physics import get_physics
from sei_tpu_torch.transforms import crop_offsets, crop_pair_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
CFG = dict(embed_dim=12, depths=(2,), num_heads=(2,), window_size=4)
SIGMA = 5.0 / 255.0
TINY = ["--SwinIR__embed_dim", "12", "--SwinIR__depths", "2", "--SwinIR__num_heads", "2",
        "--SwinIR__window_size", "4"]


def _x(seed, shape=(2, 3, 24, 36)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _physics(rate, **kw):
    return (jax_get_physics(task="sr", sr_factor=rate, noise_level=5, **kw),
            get_physics(task="sr", sr_factor=rate, noise_level=5, device="cpu", **kw))


@pytest.mark.parametrize("rate,antialias", [(2, True), (3, True), (4, True), (2, False)])
def test_sr_operators_match_jax(rate, antialias):
    jphys, phys = _physics(rate, antialias=antialias)
    tphys = get_physics(task="sr", sr_factor=rate, physics_true_adjoint=True,
                        antialias=antialias, device="cpu")
    jtphys = jax_get_physics(task="sr", sr_factor=rate, physics_true_adjoint=True,
                             antialias=antialias)
    x = _x(rate)
    y = np.array(jphys.A(jnp.asarray(x)))
    assert y.shape == (2, 3, 24 // rate, 36 // rate)
    np.testing.assert_allclose(phys.A(torch.from_numpy(x)).numpy(), y, rtol=RTOL, atol=ATOL)
    for p, jp in ((phys, jphys), (tphys, jtphys)):  # deprecated, then true adjoint
        got = p.A_adjoint(torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(got, np.asarray(jp.A_adjoint(jnp.asarray(y))),
                                   rtol=RTOL, atol=ATOL)
        assert got.shape == x.shape
    assert phys.sigma == jphys.sigma and phys.rate == rate and phys.kernel is None


@pytest.mark.parametrize("rate", [2, 3, 4])
def test_sr_true_adjoint_is_the_transpose(rate):
    phys = get_physics(task="sr", sr_factor=rate, physics_true_adjoint=True, device="cpu")
    x = torch.from_numpy(_x(10 + rate)).double()
    y = torch.from_numpy(_x(20 + rate, (2, 3, 24 // rate, 36 // rate))).double()
    lhs = float((phys.A(x) * y).sum())
    rhs = float((x * phys.A_adjoint(y)).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.parametrize("true_adjoint", [True, False])
def test_sr_dagger_matches_jax(true_adjoint):
    jphys, phys = _physics(2, physics_true_adjoint=true_adjoint)
    y = np.array(jphys.A(jnp.asarray(_x(7, (1, 3, 16, 20)))))
    want = np.asarray(jphys.A_dagger(jnp.asarray(y)))
    got = phys.A_dagger(torch.from_numpy(y)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)


def test_sr_task_needs_its_factor():
    with pytest.raises(ValueError, match="sr_factor"):
        get_physics(task="sr", device="cpu")


# ---- the pixelshuffle head ------------------------------------------------

def _flax_sr(rate, seed=0, homogeneous=False):
    """A small flax SR SwinIR and its params, perturbed so no leaf is
    trivially zero or one."""
    module = jax_swinir_config(task="sr", sr_factor=rate, homogeneous=homogeneous,
                               overrides=dict(CFG, drop_path_rate=0.0))
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 3, 16, 16)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32), params)
    return module, params


def _port_sr(rate, params, **kw):
    model = get_model(task="sr", sr_factor=rate, device="cpu",
                      swinir_overrides=dict(CFG, drop_path_rate=0.0), **kw)
    model.load_weights(params)
    return model


@pytest.mark.parametrize("rate", [2, 3, 4])
def test_sr_head_forward_matches_flax(rate):
    module, params = _flax_sr(rate)
    x = _x(30 + rate, (2, 3, 13, 18))  # not a multiple of the window: reflect pad
    want = np.asarray(jax.jit(lambda p, v: module.apply({"params": p}, v))(params, jnp.asarray(x)))
    assert want.shape == (2, 3, 13 * rate, 18 * rate)
    model = _port_sr(rate, params)
    assert model.scale == rate
    # the JAX package's converter emits exactly the port's state_dict names
    assert set(flax_swinir_to_torch(params)) == set(model.module.state_dict())
    with torch.no_grad():
        for plain in (False, True):
            got = model.module(torch.from_numpy(x), plain=plain).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_sr_head_in_bf16_computes_in_bf16():
    """The head's convs take the compute dtype: a bf16 SR model's output is
    f32 (the mean added back promotes), close to the f32 model's."""
    _, params = _flax_sr(2, seed=1)
    f32 = _port_sr(2, params)
    bf16 = _port_sr(2, params, dtype=torch.bfloat16)
    assert all(m.compute_dtype == torch.bfloat16 for m in
               (bf16.module.conv_before_upsample[0], bf16.module.upsample[0],
                bf16.module.conv_last))
    x = torch.from_numpy(_x(5, (1, 3, 16, 16)))
    a, b = f32(x), bf16(x)
    assert b.dtype == torch.float32 and b.shape == a.shape == (1, 3, 32, 32)
    assert float((a - b).abs().max()) <= 5e-2


def test_homogeneous_swinir_has_no_head():
    cfg = swinir_config(task="sr", sr_factor=2, homogeneous=True, overrides=CFG)
    jmod = jax_swinir_config(task="sr", sr_factor=2, homogeneous=True)
    assert (cfg["upsampler"], cfg["upscale"]) == (jmod.upsampler, jmod.upscale) == (None, 1)
    model = get_model(task="sr", sr_factor=2, homogeneous_swinir=True, device="cpu",
                      swinir_overrides=CFG)
    assert model.scale == 1 and not hasattr(model.module, "upsample")
    with pytest.raises(ValueError, match="upscale 5"):
        tswinir.SwinIR(upsampler="pixelshuffle", upscale=5, **CFG)


@pytest.mark.parametrize("rate", [2, 3])
def test_upsample_matches_jax(rate):
    jphys, phys = _physics(rate)
    y = _x(40 + rate, (1, 3, 10, 14))
    want = np.asarray(jax_upsample_model(jphys, rate)(jnp.asarray(y)))
    model = get_model(kind="up", task="sr", sr_factor=rate, device="cpu")
    np.testing.assert_allclose(model(y).numpy(), want, rtol=RTOL, atol=ATOL)
    # the eval runs it at the measurement's own size (no pad bucket)
    x = _x(50 + rate, (3, 10 * rate + 1, 14 * rate))
    result = evaluate(model, phys, [x])
    assert len(result.psnr) == 1 and np.isfinite(result.psnr[0])


# ---- data -----------------------------------------------------------------

class _Gt:
    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def load_all(self):
        return self.images

    def unique_id(self, i):
        return i


@pytest.mark.parametrize("homogeneous", [False, True])
def test_sr_device_cache_matches_jax(homogeneous):
    jphys = jax_get_physics(task="sr", sr_factor=2, noise_level=0)
    phys = get_physics(task="sr", sr_factor=2, noise_level=0, device="cpu")
    images = [_x(60 + i, (3, h, w)) for i, (h, w) in enumerate([(17, 22), (20, 15), (13, 21)])]
    want = jax_build_device_cache(_Gt(images), jphys, base_key=jax.random.PRNGKey(0),
                                  deterministic=False, upsample_y_to_x=homogeneous)
    got = build_device_cache(images, phys, upsample_y_to_x=homogeneous)
    assert got.rate == want.rate == (1 if homogeneous else 2)
    assert got.x.shape == want.x.shape == (3, 3, 20, 22)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.heights.numpy(), np.asarray(want.heights))
    np.testing.assert_array_equal(got.widths.numpy(), np.asarray(want.widths))
    assert got.y.shape == want.y.shape == ((3, 3, 20, 22) if homogeneous else (3, 3, 10, 11))
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rate,size,hw", [(2, 6, (9, 11)), (3, 4, (7, 9)), (2, 12, (9, 11))])
def test_ratio_crops_match_jax(rate, size, hw):
    """y cropped ``size`` at the offsets, x ``size * rate`` at ``rate``
    times them, after MinSizePadding (the last case pads both)."""
    h, w = hw
    y = _x(70 + rate, (2, 3, h, w))
    x = _x(80 + rate, (2, 3, h * rate, w * rate))
    offsets = np.array([[max(h - size, 0) // 2, max(w - size, 0) // 2]] * 2)
    gx, gy = crop_pair_batch(torch.from_numpy(x), torch.from_numpy(y), size=size,
                             xy_size_ratio=rate, offsets=torch.from_numpy(offsets))
    for b in range(2):
        wx, wy = jax_crop_pair(jnp.asarray(x[b]), jnp.asarray(y[b]), size=size,
                               location="center", xy_size_ratio=rate)
        np.testing.assert_array_equal(gx[b].numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy[b].numpy(), np.asarray(wy))


def test_sr_training_batch_is_aligned():
    """``sample_train_batch`` on an SR cache: y crops drawn inside each
    image's true (h / rate, w / rate) region, x the aligned crop."""
    phys = get_physics(task="sr", sr_factor=2, noise_level=0, device="cpu")
    images = [_x(90 + i, (3, 20 + 2 * i, 24)) for i in range(4)]
    cache = build_device_cache(images, phys)
    idx = torch.tensor([3, 0, 2])
    gen = torch.Generator().manual_seed(0)
    offsets = torch.stack([torch.randint(0, 4, (3,), generator=gen)] * 2, 1)
    x, y = sample_train_batch(cache, idx, crop_size=8, offsets=offsets)
    assert x.shape == (3, 3, 16, 16) and y.shape == (3, 3, 8, 8)
    for b, (i, j) in enumerate(offsets.tolist()):
        k = int(idx[b])
        assert torch.equal(x[b], cache.x[k, :, 2 * i:2 * i + 16, 2 * j:2 * j + 16])
        assert torch.equal(y[b], cache.y[k, :, i:i + 8, j:j + 8])
    # drawn offsets: inside each image's true y region (h / 2 - 8, w / 2 - 8)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    drawn = crop_offsets(g2, cache.heights[idx] // 2, cache.widths[idx] // 2, 8)
    assert torch.all(drawn[:, 0] <= cache.heights[idx] // 2 - 8)
    assert torch.all(drawn[:, 1] <= cache.widths[idx] // 2 - 8)
    got = sample_train_batch(cache, idx, crop_size=8, generator=g1)
    want = sample_train_batch(cache, idx, crop_size=8, offsets=drawn)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---- losses ---------------------------------------------------------------

@pytest.fixture(scope="module")
def sr_models():
    module, params = _flax_sr(2, seed=2)
    jfwd = lambda p, img: module.apply({"params": p}, img)  # noqa: E731
    return jfwd, params, _port_sr(2, params)


@pytest.fixture(scope="module")
def sr_batch():
    """(x, y, crop offsets, the cropped pair) of a batch of 2: y 16 px, the
    loss crop 12 px of y and 24 px of x."""
    jphys, _ = _physics(2)
    rng = np.random.default_rng(9)
    x = rng.random((2, 3, 32, 32)).astype(np.float32)
    y = (np.asarray(jphys.A(jnp.asarray(x)))
         + SIGMA * rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
    crop = rng.integers(0, 5, (2, 2))
    yc = np.stack([y[b, :, i:i + 12, j:j + 12] for b, (i, j) in enumerate(crop)])
    xc = np.stack([x[b, :, 2 * i:2 * i + 24, 2 * j:2 * j + 24] for b, (i, j) in enumerate(crop)])
    return x, y.astype(np.float32), crop, xc, yc


def _check_grads(module, jgrads):
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(module.named_parameters())
    assert set(named) == set(want)
    for k, g in want.items():
        rel = np.abs(named[k].grad.numpy() - g.numpy()).max() / max(np.abs(g.numpy()).max(), 1e-6)
        assert rel <= 1e-4, (k, rel)


def _port_loss(model, loss_fn, x, y, draws):
    module = model.module.train()
    module.zero_grad()
    loss = loss_fn(torch.from_numpy(x), torch.from_numpy(y), module, None, draws)
    loss.backward()
    module.eval()
    return loss.item(), module


@pytest.mark.parametrize("hotfix,partial_sr", [(False, False), (True, True)])
def test_sr_proposed_loss_and_grads_match_jax(sr_models, sr_batch, hotfix, partial_sr):
    jfwd, params, model = sr_models
    x, y, crop, xc, yc = sr_batch
    jphys, phys = _physics(2)
    margin = compute_sure_margin(partial_sure=True, sure_margin=None, task="sr",
                                 partial_sure_sr=partial_sr)
    assert margin == (2 if partial_sr else 0)
    kw = dict(method="proposed", partial_sure_sr=partial_sr, sure_rate_hotfix=hotfix)
    jfn = jax_get_loss(physics=jphys, crop_training_pairs=False, **kw)
    key = jax.random.PRNGKey(4)

    def jax_loss(p):
        return jfn(key, jnp.asarray(xc), jnp.asarray(yc), lambda img: jfwd(p, img))

    want, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)
    # the JAX loss's draws: probe from k_sure (y's shape), scaling from k_t
    k_sure, k_t = jax.random.split(key)
    rates, _, centers = JaxScaling().sample_params(k_t, 2)
    d = dict(crop=crop, probe=jax_sample_probe(k_sure, jnp.asarray(yc), margin),
             rates=rates, centers=centers)
    draws = LossDraws(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})
    got, module = _port_loss(model, get_loss(physics=phys, crop_size=12, **kw), x, y, draws)
    assert got == pytest.approx(float(want), rel=1e-5)
    _check_grads(module, jgrads)


def test_sr_r2r_ei_loss_and_grads_match_jax(sr_models, sr_batch):
    jfwd, params, model = sr_models
    x, y, crop, xc, yc = sr_batch
    jphys, phys = _physics(2)
    key = jax.random.PRNGKey(12)

    def jax_loss(p):
        return jax_r2r_ei(key, jnp.asarray(yc), lambda img: jfwd(p, img), jphys.A, JaxScaling(),
                          sigma=SIGMA)

    want, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)
    k_r2r, k1, k2, kt = jax.random.split(key, 4)
    rates, _, centers = JaxScaling().sample_params(kt, 2)
    d = dict(crop=crop, pert=jax.random.normal(k_r2r, yc.shape) * SIGMA,
             eps1=0.5 * SIGMA * jax.random.normal(k1, yc.shape),
             eps2=1.5 * SIGMA * jax.random.normal(k2, yc.shape), rates=rates, centers=centers)
    draws = LossDraws(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})
    loss_fn = get_loss(method="proposed", physics=phys, crop_size=12, sure_alternative="r2r")
    got, module = _port_loss(model, loss_fn, x, y, draws)
    assert got == pytest.approx(float(want), rel=1e-5)
    _check_grads(module, jgrads)


def test_scaling_transform_at_the_x2_estimates_size():
    """SR x2 with 48 px crops gives 96 px estimates: the (default, not
    antialiased) scaling transform there against the JAX package's (1e-5)."""
    rng = np.random.default_rng(11)
    x = rng.random((2, 3, 96, 96)).astype(np.float32)
    rates = np.array([0.75, 0.5], np.float32)
    centers = (2 * rng.random((2, 2)) - 1).astype(np.float32)
    want = np.asarray(jax.jit(jax_scaling)(*map(jnp.asarray, (x, rates, centers))))
    got = padded_scaling_transform(*map(torch.from_numpy, (x, rates, centers)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---- command lines --------------------------------------------------------

@pytest.fixture(scope="module")
def sr_run(tmp_path_factory):
    """8 PNGs of 48x56 (40x46 after the shorter-side resize); a tiny SR x2
    SwinIR trained one epoch of 2 steps on the CPU by the command line."""
    root = tmp_path_factory.mktemp("sr_cli")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:56]
    for i in range(8):
        smooth = 0.5 + 0.4 * np.sin(yy / (3.0 + i) + rng.random() * 6)[None] * np.cos(xx / 5.0)[None]
        write_image(str(root / "gt" / f"{i}.png"), smooth * rng.random((3, 1, 1)))
    data = ["--dataset", f"gt_folder:{root / 'gt'}", "--GroundTruthDataset__size", "40"]
    out = root / "run"
    argv = ["--device", "cpu", "--task", "sr", "--sr_factor", "2", "--method", "proposed", *data,
            *TINY, "--epochs", "1", "--batch_size", "4", "--Loss__crop_size", "12",
            "--out_dir", str(out)]
    result = cli_train.main(argv)
    return types.SimpleNamespace(root=root, data=data, out=out, argv=argv, result=result)


def _metrics(text):
    return {k: float(re.search(rf"^{k}: ([-0-9.]+)$", text, re.M).group(1))
            for k in ("N", "PSNR", "SSIM")}


def test_sr_train_takes_the_sr_crops(sr_run):
    trainer = sr_run.result["trainer"]
    assert trainer.crop_size == 12 and trainer.cache.rate == 2
    assert trainer.model.scale == 2 and float(trainer.lr_t) > 0
    x, y = trainer.batch(0)
    assert x.shape == (4, 3, 24, 24) and y.shape == (4, 3, 12, 12)
    assert len(sr_run.result["losses"]) == 2
    assert np.all(np.isfinite([float(v) for v in sr_run.result["losses"]]))
    assert (sr_run.out / "weights.pt").is_file()


def test_jax_and_port_score_the_sr_weights_alike(sr_run, capsys, monkeypatch):
    argv = ["--device", "cpu", "--task", "sr", "--sr_factor", "2", "--noise_level", "0",
            *sr_run.data, *TINY, "--weights", str(sr_run.out / "weights.pt")]
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["demo/test.py", *argv])
    runpy.run_path(os.path.join(REPO, "demo", "test.py"), run_name="__main__")
    want = _metrics(capsys.readouterr().out)
    result = cli_test.main(argv)
    printed = capsys.readouterr().out
    got = _metrics(printed)
    assert got["N"] == want["N"] == 8 == len(result.psnr)
    assert abs(got["PSNR"] - want["PSNR"]) <= 0.01 and abs(got["SSIM"] - want["SSIM"]) <= 1e-4


@pytest.mark.parametrize("flags", [
    ["--sure_rate_hotfix", "--partial_sure_sr", "--physics_true_adjoint"],
    ["--homogeneous_swinir", "--method", "supervised", "--no-Loss__crop_training_pairs"],
])
def test_sr_flags_train(sr_run, tmp_path, flags):
    """The SR flags reach the physics, loss, model and data as in
    ``demo/train.py``: the rate hotfix and the SR SURE margin, the true
    adjoint; the homogeneous SwinIR (no head, rate-1 cache of upsampled
    measurements, 48 px crops), trained as the JAX package can train it:
    supervised on the dataset crops (its loss crop takes the SR ratio, and
    SURE compares A(f(y)) with the upsampled y: both fail on shapes)."""
    result = cli_train.main(sr_run.argv[:-2] + ["--out_dir", str(tmp_path / "r"), *flags])
    trainer = result["trainer"]
    assert np.all(np.isfinite([float(v) for v in result["losses"]]))
    if "--homogeneous_swinir" in flags:
        assert trainer.model.scale == 1 and trainer.cache.rate == 1
        assert trainer.crop_size == 48 and trainer.cache.y.shape == trainer.cache.x.shape
    else:
        assert trainer.physics.true_adjoint
        assert [float(v) for v in result["losses"]] != \
            [float(v) for v in sr_run.result["losses"]]


def test_upsample_scores_alike_on_the_command_line(sr_run, capsys):
    """``cli.test --model_kind Upsample``: each pair scored at its own size,
    equal to the JAX package's upsample of the same measurement."""
    capsys.readouterr()
    result = cli_test.main(["--device", "cpu", "--task", "sr", "--sr_factor", "2",
                            "--noise_level", "0", *sr_run.data, "--model_kind", "Upsample",
                            "--indices", "0,5"])
    assert len(result.psnr) == 2 and "PSNR:" in capsys.readouterr().out
    jphys = jax_get_physics(task="sr", sr_factor=2, noise_level=0)
    gt = GroundTruthDataset(sr_run.data[1], size=40)
    for n, i in enumerate((0, 5)):
        x = jnp.asarray(gt[i])
        y = jphys.A(x[None])
        x_hat = jax_quantize(jax_upsample_model(jphys, 2)(y))[0]
        p, s, _ = jax_metrics(jax_quantize(x[..., : y.shape[-2] * 2, : y.shape[-1] * 2]), x_hat)
        assert abs(result.psnr[n] - float(p)) <= 1e-3 and abs(result.ssim[n] - float(s)) <= 1e-5


def test_generate_dataset_writes_the_sr_measurements(sr_run, tmp_path):
    out = tmp_path / "lr"
    n = cli_generate.main(["--device", "cpu", "--task", "sr", "--sr_factor", "2",
                           "--noise_level", "0", str(sr_run.root / "gt"), str(out)])
    assert n == 8
    jphys = jax_get_physics(task="sr", sr_factor=2, noise_level=0)
    src = JaxFolderDataset(str(sr_run.root / "gt"))
    for i in range(n):
        want = np.asarray(jphys.A(jnp.asarray(src.load(i))[None])[0])
        want = np.clip(want * 255.0 + 0.5, 0, 255).astype(np.uint8)
        got = np.round(jax_read_image(str(out / src.basename(i))) * 255.0).astype(np.uint8)
        assert got.shape == want.shape == (3, 24, 28)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
