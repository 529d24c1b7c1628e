"""Halo strip tiling and the tiled eval against the JAX package (CPU).

* ``sei_tpu_torch.parallel.tiling.tiled_apply`` against
  ``sei_tpu.parallel.tiling.tiled_apply`` on the same numpy inputs: a local
  model (two 5x5 convs, the same weights in both), whose receptive field the
  halo covers, so both equal the whole-image forward (1e-5: two conv
  implementations); the SR ``out_scale=2`` case (exact); the clamped last
  strip, which slides back and overlaps the strip before it.
* ``restore`` of a tiny SwinIR (weights carried across from the flax model)
  above a small ``eval_tile_height`` against ``demo/test.py``'s tiled apply
  (``tiled_apply`` of the jitted forward, strips unpadded) to 1e-5, the
  models' agreement; ``cli.test --eval_tile_height`` and ``demo/test.py``
  print the same PSNR and SSIM on the same image (0.01 dB, 1e-4).
* ``Identity`` and ``Upsample`` run whole above the tile height, as in
  ``demo/test.py``, equal to the JAX baselines (1e-5 / 1e-6).
* Noise2Inverse wraps the tiled restoration: each of its 4 forwards is one
  batch of strips.
* A process group of one rank (gloo) is the one-process path: the same
  bits, one forward of every strip, no collective.
"""

import os
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sei_tpu.models import get_model as jax_get_model
from sei_tpu.models.baselines import identity_model as jax_identity_model
from sei_tpu.models.baselines import upsample_model as jax_upsample_model
from sei_tpu.parallel.tiling import tiled_apply as jax_tiled_apply
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu_torch.cli import test as cli_test
from sei_tpu_torch.data import GroundTruthDataset, image_seed, write_image
from sei_tpu_torch.evaluate import (degraded_pair, eval_apply, evaluate_pairs, restore,
                                    tile_plan)
from sei_tpu_torch.models import get_model
from sei_tpu_torch.parallel.tiling import strips, tiled_apply
from sei_tpu_torch.physics import get_physics

OVERRIDES = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 200 rows at a tile height of 64: 4 strips of 50 rows, halo 64, windows of
# 178 rows starting at 0, 0, 22, 22
H, W, TILE = 200, 24, 64


def _local_models(seed, k=5, layers=2):
    """The same two-conv local model in both packages."""
    rng = np.random.default_rng(seed)
    kernels = [(rng.standard_normal((3, 3, k, k)) / (3 * k * k)).astype(np.float32)
               for _ in range(layers)]

    def jax_fn(x):
        for w in kernels:
            x = jax.lax.conv_general_dilated(x, jnp.asarray(w), (1, 1), "SAME",
                                             dimension_numbers=("NCHW", "OIHW", "NCHW"))
            x = jnp.tanh(x)
        return x

    def torch_fn(x):
        for w in kernels:
            x = torch.tanh(F.conv2d(x, torch.from_numpy(w), padding=k // 2))
        return x

    return jax_fn, torch_fn


@pytest.mark.parametrize("h,n_tiles,halo", [(63, 4, 8), (64, 8, 8), (100, 3, 6)])
def test_tiled_apply_matches_jax_for_a_local_model(h, n_tiles, halo):
    jax_fn, torch_fn = _local_models(h)
    y = np.random.default_rng(h).random((1, 3, h, 32)).astype(np.float32)
    want = np.asarray(jax_tiled_apply(jax_fn, jnp.asarray(y), n_tiles=n_tiles, halo=halo))
    got = tiled_apply(torch_fn, torch.from_numpy(y), n_tiles=n_tiles, halo=halo).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, torch_fn(torch.from_numpy(y)).numpy(), rtol=0, atol=1e-5)


def test_a_one_rank_group_is_the_one_process_path(tmp_path, monkeypatch):
    _, torch_fn = _local_models(64)
    y = torch.from_numpy(np.random.default_rng(64).random((1, 3, 64, 32)).astype(np.float32))
    want = tiled_apply(torch_fn, y, n_tiles=4, halo=8)
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}",
                                         rank=0, world_size=1)
    try:
        monkeypatch.setattr(torch.distributed, "all_gather", None)  # a call would raise
        seen = []
        got = tiled_apply(lambda t: seen.append(t.shape[0]) or torch_fn(t), y, n_tiles=4,
                          halo=8, group=torch.distributed.group.WORLD)
    finally:
        torch.distributed.destroy_process_group()
    assert seen == [4] and torch.equal(got, want)


def test_tiled_apply_sr_scale_matches_jax():
    def up2(x):
        return x.repeat_interleave(2, -1).repeat_interleave(2, -2)

    y = np.random.default_rng(2).random((1, 3, 48, 24)).astype(np.float32)
    want = jax_tiled_apply(lambda x: jnp.repeat(jnp.repeat(x, 2, -1), 2, -2), jnp.asarray(y),
                           n_tiles=3, halo=4, out_scale=2)
    got = tiled_apply(up2, torch.from_numpy(y), n_tiles=3, halo=4, out_scale=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), up2(torch.from_numpy(y)).numpy())


def test_last_strip_is_clamped_and_overlaps():
    strip, win, parts = strips(63, 4, 8)
    assert (strip, win) == (16, 32)
    # (window start, core offset in the window, core start)
    assert parts == [(0, 0, 0), (8, 8, 16), (24, 8, 32), (31, 16, 47)]
    with pytest.raises(ValueError, match="exceeds image height"):
        strips(20, 2, 8)
    with pytest.raises(ValueError, match="single image"):
        tiled_apply(lambda x: x, torch.zeros(2, 3, 64, 8), n_tiles=2, halo=4)
    assert tile_plan(H, TILE) == (4, 64) and tile_plan(1356) == (2, 64)
    assert strips(H, 4, 64)[1] == 178


@pytest.fixture(scope="module")
def models():
    jmodel = jax_get_model(kind="Proposed", task="deblurring", swinir_overrides=OVERRIDES)
    rng = np.random.default_rng(0)
    jmodel.params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v)
                              + 0.05 * rng.standard_normal(v.shape).astype(np.float32)),
        jmodel.params)
    model = get_model(device="cpu", swinir_overrides=OVERRIDES)
    model.load_weights(jax.tree_util.tree_map(np.asarray, jmodel.params))
    return jmodel, model


def test_tiny_swinir_tiled_eval_matches_demo_test(models):
    jmodel, model = models
    y = np.random.default_rng(5).random((1, 3, H, W)).astype(np.float32)
    fwd = jax.jit(lambda p, y: jmodel.apply_fn(p, y))
    n_tiles, halo = tile_plan(H, TILE)
    want = np.asarray(jax_tiled_apply(lambda t: fwd(jmodel.params, t), jnp.asarray(y),
                                      n_tiles=n_tiles, halo=halo))
    seen = []
    module = model.module
    hook = module.register_forward_pre_hook(lambda m, args: seen.append(tuple(args[0].shape)))
    try:
        got = restore(model, torch.from_numpy(y), eval_tile_height=TILE).numpy()
    finally:
        hook.remove()
    assert seen == [(4, 3, 178, W)]  # one forward of the unpadded strips
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # below the tile height nothing changes: padded to the bucket, whole
    whole = restore(model, torch.from_numpy(y)).numpy()
    assert whole.shape == got.shape and not np.array_equal(whole, got)


def _metrics(text):
    return {k: float(re.search(rf"^{k}: ([-0-9.]+)$", text, re.M).group(1))
            for k in ("N", "PSNR", "SSIM")}


def test_cli_test_tiles_as_demo_test(models, tmp_path, capsys, monkeypatch):
    _, model = models
    x = np.random.default_rng(6).random((3, H, W)).astype(np.float32)
    write_image(str(tmp_path / "gt" / "0.png"), x)
    weights = str(tmp_path / "w.pt")
    model.save_reference_format(weights)
    argv = ["--task", "deblurring", "--kernel", "Gaussian_R2", "--noise_level", "0",
            "--dataset", f"gt_folder:{tmp_path / 'gt'}", "--GroundTruthDataset__no_resize",
            "--SwinIR__embed_dim", "16", "--SwinIR__depths", "2", "2", "--SwinIR__num_heads",
            "2", "2", "--SwinIR__window_size", "4", "--weights", weights,
            "--eval_tile_height", str(TILE)]
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["demo/test.py", "--device", "cpu", *argv])
    runpy.run_path(os.path.join(REPO, "demo", "test.py"), run_name="__main__")
    want = _metrics(capsys.readouterr().out)
    result = cli_test.main(["--device", "cpu", *argv])
    got = _metrics(capsys.readouterr().out)
    assert got["N"] == want["N"] == 1
    assert abs(got["PSNR"] - want["PSNR"]) <= 0.01 and abs(got["SSIM"] - want["SSIM"]) <= 1e-4
    # the command line scores what evaluate_pairs scores at that tile height
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=0, device="cpu")
    # the image as the command line reads it (the native loader: the numpy
    # reader's values, in a contiguous array, which the eval's sums follow)
    x_png = GroundTruthDataset(f"gt_folder:{tmp_path / 'gt'}", size=None)[0]
    np.testing.assert_array_equal(x_png, cli_test.FolderDataset(str(tmp_path / "gt")).load(0))
    pair = degraded_pair(phys, torch.as_tensor(x_png), image_seed(0, 0))
    assert evaluate_pairs(model, [pair], eval_tile_height=TILE).psnr == result.psnr


@pytest.mark.parametrize("kind", ["Identity", "Upsample"])
def test_untrained_models_run_whole_above_the_tile_height(kind):
    jphys = jax_get_physics(task="sr", sr_factor=2, noise_level=5)
    model = get_model(kind=kind, task="sr", sr_factor=2, device="cpu")
    jfn = jax_identity_model(jphys) if kind == "Identity" else jax_upsample_model(jphys, 2)
    y = np.random.default_rng(7).random((1, 3, 3 * TILE, 20)).astype(np.float32)
    got = restore(model, torch.from_numpy(y), eval_tile_height=TILE).numpy()
    assert got.shape == (1, 3, 3 * TILE * model.scale, 20 * model.scale)
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(y))), rtol=1e-5, atol=1e-6)


def test_noise2inverse_wraps_the_tiled_restoration(models):
    _, model = models
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    seen = []
    hook = model.module.register_forward_pre_hook(lambda m, args: seen.append(args[0].shape[0]))
    try:
        apply = eval_apply(model, phys, eval_tile_height=TILE, noise2inverse=True)
        out = apply(torch.rand(1, 3, H, W, generator=torch.Generator().manual_seed(0)))
    finally:
        hook.remove()
    assert seen == [4] * 4 and out.shape == (1, 3, H, W) and torch.isfinite(out).all()
