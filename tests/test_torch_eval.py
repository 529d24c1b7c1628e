"""The port's eval slice as a whole vs the JAX package's eval loop (CPU).

A small SwinIR with weights carried across from the flax model, two images
of different odd sizes and the same measurement y for both packages.  The
JAX side is the ``demo/test.py`` loop: ``Model.apply_fn`` on y reflect-padded
to the 64 bucket, crop, ``quantize_and_clamp``, ``compute_metrics``.
Tolerance 1e-3 dB on PSNR and 1e-5 on SSIM per image (model outputs agree to
~1e-5; 8-bit quantization can flip a pixel at a rounding boundary).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sei_tpu.metrics as jm
from sei_tpu.models import get_model as jax_get_model
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu_torch.evaluate import EVAL_TILE_HEIGHT, evaluate, evaluate_pairs, restore
from sei_tpu_torch.models import get_model
from sei_tpu_torch.physics import get_physics

OVERRIDES = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    jmodel = jax_get_model(kind="Proposed", task="deblurring", swinir_overrides=OVERRIDES)
    rng = np.random.default_rng(0)
    jmodel.params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32)),
        jmodel.params)
    model = get_model(device="cpu", swinir_overrides=OVERRIDES)
    model.load_weights(jax.tree_util.tree_map(np.asarray, jmodel.params))
    return jmodel, model


@pytest.fixture(scope="module")
def pairs():
    jphys = jax_get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    rng = np.random.default_rng(1)
    out = []
    for shape in ((3, 37, 45), (3, 50, 29)):
        x = rng.random(shape).astype(np.float32)
        y = np.asarray(jphys.A(jnp.asarray(x))) + jphys.sigma * rng.standard_normal(shape).astype(np.float32)
        out.append((x, y.astype(np.float32)))
    return out


def _jax_eval(jmodel, pairs, bucket=64):
    fwd = jax.jit(lambda p, y: jmodel.apply_fn(p, y))
    psnrs, ssims = [], []
    for x, y in pairs:
        yj = jnp.asarray(y)[None]
        h, w = yj.shape[-2:]
        yj = jnp.pad(yj, ((0, 0), (0, 0), (0, (-h) % bucket), (0, (-w) % bucket)), mode="reflect")
        x_hat = jm.quantize_and_clamp(fwd(jmodel.params, yj)[..., :h, :w])[0]
        p, s, _ = jm.compute_metrics(jm.quantize_and_clamp(jnp.asarray(x)), x_hat)
        psnrs.append(p)
        ssims.append(s)
    return psnrs, ssims


def test_eval_slice_matches_jax(models, pairs):
    jmodel, model = models
    want_p, want_s = _jax_eval(jmodel, pairs)
    got = evaluate_pairs(model, pairs)
    np.testing.assert_allclose(got.psnr, want_p, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.ssim, want_s, rtol=0, atol=1e-5)
    assert got.psnr_mean == pytest.approx(np.mean(want_p), abs=1e-3)


def test_evaluate_degrades_with_seeds(models, pairs):
    """evaluate = seeded degradation + evaluate_pairs; same seeds, same scores."""
    _, model = models
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    images = [x for x, _ in pairs]
    a = evaluate(model, phys, images, seeds=[11, 12])
    b = evaluate(model, phys, images, seeds=[11, 12])
    assert a == b
    ys = [phys.randomly_degrade(torch.from_numpy(x)[None], s)[0] for x, s in zip(images, (11, 12))]
    assert evaluate_pairs(model, zip(images, ys)) == a
    assert np.all(np.isfinite(a.psnr)) and np.all(np.isfinite(a.ssim))


def test_restore_pads_to_bucket_and_crops():
    seen = []

    class Probe:
        device = torch.device("cpu")

        def __call__(self, y):
            seen.append(tuple(y.shape))
            return y

    y = torch.rand(1, 3, 37, 70)
    out = restore(Probe(), y)
    assert seen == [(1, 3, 64, 128)] and torch.equal(out, y)
    # above the tile height: 2 unpadded strips of 385 rows + 2 x 64 halo
    y = torch.rand(1, 3, EVAL_TILE_HEIGHT + 1, 8)
    out = restore(Probe(), y)
    assert seen[1:] == [(2, 3, 513, 8)] and torch.equal(out, y)


def test_port_imports_no_jax():
    """Importing every sei_tpu_torch module pulls in neither jax nor sei_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import sei_tpu_torch\n"
        "for m in pkgutil.walk_packages(sei_tpu_torch.__path__, 'sei_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sei_tpu'))\n"
        "assert not bad, bad\n"
        "assert {'sei_tpu_torch.ops.swin_trunk', 'sei_tpu_torch.losses', 'sei_tpu_torch.data',\n"
        "        'sei_tpu_torch.transforms', 'sei_tpu_torch.train.trainer',\n"
        "        'sei_tpu_torch.cli.train', 'sei_tpu_torch.cli.test',\n"
        "        'sei_tpu_torch.cli.generate_dataset', 'sei_tpu_torch.data.sources',\n"
        "        'sei_tpu_torch.bench', 'sei_tpu_torch.losses.r2r',\n"
        "        'sei_tpu_torch.train.validate', 'sei_tpu_torch.models.baselines',\n"
        "        'sei_tpu_torch.models.bm3d', 'sei_tpu_torch.models.convolutional',\n"
        "        'sei_tpu_torch.models.drunet', 'sei_tpu_torch.models.diffunet',\n"
        "        'sei_tpu_torch.models.denoiser_solvers', 'sei_tpu_torch.models.pnp',\n"
        "        'sei_tpu_torch.metrics.lpips', 'sei_tpu_torch.parallel.tiling',\n"
        "        'sei_tpu_torch.train.denoisers', 'sei_tpu_torch.cli.train_drunet',\n"
        "        'sei_tpu_torch.cli.train_diffunet'} <= new, new\n"
        "print('ok', len(new))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_physics(task="deblurring", kernel="Gaussian_R2")
