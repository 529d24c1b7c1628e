"""The port's training-free baselines against the JAX package's (CPU).

The same numpy inputs go through ``sei_tpu`` and ``sei_tpu_torch``;
tolerances, each stated where it is checked:

* ``InverseFilter`` (``physics.A_dagger``) for deblurring and SR x2: 1e-4
  of the output's largest value (SR: 50 CG steps).  Deblurring with
  ``Gaussian_R1``: the ``Gaussian_R2`` OTF's smallest bins are below f32's
  resolution (3.7e-8 in f32 against 3.1e-8 in f64 at 32x40; 2.9e-10
  against 8.3e-12 at 256x341), so two f32 FFTs' inverse filters of it
  agree in no digit there.
* ``TV`` (PGD + Chambolle's prox) for deblurring and SR x2, 40 iterations
  at lambd 0.1 and 0.05: 1e-5 of the output's largest value (f32 sums in
  another order, iterated).
* ``DeepImagePrior``: the deepinv ConvDecoder's size schedule and the
  nearest-resize indices exactly; at 32 px (deblurring) and 24 px (SR x2)
  with the JAX solve's ``PRNGKey(0)`` draws handed to the port, the fit's
  loss (1e-5 relative) and every gradient (1e-4 of its largest entry;
  4e-6 seen) at the draws, and the solve after one Adam step: 99% of the
  pixels within 2e-3 of the output's largest value, all within 2e-2 (one
  SR pixel of 1728 was 1.6e-2 off).  More steps are not comparable: Adam's
  first steps are sign-like in the gradient, and a 1e-7 relative change
  of the port's own latent moves its output by 1.1e-3 after one step, 0.14
  after two and 3.9 after five (of a largest value ~6), as the JAX
  package's f32 roundoff moves it (6.6e-4, 0.14, 2.2).  ``get_model``'s default
  iterations (4000 for a Gaussian deblurring kernel, else 1000), as the JAX
  package's.
* ``BM3D``: ``bm3d_deblur`` of a 2-image batch of 48x56 images: 1e-4 of the
  output's largest value (the aggregation sums in another fixed order);
  twice in a row the same bits; the pad reflects past the image (20 px of
  a 16-px plane).
* ``cli.test`` of ``TV`` against ``demo/test.py`` at noise 0 (the noise
  draws differ by design): the same PSNR/SSIM lines to 0.01 dB and 1e-4;
  ``--print_all_metrics`` prints ``LIPS: nan`` without LPIPS weights.
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

import sei_tpu.models as jax_models
from sei_tpu.models import get_model as jax_get_model
from sei_tpu.models.baselines import _conv_decoder_apply as jax_decoder_apply
from sei_tpu.models.baselines import _nearest_resize_torch as jax_nearest
from sei_tpu.models.baselines import conv_decoder_sizes as jax_sizes
from sei_tpu.models.baselines import dip_model as jax_dip_model
from sei_tpu.models.baselines import inverse_filter_model as jax_inverse_filter
from sei_tpu.models.baselines import tv_model as jax_tv_model
from sei_tpu.models.bm3d import bm3d_deblur as jax_bm3d_deblur
from sei_tpu.models.bm3d import bm3d_denoise as jax_bm3d_denoise
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu_torch import models
from sei_tpu_torch.cli import test as cli_test
from sei_tpu_torch.data import write_image
from sei_tpu_torch.models import FunctionalModel, get_model
from sei_tpu_torch.models.baselines import (_leaves, conv_decoder_apply, conv_decoder_sizes,
                                            dip_model, inverse_filter_model, nearest_resize,
                                            tv_model)
from sei_tpu_torch.models.bm3d import bm3d_deblur, bm3d_denoise
from sei_tpu_torch.physics import get_physics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = {"deblurring": dict(task="deblurring", kernel="Gaussian_R2"),
         "sr": dict(task="sr", sr_factor=2)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small ops stall when the test workers'
    thread pools oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _physics(task, **kw):
    kw = {**TASKS[task], **kw}
    return (jax_get_physics(noise_level=5, **kw), get_physics(noise_level=5, device="cpu", **kw))


def _y(task, seed, h=32, w=40, b=2):
    f = 2 if task == "sr" else 1
    return np.random.default_rng(seed).random((b, 3, h // f, w // f)).astype(np.float32)


def _close(got, want, frac):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=frac * scale)


@pytest.mark.parametrize("task", list(TASKS))
def test_inverse_filter_matches_jax(task):
    jphys, phys = _physics(task, **({"kernel": "Gaussian_R1"} if task == "deblurring" else {}))
    y = _y(task, 0)
    want = np.asarray(jax_inverse_filter(jphys)(jnp.asarray(y)))
    got = inverse_filter_model(phys)(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape
    _close(got, want, 1e-4)


@pytest.mark.parametrize("task,lambd", [("deblurring", None), ("deblurring", 0.05),
                                        ("sr", None)])
def test_tv_matches_jax(task, lambd):
    jphys, phys = _physics(task)
    y = _y(task, 1)
    want = np.asarray(jax_tv_model(jphys, lambd=lambd, max_iter=40)(jnp.asarray(y)))
    got = tv_model(phys, lambd=lambd, max_iter=40)(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape
    _close(got, want, 1e-5)


def test_dip_schedule_and_nearest_resize_match_jax():
    for out in ((32, 32), (256, 341), (500, 333), (37, 1000)):
        assert conv_decoder_sizes((16, 16), out, 7) == jax_sizes((16, 16), out, 7)
    x = np.random.default_rng(2).random((1, 2, 7, 11)).astype(np.float32)
    for size in ((13, 29), (17, 23), (100, 60), (7, 11)):
        np.testing.assert_array_equal(nearest_resize(torch.from_numpy(x), size).numpy(),
                                      np.asarray(jax_nearest(jnp.asarray(x), size)))


def _jax_dip_draws(batch, sizes, channels=32, in_size=(16, 16)):
    """The JAX solve's draws from PRNGKey(0), as the port's ``init``."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    z = jax.random.uniform(k1, (batch, channels, *in_size)) * 0.1
    n_convs = len(sizes) + 1
    keys = jax.random.split(k2, n_convs + 1)

    def t(a):
        return torch.from_numpy(np.array(a))

    convs = [{"weight": t(jax.random.normal(keys[i], (channels, channels, 3, 3))
                          * jnp.sqrt(2.0 / (channels * 9))),
              "bias": torch.zeros(channels)} for i in range(n_convs)]
    params = {"convs": convs,
              "head": {"weight": t(jax.random.normal(keys[-1], (3, channels, 1, 1))
                                   * jnp.sqrt(2.0 / channels)),
                       "bias": torch.zeros(3)},
              "bn_scale": [torch.ones(channels) for _ in range(n_convs)],
              "bn_bias": [torch.zeros(channels) for _ in range(n_convs)]}
    return t(z), params


def _jax_tree(params):
    def a(t):
        return jnp.asarray(t.detach().numpy())

    return {"convs": [{"kernel": a(c["weight"]), "bias": a(c["bias"])} for c in params["convs"]],
            "head": {"kernel": a(params["head"]["weight"]), "bias": a(params["head"]["bias"])},
            "bn_scale": [a(v) for v in params["bn_scale"]],
            "bn_bias": [a(v) for v in params["bn_bias"]]}


@pytest.mark.parametrize("task,h,w", [("deblurring", 32, 32), ("sr", 24, 24)])
def test_dip_matches_jax_with_its_draws(task, h, w):
    jphys, phys = _physics(task)
    y = _y(task, 3, h, w, b=1)
    sr = 2 if task == "sr" else None
    sizes = conv_decoder_sizes((16, 16), (h, w), 7)
    # the fit's loss and gradients at the draws
    z, params = _jax_dip_draws(1, sizes)
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    r = phys.A(conv_decoder_apply(params, z, sizes)) - torch.from_numpy(y)
    loss = torch.mean(r * r)
    loss.backward()

    def jloss(p):
        rr = jphys.A(jax_decoder_apply(p, jnp.asarray(z.numpy()), sizes)) - jnp.asarray(y)
        return jnp.mean(rr * rr)

    jl, jg = jax.value_and_grad(jloss)(_jax_tree(params))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    pairs = [(params["head"]["weight"], jg["head"]["kernel"]),
             (params["head"]["bias"], jg["head"]["bias"])]
    for c, jc in zip(params["convs"], jg["convs"]):
        pairs += [(c["weight"], jc["kernel"]), (c["bias"], jc["bias"])]
    for name in ("bn_scale", "bn_bias"):
        pairs += list(zip(params[name], jg[name]))
    assert len(pairs) == len(leaves)
    for t, g in pairs:
        _close(t.grad.numpy(), np.asarray(g), 1e-4)
    # one Adam step of the solve
    want = np.asarray(jax_dip_model(jphys, iterations=1, sr_factor=sr)(jnp.asarray(y)))
    got = dip_model(phys, iterations=1, sr_factor=sr)(
        torch.from_numpy(y), init=_jax_dip_draws(1, sizes)).numpy()
    assert got.shape == want.shape == (1, 3, h, w)
    err = np.abs(got - want) / np.abs(want).max()
    assert np.mean(err <= 2e-3) >= 0.99 and err.max() <= 2e-2


def test_dip_default_iterations(monkeypatch):
    seen = []
    monkeypatch.setattr(models, "dip_model", lambda physics, iterations, **_: seen.append(
        iterations))
    monkeypatch.setattr(jax_models, "dip_model", lambda physics, iterations, **_: seen.append(
        iterations))
    for task, kernel, want in (("deblurring", "Gaussian_R2", 4000),
                               ("deblurring", "Box_R2", 1000), ("sr", None, 1000)):
        kw = TASKS[task] if task == "sr" else dict(task=task, kernel=kernel)
        phys = get_physics(noise_level=5, device="cpu", **kw)
        model = get_model(kind="dip", task=task, sr_factor=kw.get("sr_factor"), device="cpu",
                          physics=phys, kernel_name=kernel)
        assert isinstance(model, FunctionalModel) and model.kind == "DeepImagePrior"
        jax_get_model(kind="dip", task=task, sr_factor=kw.get("sr_factor"),
                      physics=jax_get_physics(noise_level=5, **kw), kernel_name=kernel)
        assert seen[-2:] == [want, want]


def test_bm3d_deblur_matches_jax():
    jphys, phys = _physics("deblurring")
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:48, 0:56]
    x = 0.5 + 0.3 * np.sin(yy / 5.0)[None, None] * np.cos(xx / 7.0) * rng.random((2, 3, 1, 1))
    y = np.asarray(jphys.A(jnp.asarray(x, jnp.float32))) \
        + 0.02 * rng.standard_normal(x.shape).astype(np.float32)
    y = y.astype(np.float32)
    want = np.asarray(jax_bm3d_deblur(jnp.asarray(y), jphys.kernel, 5 / 255))
    model = get_model(kind="BM3D", device="cpu", physics=phys, noise_level=5)
    got = model(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == y.shape
    _close(got, want, 1e-4)
    again = bm3d_deblur(torch.from_numpy(y), phys.kernel, 5 / 255).numpy()
    np.testing.assert_array_equal(again, got)


def test_bm3d_pads_past_a_small_plane():
    z = np.random.default_rng(5).random((16, 20)).astype(np.float32)
    want = np.asarray(jax_bm3d_denoise(jnp.asarray(z), 0.1))
    got = bm3d_denoise(torch.from_numpy(z), 0.1).numpy()
    _close(got, want, 1e-4)


def _metrics(text):
    return {k: float(re.search(rf"^{k}: ([-0-9.]+)$", text, re.M).group(1))
            for k in ("N", "PSNR", "SSIM")}


def test_cli_test_tv_matches_demo_test(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:40, 0:48]
    x = 0.5 + 0.4 * np.sin(yy / 4.0)[None] * np.cos(xx / 6.0)[None] * rng.random((3, 1, 1))
    write_image(str(tmp_path / "gt" / "0.png"), x)
    argv = ["--task", "deblurring", "--kernel", "Gaussian_R2", "--noise_level", "0",
            "--dataset", f"gt_folder:{tmp_path / 'gt'}", "--GroundTruthDataset__no_resize",
            "--model_kind", "TV", "--tv_max_iter", "20", "--tv_lambd", "0.02"]
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["demo/test.py", "--device", "cpu", *argv])
    runpy.run_path(os.path.join(REPO, "demo", "test.py"), run_name="__main__")
    want = _metrics(capsys.readouterr().out)
    result = cli_test.main(["--device", "cpu", *argv, "--print_all_metrics"])
    out = capsys.readouterr().out
    got = _metrics(out)
    assert got["N"] == want["N"] == 1
    assert abs(got["PSNR"] - want["PSNR"]) <= 0.01 and abs(got["SSIM"] - want["SSIM"]) <= 1e-4
    assert "LIPS: nan" in out and "LPIPS: n/a" in out and np.isnan(result.lpips[0])
