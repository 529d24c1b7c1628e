"""The denoiser priors' trainers against the JAX package's (CPU):
``sei_tpu_torch/train/denoisers.py``, ``cli/train_{drunet,diffunet}.py``,
``models/drunet.py`` ``save_drunet_native`` and ``models/diffunet.py``
``save_diffunet``.

The JAX step is a closure inside ``main()`` of ``experiments/train_drunet.py``
(:73-106) and ``experiments/train_diffunet.py`` (:101-124), so no JAX
function computes one step.  The JAX side here is rebuilt from the JAX
package's own pieces as the scripts put them together: the crop by
``lax.dynamic_slice`` of the padded f16 cache cast to f32, ``DRUNet.apply`` /
``DiffUNet.apply``, the loss as written there, ``jax.value_and_grad`` and
``optax.adam``.  Both sides get the same image indices, offsets, sigma,
noise, t and eps, made with numpy, and start from the JAX init carried
over (``native_to_state_dict``, ``flax_diffunet_to_torch``).  Tiny widths:
DRUNet channels (8, 16, 32, 64), 1 block; DiffUNet 32 channels, mult (1,
2), attention at ds 2 (GroupNorm(32) and 64 channels per head); crop 16,
batch 2.  Tolerances, each named where it is checked:

* crops: equal, bit for bit (a gather of the same f16 values);
* the loss: rtol 1e-5;
* each parameter's gradient: 1e-4 of that gradient's largest value, that
  largest value taken no smaller than 1e-5 of the network's largest
  gradient (a DiffUNet bias that feeds a GroupNorm of one channel per group
  has a gradient of exactly 0, which f32 leaves at ~1e-10 of that in both
  packages);
* the parameters after two Adam steps (DiffUNet: three): 1e-6 absolute
  (one step moves a parameter by about the LR, 1e-4 / 2e-4) wherever the
  gradient check fixes Adam's update, i.e. every element whose gradient
  lies beyond that check's tolerance of 0 in each step, or is 0 in both
  packages.  Adam's first update is lr g / (|g| + 1e-8): a gradient within
  roundoff of 0 (the DRUNet's uniform case has one of 8192 in
  ``m_down3.1``: 2.4e-9 against -6.8e-10, its largest 0.126) takes either
  sign, so such elements (0.8% of the DRUNet's, at most 2% allowed) are
  held to 2 lr a step, the most an update can part them by;
* the saved files: the JAX forward on the port's file equals the port's to
  1e-5 of its largest value (DRUNet) / 1e-4 (DiffUNet, as
  ``tests/test_torch_denoisers.py``); a float sigma and a 0-d tensor sigma
  give equal DRUNet outputs, bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sei_tpu.models.diffunet import DiffUNet as JaxDiffUNet
from sei_tpu.models.diffunet import DiffUNetConfig as JaxDiffUNetConfig
from sei_tpu.models.diffunet import diffunet_config_from_state_dict as jax_config_from_sd
from sei_tpu.models.diffunet import ddpm_alphas_cumprod, flax_diffunet_to_torch
from sei_tpu.models.diffunet import torch_diffunet_to_flax
from sei_tpu.models.drunet import DRUNet as JaxDRUNet
from sei_tpu.models.drunet import load_drunet_native as jax_load_drunet_native
from sei_tpu.models.drunet import save_drunet_native as jax_save_drunet_native
from sei_tpu_torch.cli import test as cli_test
from sei_tpu_torch.cli import train_diffunet, train_drunet
from sei_tpu_torch.data import GroundTruthDataset, write_image
from sei_tpu_torch.models.diffunet import (DiffUNet, DiffUNetConfig, load_diffunet,
                                           save_diffunet)
from sei_tpu_torch.models.drunet import (DRUNet, _flax_path, _native_name, load_drunet,
                                         native_to_state_dict, save_drunet_native)
from sei_tpu_torch.train import denoisers as dn
from sei_tpu_torch.train.optim import get_optimizer

CHANNELS, NB = (8, 16, 32, 64), 1
TINY_UNET = dict(model_channels=32, channel_mult=(1, 2), attention_ds=(2,))
CROP, BATCH = 16, 2
SIGMA_MAX = 55.0 / 255.0
LOSS_RTOL, GRAD_FRAC, PARAM_ATOL = 1e-5, 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test workers' pools oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _images():
    """Three images of unequal sizes; the second shorter than the crop, the
    third narrower."""
    rng = np.random.default_rng(0)
    return [rng.random((3, h, w)).astype(np.float32) for h, w in ((20, 24), (10, 30), (24, 12))]


def _jax_cache(images):
    """``train_drunet.py:50-64``: the padded f16 array and the sizes."""
    hmax = max(im.shape[-2] for im in images)
    wmax = max(im.shape[-1] for im in images)
    xpad = np.zeros((len(images), 3, hmax, wmax), np.float16)
    for i, im in enumerate(images):
        xpad[i, :, : im.shape[-2], : im.shape[-1]] = im
    return jnp.asarray(xpad)


def _jax_crops(data, idx, oi, oj):
    """``train_drunet.py:75-87`` with the draws given."""
    xs = data[idx].astype(jnp.float32)
    crop = jax.vmap(lambda one, i, j: jax.lax.dynamic_slice(one, (0, i, j), (3, CROP, CROP)))
    return crop(xs, jnp.asarray(oi), jnp.asarray(oj))


def _np_crop_draws(rng, images):
    idx = rng.integers(0, len(images), BATCH)
    hi = [max(images[i].shape[-2] - CROP + 1, 1) for i in idx]
    wi = [max(images[i].shape[-1] - CROP + 1, 1) for i in idx]
    return idx, np.array([rng.integers(0, h) for h in hi]), np.array([rng.integers(0, w) for w in wi])


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _flat(tree):
    return {"/".join(getattr(k, "key", str(k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_params(net, want, resolved, lr, steps=2):
    """The parameters after Adam steps (tolerances in the docstring)."""
    unresolved = total = 0
    for name, p in net.named_parameters():
        got, mask = p.detach(), resolved[name]
        np.testing.assert_allclose(got[mask].numpy(), want[name][mask].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        np.testing.assert_allclose(got[~mask].numpy(), want[name][~mask].numpy(), rtol=0,
                                   atol=2 * lr * steps, err_msg=name)
        unresolved += int((~mask).sum())
        total += mask.numel()
    assert unresolved <= 2e-2 * total, (unresolved, total)


def _close_grads(net, want, step, resolved):
    """Each parameter's gradient against the JAX one; ``resolved[name]``
    and-ed with the elements whose sign that check fixes (docstring)."""
    floor = 1e-5 * max(float(v.abs().max()) for v in want.values())
    for name, p in net.named_parameters():
        tol = GRAD_FRAC * max(float(want[name].abs().max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0, atol=tol,
                                   err_msg=f"step {step} grad {name}")
        fixed = (want[name].abs() > tol) | ((want[name] == 0) & (p.grad == 0))
        resolved[name] = resolved.get(name, True) & fixed


def _close(got, want, frac, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=frac * float(np.abs(want).max()), err_msg=name)


# (a) the crops ---------------------------------------------------------------


def test_sample_crops_match_jax():
    images = _images()
    cache = dn.load_cache(images, "cpu")
    data = _jax_cache(images)
    assert cache.data.dtype == torch.float16
    np.testing.assert_array_equal(cache.data.numpy(), np.asarray(data))
    assert cache.hs.tolist() == [20, 10, 24] and cache.ws.tolist() == [24, 30, 12]
    rng = np.random.default_rng(1)
    for _ in range(4):
        idx, oi, oj = _np_crop_draws(rng, images)
        want = np.asarray(_jax_crops(data, idx, oi, oj))
        got = dn.take_crops(cache, _t(idx), _t(oi), _t(oj), CROP)
        assert got.dtype == torch.float32 and got.shape == (BATCH, 3, CROP, CROP)
        np.testing.assert_array_equal(got.numpy(), want)  # bit for bit
    # the image shorter than the crop reads the zero padding below it
    got = dn.take_crops(cache, _t([1]), _t([0]), _t([5]), CROP)
    assert torch.equal(got[0, :, 10:], torch.zeros(3, CROP - 10, CROP))
    # the port's own draws stay in [0, max(h - crop + 1, 1)) on each axis
    gen = torch.Generator().manual_seed(0)
    idx, oi, oj = dn.draw_crops(cache, 4000, CROP, gen)
    assert set(idx.tolist()) == {0, 1, 2}
    for i, (h, w) in enumerate(((20, 24), (10, 30), (24, 12))):
        sel = idx == i
        assert set(oi[sel].tolist()) == set(range(max(h - CROP + 1, 1)))
        assert set(oj[sel].tolist()) == set(range(max(w - CROP + 1, 1)))
    with pytest.raises(ValueError, match="exceeds"):
        dn.take_crops(cache, _t([0]), _t([0]), _t([0]), 25)


@pytest.mark.parametrize("dist", ["uniform", "log"])
def test_draw_sigma_range(dist):
    gen = torch.Generator().manual_seed(0)
    s = torch.stack([dn.draw_sigma(gen, SIGMA_MAX, dist, "cpu") for _ in range(2000)])
    assert s.dtype == torch.float32 and s.shape == (2000,)
    lo = 1e-3 if dist == "log" else 0.0
    assert float(s.min()) >= lo and float(s.max()) <= SIGMA_MAX
    if dist == "log":  # even over the decades: the log's median near the middle
        mid = (math.log(1e-3) + math.log(SIGMA_MAX)) / 2
        assert abs(float(torch.log(s).median()) - mid) < 0.2
    else:
        assert abs(float(s.median()) - SIGMA_MAX / 2) < 0.02


# (b) DRUNet's steps ------------------------------------------------------------


def _drunet_draws(rng, images, dist):
    idx, oi, oj = _np_crop_draws(rng, images)
    if dist == "log":
        sigma = np.float32(np.exp(rng.uniform(np.log(1e-3), np.log(SIGMA_MAX))))
    else:
        sigma = np.float32(rng.uniform(0.0, SIGMA_MAX))
    noise = rng.standard_normal((BATCH, 3, CROP, CROP)).astype(np.float32)
    return idx, oi, oj, sigma, noise


def _jax_drunet_step(net, tx, log_weight):
    """``train_drunet.py:73-106``, the draws given."""

    @jax.jit
    def step(params, opt, data, idx, oi, oj, sigma, noise):
        x = _jax_crops(data, idx, oi, oj)
        y = x + sigma * noise

        def loss_fn(p):
            mse = jnp.mean((net.apply({"params": p}, y, sigma) - x) ** 2)
            if log_weight:
                mse = mse / (sigma**2 + 1e-4)
            return mse

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss, grads

    return step


@pytest.mark.parametrize("dist", ["uniform", "log"])
def test_drunet_steps_match_jax(dist):
    images = _images()
    jnet = JaxDRUNet(channels=CHANNELS, nb=NB)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, CROP, CROP)), 0.1)["params"]
    tx = optax.adam(1e-4)
    opt = tx.init(params)
    jstep = _jax_drunet_step(jnet, tx, dist == "log")
    data = _jax_cache(images)

    net = DRUNet(channels=CHANNELS, nb=NB)
    net.load_state_dict(native_to_state_dict(_flat(params), NB), strict=True)
    topt = get_optimizer(net.parameters(), lr=1e-4)
    cache = dn.load_cache(images, "cpu")
    rng = np.random.default_rng(2)
    resolved = {}
    for step in range(2):
        idx, oi, oj, sigma, noise = _drunet_draws(rng, images, dist)
        params, opt, jloss, jgrads = jstep(params, opt, data, idx, oi, oj, sigma, noise)
        x = dn.take_crops(cache, _t(idx), _t(oi), _t(oj), CROP)
        loss = dn.train_step(net, topt, dn.drunet_loss, x, _t(sigma), _t(noise), dist == "log")
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
        want = native_to_state_dict(_flat(jgrads), NB)
        _close_grads(net, want, step, resolved)
    _check_params(net, native_to_state_dict(_flat(params), NB), resolved, 1e-4)


# (c) DiffUNet's steps -----------------------------------------------------------


def _jax_diffunet_step(net, tx, abar):
    """``train_diffunet.py:101-124``, the draws given."""

    @jax.jit
    def step(params, opt, data, idx, oi, oj, t, eps):
        x0 = 2.0 * _jax_crops(data, idx, oi, oj) - 1.0
        a = abar[t][:, None, None, None]
        xt = jnp.sqrt(a) * x0 + jnp.sqrt(1.0 - a) * eps

        def loss_fn(p):
            out = net.apply({"params": p}, xt, t)
            return jnp.mean((out[:, :3] - eps) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss, grads

    return step


def _torch_sd(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in flax_diffunet_to_torch(tree).items()}


def test_diffunet_steps_match_jax():
    """Three steps: the JAX init's zero output convs leave the first step's
    gradients zero above the last conv, the second's reach the skip paths
    and the blocks' output convs, the third's every parameter."""
    images = _images()
    cfg = JaxDiffUNetConfig(**TINY_UNET, num_res_blocks=1, num_head_channels=64)
    jnet = JaxDiffUNet(cfg=cfg)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, CROP, CROP)),
                                jnp.zeros((1,), jnp.int32))["params"]
    tx = optax.adam(2e-4)
    opt = tx.init(params)
    abar = jnp.asarray(ddpm_alphas_cumprod(1000), jnp.float32)
    jstep = _jax_diffunet_step(jnet, tx, abar)
    data = _jax_cache(images)

    net = DiffUNet(DiffUNetConfig(**TINY_UNET))
    net.load_state_dict(_torch_sd(params), strict=True)
    topt = get_optimizer(net.parameters(), lr=2e-4)
    cache = dn.load_cache(images, "cpu")
    tabar = dn.ddpm_abar("cpu")
    np.testing.assert_array_equal(tabar.numpy(), np.asarray(abar))
    rng = np.random.default_rng(3)
    resolved = {}
    for step in range(3):
        idx, oi, oj = _np_crop_draws(rng, images)
        t = rng.integers(0, 1000, BATCH).astype(np.int32)
        eps = rng.standard_normal((BATCH, 3, CROP, CROP)).astype(np.float32)
        params, opt, jloss, jgrads = jstep(params, opt, data, idx, oi, oj, t, eps)
        x0 = dn.take_crops(cache, _t(idx), _t(oi), _t(oj), CROP)
        loss = dn.train_step(net, topt, dn.diffunet_loss, x0, _t(t, torch.int64), _t(eps), tabar)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
        want = _torch_sd(jgrads)
        _close_grads(net, want, step, resolved)
        moved = sum(bool(v.abs().max() > 0) for v in want.values())
        assert moved == {0: 2, 2: len(want)}.get(step, moved), (step, moved)
    _check_params(net, _torch_sd(params), resolved, 2e-4, steps=3)
    # the variance channels stay at their zero init
    assert not net.out[2].weight[3:].any() and not net.out[2].bias[3:].any()


# (d) save_drunet_native ---------------------------------------------------------


def test_save_drunet_native_round_trips(tmp_path):
    net = dn.lecun_init_(DRUNet(channels=CHANNELS, nb=NB), torch.Generator().manual_seed(4))
    for name in net.state_dict():
        assert _native_name(_flax_path(name, NB).rsplit("/", 1)[0], NB) == name
    path = str(tmp_path / "port.npz")
    save_drunet_native(path, net)
    # the same keys, shapes and config arrays as the JAX package's own file
    jnet = JaxDRUNet(channels=CHANNELS, nb=NB)
    jparams = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)), 0.1)["params"]
    jpath = str(tmp_path / "jax.npz")
    jax_save_drunet_native(jpath, jparams, channels=list(CHANNELS), nb=NB)
    with np.load(path) as got, np.load(jpath) as want:
        assert {k: (got[k].shape, got[k].dtype) for k in got.files} == \
            {k: (want[k].shape, want[k].dtype) for k in want.files}
        np.testing.assert_array_equal(got["__channels"], want["__channels"])
        assert int(got["__nb"]) == int(want["__nb"])
    # the JAX package loads the port's file: its forward equals the port's
    params, jloaded = jax_load_drunet_native(path)
    x = np.random.default_rng(5).random((2, 3, 21, 27)).astype(np.float32)
    want = np.asarray(jloaded.apply({"params": params}, jnp.asarray(x), 0.1))
    with torch.no_grad():
        got = net(torch.from_numpy(x), 0.1).numpy()
        got_t = net(torch.from_numpy(x), torch.tensor(0.1)).numpy()
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(got_t, got)  # float and 0-d tensor sigma, bit for bit
    # a JAX-written file through the port and back is unchanged
    again = str(tmp_path / "again.npz")
    save_drunet_native(again, load_drunet(jpath))
    with np.load(again) as got, np.load(jpath) as want:
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# (e) save_diffunet --------------------------------------------------------------


def test_saved_diffunet_loads_in_jax(tmp_path):
    """A port-written checkpoint through ``torch_diffunet_to_flax`` gives the
    port's eps.  No zero-init kernel here, so the output is not trivial."""
    net = dn.lecun_init_(DiffUNet(DiffUNetConfig(**TINY_UNET)), torch.Generator().manual_seed(6))
    path = str(tmp_path / "unet.pt")
    save_diffunet(path, net)
    sd = torch.load(path)
    cfg = jax_config_from_sd(sd)
    assert cfg == JaxDiffUNetConfig(**TINY_UNET)
    params = torch_diffunet_to_flax({k: v.numpy() for k, v in sd.items()})
    x = np.random.default_rng(7).standard_normal((2, 3, 16, 16)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    want = np.asarray(jax.jit(JaxDiffUNet(cfg=cfg).apply)({"params": params}, jnp.asarray(x),
                                                          jnp.asarray(t)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        again = load_diffunet(path)(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (2, 6, 16, 16)
    _close(got, want, 1e-4)
    np.testing.assert_array_equal(again, got)


# (f) the command lines -----------------------------------------------------------


@pytest.fixture(scope="module")
def train_dir(tmp_path_factory):
    """A ``div2k``-style train folder of three small PNGs, and a val image."""
    root = tmp_path_factory.mktemp("denoiser_training")
    rng = np.random.default_rng(8)
    for i in range(3):
        write_image(str(root / "train" / f"{i + 1:04d}.png"), rng.random((3, 32, 40)))
    yy, xx = np.mgrid[0:40, 0:48]
    write_image(str(root / "val" / "0.png"),
                0.5 + 0.4 * np.sin(yy / 4.0)[None] * np.cos(xx / 6.0)[None] * rng.random((3, 1, 1)))
    return root


TRAINERS = {
    "drunet": (train_drunet, ["--channels", *map(str, CHANNELS), "--nb", str(NB)],
               "PlugAndPlay", "SEI_DRUNET_WEIGHTS", "drunet.npz"),
    "diffunet": (train_diffunet, ["--model_channels", "32", "--channel_mult", "1", "2",
                                  "--attention_ds", "2"],
                 "DiffPIR_DiffUNet", "SEI_DIFFUNET_WEIGHTS", "diffunet.pt"),
}


@pytest.mark.parametrize("trainer", list(TRAINERS))
def test_cli_trains_then_scores(trainer, train_dir, tmp_path, monkeypatch, capsys):
    """``cli.train_* --device cpu --steps 2`` at tiny widths (the ``div2k``
    source pointed at a folder of three PNGs, kept at their size), then
    ``cli.test`` of the kind that reads the saved file: finite."""
    module, widths, kind, env, name = TRAINERS[trainer]
    folder = f"gt_folder:{train_dir / 'train'}"
    # both trainers read their images through train_drunet.prepare
    monkeypatch.setattr(train_drunet, "GroundTruthDataset",
                        lambda dataset_name, datasets_dir, split: GroundTruthDataset(
                            folder, size=None))
    out = str(tmp_path / name)
    net, logged = module.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--crop", "16",
                               "--out", out, *widths])
    assert logged == []  # no loss line before step 500
    text = capsys.readouterr().out
    assert "trained 2 steps at batch 2" in text and f"saved: {out}" in text
    monkeypatch.setenv(env, out)
    got = cli_test.main(["--device", "cpu", "--task", "deblurring", "--kernel", "Gaussian_R2",
                         "--dataset", f"gt_folder:{train_dir / 'val'}",
                         "--GroundTruthDataset__no_resize", "--model_kind", kind])
    assert len(got.psnr) == 1 and np.isfinite(got.psnr[0]) and np.isfinite(got.ssim[0])


def test_fit_logs_every_500_steps():
    lines = []
    losses = iter(torch.arange(1000, dtype=torch.float32))
    got = dn.fit(lambda: next(losses), 1000, suffix="; card", log=lines.append)
    assert got == [(500, 499.0), (1000, 999.0)]
    assert lines[0].startswith("step 500/1000 loss 4.990e+02 (") and lines[0].endswith(
        " it/s); card")


@pytest.mark.parametrize("module", [train_drunet, train_diffunet])
def test_cli_needs_cuda_by_default(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(["--steps", "1"])
