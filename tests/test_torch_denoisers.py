"""The denoiser-prior baselines against the JAX package's (CPU): DRUNet,
DiffUNet, the DPIR/HQS, DiffPIR and DPS solvers, their weights gate, and
every model kind through ``cli.test``.

Random weights throughout (the repository holds no pretrained denoiser).
Tolerances, each stated where it is checked:

* DRUNet at narrow widths (8, 16, 32, 64; 1 block), from the JAX package's
  native ``.npz`` (``save_drunet_native``) and from a torch file under the
  published ``drunet_color.pth`` names written from it: the forward at an
  odd size (edge-padded to a multiple of 8) to 1e-4 of the output's
  largest value; the published-width loader refuses other widths.
* DiffUNet, a tiny guided-diffusion config (32 channels, mult (1, 2),
  attention at ds 2, the JAX params perturbed by 0.05 N(0, 1) so the
  zero-initialised output convs are not trivial), carried over by the JAX
  package's ``flax_diffunet_to_torch``: the config read back from the
  state_dict equal, the forward at two timesteps to 1e-4 of its largest
  value, ``diffunet_denoise`` at 13x19 (edge pad to 2) to 1e-4.
* The solvers with the narrow DRUNet on a 2-image 24x32 batch (deblurring
  Gaussian_R2; DPIR also SR x2, the CG prox): ``dpir_hqs`` (3 iterations),
  ``diffpir`` (4 steps) and ``dps`` (3 steps) with the JAX package's
  ``PRNGKey(0)`` draws handed to the port: 1e-4 of the output's largest
  value.
* ``get_denoiser_model`` raises ``NotImplementedError`` with the JAX
  package's message without its env var; ``cli.test`` runs every one of
  the 11 kinds on a 40x48 image and prints a finite PSNR.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.models.denoiser_solvers import diffpir as jax_diffpir
from sei_tpu.models.denoiser_solvers import dpir_hqs as jax_dpir
from sei_tpu.models.denoiser_solvers import dps as jax_dps
from sei_tpu.models.diffunet import DiffUNet as JaxDiffUNet
from sei_tpu.models.diffunet import DiffUNetConfig as JaxDiffUNetConfig
from sei_tpu.models.diffunet import diffunet_denoise as jax_diffunet_denoise
from sei_tpu.models.diffunet import flax_diffunet_to_torch
from sei_tpu.models.drunet import DRUNet as JaxDRUNet
from sei_tpu.models.drunet import save_drunet_native
from sei_tpu.models.pnp import get_denoiser_model as jax_get_denoiser_model
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu_torch.cli import test as cli_test
from sei_tpu_torch.data import write_image
from sei_tpu_torch.models import KINDS
from sei_tpu_torch.models.denoiser_solvers import diffpir, dpir_hqs, dps
from sei_tpu_torch.models.diffunet import (DiffUNet, DiffUNetConfig,
                                           diffunet_config_from_state_dict, diffunet_denoise)
from sei_tpu_torch.models.drunet import DRUNet, load_drunet, load_drunet_native
from sei_tpu_torch.models.pnp import get_denoiser_model
from sei_tpu_torch.physics import get_physics

CHANNELS, NB = (8, 16, 32, 64), 1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small ops stall when the test workers'
    thread pools oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
TINY_UNET = dict(model_channels=32, channel_mult=(1, 2), attention_ds=(2,))


def _close(got, want, frac):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=frac * scale)


@pytest.fixture(scope="module")
def drunet(tmp_path_factory):
    """(JAX apply, params, native .npz path, torch-name .pth path, port net)."""
    tmp = tmp_path_factory.mktemp("drunet")
    net = JaxDRUNet(channels=CHANNELS, nb=NB)
    params = jax.jit(net.init)(jax.random.PRNGKey(1), jnp.zeros((1, 3, 16, 16)), 0.1)["params"]
    native = str(tmp / "drunet.npz")
    save_drunet_native(native, params, channels=CHANNELS, nb=NB)
    port = load_drunet_native(native)
    pth = str(tmp / "drunet_color.pth")
    torch.save(port.state_dict(), pth)
    fwd = jax.jit(lambda p, x, s: net.apply({"params": p}, x, s))
    return (lambda x, s: fwd(params, x, s)), native, pth, port


@pytest.mark.parametrize("source", ["npz", "pth"])
def test_drunet_matches_jax(drunet, source):
    jfn, native, pth, _ = drunet
    if source == "npz":
        net = load_drunet(native)  # a .npz goes to load_drunet_native
    else:
        net = DRUNet(channels=CHANNELS, nb=NB)
        net.load_state_dict(torch.load(pth), strict=True)
        assert {k.split(".")[0] for k in net.state_dict()} == {
            "m_head", "m_down1", "m_down2", "m_down3", "m_body", "m_up1", "m_up2", "m_up3",
            "m_tail"}
    x = np.random.default_rng(0).random((2, 3, 21, 27)).astype(np.float32)
    want = np.asarray(jfn(jnp.asarray(x), 0.1))
    with torch.no_grad():
        got = net(torch.from_numpy(x), 0.1).numpy()
    assert got.shape == want.shape == x.shape
    _close(got, want, 1e-4)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_drunet(pth)  # the published widths


@pytest.fixture(scope="module")
def diffunet(tmp_path_factory):
    cfg = JaxDiffUNetConfig(**TINY_UNET)
    net = JaxDiffUNet(cfg=cfg)
    params = jax.jit(net.init)(jax.random.PRNGKey(2), jnp.zeros((1, 3, 16, 16)),
                               jnp.zeros((1,), jnp.int32))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) + 0.05 * rng.standard_normal(v.shape)
                              .astype(np.float32)), params)
    sd = flax_diffunet_to_torch(params)
    path = str(tmp_path_factory.mktemp("diffunet") / "unet.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    apply_fn = jax.jit(lambda p, x, t: net.apply({"params": p}, x, t))
    port = DiffUNet(diffunet_config_from_state_dict(sd))
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return apply_fn, params, path, port


def test_diffunet_matches_jax(diffunet):
    apply_fn, params, _, port = diffunet
    assert port.cfg == DiffUNetConfig(**TINY_UNET)
    x = np.random.default_rng(4).standard_normal((2, 3, 16, 16)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    want = np.asarray(apply_fn(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (2, 6, 16, 16)
    _close(got, want, 1e-4)
    x = np.random.default_rng(5).random((1, 3, 13, 19)).astype(np.float32)
    want = np.asarray(jax_diffunet_denoise(apply_fn, params, jnp.asarray(x), 0.1, multiple=2))
    with torch.no_grad():
        got = diffunet_denoise(port, torch.from_numpy(x), 0.1, multiple=2).numpy()
    assert got.shape == want.shape == x.shape
    _close(got, want, 1e-4)
    with pytest.raises(ValueError, match="multiples of 32"):
        DiffUNetConfig(model_channels=16)


def _solver_setup(task):
    kw = dict(task="deblurring", kernel="Gaussian_R2") if task == "deblurring" \
        else dict(task="sr", sr_factor=2)
    jphys = jax_get_physics(noise_level=5, **kw)
    phys = get_physics(noise_level=5, device="cpu", **kw)
    f = 2 if task == "sr" else 1
    y = np.random.default_rng(6).random((2, 3, 24 // f, 32 // f)).astype(np.float32)
    return jphys, phys, y


def _jax_normals(n, shape):
    """The JAX solvers' draws: k0 from PRNGKey(0)'s first split, then one
    split per step."""
    k0, key = jax.random.split(jax.random.PRNGKey(0))
    out = [jax.random.normal(k0, shape)]
    for _ in range(n - 1):
        key, kn = jax.random.split(key)
        out.append(jax.random.normal(kn, shape))
    return [torch.from_numpy(np.asarray(v)) for v in out]


@pytest.mark.parametrize("solver,task", [("dpir", "deblurring"), ("dpir", "sr"),
                                         ("diffpir", "deblurring"), ("dps", "deblurring")])
def test_solvers_match_jax(drunet, solver, task):
    jfn, _, _, net = drunet
    jphys, phys, y = _solver_setup(task)
    yt, yj = torch.from_numpy(y), jnp.asarray(y)
    sigma = 5 / 255
    shape = (2, 3, 24, 32)
    if solver == "dpir":
        want = jax_dpir(yj, jphys, jfn, noise_level_img=sigma, iters=3)
        with torch.no_grad():
            got = dpir_hqs(yt, phys, net, noise_level_img=sigma, iters=3)
    elif solver == "diffpir":
        want = jax_diffpir(yj, jphys, jfn, noise_level_img=sigma, steps=4)
        with torch.no_grad():
            got = diffpir(yt, phys, net, noise_level_img=sigma, steps=4,
                          normals=_jax_normals(4, shape))
    else:
        want = jax_dps(yj, jphys, jfn, steps=3)
        got = dps(yt, phys, net, steps=3, normals=_jax_normals(3, shape))
    assert got.shape == want.shape == shape
    _close(got.detach().numpy(), np.asarray(want), 1e-4)


@pytest.mark.parametrize("kind", ["PlugAndPlay", "DiffPIR_DRUNet", "DPS", "DiffPIR_DiffUNet"])
def test_get_denoiser_model_raises_without_weights(monkeypatch, kind):
    monkeypatch.delenv("SEI_DRUNET_WEIGHTS", raising=False)
    monkeypatch.delenv("SEI_DIFFUNET_WEIGHTS", raising=False)
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", device="cpu")
    with pytest.raises(NotImplementedError) as got:
        get_denoiser_model(kind, physics=phys, noise_level=5, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError) as want:
        jax_get_denoiser_model(kind, physics=None, noise_level=5, task="deblurring",
                               sr_factor=None)
    assert str(got.value) == str(want.value)


ARGS = {"Proposed": ["--SwinIR__embed_dim", "12", "--SwinIR__depths", "2",
                     "--SwinIR__num_heads", "2", "--SwinIR__window_size", "4"],
        "Upsample": ["--task", "sr", "--sr_factor", "2"],
        "DeepImagePrior": ["--dip_iterations", "2"], "TV": ["--tv_max_iter", "3"]}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("kinds")
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:40, 0:48]
    write_image(str(root / "gt" / "0.png"),
                0.5 + 0.4 * np.sin(yy / 4.0)[None] * np.cos(xx / 6.0)[None] * rng.random((3, 1, 1)))
    return root


@pytest.mark.parametrize("kind", KINDS)
def test_cli_test_runs_every_kind(kind, folder, drunet, diffunet, monkeypatch):
    monkeypatch.setenv("SEI_DRUNET_WEIGHTS", drunet[1])
    monkeypatch.setenv("SEI_DIFFUNET_WEIGHTS", diffunet[2])
    task = [] if kind == "Upsample" else ["--task", "deblurring", "--kernel", "Gaussian_R2"]
    got = cli_test.main(["--device", "cpu", *task, "--dataset", f"gt_folder:{folder / 'gt'}",
                         "--GroundTruthDataset__no_resize", "--model_kind", kind,
                         *ARGS.get(kind, [])])
    assert len(got.psnr) == 1 and np.isfinite(got.psnr[0]) and np.isfinite(got.ssim[0])
