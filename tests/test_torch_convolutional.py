"""The Convolutional architecture against the JAX package's (CPU).

The JAX ``ConvolutionalModel``'s params (initialised, then perturbed by
0.05 N(0, 1) so no LayerNorm or bias is trivial) are carried into the port
by ``convolutional.jax_params_to_state_dict``.  Tolerances, each stated
where it is checked:

* ``ideal_resample`` up and down, odd and even sizes: 1e-5 of the largest
  value (f32 FFTs of two libraries).
* The forward for deblurring (blueprints: the default 5 scales at 8 hidden
  channels, 2048 at the bottom; 3 scales, 2 blocks, no residuals, no in/out
  convs) and with
  the SR x2 head, at an odd size that needs the reflect pad (37x45, SR
  19x23): 1e-4 of the output's largest value; 1e-3 where a LayerNorm
  runs over the 3 colour channels (the SR head, and the blueprint without
  in/out convs): it divides by sqrt(var + 1e-6), up to 1e3 on a near-grey
  pixel (4.1e-4 and 1.8e-4 seen).
* ``proposed``'s loss (SURE on the 2B forward + EI; 4 scales at 8 hidden
  channels) to 1e-5 relative and its gradients to 1e-4 of each tensor's
  largest entry, the JAX package's draws handed to the port.
* The port's initialiser: JAX's variance scaling 1/3 (fan in, uniform):
  every conv weight within +-1/sqrt(fan in), biases zero, LayerNorms one
  (3 scales; the default blueprint holds 645M parameters, 8192 channels
  at its bottom scale).
* ``cli.train --ProposedModel__architecture Convolutional`` (2 steps,
  ``--bf16`` too: the network stays f32), ``weights.pt`` into ``cli.test``
  equal to ``evaluate_pairs`` bit for bit; another network's state_dict
  raises.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.losses.sure import sure_gaussian_loss_from_outputs as jax_sure
from sei_tpu.models import get_model as jax_get_model
from sei_tpu.models.convolutional import ideal_resample as jax_ideal_resample
from sei_tpu.ops.scaling import padded_scaling_transform as jax_scaling
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu_torch.cli import test as cli_test
from sei_tpu_torch.cli import train as cli_train
from sei_tpu_torch.data import GroundTruthDataset, image_seed, write_image
from sei_tpu_torch.evaluate import degraded_pair, evaluate_pairs
from sei_tpu_torch.losses import LossDraws, compute_sure_margin, get_loss
from sei_tpu_torch.models import ConvolutionalModel, get_model
from sei_tpu_torch.models.convolutional import ideal_resample, jax_params_to_state_dict
from sei_tpu_torch.physics import get_physics

SIGMA = 5.0 / 255.0
BLUEPRINTS = {
    "default": dict(hidden_channels=8),
    "bare": dict(scales=3, num_conv_blocks=2, residual=False, inner_residual=False,
                 inout_convs=False, hidden_channels=8),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small ops stall when the test workers'
    thread pools oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, frac):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=frac * scale)


@pytest.mark.parametrize("shape,rate", [((2, 5, 16, 24), 2.0), ((1, 3, 9, 7), 3.0),
                                        ((2, 5, 16, 24), 0.5), ((1, 4, 18, 10), 0.5)])
def test_ideal_resample_matches_jax(shape, rate):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    want = np.asarray(jax_ideal_resample(jnp.asarray(x.transpose(0, 2, 3, 1)), rate))
    got = ideal_resample(torch.from_numpy(x), rate).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    _close(got, want, 1e-5)


def _models(bp, task="deblurring", sr=None, seed=0):
    jmodel = jax_get_model(kind="Proposed", architecture="Convolutional", task=task,
                           sr_factor=sr, conv_blueprint=bp)
    rng = np.random.default_rng(seed)
    jmodel.params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) + 0.05 * rng.standard_normal(v.shape)
                              .astype(np.float32)), jmodel.params)
    model = get_model(architecture="Convolutional", task=task, sr_factor=sr, device="cpu",
                      conv_blueprint=bp)
    model.load_weights(jax.tree_util.tree_map(np.asarray, jmodel.params))
    return jmodel, model


@pytest.mark.parametrize("name,task", [("default", "deblurring"), ("bare", "deblurring"),
                                       ("default", "sr")])
def test_forward_matches_jax(name, task):
    sr = 2 if task == "sr" else None
    jmodel, model = _models(BLUEPRINTS[name], task, sr)
    h, w = (19, 23) if sr else (37, 45)
    y = np.random.default_rng(1).random((2, 3, h, w)).astype(np.float32)
    want = np.asarray(jmodel(jnp.asarray(y)))
    got = model(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == (2, 3, h * (sr or 1), w * (sr or 1))
    _close(got, want, 1e-3 if name == "bare" or sr else 1e-4)
    assert model.scale == (sr or 1)


def test_initialiser_is_the_jax_one():
    bp = dict(hidden_channels=8, scales=3)
    module = get_model(architecture="Convolutional", device="cpu", seed=3,
                       conv_blueprint=bp).module
    assert isinstance(module, ConvolutionalModel)
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            assert torch.all(p == 0), name
        elif p.dim() == 1:  # LayerNorm weight
            assert torch.all(p == 1), name
        else:
            bound = 1 / np.sqrt(p[0].numel())
            assert float(p.abs().max()) <= bound and float(p.abs().max()) > 0.9 * bound, name
    again = get_model(architecture="Convolutional", device="cpu", seed=3,
                      conv_blueprint=bp).module
    assert all(torch.equal(a, b) for a, b in zip(module.parameters(), again.parameters()))


def test_proposed_loss_and_grads_match_jax():
    jphys = jax_get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    jmodel, model = _models(dict(hidden_channels=8, scales=4), seed=2)
    crop, b = 32, 2
    margin = compute_sure_margin(partial_sure=True, sure_margin=None, task="deblurring",
                                 kernel_shape=(13, 13))
    rng = np.random.default_rng(5)
    x = rng.random((b, 3, 40, 40)).astype(np.float32)
    y = (np.asarray(jphys.A(jnp.asarray(x)))
         + SIGMA * rng.standard_normal(x.shape).astype(np.float32)).astype(np.float32)
    probe = rng.standard_normal((b, 3, crop, crop)).astype(np.float32)
    probe[..., :margin, :] = probe[..., -margin:, :] = 0.0
    probe[..., :, :margin] = probe[..., :, -margin:] = 0.0
    d = dict(crop=rng.integers(0, 9, (b, 2)), probe=probe,
             rates=np.array([0.75, 0.5], np.float32),
             centers=(2 * rng.random((b, 2)) - 1).astype(np.float32))
    yc = np.stack([y[i, :, r:r + crop, c:c + crop] for i, (r, c) in enumerate(d["crop"])])

    def jax_loss(params):
        def f(img):
            return jmodel.apply_fn(params, img)

        ycj, bj = jnp.asarray(yc), jnp.asarray(probe)
        x_net, x_tau = jnp.split(f(jnp.concatenate([ycj, ycj + bj * 1e-2])), 2)
        loss = jax_sure(ycj, x_net, x_tau, bj, jphys.A, sigma=SIGMA, tau=1e-2, margin=margin,
                        cropped_div=True, averaged_cst=False)
        x2 = jax.lax.stop_gradient(
            jax_scaling(x_net, jnp.asarray(d["rates"]), jnp.asarray(d["centers"])))
        return loss + jnp.mean((f(jphys.A(x2)) - x2) ** 2)

    want, jgrads = jax.jit(jax.value_and_grad(jax_loss))(jmodel.params)
    want_sd = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    module = model.module.train()
    draws = LossDraws(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})
    got = get_loss(method="proposed", physics=phys, crop_size=crop)(
        torch.from_numpy(x), torch.from_numpy(y), module, None, draws)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    named = dict(module.named_parameters())
    assert set(named) == set(want_sd)
    for k, g in want_sd.items():
        _close(named[k].grad.numpy(), g.numpy(), 1e-4)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("conv")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:56]
    for i in range(8):
        smooth = 0.5 + 0.4 * np.sin(yy / (3.0 + i))[None] * np.cos(xx / 5.0)[None]
        write_image(str(root / "gt" / f"{i}.png"), smooth * rng.random((3, 1, 1)))
    data = ["--dataset", f"gt_folder:{root / 'gt'}", "--GroundTruthDataset__size", "40"]
    arch = ["--ProposedModel__architecture", "Convolutional",
            "--ConvolutionalModel__hidden_channels", "8", "--ConvolutionalModel__scales", "3"]
    task = ["--task", "deblurring", "--kernel", "Gaussian_R2"]
    argv = ["--device", "cpu", *task, "--method", "proposed", *data, *arch, "--epochs", "1",
            "--batch_size", "4", "--PrepareTrainingPairs__crop_size", "32",
            "--Loss__crop_size", "24", "--out_dir", str(root / "run")]
    result = cli_train.main(argv)
    bf16 = cli_train.main(argv[:-1] + [str(root / "bf16"), "--bf16"])
    return types.SimpleNamespace(root=root, data=data, arch=arch, task=task, result=result,
                                 bf16=bf16)


def test_cli_train_trains_the_convolutional_network(run):
    losses = [float(v) for v in run.result["losses"]]
    assert run.result["stats"]["steps"] == 2 and np.all(np.isfinite(losses))
    module = run.result["trainer"].model.module
    assert isinstance(module, ConvolutionalModel)
    # --bf16 leaves the Convolutional network in f32: the same steps
    assert [float(v) for v in run.bf16["losses"]] == losses
    assert (run.root / "run" / "weights.pt").exists()


def test_cli_test_scores_its_weights_as_evaluate_pairs(run):
    weights = str(run.root / "run" / "weights.pt")
    got = cli_test.main(["--device", "cpu", *run.task, *run.data, *run.arch,
                         "--weights", weights, "--indices", "0,1"])
    model = get_model(architecture="Convolutional", device="cpu",
                      conv_blueprint=dict(hidden_channels=8, scales=3))
    model.load_weights(torch.load(weights))
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    gt = GroundTruthDataset(f"gt_folder:{run.root / 'gt'}", split="val", size=40)
    pairs = [degraded_pair(phys, torch.as_tensor(gt[i]), image_seed(0, gt.unique_id(i)))
             for i in (0, 1)]
    want = evaluate_pairs(model, pairs)
    assert (got.psnr, got.ssim) == (want.psnr, want.ssim)


def test_other_state_dicts_raise(run):
    model = get_model(architecture="Convolutional", device="cpu",
                      conv_blueprint=dict(hidden_channels=8, scales=3))
    swinir = get_model(device="cpu", swinir_overrides=dict(embed_dim=12, depths=(2,),
                                                           num_heads=(2,), window_size=4))
    with pytest.raises(RuntimeError, match="state_dict"):
        model.load_weights(swinir.module.state_dict())
