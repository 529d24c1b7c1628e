"""The port's command lines against the JAX package's (CPU).

* The port's parsers (``sei_tpu_torch.config``) give the namespace of
  ``sei_tpu.config``'s, ``device`` aside, for the commands of
  ``tests/test_cli_compat.py`` and the reference's namespaced flags.
* Every flag is ported: the command lines set up (device and physics)
  and build their model (and ``cli.test`` its LPIPS), which restores a
  measurement, with each flag of the later ROADMAP items (the CT-like
  task, the spatial blur, the training modes, the eval wrappers, the CT
  source, the tiled eval, data-parallel training, the baselines, the
  Convolutional network, LPIPS); item 7 (the bf16 module path) has no
  flag: ``SEI_FUSED_TRUNK=0`` reaches it (``tests/test_torch_module_path.py``);
  without a GPU, an entry point run without ``--device cpu`` raises.
* End to end: ``cli.train.main`` with ``--device cpu`` trains a tiny SwinIR
  on 8 PNGs of a ``gt_folder:`` and writes ``training.csv``,
  ``checkpoints/ckp_*.pt`` and ``weights.pt``; ``demo/test.py`` (the JAX
  package, run in this process) and ``cli.test.main`` score that ``weights.pt``
  at noise 0 (y = A(x) in both) and print the same ``PSNR:`` and ``SSIM:``
  lines, to 0.01 dB and 1e-4.
* ``--RESUME`` starts at the epoch the JAX trainer starts at (its
  ``load_checkpoint`` run on an orbax checkpoint with the same ``epoch``
  entry), with the LR pinned unless ``--RESUME_keep_schedule``.
* ``cli.generate_dataset`` at noise 0 writes the JAX package's A(x).
* ``--eval_interval``, ``--eval_count`` and ``--ProposedLoss__sure_alternative
  r2r`` train and validate (``validation.csv``, ``ckp_best.pt``); without a
  val split, training goes on with the JAX package's message.
* ``bin_torch/deblur`` and ``bin_torch/upsample`` (``bin/``'s arguments) run
  in a subprocess on a folder of 2 measurement PNGs with a tiny SwinIR and
  write the same ``estimates/`` as ``cli.test.main``, byte for byte.
"""

import os
import re
import runpy
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu import config as jax_config
from sei_tpu.data import FolderDataset as JaxFolderDataset
from sei_tpu.data.loader import read_image as jax_read_image
from sei_tpu.models.drunet import DRUNet as JaxDRUNet
from sei_tpu.models.drunet import save_drunet_native
from sei_tpu.models.torch_io import flax_swinir_to_torch, torch_swinir_to_flax
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu.train.checkpoint import CheckpointManager
from sei_tpu.train.trainer import Trainer as JaxTrainer
from sei_tpu_torch import bench, config
from sei_tpu_torch.cli import generate_dataset as cli_generate
from sei_tpu_torch.cli import test as cli_test
from sei_tpu_torch.cli import train as cli_train
from sei_tpu_torch.data import GroundTruthDataset, image_seed, write_image
from sei_tpu_torch.evaluate import degraded_pair, eval_apply, score_pair
from sei_tpu_torch.models import get_model
from sei_tpu_torch.physics import get_physics
from sei_tpu_torch.train.checkpoint import latest_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--SwinIR__embed_dim", "12", "--SwinIR__depths", "2", "--SwinIR__num_heads", "2",
        "--SwinIR__window_size", "4"]
TASK = ["--task", "deblurring", "--kernel", "Gaussian_R2"]

TRAIN_COMMANDS = [
    ["--device", "cpu", "--method", "proposed", "--task", "deblurring", "--kernel", "Gaussian_R2",
     "--out_dir", "/tmp/x"],
    *[["--task", "deblurring", "--method", m] for m in ("proposed", "sup", "css", "ei-shift",
                                                        "ei-rotate")],
    ["--task", "deblurring", "--no-stop_gradient"],
    ["--task", "sr", "--sr_factor", "2", "--GroundTruthDataset__size", "128",
     "--SyntheticDataset__unique_seeds", "--PrepareTrainingPairs__crop_size", "96",
     "--ProposedModel__architecture", "Convolutional", "--ConvolutionalModel__hidden_channels",
     "16", "--ScalingTransform__kind", "normal", "--Loss__crop_size", "24",
     "--SyntheticDataset__deterministic_measurements", "--physics_true_adjoint",
     "--no-physics_v2", "--no-physics_antialias"],
    ["--task", "sr", "--sr_factor", "2"],
    ["--device", "cuda:0", "--task", "deblurring", "--bf16", "--scan_steps", "4", "--RESUME",
     "ckp", "--RESUME_keep_schedule", "--lr", "1e-3", "--profile_dir", "prof", *TINY],
]
TEST_COMMANDS = [
    ["--device", "cpu", "--task", "deblurring", "--kernel", "Gaussian_R2", "--weights",
     "Div2K-Train_Deblurring_Gaussian_R2_Noise5_SEI"],
    *[["--task", "deblurring", "--model_kind", k] for k in ("swinir", "dip", "pnp", "bm3d", "up",
                                                           "id")],
    ["--task", "deblurring", "--GroundTruthDataset__no_resize"],
    ["--task", "deblurring", "--indices", "0,3", "--save_images", "--save_psf", "--out_dir", "o",
     "--print_all_metrics", "--eval_pad_bucket", "0", "--eval_tile_height", "512"],
]


def _namespaces(add, argv):
    got, want = config.DefaultArgParser(), jax_config.DefaultArgParser()
    getattr(config, add)(got)
    getattr(jax_config, add)(want)
    got, want = vars(got.parse_args(argv)), vars(want.parse_args(argv))
    return ({k: v for k, v in got.items() if k != "device"},
            {k: v for k, v in want.items() if k != "device"}, got["device"])


@pytest.mark.parametrize("add,argv", [("add_train_args", a) for a in TRAIN_COMMANDS]
                         + [("add_test_args", a) for a in TEST_COMMANDS])
def test_parsers_match_the_jax_package(add, argv):
    got, want, device = _namespaces(add, argv)
    assert got == want
    assert device == (argv[argv.index("--device") + 1] if "--device" in argv else "cuda")
    assert config.default_epochs("urban100") == jax_config.default_epochs("urban100")
    assert config.default_checkpoint_interval("urban100") == \
        jax_config.default_checkpoint_interval("urban100")
    assert config.default_lr("sr", False) == jax_config.default_lr("sr", False)
    assert config.default_optimizer(True) == jax_config.default_optimizer(True)


def test_device_flag_is_checked():
    parser = config.DefaultArgParser()
    with pytest.raises(SystemExit):
        parser.parse_args(["--device", "tpu"])


# the flags of ROADMAP Queue 1 items 3-6, ported: the command lines set up with them
PORTED = [
    (config.add_train_args, ["--model_kind", "Proposed", "--ProposedModel__architecture",
                             "Convolutional", "--ConvolutionalModel__scales", "3"]),
    (config.add_train_args, ["--ProposedModel__architecture", "Convolutional", "--bf16"]),
    (config.add_test_args, ["--model_kind", "bm3d"]),
    (config.add_test_args, ["--model_kind", "dip", "--dip_iterations", "3"]),
    (config.add_test_args, ["--model_kind", "TV", "--tv_lambd", "0.1", "--tv_max_iter", "10"]),
    (config.add_test_args, ["--model_kind", "InverseFilter"]),
    (config.add_test_args, ["--model_kind", "pnp"]),
    (config.add_test_args, ["--lpips_weights", "lpips.pt"]),
    (config.add_train_args, ["--data_parallel_devices", "0,1"]),
    (config.add_train_args, ["--dataset", "ct"]),
    (config.add_test_args, ["--dataset", "ct"]),
    (config.add_test_args, ["--eval_tile_height", "512"]),
    (config.add_train_args, ["--fine_tuning"]),
    (config.add_train_args, ["--fine_tuning", "--fine_tuning_params"]),
    (config.add_train_args, ["--fine_tuning", "--weights_distance_loss"]),
    (config.add_train_args, ["--supervised_l1"]),
    (config.add_train_args, ["--ScalingTransform__kind", "normal"]),
    (config.add_train_args, ["--no-SyntheticDataset__deterministic_measurements"]),
    (config.add_train_args, ["--method", "css"]),
    (config.add_train_args, ["--method", "ei-shift"]),
    (config.add_train_args, ["--method", "ei-rotate"]),
    (config.add_train_args, ["--ProposedLoss__transforms", "Rotations"]),
    (config.add_train_args, ["--ProposedLoss__transforms", "Shifts"]),
    (config.add_train_args, ["--ProposedLoss__transforms", "Rotations+Shifts"]),
    (config.add_train_args, ["--no-physics_v2"]),
    (config.add_train_args, ["--task", "invert_a_tomography_like_filter"]),
    (config.add_test_args, ["--r2r"]),
    (config.add_test_args, ["--r2r", "--r2r_itercount", "4"]),
    (config.add_test_args, ["--noise2inverse"]),
    (config.add_test_args, ["--no-SyntheticDataset__deterministic_measurements"]),
    (config.add_test_args, ["--task", "invert_a_tomography_like_filter"]),
]


# narrow widths for every model a case builds (a case's own flags come after)
NARROW = [*TINY, "--ConvolutionalModel__hidden_channels", "8", "--ConvolutionalModel__scales",
          "3"]
ALEXNET = ((0, 64, 3, 11), (3, 192, 64, 5), (6, 384, 192, 3), (8, 256, 384, 3),
           (10, 256, 256, 3))


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """A narrow DRUNet in the JAX package's native ``.npz`` (for
    ``SEI_DRUNET_WEIGHTS``) and a seeded random AlexNet/LPIPS checkpoint
    (for ``--lpips_weights``)."""
    root = tmp_path_factory.mktemp("weights")
    channels, nb = (8, 16, 32, 64), 1
    params = JaxDRUNet(channels=channels, nb=nb).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)), 0.1)["params"]
    drunet = str(root / "drunet.npz")
    save_drunet_native(drunet, params, channels=channels, nb=nb)
    g = torch.Generator().manual_seed(0)
    sd = {}
    for i, (idx, cout, cin, k) in enumerate(ALEXNET):
        sd[f"features.{idx}.weight"] = torch.randn(cout, cin, k, k, generator=g) / np.sqrt(
            cin * k * k)
        sd[f"features.{idx}.bias"] = 0.1 * torch.randn(cout, generator=g)
        sd[f"lin{i}.model.1.weight"] = torch.rand(1, cout, 1, 1, generator=g)
    lpips = str(root / "lpips.pt")
    torch.save(sd, lpips)
    return types.SimpleNamespace(drunet=drunet, lpips=lpips)


@pytest.mark.parametrize("add_args,argv", PORTED)
def test_ported_flags_pass_check_ported(add_args, argv, weight_files, monkeypatch):
    """Each flag sets the command line up and builds the model it asks for
    as the command line does (``cli.test``: and the LPIPS); the model
    restores a 32x32 measurement, finite and of its shape."""
    monkeypatch.setenv("SEI_DRUNET_WEIGHTS", weight_files.drunet)
    parser = config.DefaultArgParser()
    add_args(parser)
    argv = [weight_files.lpips if a == "lpips.pt" else a for a in argv]
    args = parser.parse_args(["--device", "cpu", *TASK, *NARROW, *argv])
    if add_args is config.add_test_args:
        device, physics, model, lpips = cli_test.build(args)
    else:
        device, physics = cli_train.setup(args)
        model, lpips = cli_train.build_model(args, device), None
    assert device.type == "cpu" and physics.task == args.task
    x = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(physics.A(x))
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert (lpips is not None) == (getattr(args, "lpips_weights", None) is not None)
    if lpips is not None:
        assert np.isfinite(lpips(out[0].clamp(0, 1), x[0]))


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_train.main([*TASK, "--method", "proposed"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_test.main(TASK)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_generate.main([*TASK, "in", "out"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """8 PNGs of 48x56 (40x46 after the shorter-side resize); a tiny SwinIR
    trained for 2 epochs of 2 steps on the CPU by the command line."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:56]
    for i in range(8):
        smooth = 0.5 + 0.4 * np.sin(yy / (3.0 + i) + rng.random() * 6)[None] * np.cos(xx / 5.0)[None]
        write_image(str(root / "gt" / f"{i}.png"), smooth * rng.random((3, 1, 1)))
    data = ["--dataset", f"gt_folder:{root / 'gt'}", "--GroundTruthDataset__size", "40"]
    out = root / "run"
    argv = ["--device", "cpu", *TASK, "--method", "proposed", *data, *TINY, "--epochs", "2",
            "--batch_size", "4", "--PrepareTrainingPairs__crop_size", "32", "--Loss__crop_size",
            "24", "--checkpoint_interval", "1", "--out_dir", str(out)]
    result = cli_train.main(argv)
    return types.SimpleNamespace(root=root, data=data, out=out, argv=argv, result=result)


def test_train_writes_the_reference_outputs(run):
    stats = run.result["stats"]
    assert stats["steps"] == 4 and len(run.result["losses"]) == 4
    assert np.all(np.isfinite([float(v) for v in run.result["losses"]]))
    rows = (run.out / "training.csv").read_text().splitlines()
    assert rows[0] == "Epoch,Training Loss" and [r.split(",")[0] for r in rows[1:]] == ["1", "2"]
    assert sorted(os.listdir(run.out / "checkpoints")) == ["ckp_0.pt", "ckp_1.pt", "ckp_2.pt"]
    assert latest_checkpoint(str(run.out / "checkpoints")) == str(run.out / "checkpoints/ckp_2.pt")
    assert latest_checkpoint(str(run.out / "nowhere")) is None
    sd = torch.load(run.out / "weights.pt", weights_only=False)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in sd.values())
    # the JAX package's reader maps it to its params tree and back to the same keys
    params = torch_swinir_to_flax({k: v.numpy() for k, v in sd.items()})
    assert set(flax_swinir_to_torch(params)) == set(sd)
    final = run.result["trainer"].model.module.state_dict()
    assert all(torch.equal(sd[k], final[k]) for k in sd)


def _metrics(text):
    return {k: float(re.search(rf"^{k}: ([-0-9.]+)$", text, re.M).group(1))
            for k in ("N", "PSNR", "SSIM")}


def test_jax_and_port_score_the_weights_alike(run, capsys, monkeypatch):
    argv = ["--device", "cpu", *TASK, "--noise_level", "0", *run.data, *TINY,
            "--weights", str(run.out / "weights.pt")]
    # demo/test.py in this process (JAX on the CPU), so its compilations use
    # the tests' JAX cache
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["demo/test.py", *argv])
    runpy.run_path(os.path.join(REPO, "demo", "test.py"), run_name="__main__")
    want = _metrics(capsys.readouterr().out)
    result = cli_test.main(argv)
    printed = capsys.readouterr().out
    got = _metrics(printed)
    assert got["N"] == want["N"] == 8 == len(result.psnr)
    assert abs(got["PSNR"] - want["PSNR"]) <= 0.01 and abs(got["SSIM"] - want["SSIM"]) <= 1e-4
    assert f"PSNR: {np.mean(result.psnr):.2f}" in printed
    assert "LPIPS: n/a" in printed


def test_test_saves_images_and_psf(run, tmp_path):
    out = tmp_path / "eval"
    result = cli_test.main(["--device", "cpu", *TASK, *run.data, *TINY, "--weights",
                            str(run.out / "checkpoints" / "ckp_2.pt"), "--indices", "1,3",
                            "--save_images", "--save_psf", "--out_dir", str(out)])
    assert len(result.psnr) == 2
    assert (out / "psf.png").is_file()
    for tree in ("ground_truth", "predictors", "estimates"):
        assert sorted(os.listdir(out / tree)) == ["1.png", "3.png"]
    shape = jax_read_image(str(out / "estimates" / "1.png")).shape
    assert shape == (3, 40, 46)


def test_resume_starts_where_the_jax_trainer_starts(run, tmp_path, capsys):
    ckp = run.out / "checkpoints" / "ckp_2.pt"
    epoch = torch.load(ckp, weights_only=False)["epoch"]
    assert epoch == 1  # ckp_{e + 1} holds epoch e, as the JAX trainer names them
    mgr = CheckpointManager(str(tmp_path / "orbax"))
    path = mgr.save(2, 2, {"epoch": np.asarray(epoch), "params": {"w": np.zeros(2, np.float32)},
                           "opt_state": {"m": np.zeros(2, np.float32)}})
    mgr.wait()
    jax_trainer = types.SimpleNamespace(model=types.SimpleNamespace(params=None))
    JaxTrainer.load_checkpoint(jax_trainer, path)

    base = run.argv[:-2] + ["--out_dir", str(tmp_path / "r")]  # the run's flags, another out_dir
    with pytest.raises(ValueError, match="--lr"):
        cli_train.main(base + ["--RESUME", str(ckp)])
    capsys.readouterr()
    resumed = cli_train.main(base + ["--RESUME", str(ckp), "--lr", "5e-5"])
    trainer = resumed["trainer"]
    assert trainer.start_epoch == jax_trainer.start_epoch == 1
    assert "Loading checkpoint from epoch 1" in capsys.readouterr().out
    assert trainer.lr_scheduler_kind is None and float(trainer.lr_t) == pytest.approx(5e-5)
    assert resumed["stats"]["steps"] == 6  # epoch 1 once more, after the 4 steps it holds
    kept = cli_train.main(base + ["--RESUME", str(ckp), "--lr", "5e-5", "--RESUME_keep_schedule"])
    assert kept["trainer"].lr_scheduler_kind == "delayed_linear_decay"


@pytest.mark.parametrize("flags,epochs,rows", [
    (["--eval_interval", "1"], ["1", "2"], 8),
    (["--eval_interval", "2", "--eval_count", "3"], ["2"], 3),
    (["--ProposedLoss__sure_alternative", "r2r", "--eval_interval", "1"], ["1", "2"], 8),
])
def test_train_validates_during_training(run, tmp_path, capsys, flags, epochs, rows):
    """The flags of in-training validation and R2R-EI train and validate on
    the CPU: ``validation.csv`` after the given epochs, over the first
    ``--eval_count`` images of the ``gt_folder:`` (split ``all``), and
    ``ckp_best.pt`` beside the numbered checkpoints."""
    out = tmp_path / "r"
    capsys.readouterr()
    result = cli_train.main(run.argv[:-2] + ["--out_dir", str(out), *flags])
    trainer = result["trainer"]
    assert np.all(np.isfinite([float(v) for v in result["losses"]]))
    assert len(trainer.eval_hook) == rows
    lines = (out / "validation.csv").read_text().splitlines()
    assert lines[0] == "Epoch,PSNR,SSIM" and [r.split(",")[0] for r in lines[1:]] == epochs
    assert [e for e, _, _ in result["stats"]["validation"]] == [int(e) for e in epochs]
    assert "(best)" in capsys.readouterr().out
    assert (out / "checkpoints" / "ckp_best.pt").is_file()
    assert latest_checkpoint(str(out / "checkpoints")) == str(out / "checkpoints/ckp_2.pt")
    if "r2r" in flags:
        assert trainer.loss_fn is not run.result["trainer"].loss_fn
        assert [float(v) for v in result["losses"]] != [float(v) for v in run.result["losses"]]


def test_eval_interval_without_a_val_split_trains_on(run, tmp_path, capsys, monkeypatch):
    def no_val_split(*a, **k):
        raise ValueError("no val split here")

    monkeypatch.setattr(cli_train, "ValidationHook", no_val_split)
    result = cli_train.main(run.argv[:-2] + ["--out_dir", str(tmp_path / "r"),
                                             "--eval_interval", "1"])
    assert "eval_interval disabled (no val split): no val split here" in capsys.readouterr().out
    assert result["trainer"].eval_interval == 0 and result["stats"]["validation"] == []
    assert not (tmp_path / "r" / "validation.csv").exists()


def test_generate_dataset_writes_the_jax_packages_measurements(run, tmp_path):
    out = tmp_path / "degraded"
    n = cli_generate.main(["--device", "cpu", *TASK, "--noise_level", "0",
                           str(run.root / "gt"), str(out)])
    assert n == 8
    jphys = jax_get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=0)
    src = JaxFolderDataset(str(run.root / "gt"))
    for i in range(n):
        want = np.asarray(jphys.A(jnp.asarray(src.load(i))[None])[0])
        want = np.clip(want * 255.0 + 0.5, 0, 255).astype(np.uint8)
        got = np.round(jax_read_image(str(out / src.basename(i))) * 255.0).astype(np.uint8)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


CT = ["--task", "invert_a_tomography_like_filter"]


@pytest.fixture(scope="module")
def ct_run(run, tmp_path_factory):
    """The tiny SwinIR trained by the command line for 1 epoch on the CT-like
    task (proposed R2R-EI, the JAX package's recipe) on the same PNGs."""
    out = tmp_path_factory.mktemp("ct") / "run"
    argv = ["--device", "cpu", *CT, "--method", "proposed", "--ProposedLoss__sure_alternative",
            "r2r", *run.data, *TINY, "--epochs", "1", "--batch_size", "4",
            "--PrepareTrainingPairs__crop_size", "32", "--Loss__crop_size", "24",
            "--out_dir", str(out)]
    return types.SimpleNamespace(out=out, result=cli_train.main(argv))


def test_ct_like_task_trains_and_scores_as_the_jax_package(run, ct_run, capsys, monkeypatch):
    """``cli.train --task invert_a_tomography_like_filter`` trains; ``cli.test``
    on its ``weights.pt`` at noise 0 prints ``demo/test.py``'s PSNR and SSIM
    (to 0.01 dB and 1e-4).  (``--noise2inverse``'s ensemble is held against
    the JAX package's in ``tests/test_torch_n2i.py``.)"""
    assert np.all(np.isfinite([float(v) for v in ct_run.result["losses"]]))
    assert ct_run.result["trainer"].physics.task == "invert_a_tomography_like_filter"
    argv = ["--device", "cpu", *CT, "--noise_level", "0", *run.data, *TINY,
            "--weights", str(ct_run.out / "weights.pt")]
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["demo/test.py", *argv])
    runpy.run_path(os.path.join(REPO, "demo", "test.py"), run_name="__main__")
    want = _metrics(capsys.readouterr().out)
    result = cli_test.main(argv)
    got = _metrics(capsys.readouterr().out)
    assert got["N"] == want["N"] == 8 == len(result.psnr)
    assert abs(got["PSNR"] - want["PSNR"]) <= 0.01 and abs(got["SSIM"] - want["SSIM"]) <= 1e-4


def test_ct_like_noise2inverse_eval_matches_eval_apply(run, ct_run, capsys):
    """``cli.test --noise2inverse`` on the CT-like task scores two images as
    ``score_pair`` with ``eval_apply(..., noise2inverse=True)`` does (the
    same pairs, bit for bit)."""
    argv = ["--device", "cpu", *CT, *run.data, *TINY, "--weights",
            str(ct_run.out / "weights.pt"), "--noise2inverse", "--indices", "0,1"]
    result = cli_test.main(argv)
    assert "PSNR:" in capsys.readouterr().out
    model = get_model(device="cpu", swinir_overrides=dict(embed_dim=12, depths=(2,),
                                                          num_heads=(2,), window_size=4))
    model.load_weights(torch.load(ct_run.out / "weights.pt", weights_only=False))
    phys = get_physics(task="invert_a_tomography_like_filter", device="cpu")
    gt = GroundTruthDataset(run.data[1], size=40)
    apply = eval_apply(model, phys, noise2inverse=True)
    want = [score_pair(model, *degraded_pair(phys, torch.as_tensor(gt[i]),
                                             image_seed(0, gt.unique_id(i))), apply=apply)[:2]
            for i in (0, 1)]
    assert list(zip(result.psnr, result.ssim)) == want


@pytest.mark.parametrize("wrapper,lead,task", [
    ("deblur", [], ["--task", "deblurring"]),
    ("upsample", ["2"], ["--task", "sr", "--sr_factor", "2"])])
def test_bin_torch_wrapper_writes_what_cli_test_writes(tmp_path, wrapper, lead, task):
    rng = np.random.default_rng(5)
    for i in range(2):
        write_image(str(tmp_path / "in" / f"m{i}.png"), rng.random((3, 40, 48)))
    extra = ["--device", "cpu", *TINY]
    parser = config.DefaultArgParser()
    config.add_test_args(parser)
    _, _, model, _ = cli_test.build(parser.parse_args([*task, "--dataset", str(tmp_path / "in"),
                                                       *extra]))
    weights = tmp_path / "weights.pt"
    torch.save(model.module.state_dict(), weights)
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ["PATH"],
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    subprocess.run(["bash", os.path.join(REPO, "bin_torch", wrapper), *lead, str(weights),
                    str(tmp_path / "in"), str(tmp_path / "wrapper"), *extra],
                   check=True, env=env, timeout=600)
    cli_test.main([*task, "--model_kind", "Proposed", "--weights", str(weights), "--dataset",
                   str(tmp_path / "in"), "--out_dir", str(tmp_path / "main"), "--save_images",
                   *extra])
    names = sorted(os.listdir(tmp_path / "main" / "estimates"))
    assert names == ["m0.png", "m1.png"]
    assert sorted(os.listdir(tmp_path / "wrapper" / "estimates")) == names
    for name in names:
        got = (tmp_path / "wrapper" / "estimates" / name).read_bytes()
        assert got == (tmp_path / "main" / "estimates" / name).read_bytes()
