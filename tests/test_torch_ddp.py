"""Data-parallel training over a process group (``sei_tpu_torch.parallel``)
against the one-process ``Trainer`` (CPU, gloo).

The JAX package shards each step's global batch over a mesh and computes
the one-process step; so must R ranks here.  Two gloo ranks
(``torch.multiprocessing.spawn``, file rendezvous in the test's tmp dir)
train a tiny SwinIR with drop-path 0.2 at batch 4 for 2 steps with
``proposed`` (SURE), ``proposed`` with R2R-EI and ``supervised``; their
losses, final weights and Adam state must equal the one-process trainer's
to f32 roundoff: the same draws and the same per-image arithmetic, only the
batch sums split in two (rtol 1e-5 on the losses; the weights and Adam's
moments within 1e-5 of each tensor's largest entry, as Adam's first update
is m / sqrt(v), a sign-like function of gradients whose f32 sums differ in
their last bits: 1.3e-6 at most was seen).  Only rank 0 writes
``training.csv``, ``validation.csv`` and the checkpoints, and validates; a
batch that R does not divide raises; ``cli.train --device cpu
--data_parallel_devices 0,1`` writes the one-process ``training.csv``
within the same roundoff.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sei_tpu_torch import parallel
from sei_tpu_torch.cli import train as cli_train
from sei_tpu_torch.data import build_device_cache, write_image
from sei_tpu_torch.losses import get_loss
from sei_tpu_torch.models import get_model
from sei_tpu_torch.parallel.tiling import tiled_apply
from sei_tpu_torch.physics import get_physics
from sei_tpu_torch.train import Trainer

TINY = dict(embed_dim=12, depths=(2, 2), num_heads=(2, 2), window_size=4, drop_path_rate=0.2)
BATCH, WORLD = 4, 2
METHODS = {
    "sure": dict(method="proposed"),
    "r2r": dict(method="proposed", sure_alternative="r2r"),
    "supervised": dict(method="supervised"),
}
LOSS_RTOL = 1e-5
STATE_FRAC = 1e-5


def _train(method, out_dir=None, data_parallel=None, eval_hook=None):
    """2 steps (one epoch of 8 images at batch 4) of a tiny SwinIR."""
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    rng = np.random.default_rng(3)
    images = [rng.random((3, 40, 48)).astype(np.float32) for _ in range(8)]
    cache = build_device_cache(images, phys, seed=0)
    model = get_model(device="cpu", swinir_overrides=TINY)
    loss_fn = get_loss(physics=phys, crop_size=24, **METHODS[method])
    trainer = Trainer(model, loss_fn, phys, cache, batch_size=BATCH, epochs=1, crop_size=32,
                      out_dir=out_dir, data_parallel=data_parallel,
                      eval_interval=1 if eval_hook else 0, eval_hook=eval_hook)
    losses = []
    trainer.train(on_step=lambda s, loss: losses.append(float(loss)), log_every_epoch=False)
    return {"losses": losses, "params": model.module.state_dict(),
            "opt": [{k: v.clone() for k, v in s.items()} for s in trainer.opt.state.values()]}


STRIPS = dict(n_tiles=3, halo=6)


def _strip_input():
    return torch.rand(1, 3, 60, 20, generator=torch.Generator().manual_seed(5))


def _strip_model(x):
    """Two 5x5 convs: a receptive field within the halo."""
    g = torch.Generator().manual_seed(6)
    for _ in range(2):
        x = torch.tanh(F.conv2d(x, torch.randn(3, 3, 5, 5, generator=g) / 15, padding=2))
    return x


def _rank(rank, init_file, tmp):
    """One gloo rank: every method, then a validated run writing to a
    directory of the rank's own, then the strips over the two ranks."""
    torch.set_num_threads(2)
    dp = parallel.init(rank, WORLD, init_file, torch.device("cpu"))
    try:
        batches = []
        strips = tiled_apply(lambda t: batches.append(t.shape[0]) or _strip_model(t),
                             _strip_input(), group=torch.distributed.group.WORLD, **STRIPS)
        out = {m: _train(m, data_parallel=dp) for m in METHODS}
        out["strips"], out["strip_batches"] = strips, batches
        calls = []
        _train("supervised", out_dir=os.path.join(tmp, f"rank{rank}"), data_parallel=dp,
               eval_hook=lambda model: calls.append(1) or (20.0, 0.5))
        out["validations"] = len(calls)
        torch.save(out, os.path.join(tmp, f"result{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ddp"))
    torch.multiprocessing.spawn(_rank, args=(os.path.join(tmp, "dist_init"), tmp), nprocs=WORLD)
    return tmp, [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                 for r in range(WORLD)]


def _close(got, want, frac=STATE_FRAC):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= frac * scale


@pytest.mark.parametrize("method", list(METHODS))
def test_two_ranks_compute_the_one_process_step(ranks, method):
    _, results = ranks
    want = _train(method)
    for got in results:  # every rank holds the same state
        np.testing.assert_allclose(got[method]["losses"], want["losses"], rtol=LOSS_RTOL)
        for k, v in want["params"].items():
            _close(got[method]["params"][k], v)
        assert len(got[method]["opt"]) == len(want["opt"])
        for g, w in zip(got[method]["opt"], want["opt"]):
            for k in w:
                _close(g[k], w[k])
    assert results[0][method]["losses"] == results[1][method]["losses"]


def test_tiled_apply_over_two_ranks_equals_one_process(ranks):
    _, results = ranks
    want = tiled_apply(_strip_model, _strip_input(), **STRIPS)
    for got in results:
        assert got["strip_batches"] == [2]
        np.testing.assert_allclose(got["strips"].numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert torch.equal(results[0]["strips"], results[1]["strips"])


def test_only_rank_0_writes_and_validates(ranks):
    tmp, results = ranks
    assert [r["validations"] for r in results] == [1, 0]
    lead = os.path.join(tmp, "rank0")
    assert sorted(os.listdir(lead)) == ["checkpoints", "training.csv", "validation.csv"]
    assert sorted(os.listdir(os.path.join(lead, "checkpoints"))) == [
        "ckp_0.pt", "ckp_1.pt", "ckp_best.pt"]
    assert not os.path.exists(os.path.join(tmp, "rank1"))


def test_a_batch_the_ranks_do_not_divide_raises():
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        parallel.DataParallel(rank=0, world=2).rows(3)
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    cache = build_device_cache([np.zeros((3, 40, 48), np.float32)] * 6, phys)
    with pytest.raises(ValueError, match="does not divide"):
        Trainer(get_model(device="cpu", swinir_overrides=TINY),
                get_loss(method="supervised", physics=phys), phys, cache, batch_size=3,
                data_parallel=parallel.DataParallel(rank=1, world=2))


def test_draw_rows_keeps_this_ranks_rows_of_the_global_draw():
    def draw(shape):
        return torch.arange(int(np.prod(shape))).reshape(shape)

    assert torch.equal(parallel.draw_rows(draw, (4, 3)), draw((4, 3)))
    with parallel.sharded_rows(1, 2, 2):
        # a 2b stack: rank 1 holds global rows 2, 3 of each half of 2B = 8
        got = parallel.draw_rows(draw, (4, 3))
        assert torch.equal(got, draw((8, 3))[[2, 3, 6, 7]])
        got = parallel.draw_rows(draw, (5, 2, 2), dim=2)
        assert torch.equal(got, draw((5, 2, 4))[:, :, 2:])
        assert parallel.global_rows(2) == 4
        with pytest.raises(ValueError, match="blocks"):
            parallel.draw_rows(draw, (3,))
    assert parallel.global_rows(2) == 2


def test_cli_train_data_parallel_writes_the_one_process_csv(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(8):
        write_image(str(tmp_path / "gt" / f"{i}.png"), rng.random((3, 40, 48)))
    argv = ["--device", "cpu", "--task", "deblurring", "--kernel", "Gaussian_R2", "--method",
            "proposed", "--dataset", f"gt_folder:{tmp_path / 'gt'}",
            "--GroundTruthDataset__size", "40", "--SwinIR__embed_dim", "12", "--SwinIR__depths",
            "2", "--SwinIR__num_heads", "2", "--SwinIR__window_size", "4", "--epochs", "1",
            "--batch_size", "4", "--PrepareTrainingPairs__crop_size", "32", "--Loss__crop_size",
            "24"]
    one = cli_train.main(argv + ["--out_dir", str(tmp_path / "one")])
    assert cli_train.main(argv + ["--out_dir", str(tmp_path / "two"),
                                  "--data_parallel_devices", "0,1"]) is None

    def rows(run):
        lines = (tmp_path / run / "training.csv").read_text().splitlines()
        return lines[0], [[float(v) for v in line.split(",")] for line in lines[1:]]

    head, want = rows("one")
    assert rows("two")[0] == head and len(want) == 1
    np.testing.assert_allclose(rows("two")[1], want, rtol=LOSS_RTOL)
    assert float(np.mean([float(v) for v in one["losses"]])) == pytest.approx(want[0][1],
                                                                             rel=1e-6)
    assert sorted(os.listdir(tmp_path / "two" / "checkpoints")) == ["ckp_0.pt", "ckp_1.pt"]
    final = torch.load(tmp_path / "two" / "checkpoints" / "ckp_1.pt", weights_only=False)
    for k, v in one["trainer"].model.module.state_dict().items():
        _close(final["params"][k], v)
