"""LPIPS (AlexNet) against the JAX package's (CPU), on a seeded random
checkpoint (the repository holds no AlexNet or LPIPS weights).

* ``metrics.lpips.LPIPS`` against ``sei_tpu.metrics.lpips.LPIPS`` on the
  same file, both head spellings (``lin{i}.model.1.weight`` and
  ``lins.{i}.model.1.weight``), 3-D and 4-D inputs at 64x72 and 80x80:
  1e-4 relative (f32 convs of two libraries through five layers).
* The hook: ``compute_metrics(..., lpips=...)``'s third value is the
  distance, NaN without weights; ``cli.test --lpips_weights`` prints the
  ``LPIPS:``/``LPIPS std:`` lines and ``METRICS_i``'s ``LIPS`` as
  ``demo/test.py`` does on the same image at noise 0 (1e-4).
"""

import os
import re
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.metrics.lpips import LPIPS as JaxLPIPS
from sei_tpu_torch.cli import test as cli_test
from sei_tpu_torch.data import write_image
from sei_tpu_torch.metrics import compute_metrics
from sei_tpu_torch.metrics.lpips import LPIPS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONVS = ((0, 64, 3, 11), (3, 192, 64, 5), (6, 384, 192, 3), (8, 256, 384, 3),
         (10, 256, 256, 3))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small ops stall when the test workers'
    thread pools oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _checkpoint(path, heads="lin{}"):
    g = torch.Generator().manual_seed(0)
    sd = {}
    for idx, cout, cin, k in CONVS:
        sd[f"features.{idx}.weight"] = torch.randn(cout, cin, k, k, generator=g) / np.sqrt(
            cin * k * k)
        sd[f"features.{idx}.bias"] = 0.1 * torch.randn(cout, generator=g)
    for i, (_, cout, _, _) in enumerate(CONVS):
        sd[heads.format(i) + ".model.1.weight"] = torch.rand(1, cout, 1, 1, generator=g)
    torch.save(sd, path)
    return str(path)


@pytest.mark.parametrize("heads,shape", [("lin{}", (3, 64, 72)), ("lins.{}", (2, 3, 80, 80))])
def test_lpips_matches_jax(tmp_path, heads, shape):
    path = _checkpoint(tmp_path / "alex.pt", heads)
    rng = np.random.default_rng(1)
    a, b = (rng.random(shape).astype(np.float32) for _ in range(2))
    want = JaxLPIPS(path)(jnp.asarray(a), jnp.asarray(b))
    got = LPIPS(path)(torch.from_numpy(a), torch.from_numpy(b))
    assert got == pytest.approx(want, rel=1e-4) and got > 0
    _, _, d = compute_metrics(torch.from_numpy(b), torch.from_numpy(a), lpips=LPIPS(path))
    assert d == got
    assert np.isnan(compute_metrics(torch.from_numpy(b), torch.from_numpy(a))[2])


def _lines(text):
    return {k: float(re.search(rf"^{k}: ([-0-9.na]+)$", text, re.M).group(1))
            for k in ("PSNR", "LPIPS", "LPIPS std")}


def test_cli_test_prints_lpips_as_demo_test(tmp_path, capsys, monkeypatch):
    weights = _checkpoint(tmp_path / "alex.pt")
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:64, 0:72]
    write_image(str(tmp_path / "gt" / "0.png"),
                0.5 + 0.4 * np.sin(yy / 4.0)[None] * np.cos(xx / 6.0)[None] * rng.random((3, 1, 1)))
    argv = ["--task", "deblurring", "--kernel", "Gaussian_R2", "--noise_level", "0",
            "--dataset", f"gt_folder:{tmp_path / 'gt'}", "--GroundTruthDataset__no_resize",
            "--model_kind", "Identity", "--lpips_weights", weights, "--print_all_metrics"]
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["demo/test.py", "--device", "cpu", *argv])
    runpy.run_path(os.path.join(REPO, "demo", "test.py"), run_name="__main__")
    want_out = capsys.readouterr().out
    result = cli_test.main(["--device", "cpu", *argv])
    got_out = capsys.readouterr().out
    want, got = _lines(want_out), _lines(got_out)
    assert got["PSNR"] == pytest.approx(want["PSNR"], abs=0.01)
    assert got["LPIPS"] == pytest.approx(want["LPIPS"], abs=1e-4) and got["LPIPS"] > 0
    assert got["LPIPS std"] == want["LPIPS std"] == 0.0
    lips = [float(re.search(r"LIPS: ([0-9.]+)$", t, re.M).group(1)) for t in (got_out, want_out)]
    assert lips[0] == pytest.approx(lips[1], abs=1e-4)
    assert result.lpips[0] == pytest.approx(got["LPIPS"], abs=1e-4)
