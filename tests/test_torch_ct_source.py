"""The CT source (deepinv's HDF5 file) against the JAX package's (CPU).

The file is written as ``tests/test_datasets_sources.py`` writes it, in
deepinv's schema (``x_train``/``y_train``/``x_test``/``y_test``, an
``operator`` attribute).  The port's ``TomographyDataset`` must give the
JAX class's pixels (exactly), in both channel modes, with the same split
sizes and ids, and the same ``KeyError`` listing the keys of a file in no
known layout; with ``h5py`` unimportable it raises an ``ImportError`` that
names the package.  ``--dataset ct``'s ground truth (``GroundTruthDataset``,
with and without the shorter-side resize) equals the JAX package's, and
its noiseless measurements under the CT-like filter agree to 1e-5 (two FFT
implementations); one ``cli.train --dataset ct`` step runs on the val
split.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.data import GroundTruthDataset as JaxGroundTruthDataset
from sei_tpu.data.sources import TomographyDataset as JaxTomographyDataset
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu_torch.cli import train as cli_train
from sei_tpu_torch.data import GroundTruthDataset, TomographyDataset
from sei_tpu_torch.physics import get_physics

CT = "invert_a_tomography_like_filter"  # the CT-like task's ramp filter


@pytest.fixture(scope="module")
def ct_root(tmp_path_factory):
    """A datasets_dir holding CT/dinv_dataset0.h5 in deepinv's schema."""
    import h5py

    root = tmp_path_factory.mktemp("datasets")
    os.makedirs(root / "CT")
    rng = np.random.default_rng(0)
    x_train = rng.random((4992, 1, 8, 8)).astype(np.float32)
    x_test = rng.random((100, 1, 8, 8)).astype(np.float32)
    with h5py.File(root / "CT" / "dinv_dataset0.h5", "w") as hf:
        hf.attrs["operator"] = "Tomography"
        hf.create_dataset("x_train", data=x_train)
        hf.create_dataset("y_train", data=x_train * 0.5)
        hf.create_dataset("x_test", data=x_test)
        hf.create_dataset("y_test", data=x_test * 0.5)
    return str(root)


@pytest.mark.parametrize("split,channels", [("train", 3), ("val", 3), ("train", 1),
                                            ("val", 1)])
def test_tomography_dataset_matches_jax(ct_root, split, channels):
    got = TomographyDataset(split, ct_root, channels=channels)
    want = JaxTomographyDataset(split, ct_root, channels=channels)
    assert len(got) == len(want) == (4992 if split == "train" else 100)
    for i in (0, 7, len(want) - 1):
        np.testing.assert_array_equal(got.load(i), want.load(i))
        assert got.load(i).shape == (channels, 8, 8) and got.load(i).dtype == np.float32
        assert got.unique_id(i) == want.unique_id(i)
    assert got.unique_id(7) == (7 if split == "train" else 4999)


def test_unknown_keys_raise_the_same_key_error(tmp_path):
    import h5py

    os.makedirs(tmp_path / "CT")
    with h5py.File(tmp_path / "CT" / "dinv_dataset0.h5", "w") as hf:
        hf.create_dataset("images", data=np.zeros((4, 1, 8, 8), np.float32))
    with pytest.raises(KeyError) as want:
        JaxTomographyDataset("train", str(tmp_path))
    with pytest.raises(KeyError) as got:
        TomographyDataset("train", str(tmp_path))
    assert str(got.value) == str(want.value) and "images" in str(got.value)


def test_without_h5py_the_source_raises(ct_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py -> ImportError
    with pytest.raises(ImportError, match=r"h5py.*dinv_dataset0\.h5"):
        TomographyDataset("val", ct_root)
    with pytest.raises(ValueError, match="channels"):
        TomographyDataset("val", ct_root, channels=2)


@pytest.mark.parametrize("size", [None, 16])
def test_ct_pairs_match_jax(ct_root, size):
    got = GroundTruthDataset("ct", ct_root, split="val", size=size)
    want = JaxGroundTruthDataset("ct", ct_root, split="val", size=size)
    phys = get_physics(task=CT, noise_level=0, device="cpu")
    jphys = jax_get_physics(task=CT, noise_level=0)
    for i in (0, 3, 99):
        x, xj = got[i], np.asarray(want[i])
        np.testing.assert_allclose(x, xj, rtol=0, atol=1e-6 if size else 0)
        assert got.unique_id(i) == want.unique_id(i) == 4992 + i
        y = phys.A(torch.from_numpy(x)[None]).numpy()
        yj = np.asarray(jphys.A(jnp.asarray(xj)[None]))
        np.testing.assert_allclose(y, yj, rtol=0, atol=1e-5)


def test_cli_train_reads_the_ct_dataset(ct_root, tmp_path):
    result = cli_train.main([
        "--device", "cpu", "--task", CT, "--method", "proposed", "--dataset", "ct",
        "--GroundTruthDataset__datasets_dir", ct_root,
        "--GroundTruthDataset__split", "val", "--GroundTruthDataset__no_resize",
        "--SwinIR__embed_dim", "12", "--SwinIR__depths", "2", "--SwinIR__num_heads", "2",
        "--SwinIR__window_size", "4", "--epochs", "1", "--batch_size", "100",
        "--PrepareTrainingPairs__crop_size", "8", "--Loss__crop_size", "8",
        "--out_dir", str(tmp_path / "run")])
    assert result["stats"]["steps"] == 1 and len(result["trainer"].cache) == 100
    assert np.isfinite(float(result["losses"][0]))
    assert (tmp_path / "run" / "weights.pt").is_file()
