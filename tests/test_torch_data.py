"""The port's data layer against the JAX package (CPU).

* ``read_image``: the port's own PNG codec (numpy + zlib) against the JAX
  package's Pillow reader, bit for bit, on PNGs this test encodes in each
  colour type (grey, grey + alpha, RGB, RGBA) with each row filter (none,
  sub, up, average, Paeth, and all five mixed), and on Pillow's own files;
  ``write_image`` then ``read_image`` round trips, and its bytes decode
  to the JAX package's ``write_image``'s pixels.
* ``GroundTruthDataset`` over tiny Div2K, Urban100, FMD, single-image and
  ``gt_folder:`` trees written here: items to 1e-6 (the same numpy resize)
  and ``unique_id``s equal.
* ``build_device_cache(gt)``: x equal to the JAX cache's x, y equal to the
  JAX cache's at noise 0 (y = A(x), FFT blur in f32) to 1e-5; ids, sizes.
* A ``.npy`` and a ``.pt`` PSF file through both ``get_physics``.
"""

import struct
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

from sei_tpu.data import GroundTruthDataset as JaxGroundTruthDataset
from sei_tpu.data import native as jax_native
from sei_tpu.data import build_device_cache as jax_build_device_cache
from sei_tpu.data.loader import read_image as jax_read_image
from sei_tpu.data.loader import write_image as jax_write_image
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu_torch.data import GroundTruthDataset, build_device_cache, read_image, write_image
from sei_tpu_torch.data.loader import read_png, write_png
from sei_tpu_torch.physics import get_physics

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_png(path, arr, filters):
    """An 8-bit PNG of arr (H, W, C) with row i filtered by filters[i % len]."""
    h, w, c = arr.shape
    x = arr.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, 1:] = x[:-1, :-1]
    preds = [0 * x, a, b, (a + b) >> 1, _paeth(a, b, cc)]
    rows = []
    for i in range(h):
        f = filters[i % len(filters)]
        rows.append(bytes([f]) + ((x[i] - preds[f][i]) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def _pixels(seed, h, w, c):
    """Smooth gradients plus noise: every filter has something to predict."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy[..., None] * 3 + xx[..., None] * np.arange(1, c + 1) * 2) % 256
    return ((base + rng.integers(0, 40, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_image_matches_the_jax_reader(tmp_path, channels, filters):
    path = str(tmp_path / "im.png")
    arr = _pixels(channels, 13, 17, channels)
    _encode_png(path, arr, filters)
    np.testing.assert_array_equal(read_png(path), arr)
    if channels == 2:  # grey + alpha: the channel policy refuses it in both
        for reader in (read_image, jax_read_image):
            with pytest.raises(ValueError, match="channels"):
                reader(path)
        got, want = read_image(path, channels=None), jax_read_image(path, channels=None)
    else:
        got, want = read_image(path), jax_read_image(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_image_of_pillows_files(tmp_path, channels):
    from PIL import Image

    path = str(tmp_path / "pil.png")
    arr = _pixels(10 + channels, 40, 57, channels)
    Image.fromarray(arr[..., 0] if channels == 1 else arr, MODES[channels]).save(path)
    np.testing.assert_array_equal(read_png(path).reshape(arr.shape), arr)
    policy = dict(channels=None) if channels == 2 else {}
    np.testing.assert_array_equal(read_image(path, **policy), jax_read_image(path, **policy))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_then_read_round_trips(tmp_path, channels):
    x = np.random.default_rng(channels).random((channels, 9, 14)).astype(np.float32)
    x[:, 0, :3] = (-0.2, 1.3, 0.5 / 255)  # clamped, and a value on a rounding edge
    write_image(str(tmp_path / "port.png"), x)
    jax_write_image(str(tmp_path / "jax.png"), x)
    want = np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)
    got = read_png(str(tmp_path / "port.png"))
    np.testing.assert_array_equal(got, np.transpose(want, (1, 2, 0)))
    np.testing.assert_array_equal(got, read_png(str(tmp_path / "jax.png")).reshape(got.shape))
    back = read_image(str(tmp_path / "port.png"), channels=None)
    np.testing.assert_array_equal(back, want.astype(np.float32) / 255.0)


def test_corrupt_and_unsupported_pngs_raise(tmp_path):
    path = tmp_path / "im.png"
    write_png(str(path), np.zeros((4, 5, 3), np.uint8))
    data = bytearray(path.read_bytes())
    data[-20] ^= 0xFF  # inside the IDAT chunk: its CRC no longer holds
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        read_image(str(bad))
    from PIL import Image

    Image.fromarray(np.zeros((4, 5), np.uint16) + 300).save(tmp_path / "deep.png")
    with pytest.raises(ValueError, match="unsupported"):
        read_image(str(tmp_path / "deep.png"))


def test_jpeg_needs_pillow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL now raises ImportError
    with pytest.raises(RuntimeError, match="Pillow"):
        read_image(str(tmp_path / "photo.jpg"))
    with pytest.raises(RuntimeError, match="Pillow"):
        write_image(str(tmp_path / "photo.jpeg"), np.zeros((3, 4, 4), np.float32))


def _write_tree(root, names, sizes, seed=0):
    rng = np.random.default_rng(seed)
    for i, name in enumerate(names):
        h, w = sizes[i % len(sizes)]
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        write_png(str(path), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    sizes = [(20, 28), (31, 22), (24, 24)]
    _write_tree(root, [f"DIV2K/DIV2K_train_HR/{i:04d}.png" for i in range(1, 4)]
                + [f"DIV2K/DIV2K_valid_HR/{i:04d}.png" for i in range(801, 804)], sizes)
    _write_tree(root, [f"Urban100/Urban100_HR/img_{i:03d}.png" for i in range(1, 101)], sizes, 1)
    _write_tree(root, [f"Split_FMD/train/{i:03d}.png" for i in range(216)]
                + [f"Split_FMD/test/{i:03d}.png" for i in range(24)], [(8, 10)], 2)
    _write_tree(root, [f"folder/{c}.png" for c in "dcbae"], sizes, 3)
    return root


CASES = [("div2k", "train", 3), ("div2k", "val", 3), ("urban100", "train", 4),
         ("urban100", "val", 4), ("urban100", "all", 4), ("fmd", "train", 4), ("fmd", "val", 4),
         ("gt_folder:{root}/folder", "train", 5), ("single_image", "train", 3)]


@pytest.mark.parametrize("size", [16, None])
@pytest.mark.parametrize("name,split,n_items", CASES)
def test_ground_truth_dataset_matches_jax(trees, name, split, n_items, size):
    kw = dict(dataset_name=name.format(root=trees), datasets_dir=str(trees), split=split, size=size,
              single_image_blueprint={"image_path": str(trees / "folder/a.png"),
                                      "duplicates_count": 7})
    gt, jgt = GroundTruthDataset(**kw), JaxGroundTruthDataset(**kw)
    assert len(gt) == len(jgt)
    assert [gt.unique_id(i) for i in range(len(gt))] == [jgt.unique_id(i) for i in range(len(jgt))]
    for i in range(n_items):
        got, want = gt[i], jgt[i]
        assert got.shape == want.shape and got.dtype == np.float32
        if size is not None:
            assert min(got.shape[-2:]) == size
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert gt[i] is got  # memoized


def test_unknown_and_ct_datasets_raise(trees):
    with pytest.raises(ValueError, match="Unknown dataset"):
        GroundTruthDataset("imagenet", datasets_dir=str(trees))
    with pytest.raises(FileNotFoundError):  # no CT/dinv_dataset0.h5 there
        GroundTruthDataset("ct", datasets_dir=str(trees))
    with pytest.raises(ValueError, match="split"):
        GroundTruthDataset("div2k", datasets_dir=str(trees), split="test")


@pytest.mark.parametrize("unique_seeds", [True, False])
def test_device_cache_of_a_dataset_matches_jax(trees, unique_seeds, monkeypatch):
    """The JAX cache through its Pillow path (its native loader divides by
    255 in another order: 1 ulp); the port's cache reads the PNGs through
    its native loader, which divides as its numpy path does."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    name = f"gt_folder:{trees}/folder"
    jphys = jax_get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=0)
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=0, device="cpu")
    want = jax_build_device_cache(JaxGroundTruthDataset(name, size=None), jphys,
                                  base_key=jax.random.PRNGKey(0), unique_seeds=unique_seeds)
    got = build_device_cache(GroundTruthDataset(name, size=None), phys, seed=0,
                             unique_seeds=unique_seeds)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.heights.numpy(), np.asarray(want.heights))
    np.testing.assert_array_equal(got.widths.numpy(), np.asarray(want.widths))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert got.ids.tolist() == ([0, 1, 2, 3, 4] if unique_seeds else [0] * 5)


def test_device_cache_degrades_each_image_with_its_id(trees):
    """At noise 5 the same id gives the same noise: an image's measurement
    does not depend on the other images (nor, with unique seeds off, on its
    own place)."""
    phys = get_physics(task="deblurring", kernel="Gaussian_R1", noise_level=5, device="cpu")
    gt = GroundTruthDataset(f"gt_folder:{trees}/folder", size=16)
    a = build_device_cache(gt, phys, seed=3)
    b = build_device_cache([gt[2], gt[0]], phys, seed=3, ids=[2, 0])
    torch.testing.assert_close(a.y[2], b.y[0], rtol=0, atol=0)
    same = build_device_cache(gt, phys, seed=3, unique_seeds=False)
    noise = same.y - phys.A(same.x)
    torch.testing.assert_close(noise[0], noise[2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("suffix", [".npy", ".pt"])
def test_psf_files_through_both_packages(tmp_path, suffix):
    k = np.random.default_rng(4).random((9, 7)).astype(np.float32)
    k /= k.sum()
    path = str(tmp_path / f"psf{suffix}")
    if suffix == ".npy":
        np.save(path, k)
    else:
        torch.save(torch.from_numpy(k), path)
    jphys = jax_get_physics(task="deblurring", kernel=path, noise_level=5)
    phys = get_physics(task="deblurring", kernel=path, noise_level=5, device="cpu")
    np.testing.assert_array_equal(phys.kernel.numpy(), np.asarray(jphys.kernel))
    x = np.random.default_rng(5).random((1, 3, 20, 24)).astype(np.float32)
    np.testing.assert_allclose(phys.A(torch.from_numpy(x)).numpy(),
                               np.asarray(jphys.A(jax.numpy.asarray(x))), rtol=0, atol=1e-5)
