"""The native PNG loader (``sei_tpu_torch/data/native.py`` and
``data/csrc/png_loader.cc``) against the numpy codec, its plain version
(CPU).

* It builds with ``g++`` into ``sei_tpu_torch/_build/`` under a hashed
  name; without ``g++``, or when the build fails, it raises.
* Decode: bit for bit against ``read_image`` (``read_png`` + the division
  by 255 + the channel policy) for grey, RGB and RGBA with each of the
  five row filters and all five mixed (``tests/test_torch_data.py``'s
  encoder); grey + alpha raises as ``read_image`` does.
* Resize: within 1e-6 of ``resize_shorter_side_np`` (down, up, and the
  identity returned as it is).
* ``GroundTruthDataset``: ``load_all`` and its items on a folder of PNGs
  and a JPEG equal the numpy path (``read_image``, then
  ``resize_shorter_side_np``; bit for bit without a resize, 1e-6 with it),
  the PNGs through the native loader and the JPEG by the numpy codec;
  ``load_all`` on threads and the items one by one give the same bits (one
  reader, whichever fills the memo); a corrupt PNG (a bad CRC, truncated
  data, an unknown filter type) raises.
* Importing the module and loading through it pulls in no JAX and nothing
  of ``sei_tpu``.
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from sei_tpu_torch.data import GroundTruthDataset, native, read_image
from sei_tpu_torch.data.loader import read_png
from sei_tpu_torch.ops.resize import resize_shorter_side_np
from tests.test_torch_data import _encode_png, _pixels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTERS = [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)]


def test_builds_into_the_build_directory():
    lib = native.library()
    path = lib._name
    assert os.path.dirname(path) == str(native.BUILD_DIR)
    assert os.path.basename(path).startswith("libsei_png_") and path.endswith(".so")
    assert native.library() is lib


@pytest.fixture
def unbuilt(monkeypatch):
    """A flag set never built before (a new library name), the cache cleared
    before and after."""
    native.library.cache_clear()
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + (f"-DSEI_TEST_{os.getpid()}",))
    yield monkeypatch
    native.library.cache_clear()


def test_no_compiler_raises(unbuilt):
    unbuilt.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.library()


def test_failed_build_raises(unbuilt):
    unbuilt.setattr(native, "FLAGS", native.FLAGS + ("--no-such-flag",))
    with pytest.raises(RuntimeError, match="building the native PNG loader failed"):
        native.library()
    assert not any(p.name.endswith(".tmp") and p.name.startswith("libsei_png_")
                   and str(os.getpid()) in p.name for p in native.BUILD_DIR.iterdir())


@pytest.mark.parametrize("filters", FILTERS)
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decode_equals_the_numpy_reader(tmp_path, channels, filters):
    path = str(tmp_path / "im.png")
    arr = _pixels(channels, 23, 31, channels)
    _encode_png(path, arr, filters)
    np.testing.assert_array_equal(read_png(path), arr)
    got, want = native.decode(path), read_image(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (3, 23, 31)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("filters", [(0,), (4,), (0, 1, 2, 3, 4)])
def test_grey_alpha_raises_as_the_numpy_reader(tmp_path, filters):
    path = str(tmp_path / "la.png")
    _encode_png(path, _pixels(2, 9, 11, 2), filters)
    for reader in (native.decode, read_image):
        with pytest.raises(ValueError, match="channels: 2"):
            reader(path)


@pytest.mark.parametrize("shape,size", [((3, 37, 53), 16), ((3, 64, 40), 24), ((1, 10, 14), 20),
                                        ((3, 41, 41), 17), ((3, 16, 29), 16)])
def test_resize_matches_the_numpy_resize(shape, size):
    x = np.random.default_rng(sum(shape) + size).random(shape).astype(np.float32)
    got, want = native.resize_shorter_side(x, size), resize_shorter_side_np(x, size)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if shape[1:] == want.shape[1:]:
        assert got is x


def _folder(root, names):
    """PNGs in each colour type the datasets take and filter mix, and a JPEG
    when Pillow is there."""
    (root / "f").mkdir()
    for i, name in enumerate(names):
        c = (3, 1, 4)[i % 3]
        _encode_png(str(root / "f" / name), _pixels(30 + i, 33 + i, 47 - i, c),
                    FILTERS[i % len(FILTERS)])
    try:
        from PIL import Image
    except ImportError:
        return
    Image.fromarray(_pixels(9, 35, 40, 3)).save(str(root / "f" / "z.jpg"))


def _numpy_path(ds):
    """The dataset's items by the numpy codec and resize, the native
    loader's plain version."""
    return [read_image(ds.source.path(i)) if ds.size is None
            else resize_shorter_side_np(read_image(ds.source.path(i)), ds.size, antialias=True)
            for i in range(len(ds))]


@pytest.mark.parametrize("size", [None, 16])
def test_load_all_equals_the_numpy_path(tmp_path, size, monkeypatch):
    _folder(tmp_path, [f"{c}.png" for c in "abcde"])
    name = f"gt_folder:{tmp_path / 'f'}"
    calls = []
    real = native.decode

    def spy(path):
        calls.append(os.path.basename(path))
        return real(path)

    monkeypatch.setattr(native, "decode", spy)
    ds = GroundTruthDataset(name, size=size)
    got = ds.load_all(n_threads=3)
    want = _numpy_path(ds)
    assert sorted(calls) == [f"{c}.png" for c in "abcde"]
    assert len(got) == len(want) >= 5
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        if size is None:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert all(ds[i] is im for i, im in enumerate(got))  # memoized
    assert len(calls) == 5


@pytest.mark.parametrize("memoize", [True, False])
def test_items_and_load_all_read_the_same_bits(tmp_path, memoize):
    _folder(tmp_path, [f"{c}.png" for c in "abc"])
    name = f"gt_folder:{tmp_path / 'f'}"
    items = GroundTruthDataset(name, size=16, memoize_gt=memoize)
    one_by_one = [items[i] for i in range(len(items))]
    together = GroundTruthDataset(name, size=16, memoize_gt=memoize).load_all(n_threads=2)
    assert all(np.array_equal(a, b) for a, b in zip(one_by_one, together, strict=True))


def _corrupt(path, how):
    _encode_png(path, _pixels(5, 12, 10, 3), (1,))
    data = bytearray(open(path, "rb").read())
    idat = data.index(b"IDAT")
    if how == "crc":
        data[idat + 10] ^= 0xFF
    elif how == "truncated":
        n = struct.unpack(">I", data[idat - 4:idat])[0]
        body = bytes(data[idat + 4:idat + 4 + n])[:-9]
        chunk = struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(
            ">I", zlib.crc32(b"IDAT" + body))
        data = data[:idat - 4] + chunk + data[idat + 8 + n:]
    else:  # a filter type of 7 on the first row
        raw = bytearray(zlib.decompress(bytes(data[idat + 4:idat + 4 + struct.unpack(
            ">I", data[idat - 4:idat])[0]])))
        raw[0] = 7
        body = zlib.compress(bytes(raw))
        n = struct.unpack(">I", data[idat - 4:idat])[0]
        chunk = struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(
            ">I", zlib.crc32(b"IDAT" + body))
        data = data[:idat - 4] + chunk + data[idat + 8 + n:]
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("how,match", [("crc", "corrupt PNG chunk"), ("truncated", "corrupt PNG"),
                                       ("filter", "filter type")])
def test_a_corrupt_png_raises(tmp_path, how, match):
    (tmp_path / "f").mkdir()
    _encode_png(str(tmp_path / "f" / "a.png"), _pixels(1, 12, 10, 3), (0,))
    _corrupt(str(tmp_path / "f" / "b.png"), how)
    with pytest.raises(ValueError, match=match):
        native.decode(str(tmp_path / "f" / "b.png"))
    with pytest.raises(ValueError, match=match):
        GroundTruthDataset(f"gt_folder:{tmp_path / 'f'}", size=None).load_all()
    with pytest.raises(ValueError, match=match):
        read_image(str(tmp_path / "f" / "b.png"))


def test_imports_no_jax(tmp_path):
    _encode_png(str(tmp_path / "a.png"), _pixels(2, 20, 24, 3), (4,))
    code = ("import sys\n"
            "from sei_tpu_torch.data import native\n"
            f"x = native.resize_shorter_side(native.decode({str(tmp_path / 'a.png')!r}), 16)\n"
            "assert x.shape == (3, 16, 19), x.shape\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'sei_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
