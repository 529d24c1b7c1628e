"""Ground-truth image sources (counterpart of ``sei_tpu/data/sources.py``):
Div2K, Urban100, FMD, single image, folder.

File layouts, split offsets, split sizes and unique ids are the JAX
package's (and so the reference's), so the per-image measurement seeds
reproduce.  Div2K's 800 / 100 are fixed, not counted from the files.  The
download helpers carry the same URLs; they run only with ``download=True``.
The CT source reads deepinv's HDF5 file with ``h5py``, imported when the
source is made; without it the source raises.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional

import numpy as np

from .loader import read_image


class ImageSource:
    """len / load(index) -> float32 CHW / unique_id(index)."""

    def __len__(self):
        raise NotImplementedError

    def load(self, index: int) -> np.ndarray:
        raise NotImplementedError

    def unique_id(self, index: int) -> int:
        return index


class Div2K(ImageSource):
    """800 train / 100 val PNGs named {index:04d}.png."""

    def __init__(self, split: str, datasets_dir: str, download: bool = False):
        if split not in ("train", "val"):
            raise ValueError(f"Invalid split {split}")
        self.datasets_dir = datasets_dir
        if split == "train":
            self.split_root = f"{datasets_dir}/DIV2K/DIV2K_train_HR"
            self.split_offset, self.split_size = 1, 800
        else:
            self.split_root = f"{datasets_dir}/DIV2K/DIV2K_valid_HR"
            self.split_offset, self.split_size = 801, 100
        if download:
            self.download(datasets_dir)

    def __len__(self):
        return self.split_size

    def path(self, index):
        i = self.split_offset + index
        return f"{self.split_root}/{i:04d}.png"

    def load(self, index):
        return read_image(self.path(index))

    def unique_id(self, index):
        return self.split_offset + index - 1

    @staticmethod
    def download(datasets_dir):
        _download_and_extract(
            "http://data.vision.ee.ethz.ch/cvl/DIV2K/DIV2K_train_HR.zip",
            f"{datasets_dir}/DIV2K",
        )
        _download_and_extract(
            "http://data.vision.ee.ethz.ch/cvl/DIV2K/DIV2K_valid_HR.zip",
            f"{datasets_dir}/DIV2K",
        )


class Urban100(ImageSource):
    """img_{index:03d}.png; train 1-90, val 91-100, all 1-100."""

    def __init__(self, split: str, datasets_dir: str, download: bool = False):
        self.datasets_dir = datasets_dir
        if split == "train":
            self.split_offset, self.split_size = 1, 90
        elif split == "val":
            self.split_offset, self.split_size = 91, 10
        elif split == "all":
            self.split_offset, self.split_size = 1, 100
        else:
            raise ValueError(f"Invalid split {split}")
        if download:
            self.download(datasets_dir)

    def __len__(self):
        return self.split_size

    def path(self, index):
        i = self.split_offset + index
        return f"{self.datasets_dir}/Urban100/Urban100_HR/img_{i:03d}.png"

    def load(self, index):
        return read_image(self.path(index))

    def unique_id(self, index):
        return self.split_offset + index - 1

    @staticmethod
    def download(datasets_dir):
        _download_and_extract(
            "https://huggingface.co/datasets/eugenesiow/Urban100/resolve/main/data/Urban100_HR.tar.gz?download=true",
            f"{datasets_dir}/Urban100",
        )


class TomographyDataset(ImageSource):
    """deepinv's HDF5 CT dataset ``CT/dinv_dataset0.h5``: 4992 train / 100
    val images, grey repeated to 3 channels (``channels=3``), ids ``index``
    (train) and ``index + 4992`` (val).  The key layouts of deepinv's
    versions are probed in the JAX package's order."""

    KEY_LAYOUTS = (("x_train", "x_test"), ("train_x", "test_x"), ("x/train", "x/test"))

    def __init__(self, split: str, datasets_dir: str, channels: int = 3, download: bool = False):
        if split not in ("train", "val"):
            raise ValueError(f"Invalid split {split}")
        if channels not in (1, 3):
            raise ValueError(f"channels must be 1 or 3, got {channels}")
        self.split = split
        self.channels = channels
        self.h5_path = f"{datasets_dir}/CT/dinv_dataset0.h5"
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"the CT dataset needs the h5py package to read "
                              f"{self.h5_path}") from e
        self._h5 = h5py.File(self.h5_path, "r")
        col = 0 if split == "train" else 1
        self._key = next((keys[col] for keys in self.KEY_LAYOUTS if keys[col] in self._h5), None)
        if self._key is None:
            raise KeyError(f"no known CT dataset keys in {self.h5_path}: {list(self._h5.keys())}")
        size = self._h5[self._key].shape[0]
        want = 4992 if split == "train" else 100
        if size != want:
            raise ValueError(f"{self.h5_path}:{self._key} holds {size} images, expected {want}")
        self.split_size = size

    def __len__(self):
        return self.split_size

    def load(self, index):
        x = np.asarray(self._h5[self._key][index], dtype=np.float32)
        if x.ndim == 2:
            x = x[None]
        if self.channels == 3 and x.shape[0] == 1:
            x = np.repeat(x, 3, axis=0)
        if x.shape[0] != self.channels:
            raise ValueError(f"{self.h5_path}:{self._key}[{index}] has {x.shape[0]} channels, "
                             f"expected {self.channels}")
        return x

    def unique_id(self, index):
        return index if self.split == "train" else index + 4992


class FMD(ImageSource):
    """Fluorescence microscopy split: 216 train / 24 test PNGs."""

    def __init__(self, split: str, datasets_dir: str, download: bool = False):
        train_paths = sorted(glob(f"{datasets_dir}/Split_FMD/train/*.png"))
        val_paths = sorted(glob(f"{datasets_dir}/Split_FMD/test/*.png"))
        if (len(train_paths), len(val_paths)) != (216, 24):
            raise ValueError(f"Split_FMD under {datasets_dir}: {len(train_paths)} train and "
                             f"{len(val_paths)} test PNGs, expected 216 and 24")
        if split == "train":
            self.split_offset = 0
            self.paths = train_paths
        elif split == "val":
            self.split_offset = len(train_paths)
            self.paths = val_paths
        else:
            raise ValueError(f"Unknown split: {split}")

    def __len__(self):
        return len(self.paths)

    def path(self, index):
        return self.paths[index]

    def load(self, index):
        return read_image(self.paths[index])

    def unique_id(self, index):
        return self.split_offset + index


class SingleImageDataset(ImageSource):
    """N duplicates of one image so epoch cadence matches other datasets."""

    def __init__(self, image_path: str, duplicates_count: int = 800, **_):
        self.image_path = image_path
        self.duplicates_count = duplicates_count
        self._im: Optional[np.ndarray] = None

    def __len__(self):
        return self.duplicates_count

    def load(self, index):
        if self._im is None:
            self._im = read_image(self.image_path)
        return self._im


class FolderDataset(ImageSource):
    """A directory of images (used for fine-tuning / directory eval)."""

    EXTENSIONS = ("*.png", "*.jpg", "*.jpeg")

    def __init__(self, root: str):
        self.paths = sorted(
            p for ext in self.EXTENSIONS for p in glob(os.path.join(root, ext))
        )
        if not self.paths:
            raise ValueError(f"no {'/'.join(self.EXTENSIONS)} images under {root}")

    def __len__(self):
        return len(self.paths)

    def path(self, index):
        return self.paths[index]

    def load(self, index):
        return read_image(self.paths[index])

    def basename(self, index):
        return os.path.basename(self.paths[index])


def _download_and_extract(url: str, dest: str):
    import tarfile
    import urllib.request
    import zipfile

    os.makedirs(dest, exist_ok=True)
    fname = os.path.join(dest, url.split("/")[-1].split("?")[0])
    if not os.path.exists(fname):
        urllib.request.urlretrieve(url, fname)
    if fname.endswith(".zip"):
        with zipfile.ZipFile(fname) as z:
            z.extractall(dest)
    elif fname.endswith((".tar.gz", ".tgz")):
        with tarfile.open(fname) as t:
            t.extractall(dest)
