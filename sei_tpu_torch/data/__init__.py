"""Datasets and training data on the device (counterpart of
``sei_tpu/data/__init__.py``).

:class:`GroundTruthDataset` is the reference's ground-truth pipeline: a name
registry (Div2K, Urban100, FMD; ``single_image``; ``gt_folder:DIR``), the
shorter-side-256 antialiased bicubic resize, and memoization.  Images are
read on the host: PNG files by the native loader (:mod:`.native`, C++;
:meth:`GroundTruthDataset.load_all` on a pool of threads), anything else by
:mod:`.loader` (numpy; ``.jpg`` through Pillow).

The reference's measurements are deterministic per image and frozen across
epochs, so each (x, y) pair is synthesized once, on the device, and the
whole dataset stays there as padded tensors (:func:`build_device_cache`).
A step's batch is then a gather of images and an aligned random crop (for
SR, x cropped ``rate`` times the y crop at ``rate`` times its offset), with
no host round trip for pixels.  Fresh measurements (y degraded anew at
every step) and CSS (the pair (y, degrade(y)) in place of (x, y)) degrade
the gathered whole images on the device before the crop, with the step's
``noise`` stream.  :func:`build_finetuning_cache` is the fine-tuning set of
a folder of measurements.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.resize import resize, resize_shorter_side_np
from ..transforms.crop import crop_offsets, crop_pair_batch, pad_min_size
from . import native
from .loader import read_image, write_image  # noqa: F401
from .sources import (  # noqa: F401
    FMD,
    Div2K,
    FolderDataset,
    ImageSource,
    SingleImageDataset,
    TomographyDataset,
    Urban100,
)

_REGISTRY = {"div2k": Div2K, "urban100": Urban100, "ct": TomographyDataset, "fmd": FMD}


class GroundTruthDataset:
    """Name registry + shorter-side resize + in-memory memoization
    (``sei_tpu/data/__init__.py:48-121``).

    ``dataset_name``: ``div2k``, ``urban100``, ``fmd``, ``ct`` (deepinv's
    HDF5 file, read with ``h5py``), ``single_image`` (``single_image_blueprint``: ``image_path``,
    ``duplicates_count``) or ``gt_folder:DIR``, a directory of images used
    as ground truth (unique id = sorted index).  ``size``: the shorter side
    after the antialiased bicubic resize, None to keep the files' size.
    """

    def __init__(self, dataset_name: str, datasets_dir: str = "./datasets",
                 split: str = "train", download: bool = False, size: Optional[int] = 256,
                 memoize_gt: bool = True, single_image_blueprint: Optional[dict] = None):
        name = dataset_name.lower()
        if name == "single_image":
            self.source = SingleImageDataset(**(single_image_blueprint or {}))
        elif name.startswith("gt_folder:"):
            self.source = FolderDataset(dataset_name.split(":", 1)[1])
        elif name in _REGISTRY:
            self.source = _REGISTRY[name](split, datasets_dir, download=download)
        else:
            raise ValueError(f"Unknown dataset: {dataset_name}")
        self.size = size
        self.memoize = memoize_gt
        self._cache: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.source)

    def unique_id(self, index: int) -> int:
        return self.source.unique_id(index)

    def __getitem__(self, index: int) -> np.ndarray:
        if self.memoize and index in self._cache:
            return self._cache[index]
        x = self._read(index)
        if self.memoize:
            self._cache[index] = x
        return x

    def _png_path(self, index: int) -> Optional[str]:
        """The item's file when it is a PNG (read by the native loader)."""
        path_of = getattr(self.source, "path", None)
        path = path_of(index) if path_of is not None else None
        return path if path is not None and path.lower().endswith(".png") else None

    def _read(self, index: int) -> np.ndarray:
        """One item read and resized: a PNG file through the native loader
        (:mod:`.native`), anything else (``.jpg``, the CT file) by its
        source and ``resize_shorter_side_np``."""
        path = self._png_path(index)
        if path is not None:
            x = native.decode(path)
            return x if self.size is None else native.resize_shorter_side(x, self.size)
        x = self.source.load(index)
        if self.size is not None:
            x = resize_shorter_side_np(x, self.size, antialias=True)
        return x

    def load_all(self, n_threads: int = 16) -> list[np.ndarray]:
        """Every image, in order (``sei_tpu/data/__init__.py:97-121``): the
        PNG files read on ``n_threads`` host threads, the rest item by item.
        The native loader does not fall back: a file it cannot read
        raises."""
        n = len(self)
        pngs = [i for i in range(n) if not (self.memoize and i in self._cache)
                and self._png_path(i) is not None]
        loaded = {}
        if pngs:
            native.library()  # built once, before the threads start
            with ThreadPoolExecutor(max(1, min(n_threads, len(pngs)))) as pool:
                loaded = dict(zip(pngs, pool.map(self._read, pngs)))
            if self.memoize:
                self._cache.update(loaded)
        return [loaded[i] if i in loaded else self[i] for i in range(n)]


@dataclasses.dataclass
class DeviceDataCache:
    """The dataset as padded device tensors.

    x: (N, C, Hmax, Wmax) clean images, zero-padded bottom/right (Hmax,
    Wmax multiples of ``rate``); y: the measurements, (N, C, Hmax / rate,
    Wmax / rate); heights/widths: each image's true x size rounded up to a
    multiple of ``rate`` (on the device, where the crop ranges are drawn);
    ids: per-image seed ids (host); rate: x's size over y's (the SR rate,
    else 1).
    """

    x: torch.Tensor
    y: torch.Tensor
    heights: torch.Tensor
    widths: torch.Tensor
    ids: torch.Tensor
    rate: int = 1

    def __len__(self) -> int:
        return self.x.shape[0]


def image_seed(seed: int, image_id: int) -> int:
    """The degradation seed of one image: a mix of the run's seed and the
    image's id (the JAX package folds the id into its base key)."""
    return int(np.random.SeedSequence([seed, image_id]).generate_state(1)[0])


def build_device_cache(images: Union[GroundTruthDataset, Sequence[np.ndarray]], physics, *,
                       seed: int = 0, ids: Optional[Sequence[int]] = None,
                       unique_seeds: bool = True, upsample_y_to_x: bool = False,
                       device=None) -> DeviceDataCache:
    """Pad the (C, H, W) images to one size (a multiple of the SR rate),
    degrade each padded image once on the device with its own seeded
    generator (the deterministic, frozen measurements), and keep both on
    the device (default: the physics' device).  ``images``: a
    :class:`GroundTruthDataset` (each image's id its ``unique_id``) or
    arrays (ids ``ids``, default their index); ``unique_seeds=False`` gives
    every image the id 0, as the reference's
    ``--no-SyntheticDataset__unique_seeds``.  ``upsample_y_to_x`` (the
    homogeneous SwinIR's data, ``sei_tpu/data/__init__.py:214-225``): each
    SR measurement bicubic-upsampled to x's size, and the cache has rate 1.
    With fresh measurements the trainer degrades x anew at every step and
    never reads this y."""
    dev = physics.device if device is None else torch.device(device)
    rate = physics.rate if physics.task == "sr" else 1
    if isinstance(images, GroundTruthDataset):
        if ids is not None:
            raise ValueError("a GroundTruthDataset brings its own ids")
        ids = [images.unique_id(i) for i in range(len(images))]
        images = images.load_all()
    ids = list(range(len(images))) if ids is None else list(ids)
    if not unique_seeds:
        ids = [0] * len(images)
    hs = np.array([im.shape[-2] for im in images])
    ws = np.array([im.shape[-1] for im in images])
    hmax, wmax = int(hs.max()), int(ws.max())
    hmax += (-hmax) % rate
    wmax += (-wmax) % rate
    x = np.zeros((len(images), images[0].shape[0], hmax, wmax), np.float32)
    for i, im in enumerate(images):
        x[i, :, : im.shape[-2], : im.shape[-1]] = im
    x_dev = torch.from_numpy(x).to(dev)
    y_dev = torch.cat([physics.randomly_degrade(x_dev[i:i + 1], image_seed(seed, ids[i]))
                       for i in range(len(images))])
    if upsample_y_to_x and rate > 1:
        y_dev = resize(y_dev, size=(hmax, wmax), antialias=False)
        rate = 1
    return DeviceDataCache(x=x_dev, y=y_dev,
                           heights=torch.tensor((hs + (-hs) % rate).tolist(), device=dev),
                           widths=torch.tensor((ws + (-ws) % rate).tolist(), device=dev),
                           ids=torch.tensor(ids), rate=rate)


def epoch_indices(perm: torch.Tensor, step_in_epoch: int, batch_size: int) -> torch.Tensor:
    """The images of one step: a slice of the epoch's permutation (wrapping
    only when the batch is larger than the dataset)."""
    n = perm.shape[0]
    return perm[(step_in_epoch * batch_size + torch.arange(batch_size)) % n]


def build_finetuning_cache(dataset_dir: str, crop_size: int, rng: np.random.Generator, *,
                           device=None) -> DeviceDataCache:
    """The fine-tuning set of a folder of measurements (``demo/train.py:38-62``):
    y a ``crop_size`` crop of each image (zero-padded bottom/right to the
    crop first where smaller) at offsets drawn from ``rng`` on the host (top,
    then left), x all zeros (the proposed loss never reads it)."""
    src = FolderDataset(dataset_dir)
    ys = []
    for i in range(len(src)):
        im = src.load(i)
        _, h, w = im.shape
        if h < crop_size or w < crop_size:
            im = np.pad(im, ((0, 0), (0, max(0, crop_size - h)), (0, max(0, crop_size - w))))
            _, h, w = im.shape
        top = int(rng.integers(0, h - crop_size + 1))
        left = int(rng.integers(0, w - crop_size + 1))
        ys.append(im[:, top:top + crop_size, left:left + crop_size])
    dev = resolve_device(device)
    y = torch.from_numpy(np.stack(ys).astype(np.float32)).to(dev)
    n = y.shape[0]
    size = torch.full((n,), crop_size, dtype=torch.int64, device=dev)
    return DeviceDataCache(x=torch.zeros_like(y), y=y, heights=size, widths=size.clone(),
                           ids=torch.arange(n), rate=1)


def sample_train_batch(cache: DeviceDataCache, idx: torch.Tensor, *, crop_size: int = 256,
                       generator: Optional[torch.Generator] = None,
                       offsets: Optional[torch.Tensor] = None, physics=None,
                       css: bool = False, fresh_measurements: bool = False,
                       noise_generator: Optional[torch.Generator] = None):
    """(x, y) crops of the images ``idx`` (an int64 tensor, best on the
    cache's device: the trainer's static index buffer): MinSizePadding (y to
    ``crop_size``, x to ``crop_size * rate``), then per image a ``crop_size``
    crop of y inside its true region (h / rate, w / rate) and the aligned
    ``crop_size * rate`` crop of x, at y offsets ``offsets`` (B, 2) or
    offsets drawn from ``generator`` (the crop stream, on the cache's
    device).  First, on the gathered whole images, ``fresh_measurements``
    makes y = degrade(x) and then ``css`` (x, y) -> (y, degrade(y)), each
    by ``physics`` with noise from ``noise_generator``
    (``sei_tpu/data/__init__.py:285-293``).  On the device throughout: a
    CUDA graph of the step holds it."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=cache.x.device)
    r = cache.rate
    if css and r > 1:
        # the JAX package runs this combination, but its swapped pair has
        # the measurement's size on both sides: its crops clamp into pairs
        # that do not line up; the port gives it no meaning
        raise ValueError("css with sr: the swapped pair (y, degrade(y)) has no x at "
                         f"{r} times the measurement's size")
    if offsets is None:
        hs, ws = cache.heights[idx], cache.widths[idx]
        if r > 1:
            hs, ws = hs // r, ws // r
        offsets = crop_offsets(generator, hs, ws, crop_size)
    x, y = cache.x[idx], cache.y[idx]
    if fresh_measurements:
        y = physics.degrade(x, noise_generator)
    if css:
        x, y = y, physics.degrade(y, noise_generator)
    x = pad_min_size(x, crop_size * r, crop_size * r)
    y = pad_min_size(y, crop_size, crop_size)
    return crop_pair_batch(x, y, size=crop_size, xy_size_ratio=r, offsets=offsets)


__all__ = ["DeviceDataCache", "Div2K", "FMD", "FolderDataset", "GroundTruthDataset",
           "ImageSource", "SingleImageDataset", "TomographyDataset", "Urban100",
           "build_device_cache", "build_finetuning_cache", "epoch_indices", "image_seed",
           "read_image", "sample_train_batch", "write_image"]
