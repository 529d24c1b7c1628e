"""Training data on the device (counterpart of ``sei_tpu/data/__init__.py``,
``DeviceDataCache`` / ``build_device_cache`` / ``sample_train_batch``).

The reference's measurements are deterministic per image and frozen across
epochs, so each (x, y) pair is synthesized once, on the device, and the
whole dataset stays there as padded tensors.  A step's batch is then a
gather of images and an aligned random crop, with no host round trip for
pixels.  Image loading, the dataset registry and fresh (non-frozen)
measurements are not ported yet (ROADMAP, Queue 1: data and the main-path
CLI).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..transforms.crop import crop_offsets, crop_pair_batch, pad_min_size


@dataclasses.dataclass
class DeviceDataCache:
    """The dataset as padded device tensors.

    x: (N, C, Hmax, Wmax) clean images, zero-padded bottom/right; y: the
    measurements, same shape; heights/widths: each image's true size (on
    the device, where the crop ranges are drawn); ids: per-image seed ids
    (host).
    """

    x: torch.Tensor
    y: torch.Tensor
    heights: torch.Tensor
    widths: torch.Tensor
    ids: torch.Tensor

    def __len__(self) -> int:
        return self.x.shape[0]


def image_seed(seed: int, image_id: int) -> int:
    """The degradation seed of one image: a mix of the run's seed and the
    image's id (the JAX package folds the id into its base key)."""
    return int(np.random.SeedSequence([seed, image_id]).generate_state(1)[0])


def build_device_cache(images: Sequence[np.ndarray], physics, *, seed: int = 0,
                       ids: Optional[Sequence[int]] = None, device=None) -> DeviceDataCache:
    """Pad the (C, H, W) images to one size, degrade each once on the
    device with its own seeded generator, and keep both on the device
    (default: the physics' device)."""
    dev = physics.kernel.device if device is None else torch.device(device)
    hs = [im.shape[-2] for im in images]
    ws = [im.shape[-1] for im in images]
    x = np.zeros((len(images), images[0].shape[0], max(hs), max(ws)), np.float32)
    for i, im in enumerate(images):
        x[i, :, : im.shape[-2], : im.shape[-1]] = im
    ids = list(range(len(images))) if ids is None else list(ids)
    x_dev = torch.from_numpy(x).to(dev)
    y_dev = torch.cat([physics.randomly_degrade(x_dev[i:i + 1], image_seed(seed, ids[i]))
                       for i in range(len(images))])
    return DeviceDataCache(x=x_dev, y=y_dev, heights=torch.tensor(hs, device=dev),
                           widths=torch.tensor(ws, device=dev), ids=torch.tensor(ids))


def epoch_indices(perm: torch.Tensor, step_in_epoch: int, batch_size: int) -> torch.Tensor:
    """The images of one step: a slice of the epoch's permutation (wrapping
    only when the batch is larger than the dataset)."""
    n = perm.shape[0]
    return perm[(step_in_epoch * batch_size + torch.arange(batch_size)) % n]


def sample_train_batch(cache: DeviceDataCache, idx: torch.Tensor, *, crop_size: int = 256,
                       generator: Optional[torch.Generator] = None,
                       offsets: Optional[torch.Tensor] = None):
    """(x, y) crops of the images ``idx`` (an int64 tensor, best on the
    cache's device: the trainer's static index buffer): MinSizePadding to
    ``crop_size``, then an aligned ``crop_size`` crop per image inside its
    true region, at ``offsets`` (B, 2) or offsets drawn from ``generator``
    (the crop stream, on the cache's device).  On the device throughout: a
    CUDA graph of the step holds it."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=cache.x.device)
    if offsets is None:
        offsets = crop_offsets(generator, cache.heights[idx], cache.widths[idx], crop_size)
    x = pad_min_size(cache.x[idx], crop_size, crop_size)
    y = pad_min_size(cache.y[idx], crop_size, crop_size)
    return crop_pair_batch(x, y, size=crop_size, offsets=offsets)


__all__ = ["DeviceDataCache", "build_device_cache", "epoch_indices", "image_seed",
           "sample_train_batch"]
