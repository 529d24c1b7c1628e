"""Noise2Inverse (counterpart of ``sei_tpu/noise2inverse.py``).

The measurement is split into ``num_splits`` row combs (split j keeps rows
j, j + num_splits, ...; zeros elsewhere), each comb is backprojected (the
spectral inverse filter for deblurring, the physics' ``A_dagger``
otherwise), and with the ``X:1`` strategy the backbone restores the sum of
every (num_splits - 1)-subset; the ensemble is the sum of those
restorations (4 splits: 4 forwards of 3-comb sums).  The training pair of
one measurement (target: the left-out combs' sum, input: the subset's) is
here too, as in the JAX package, where training does not use it.
"""

from __future__ import annotations

from itertools import combinations
from typing import Callable, Optional, Union

import torch

from .ops.fft_conv import inverse_filter


def measurement_slices(y: torch.Tensor, num_splits: int) -> list:
    """Row-comb splits: slice j keeps rows j::num_splits, zeros elsewhere."""
    rows = torch.arange(y.shape[-2], device=y.device)
    return [y * ((rows % num_splits) == j).to(y.dtype)[:, None] for j in range(num_splits)]


def make_backproject(task: str, kernel, degradation_inverse_fn: Optional[Callable]) -> Callable:
    if task == "deblurring":
        if kernel is None:
            raise ValueError("deblurring's backprojection needs the kernel")
        return lambda ys: inverse_filter(ys, kernel)
    return degradation_inverse_fn


def _subsets(num_splits: int, strategy: str) -> list:
    num_input = num_splits - 1 if strategy == "X:1" else 1
    return list(combinations(range(num_splits), num_input))


def noise2inverse_model(backbone: Callable, *, task: str, kernel=None,
                        degradation_inverse_fn: Optional[Callable] = None,
                        num_splits: int = 4, strategy: str = "X:1") -> Callable:
    """The backbone (y -> x) wrapped into the subset-sum ensemble."""
    backproject = make_backproject(task, kernel, degradation_inverse_fn)
    subsets = _subsets(num_splits, strategy)

    def apply(y: torch.Tensor) -> torch.Tensor:
        images = [backproject(s) for s in measurement_slices(y, num_splits)]
        return sum(backbone(sum(images[j] for j in idxs)) for idxs in subsets)

    return apply


def noise2inverse_train_pair(y: torch.Tensor, *, task: str, kernel=None,
                             degradation_inverse_fn: Optional[Callable] = None,
                             num_splits: int = 4, strategy: str = "X:1",
                             generator: Optional[torch.Generator] = None,
                             pick: Union[int, torch.Tensor, None] = None):
    """(target, input) from one measurement batch: one subset for the
    batch, ``pick`` or drawn uniformly from ``generator`` (a device tensor:
    every subset's pair is formed and the drawn one selected on the device,
    as the JAX package's ``lax.switch``)."""
    backproject = make_backproject(task, kernel, degradation_inverse_fn)
    subsets = _subsets(num_splits, strategy)
    images = [backproject(s) for s in measurement_slices(y, num_splits)]
    pairs = []
    for idxs in subsets:
        rest = sorted(set(range(num_splits)) - set(idxs))
        pairs.append((sum(images[j] for j in rest), sum(images[j] for j in idxs)))
    if pick is None:
        dev = y.device if generator is None else generator.device
        pick = torch.randint(0, len(subsets), (), generator=generator, device=dev)
    if isinstance(pick, int):
        return pairs[pick]
    pick = pick.to(y.device)
    tgt = torch.stack([t for t, _ in pairs]).index_select(0, pick.reshape(1))[0]
    inp = torch.stack([i for _, i in pairs]).index_select(0, pick.reshape(1))[0]
    return tgt, inp
