"""The random streams of a training run, as explicit ``torch.Generator``s.

The JAX package splits one key per step into batch, loss and dropout keys.
The port keeps one generator per stream instead, each seeded from the run's
seed, so a stream's draws do not move when another stream draws more or
less.  The two packages give different numbers from the same seed; the
golden tests hand both the same draws.
"""

from __future__ import annotations

import dataclasses

import torch

_STREAMS = ("batch", "crop", "probe", "transform", "dropout")


@dataclasses.dataclass
class Streams:
    """batch: the per-epoch image permutation (host); crop: dataset and loss
    crop offsets (host, so slicing needs no device sync); probe: the SURE
    probe, transform: the scaling rates and centers, dropout: drop-path
    keep masks (all three on the training device)."""

    batch: torch.Generator
    crop: torch.Generator
    probe: torch.Generator
    transform: torch.Generator
    dropout: torch.Generator


def make_streams(seed: int, device) -> Streams:
    device = torch.device(device)
    gens = {}
    for i, name in enumerate(_STREAMS):
        dev = "cpu" if name in ("batch", "crop") else device
        gens[name] = torch.Generator(device=dev).manual_seed(seed * len(_STREAMS) + i)
    return Streams(**gens)
