"""The random streams of a training run, as explicit ``torch.Generator``s.

The JAX package splits one key per step into batch, loss and dropout keys.
The port keeps one generator per stream instead, each seeded from the run's
seed, so a stream's draws do not move when another stream draws more or
less.  The two packages give different numbers from the same seed; the
golden tests hand both the same draws.

Every stream but ``batch`` lives on the training device, so a step draws its
crops, probe, scaling parameters and drop-path masks there, as the JAX
package draws them inside its jitted step.  A CUDA graph of the step
registers each device stream (:meth:`Streams.device_generators`), so each
replay draws new numbers from where the stream stands.

``noise`` (the JAX step's noise key) draws the measurement noise of a
step: fresh measurements and CSS's re-degradation.  It is seeded apart
from the five streams above (``NOISE_SEED_BASE + seed``), so their seeds,
``seed * 5 + i``, are those of runs without it; a checkpoint written
without a ``noise`` state leaves the stream as :func:`make_streams` seeded
it.
"""

from __future__ import annotations

import dataclasses

import torch

_STREAMS = ("batch", "crop", "probe", "transform", "dropout")
NOISE_SEED_BASE = 1 << 62  # far above every seed * 5 + i of the streams above
_NAMES = _STREAMS + ("noise",)


@dataclasses.dataclass
class Streams:
    """batch: the per-epoch image permutation (host); on the training
    device: crop, the dataset and loss crop offsets; probe, the SURE probe;
    transform, the scaling rates and centers; dropout, the drop-path keep
    masks; noise, the measurement noise of fresh measurements and CSS."""

    batch: torch.Generator
    crop: torch.Generator
    probe: torch.Generator
    transform: torch.Generator
    dropout: torch.Generator
    noise: torch.Generator

    def device_generators(self) -> list:
        """The streams a training step draws from on the device."""
        return [getattr(self, name) for name in _NAMES if name != "batch"]

    def get_state(self) -> dict:
        """Each stream's state (CPU byte tensors), for a checkpoint."""
        return {name: getattr(self, name).get_state() for name in _NAMES}

    def set_state(self, state: dict) -> None:
        """Load :meth:`get_state`'s dict; one without ``noise`` (written
        before the stream existed) leaves that stream as it is."""
        for name in _NAMES:
            if name in state:
                getattr(self, name).set_state(state[name])
            elif name != "noise":
                raise KeyError(f"no state for the {name} stream")


def make_streams(seed: int, device) -> Streams:
    device = torch.device(device)
    gens = {}
    for i, name in enumerate(_STREAMS):
        dev = "cpu" if name == "batch" else device
        gens[name] = torch.Generator(device=dev).manual_seed(seed * len(_STREAMS) + i)
    gens["noise"] = torch.Generator(device=device).manual_seed(NOISE_SEED_BASE + seed)
    return Streams(**gens)
