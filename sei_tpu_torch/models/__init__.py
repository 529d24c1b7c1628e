"""Model registry (counterpart of ``sei_tpu/models/__init__.py``).

Ported: the trained network, ``Proposed`` with the ``Transformer``
architecture (SwinIR: the deblurring/denoising head, or for ``task="sr"``
the pixelshuffle head, or with ``homogeneous_swinir`` a rate-1 SwinIR on the
bicubic pre-upsampled measurement), the ``Identity`` baseline (x_hat = y,
``sei_tpu/models/baselines.py:23``), the eval's floor, and the ``Upsample``
baseline (bicubic by the SR factor, ``baselines.py:31-33``); ``kind`` takes
the README spellings too (``KIND_ALIASES``: ``swinir`` is ``Proposed``,
``id`` is ``Identity``, ``up`` is ``Upsample``).  The other kinds raise
``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..ops.resize import resize
from .swinir import SwinIR
from .torch_io import clean_state_dict, jax_params_to_state_dict, load_torch_file

KINDS = ("Proposed", "DeepImagePrior", "PlugAndPlay", "BM3D", "DiffPIR_DRUNet",
         "DiffPIR_DiffUNet", "DPS", "TV", "Identity", "InverseFilter", "Upsample")

# README spellings (the JAX package's ``KIND_ALIASES``)
KIND_ALIASES = {"swinir": "Proposed", "dip": "DeepImagePrior", "pnp": "PlugAndPlay",
                "bm3d": "BM3D", "up": "Upsample", "id": "Identity"}


def swinir_config(*, task: str, sr_factor: Optional[int] = None, homogeneous: bool = False,
                  overrides: Optional[dict] = None) -> dict:
    """The reference's trained SwinIR config (flagship: embed 180, depths
    6x6, heads 6, window 8, MLP ratio 2, drop-path 0.1, 1conv RSTB tail);
    for SR the pixelshuffle head at ``sr_factor``, unless ``homogeneous``
    (upscale 1, no head).  ``overrides`` (embed_dim / depths / num_heads /
    window_size / drop_path_rate) shrink it for tests; ``None`` values are
    ignored."""
    sr_head = task == "sr" and bool(sr_factor) and sr_factor > 1 and not homogeneous
    cfg = dict(
        upsampler="pixelshuffle" if sr_head else None,
        upscale=sr_factor if sr_head else 1,
        embed_dim=180, depths=(6,) * 6, num_heads=(6,) * 6,
        window_size=8, mlp_ratio=2.0, drop_path_rate=0.1,
    )
    for k, v in (overrides or {}).items():
        if v is None:
            continue
        if k not in cfg:
            raise ValueError(f"unknown SwinIR override {k}")
        cfg[k] = tuple(v) if isinstance(v, list) else v
    return cfg


def _is_full_checkpoint(w) -> bool:
    return isinstance(w, dict) and "params" in w and (
        "epoch" in w or "opt_state" in w or "optimizer" in w)


@dataclasses.dataclass
class Model:
    """A SwinIR module on its device; ``model(y)`` restores a batch."""

    module: SwinIR
    device: torch.device

    @property
    def scale(self) -> int:
        """Output size over input size."""
        return self.module.upscale

    def __call__(self, y: Any) -> torch.Tensor:
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            return self.module(y)

    def load_weights(self, weights) -> None:
        """Accept a torch state_dict (tensor or numpy values), a full training
        checkpoint with a ``params`` entry, or a JAX params tree (numpy)."""
        if _is_full_checkpoint(weights):
            weights = weights["params"]
        if any("." in k for k in weights):
            sd = clean_state_dict(weights)
        else:
            sd = jax_params_to_state_dict(weights)
        self.module.load_state_dict(sd, strict=True)

    def save_reference_format(self, path: str) -> None:
        """Write the weights as a reference-format torch state_dict (f32 CPU
        tensors under the reference SwinIR's names, without the buffers it
        recomputes), which the reference repo and the JAX package's
        ``get_weights`` read (``sei_tpu/models/__init__.py:175``)."""
        torch.save(clean_state_dict({k: v.detach().cpu() for k, v in
                                     self.module.state_dict().items()}), path)


@dataclasses.dataclass
class IdentityModel:
    """The Identity baseline: ``model(y)`` is y; nothing to train or load."""

    device: torch.device
    module = None
    scale = 1
    trainable = False

    def __call__(self, y: Any) -> torch.Tensor:
        return torch.as_tensor(y, dtype=torch.float32, device=self.device)


@dataclasses.dataclass
class UpsampleModel:
    """The Upsample baseline: ``model(y)`` is y bicubic-upsampled by
    ``scale``, not antialiased (``sei_tpu/models/baselines.py:31-33``)."""

    device: torch.device
    scale: int
    module = None
    trainable = False

    def __call__(self, y: Any) -> torch.Tensor:
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        return resize(y, scale_factor=float(self.scale), antialias=False)


def get_model(*, kind: str = "Proposed", architecture: str = "Transformer",
              task: str = "deblurring", sr_factor: Optional[int] = None,
              device: DeviceLike = None, seed: int = 0,
              homogeneous_swinir: bool = False,
              swinir_overrides: Optional[dict] = None,
              dtype: Optional[torch.dtype] = None):
    """Build a model with weights initialised from ``seed`` on ``device``
    (default the GPU; raises without one unless ``device="cpu"``).
    ``dtype`` is SwinIR's compute dtype: None (f32) or ``torch.bfloat16``,
    as ``demo/train.py --bf16`` sets it (:111-112); params stay f32.
    ``kind="Identity"`` gives an :class:`IdentityModel`, ``"Upsample"`` an
    :class:`UpsampleModel` by ``sr_factor``."""
    kind = KIND_ALIASES.get(kind, kind)
    if kind not in KINDS:
        raise ValueError(f"Unknown model kind: {kind}")
    dev = resolve_device(device)
    if kind == "Identity":
        return IdentityModel(device=dev)
    if kind == "Upsample":
        if not sr_factor:
            raise ValueError("Upsample needs sr_factor")
        return UpsampleModel(device=dev, scale=sr_factor)
    if kind != "Proposed" or architecture != "Transformer":
        raise NotImplementedError(
            f"{kind}/{architecture}: not ported yet (ROADMAP, Queue 1 item 6: baselines "
            "and the rest of the model registry)")
    module = SwinIR(**swinir_config(task=task, sr_factor=sr_factor,
                                    homogeneous=homogeneous_swinir,
                                    overrides=swinir_overrides), dtype=dtype)
    module.reset_parameters(torch.Generator().manual_seed(seed))
    return Model(module=module.to(dev).eval(), device=dev)


__all__ = ["IdentityModel", "KINDS", "KIND_ALIASES", "Model", "SwinIR", "UpsampleModel",
           "get_model", "jax_params_to_state_dict", "load_torch_file", "swinir_config"]
