"""Model registry (counterpart of ``sei_tpu/models/__init__.py``).

Every kind of ``KINDS`` (``kind`` takes the README spellings too,
``KIND_ALIASES``):

- ``Proposed``, the trained network (:class:`Model`): the ``Transformer``
  architecture (SwinIR: the deblurring/denoising head, or for ``task="sr"``
  the pixelshuffle head, or with ``homogeneous_swinir`` a rate-1 SwinIR on
  the bicubic pre-upsampled measurement) or the ``Convolutional`` one
  (:mod:`.convolutional`, shaped by ``conv_blueprint``, always f32);
- ``Identity`` (x_hat = y) and ``Upsample`` (bicubic by the SR factor);
- the eval-only baselines, each a :class:`FunctionalModel` of the physics:
  ``InverseFilter``, ``TV``, ``DeepImagePrior`` (:mod:`.baselines`),
  ``BM3D`` (:mod:`.bm3d`), and ``PlugAndPlay``, ``DiffPIR_DRUNet``,
  ``DiffPIR_DiffUNet``, ``DPS`` (:mod:`.denoiser_solvers`), which need
  local denoiser weights (:mod:`.pnp`) and raise without them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..ops.resize import resize
from . import convolutional
from .baselines import dip_model, inverse_filter_model, tv_model
from .convolutional import ConvolutionalModel
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
    """A trainable network (SwinIR or the Convolutional UNet) on its device;
    ``model(y)`` restores a batch."""

    module: Any  # SwinIR or ConvolutionalModel
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
        checkpoint with a ``params`` entry, or a JAX params tree (numpy).  A
        Convolutional network takes only its own names in a state_dict (the
        port's checkpoints): any other raises, as no converter exists."""
        if _is_full_checkpoint(weights):
            weights = weights["params"]
        if any("." in k for k in weights):
            sd = clean_state_dict(weights)
        elif isinstance(self.module, ConvolutionalModel):
            sd = convolutional.jax_params_to_state_dict(weights)
        else:
            sd = jax_params_to_state_dict(weights)
        self.module.load_state_dict(sd, strict=True)

    def save_reference_format(self, path: str) -> None:
        """Write the weights as a torch state_dict of f32 CPU tensors: for
        SwinIR the reference format (its names, without the buffers it
        recomputes), which the reference repo and the JAX package's
        ``get_weights`` read (``sei_tpu/models/__init__.py:175``); for the
        Convolutional network its own names, which :meth:`load_weights`
        reads back."""
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


@dataclasses.dataclass
class FunctionalModel:
    """An eval-only baseline: ``model(y)`` is ``fn(y)`` on ``device``;
    nothing to train, nothing to load (``load_weights`` ignores its
    argument, as the JAX package's does).  ``scale``: output size over
    input size."""

    fn: Callable
    kind: str
    device: torch.device
    scale: int = 1
    module = None
    trainable = False

    def __call__(self, y: Any) -> torch.Tensor:
        return self.fn(torch.as_tensor(y, dtype=torch.float32, device=self.device))

    def load_weights(self, weights) -> None:
        pass


def get_model(*, kind: str = "Proposed", architecture: str = "Transformer",
              task: str = "deblurring", sr_factor: Optional[int] = None,
              device: DeviceLike = None, seed: int = 0,
              homogeneous_swinir: bool = False,
              swinir_overrides: Optional[dict] = None,
              dtype: Optional[torch.dtype] = None, fused_trunk: Optional[bool] = None,
              fast_gelu: Optional[bool] = None, physics=None,
              noise_level: float = 5.0, conv_blueprint: Optional[dict] = None,
              dip_iterations: Optional[int] = None, tv_lambd: Optional[float] = None,
              tv_max_iter: int = 300, kernel_name: Optional[str] = None):
    """Build a model with weights initialised from ``seed`` on ``device``
    (default the GPU; raises without one unless ``device="cpu"``).
    ``dtype`` is SwinIR's compute dtype: None (f32) or ``torch.bfloat16``,
    as ``demo/train.py --bf16`` sets it (:111-112); params stay f32; the
    Convolutional network stays f32 (``demo/train.py:107``).
    ``fused_trunk``: SwinIR's blocks through the fused trunk kernels (True)
    or as modules (False); None reads ``SEI_FUSED_TRUNK`` (unset: fused), so
    the command lines reach the module path with ``SEI_FUSED_TRUNK=0``.
    ``fast_gelu``: the fused trunk's GELU form (True the polynomial, False
    exact); None reads ``SEI_FAST_GELU`` (unset: the polynomial in bf16
    only), so the command lines reach it with that variable.
    ``kind="Identity"`` gives an :class:`IdentityModel`, ``"Upsample"`` an
    :class:`UpsampleModel` by ``sr_factor``, a baseline a
    :class:`FunctionalModel` of ``physics`` (whose device it runs on):
    ``TV`` with ``tv_lambd`` / ``tv_max_iter``; ``DeepImagePrior`` with
    ``dip_iterations`` (default 4000 for deblurring with a Gaussian
    ``kernel_name``, else 1000); ``BM3D`` and the denoiser priors at
    ``noise_level``."""
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
    if kind == "Proposed":
        if architecture == "Transformer":
            module = SwinIR(**swinir_config(task=task, sr_factor=sr_factor,
                                            homogeneous=homogeneous_swinir,
                                            overrides=swinir_overrides), dtype=dtype,
                            fused_trunk=fused_trunk, fast_gelu=fast_gelu)
        elif architecture == "Convolutional":  # blueprint keys: ConvolutionalModel's
            rate = sr_factor if task == "sr" and sr_factor else 1
            module = ConvolutionalModel(upsampling_rate=rate, **(conv_blueprint or {}))
        else:
            raise ValueError(f"Unknown model kind: {architecture}")
        module.reset_parameters(torch.Generator().manual_seed(seed))
        return Model(module=module.to(dev).eval(), device=dev)
    if physics is None:
        raise ValueError(f"{kind} needs the physics")
    scale = sr_factor if task == "sr" and sr_factor else 1
    if kind == "InverseFilter":
        fn = inverse_filter_model(physics)
    elif kind == "TV":
        fn = tv_model(physics, lambd=tv_lambd, max_iter=tv_max_iter)
    elif kind == "DeepImagePrior":
        if dip_iterations is None:  # ref src/models/__init__.py:194-204
            gaussian = task == "deblurring" and kernel_name and "Gaussian" in kernel_name
            dip_iterations = 4000 if gaussian else 1000
        fn = dip_model(physics, iterations=dip_iterations, sr_factor=sr_factor)
    elif kind == "BM3D":
        from .bm3d import bm3d_model

        fn = bm3d_model(physics, sigma_psd=noise_level / 255.0)
    else:
        from .pnp import get_denoiser_model

        model = get_denoiser_model(kind, physics=physics, noise_level=noise_level, device=dev)
        model.scale = scale
        return model
    return FunctionalModel(fn, kind, dev, scale)


__all__ = ["ConvolutionalModel", "FunctionalModel", "IdentityModel", "KINDS", "KIND_ALIASES",
           "Model", "SwinIR", "UpsampleModel", "get_model", "jax_params_to_state_dict",
           "load_torch_file", "swinir_config"]
