"""Model registry (counterpart of ``sei_tpu/models/__init__.py``).

This slice ports the trained network of the main path: ``Proposed`` with the
``Transformer`` architecture (SwinIR, deblurring/denoising head).  The other
kinds and the SR head raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..device import DeviceLike, resolve_device
from .swinir import SwinIR
from .torch_io import clean_state_dict, jax_params_to_state_dict, load_torch_file

def swinir_config(*, task: str, sr_factor: Optional[int] = None,
                  overrides: Optional[dict] = None) -> dict:
    """The reference's trained SwinIR config (flagship: embed 180, depths
    6x6, heads 6, window 8, MLP ratio 2, drop-path 0.1, 1conv RSTB tail).
    ``overrides`` (embed_dim / depths / num_heads / window_size /
    drop_path_rate) shrink it for tests; ``None`` values are ignored."""
    cfg = dict(
        upsampler="pixelshuffle" if task == "sr" and sr_factor and sr_factor > 1 else None,
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


def get_model(*, kind: str = "Proposed", architecture: str = "Transformer",
              task: str = "deblurring", sr_factor: Optional[int] = None,
              device: DeviceLike = None, seed: int = 0,
              swinir_overrides: Optional[dict] = None,
              dtype: Optional[torch.dtype] = None) -> Model:
    """Build a model with weights initialised from ``seed`` on ``device``
    (default the GPU; raises without one unless ``device="cpu"``).
    ``dtype`` is SwinIR's compute dtype: None (f32) or ``torch.bfloat16``,
    as ``demo/train.py --bf16`` sets it (:111-112); params stay f32."""
    dev = resolve_device(device)
    if kind != "Proposed" or architecture != "Transformer":
        raise NotImplementedError(
            f"{kind}/{architecture}: not ported yet (ROADMAP, Queue 1: baselines "
            "and the rest of the model registry)")
    module = SwinIR(**swinir_config(task=task, sr_factor=sr_factor,
                                    overrides=swinir_overrides), dtype=dtype)
    module.reset_parameters(torch.Generator().manual_seed(seed))
    return Model(module=module.to(dev).eval(), device=dev)


__all__ = ["Model", "SwinIR", "get_model", "jax_params_to_state_dict",
           "load_torch_file", "swinir_config"]
