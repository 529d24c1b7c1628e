"""Weights carried across: JAX params trees and torch checkpoints -> the
port's SwinIR ``state_dict``.

The port's own copy of the ``flax_swinir_to_torch`` mapping in
``sei_tpu/models/torch_io.py`` (no JAX needed: the tree's leaves are numpy
arrays):
  conv kernel (HWIO)              -> weight (OIHW)
  Dense kernel (in, out)          -> weight (out, in)
  LayerNorm scale                 -> weight
  layers_{i}.blocks_{j}.*         -> layers.{i}.residual_group.blocks.{j}.*
  layers_{i}.conv                 -> layers.{i}.conv
  patch_embed_norm                -> patch_embed.norm
  conv_before_upsample_0 / upsample_{k} -> conv_before_upsample.0 / upsample.{2k}
The reference checkpoints' ``attn_mask`` / ``relative_position_index``
buffers are dropped: the port recomputes them.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_SKIP = ("attn_mask", "relative_position_index", "absolute_pos_embed")


def _module_to_torch_name(mod: str) -> str:
    m = re.match(r"layers_(\d+)\.blocks_(\d+)\.(.*)", mod)
    if m:
        return f"layers.{m.group(1)}.residual_group.blocks.{m.group(2)}.{m.group(3)}"
    m = re.match(r"layers_(\d+)\.conv(?:_(\d+))?$", mod)
    if m:
        suffix = f".{m.group(2)}" if m.group(2) else ""
        return f"layers.{m.group(1)}.conv{suffix}"
    if mod == "patch_embed_norm":
        return "patch_embed.norm"
    if mod == "conv_before_upsample_0":
        return "conv_before_upsample.0"
    m = re.match(r"upsample_(\d+)$", mod)
    if m:
        return f"upsample.{2 * int(m.group(1))}"
    return mod


def _leaves(tree: dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_params_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """Turn the JAX package's SwinIR params tree (numpy leaves) into the
    port's ``state_dict`` (f32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _leaves(params):
        tname = _module_to_torch_name(".".join(path[:-1]))
        leaf = path[-1]
        v = np.array(v, dtype=np.float32)  # a writable copy
        if leaf == "kernel" and v.ndim == 4:
            key, v = f"{tname}.weight", v.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            key, v = f"{tname}.weight", v.T
        elif leaf == "scale":
            key = f"{tname}.weight"
        elif leaf == "bias":
            key = f"{tname}.bias"
        elif leaf == "relative_position_bias_table":
            key = f"{tname}.relative_position_bias_table"
        else:
            raise ValueError(f"unmapped JAX leaf: {'.'.join(path)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def clean_state_dict(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference-format torch state_dict (tensor or numpy values) as f32
    tensors, without the buffers the port recomputes."""
    return {
        k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                           dtype=torch.float32)
        for k, v in sd.items() if not any(s in k for s in _SKIP)
    }


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """Load a torch .pt/.pth SwinIR checkpoint; unwraps a ``params`` entry."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and isinstance(obj.get("params"), dict):
        obj = obj["params"]
    return clean_state_dict({k: v for k, v in obj.items() if torch.is_tensor(v)})
