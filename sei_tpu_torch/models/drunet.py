"""DRUNet, the denoiser of DPIR (Zhang et al. 2021) (counterpart of
``sei_tpu/models/drunet.py``).

Input: the image concatenated with a constant noise-level map; a 3x3 head
conv; three encoder scales of ``nb`` residual blocks and a 2x2 stride-2
conv; ``nb`` body blocks; three decoder scales of a 2x2 stride-2 transposed
conv and ``nb`` blocks, with additive skips; a 3x3 tail conv.  All convs
bias-free, ReLU inside the blocks; H and W edge-padded to a multiple of 8
and the output cropped back.

The submodules carry the published ``drunet_color.pth`` names
(``m_head``, ``m_down1..3`` = [blocks..., downsample at index ``nb``],
``m_body``, ``m_up3..1`` = [transposed conv at 0, blocks...], ``m_tail``;
a block's convs ``res.0`` and ``res.2``), so such a file loads with
``load_state_dict``.  :func:`load_drunet_native` reads the JAX package's
own ``.npz`` (``save_drunet_native``: flax tree paths ``head``,
``down{i}_res{j}/conv1``, ``down{i}_conv``, ``up{i}_conv``, ... joined by
``/``, plus ``__channels`` and ``__nb``) with numpy alone.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class ResBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.res = nn.Sequential(_conv3(ch, ch), nn.ReLU(), _conv3(ch, ch))

    def forward(self, x):
        return x + self.res(x)


class DRUNet(nn.Module):
    def __init__(self, in_chans: int = 3, out_chans: int = 3,
                 channels: Sequence[int] = (64, 128, 256, 512), nb: int = 4):
        super().__init__()
        c = tuple(channels)
        if len(c) != 4:
            raise ValueError(f"DRUNet has four scales, got channels {c}")
        self.m_head = _conv3(in_chans + 1, c[0])
        for i in range(3):
            setattr(self, f"m_down{i + 1}", nn.Sequential(
                *[ResBlock(c[i]) for _ in range(nb)],
                nn.Conv2d(c[i], c[i + 1], 2, stride=2, bias=False)))
            setattr(self, f"m_up{i + 1}", nn.Sequential(
                nn.ConvTranspose2d(c[i + 1], c[i], 2, stride=2, bias=False),
                *[ResBlock(c[i]) for _ in range(nb)]))
        self.m_body = nn.Sequential(*[ResBlock(c[3]) for _ in range(nb)])
        self.m_tail = _conv3(c[0], out_chans)

    def forward(self, x: torch.Tensor, sigma) -> torch.Tensor:
        """x: (B, C, H, W) in [0, 1]; sigma: the noise level in [0, 1]."""
        h, w = x.shape[-2:]
        x = F.pad(x, (0, (-w) % 8, 0, (-h) % 8), mode="replicate")
        x = torch.cat([x, torch.full_like(x[:, :1], float(sigma))], 1)
        x1 = self.m_head(x)
        x2 = self.m_down1(x1)
        x3 = self.m_down2(x2)
        x4 = self.m_down3(x3)
        x = self.m_body(x4)
        x = self.m_up3(x + x4)
        x = self.m_up2(x + x3)
        x = self.m_up1(x + x2)
        return self.m_tail(x + x1)[..., :h, :w]


def _native_name(path: str, nb: int) -> str:
    """A flax DRUNet tree path (``save_drunet_native``'s key) -> the
    published name."""
    parts = path.split("/")
    mod = parts[0]
    if mod in ("head", "tail"):
        return f"m_{mod}.weight"
    kind, _, rest = mod.partition("_")
    if kind == "body":  # body_res{j}/conv{1,2}
        j = int(mod[len("body_res"):])
        return f"m_body.{j}.res.{0 if parts[1] == 'conv1' else 2}.weight"
    stage = int(kind[-1]) + 1  # flax down0..2 / up0..2 -> m_down1..3 / m_up1..3
    name = kind[:-1]
    if rest == "conv":
        return f"m_{name}{stage}.{nb if name == 'down' else 0}.weight"
    j = int(rest[len("res"):]) + (1 if name == "up" else 0)
    return f"m_{name}{stage}.{j}.res.{0 if parts[1] == 'conv1' else 2}.weight"


def native_to_state_dict(flat: Dict[str, np.ndarray], nb: int) -> Dict[str, torch.Tensor]:
    """The flax kernels of a native file as the published state_dict: conv
    HWIO -> OIHW; a flax ``ConvTranspose`` kernel (H, W, in, out), which
    lax applies unflipped, -> torch's (in, out, H, W) flipped in H and W."""
    out = {}
    for key, v in flat.items():
        v = np.asarray(v, np.float32)
        if key.split("/")[0].startswith("up") and key.split("/")[0].endswith("_conv"):
            v = v[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            v = v.transpose(3, 2, 0, 1)
        out[_native_name(key.rsplit("/", 1)[0], nb)] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def load_drunet_native(path: str) -> DRUNet:
    """A DRUNet (on the CPU) from the JAX package's native ``.npz``."""
    with np.load(path) as z:
        channels = tuple(int(c) for c in z["__channels"])
        nb = int(z["__nb"])
        flat = {k: z[k] for k in z.files if not k.startswith("__")}
    net = DRUNet(channels=channels, nb=nb)
    net.load_state_dict(native_to_state_dict(flat, nb), strict=True)
    return net


def load_drunet(path: str) -> DRUNet:
    """A DRUNet (on the CPU) from a native ``.npz``, or else from a torch
    file holding the published state_dict, loaded into the published widths
    (channels 64, 128, 256, 512, 4 blocks; another file raises)."""
    if path.endswith(".npz"):
        return load_drunet_native(path)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    net = DRUNet()
    net.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()},
                        strict=True)
    return net
