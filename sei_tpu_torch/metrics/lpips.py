"""LPIPS, the AlexNet variant (counterpart of ``sei_tpu/metrics/lpips.py``).

The reference computes LPIPS through pyiqa, which downloads AlexNet and the
linear heads; with no network, :class:`LPIPS` takes one local torch file
holding both: torchvision AlexNet's ``features.*`` and the heads
``lin{i}.model.1.weight`` (or ``lins.{i}.model.1.weight``).  Inputs in
[0, 1] go to [-1, 1], are shifted and scaled by the LPIPS constants, run
through the five conv layers (ReLU; 3x3 stride-2 max-pools after the first
two), each layer's features are unit-normalised over channels, their
squared difference weighted by the layer's head and averaged over space,
and the five layers summed (Zhang et al. 2018).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# torchvision AlexNet's conv layers: features index, stride, padding
_ALEX = ((0, 4, 2), (3, 1, 2), (6, 1, 1), (8, 1, 1), (10, 1, 1))
_POOL_AFTER = (0, 1)


class LPIPS:
    """``LPIPS(path, device)(x_hat, x)``: the distance of the first images
    of two (B, 3, H, W) or (3, H, W) batches, a Python float."""

    def __init__(self, weights_path: str, device=None):
        sd = torch.load(weights_path, map_location="cpu", weights_only=False)
        sd = {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in sd.items()
              if torch.is_tensor(v) or hasattr(v, "shape")}
        self.convs = [(sd[f"features.{i}.weight"], sd[f"features.{i}.bias"], s, p)
                      for i, s, p in _ALEX]
        self.lins = [sd[f"lin{i}.model.1.weight" if f"lin{i}.model.1.weight" in sd
                        else f"lins.{i}.model.1.weight"] for i in range(5)]
        self.shift = torch.tensor(_SHIFT, device=device).view(1, 3, 1, 1)
        self.scale = torch.tensor(_SCALE, device=device).view(1, 3, 1, 1)

    def features(self, x: torch.Tensor) -> list:
        feats, h = [], x
        for ci, (w, b, s, p) in enumerate(self.convs):
            h = F.relu(F.conv2d(h, w, b, stride=s, padding=p))
            feats.append(h)
            if ci in _POOL_AFTER:
                h = F.max_pool2d(h, 3, 2)
        return feats

    def distance(self, x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(B,) distances of (B, 3, H, W) batches."""
        fa = self.features((2.0 * x_hat - 1.0 - self.shift) / self.scale)
        fb = self.features((2.0 * x - 1.0 - self.shift) / self.scale)
        total = 0.0
        for a, b, lin in zip(fa, fb, self.lins):
            an = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            bn = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            total = total + F.conv2d((an - bn) ** 2, lin).mean(dim=(1, 2, 3))
        return total

    def __call__(self, x_hat: torch.Tensor, x: torch.Tensor) -> float:
        x_hat = x_hat[None] if x_hat.dim() == 3 else x_hat
        x = x[None] if x.dim() == 3 else x
        with torch.no_grad():
            return float(self.distance(x_hat.float(), x.float())[0])
