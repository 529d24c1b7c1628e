"""Training throughput of the port on one GPU (counterpart of ``bench.py``).

    python -m sei_tpu_torch.bench

Times the captured ``proposed`` step (flagship SwinIR, deblurring
Gaussian_R2 at noise 5, batch 8, 48 px loss crops from 256 px dataset
crops; one CUDA graph per step) in f32 and in bf16, on 64 seeded random
256x256 images degraded into the device cache, and prints one JSON line:
img/s and ms per step of each, with the card's name and power limit from
``nvidia-smi``.  The first dispatch (warm-up and capture) is not timed;
the host clock runs over ``ITERS`` dispatches issued back to back and one
synchronize.  A yardstick for a quick look, not a benchmark cell: it
claims nothing and compares with nothing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

BATCH, IMAGES, SIZE, ITERS = 8, 64, 256, 20


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _ms_per_step(dtype, images) -> float:
    import torch

    from .data import build_device_cache
    from .losses import get_loss
    from .models import get_model
    from .physics import get_physics
    from .train import Trainer

    physics = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    model = get_model(kind="Proposed", architecture="Transformer", task="deblurring", seed=0,
                      dtype=dtype)
    cache = build_device_cache(images, physics, seed=0)
    loss_fn = get_loss(method="proposed", physics=physics, noise_level=5)
    trainer = Trainer(model, loss_fn, physics, cache, batch_size=BATCH, epochs=1,
                      crop_size=SIZE, seed=0)
    trainer.step()  # warm-up and capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        trainer.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (ITERS * trainer.scan_steps)


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from .device import resolve_device

    resolve_device("cuda")
    rng = np.random.default_rng(0)
    images = list(rng.random((IMAGES, 3, SIZE, SIZE), dtype=np.float32))
    ms = {label: _ms_per_step(dtype, images)
          for label, dtype in (("f32", None), ("bf16", torch.bfloat16))}
    line = {"metric": "train_images_per_sec", "unit": "images/sec",
            **{label: BATCH * 1e3 / v for label, v in ms.items()},
            "ms_per_step": ms, "batch": BATCH, "steps_timed": ITERS,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
