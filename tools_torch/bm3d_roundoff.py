#!/usr/bin/env python
"""Where BM3D's card-against-CPU difference comes from, on one GPU.

``chip_smoke.py``'s baselines phase holds BM3D on the card against the
port on the CPU, on one seeded 256x320 deblurring measurement (Gaussian_R2,
noise 5).  This script restores that measurement, and ``--images - 1``
more made from the next image seeds, four ways: in f32 and in f64, on the
card and on the CPU.  For each pair it prints the largest difference as a
fraction of the reference's largest value, the share of the values
(pixels of each channel) beyond 1e-4 of it, as ``chip_smoke.py`` gates
them, and the share of those values that lies within ``BAND`` px of
the image's border (beside the band's share of the image).  Then, on the
card in f32, it restores ``--perturbations`` copies of y each multiplied
by 1 + u n, n a seeded N(0, 1) draw per value and u f32's unit roundoff
(2**-24), and compares each with the restoration of y itself.

If the f32 differences are roundoff flipping BM3D's discontinuous choices
(the hard threshold at 2.7 sigma, the 8 closest of 81 candidates), a
change of y by one rounding gives the same kind of sparse pattern as the
card against the CPU in f32, flips are rare events that f32 against f64
may or may not meet on a given image, and the two devices agree in f64 by
many more digits.

    python tools_torch/bm3d_roundoff.py --images 3 --perturbations 3
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import H, W, make_images  # noqa: E402
from sei_tpu_torch.evaluate import degraded_pair  # noqa: E402
from sei_tpu_torch.models.bm3d import PATCH, SEARCH, bm3d_deblur  # noqa: E402
from sei_tpu_torch.physics import get_physics  # noqa: E402

FRAC = 1e-4  # chip_smoke's BASELINE_FRAC
BAND = SEARCH + PATCH  # the reflect pad's width
IMAGE_SEED = 6  # chip_smoke's functional_baselines image


def compare(got: torch.Tensor, want: torch.Tensor) -> str:
    got, want = got.double().cpu()[0], want.double().cpu()[0]
    err = (got - want).abs() / want.abs().max()  # (3, H, W), as chip_smoke gates it
    beyond = err > FRAC
    band = torch.ones_like(beyond)
    band[:, BAND:-BAND, BAND:-BAND] = False
    n = int(beyond.sum())
    in_band = float(beyond[band].sum()) / n if n else float("nan")
    return (f"max {float(err.max()):.3e}, {n} values ({n / err.numel():.3e}) beyond {FRAC:g}, "
            f"{in_band:.3f} of them in the {BAND} px border band ({float(band.float().mean()):.3f}"
            " of the image)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=3)
    ap.add_argument("--perturbations", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    physics = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    kernel_cpu = physics.kernel.cpu()
    sigma = 5 / 255.0
    for j in range(args.images):
        image = make_images(1, H, W, seed=IMAGE_SEED + j)[0]
        _, y = degraded_pair(physics, torch.as_tensor(image, device=physics.device), 0)
        y = y[None]
        out, secs = {}, {}
        for label, dev_y, kernel in (("card", y, physics.kernel), ("CPU", y.cpu(), kernel_cpu)):
            for dtype in (torch.float32, torch.float64):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[label, dtype] = bm3d_deblur(dev_y.to(dtype), kernel, sigma)
                torch.cuda.synchronize()
                secs[label, dtype] = time.perf_counter() - t0
        f32, f64 = torch.float32, torch.float64
        print(f"image seed {IMAGE_SEED + j}, {H}x{W}, noise seed 0: BM3D s card f32 "
              f"{secs['card', f32]:.3f} f64 {secs['card', f64]:.3f}, CPU f32 "
              f"{secs['CPU', f32]:.3f} f64 {secs['CPU', f64]:.3f}; {smi}")
        for a, b in ((("card", f32), ("CPU", f32)), (("CPU", f32), ("CPU", f64)),
                     (("card", f32), ("card", f64)), (("card", f64), ("CPU", f64))):
            print(f"  {a[0]} {str(a[1])[6:]} against {b[0]} {str(b[1])[6:]}: "
                  f"{compare(out[a], out[b])}", flush=True)
        unit = torch.finfo(torch.float32).eps / 2
        for k in range(args.perturbations):
            n = torch.randn(y.shape, generator=torch.Generator().manual_seed(k))
            yp = y * (1 + unit * n.to(y.device))
            print(f"  card float32 of y (1 + 2**-24 n), n from seed {k}, against card float32 "
                  f"of y ({int((yp != y).sum())} of {y.numel()} values changed): "
                  f"{compare(bm3d_deblur(yp, physics.kernel, sigma), out['card', f32])}",
                  flush=True)


if __name__ == "__main__":
    main()
