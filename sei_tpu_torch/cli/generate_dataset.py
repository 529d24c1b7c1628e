"""Offline degradation command line (counterpart of
``demo/generate_dataset.py``): every image of a directory through the
physics (A + fresh noise), written under the same name to another.

    python -m sei_tpu_torch.cli.generate_dataset --task deblurring \\
        --kernel Gaussian_R2 --noise_level 5 IMAGE_DIR OUT_DIR

Deblurring, or SR (``--task sr --sr_factor F``: the low-resolution
measurements, each side divided by F).  Unlike
``demo/generate_dataset.py:37``, ``--physics_antialias`` and
``--physics_true_adjoint`` are forwarded to ``get_physics``.  The noise
comes from one generator seeded 0 on the device, drawn image after image.
"""

from __future__ import annotations

import os
import sys

import torch

from ..config import DefaultArgParser
from ..data import FolderDataset, write_image
from .train import setup


def main(argv=None) -> int:
    """Degrade and write every image; returns how many."""
    parser = DefaultArgParser(prog="python -m sei_tpu_torch.cli.generate_dataset")
    # positional image_dir / out_dir as the reference, or --in_dir / --out_dir
    parser.add_argument("image_dir", type=str, nargs="?", default=None)
    parser.add_argument("out_dir_pos", type=str, nargs="?", default=None, metavar="out_dir")
    parser.add_argument("--in_dir", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default=None)
    args = parser.parse_args(argv)
    args.in_dir = args.in_dir or args.image_dir
    args.out_dir = args.out_dir or args.out_dir_pos
    if not args.in_dir or not args.out_dir:
        parser.error("need image_dir and out_dir (positional or --in_dir/--out_dir)")
    device, physics = setup(args)

    src = FolderDataset(args.in_dir)
    gen = torch.Generator(device=device).manual_seed(0)
    for i in range(len(src)):
        x = src.load(i)
        if x.shape[0] != 3:
            raise ValueError(f"{src.path(i)}: {x.shape[0]} channels, expected 3")
        y = physics.degrade(torch.as_tensor(x, device=device)[None], gen)[0]
        write_image(os.path.join(args.out_dir, src.basename(i)), y.cpu().numpy())
    print(f"wrote {len(src)} degraded images to {args.out_dir}")
    return len(src)


if __name__ == "__main__":
    main(sys.argv[1:])
