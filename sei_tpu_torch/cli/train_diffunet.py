"""Train a small guided-diffusion UNet (counterpart of
``experiments/train_diffunet.py``) and save it under the published
checkpoint's names (``diffusion_ffhq_10m.pt``'s layout), the weights of
DiffPIR_DiffUNet:

    python -m sei_tpu_torch.cli.train_diffunet --datasets_dir DIR --out runs/diffunet.pt
    SEI_DIFFUNET_WEIGHTS=runs/diffunet.pt python -m sei_tpu_torch.cli.test \\
        --model_kind DiffPIR_DiffUNet ...

The recipe is the JAX script's, flag for flag: DDPM epsilon prediction (Ho
et al.), t ~ U{0..999} per image, linear betas 1e-4..0.02, ``x_t =
sqrt(abar_t) x0 + sqrt(1 - abar_t) eps`` in [-1, 1], the MSE on the
epsilon channels (the variance channels stay at their zero init), random
64 px crops of the ``div2k`` train split, Adam 2e-4 for 6000 steps at
batch 16; ``--model_channels 64 --channel_mult 1 2 2 4 --attention_ds 8``,
one residual block per level and 64 channels per attention head (the
loaders' assumption).  Every width must be a multiple of 32 (GroupNorm(32)).
``--device`` (default ``cuda``; without a GPU it raises unless ``--device
cpu``), ``--seed``, the log and the rate line as in
:mod:`sei_tpu_torch.cli.train_drunet`.  The file loads in
:func:`sei_tpu_torch.models.diffunet.load_diffunet` and in the JAX
package's ``torch_diffunet_to_flax`` / ``diffunet_config_from_state_dict``.
"""

from __future__ import annotations

import sys

from ..models.diffunet import DiffUNet, DiffUNetConfig, save_diffunet
from ..train import denoisers as dn
from ..train.optim import get_optimizer
from .train_drunet import base_parser, prepare, run


def main(argv=None):
    """Train and save; returns (the network, the logged (step, loss) pairs)."""
    ap = base_parser("python -m sei_tpu_torch.cli.train_diffunet", "runs/diffunet.pt", 2e-4)
    ap.add_argument("--model_channels", type=int, default=64)
    ap.add_argument("--channel_mult", type=int, nargs="+", default=[1, 2, 2, 4])
    ap.add_argument("--attention_ds", type=int, nargs="+", default=[8])
    args = ap.parse_args(argv)
    cfg = DiffUNetConfig(model_channels=args.model_channels,
                         channel_mult=tuple(args.channel_mult),
                         attention_ds=tuple(args.attention_ds), num_res_blocks=1,
                         num_head_channels=64)
    device, cache, init, draws = prepare(args)
    net = dn.lecun_init_(DiffUNet(cfg), init, zero=dn.diffunet_zero_init).to(device)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"DiffUNet stand-in: {n_params / 1e6:.2f}M params, cfg={cfg}", flush=True)
    opt = get_optimizer(net.parameters(), lr=args.lr)
    abar = dn.ddpm_abar(device)

    def step():
        x0, t, eps = dn.diffunet_draws(cache, draws, batch=args.batch, crop=args.crop)
        return dn.train_step(net, opt, dn.diffunet_loss, x0, t, eps, abar)

    logged = run(args, device, net, step, lambda path: save_diffunet(path, net))
    return net, logged


if __name__ == "__main__":
    main(sys.argv[1:])
