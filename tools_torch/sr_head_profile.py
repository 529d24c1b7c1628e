#!/usr/bin/env python
"""Where an SR eval forward spends its time, on one CUDA GPU.

    python tools_torch/sr_head_profile.py

For the flagship SwinIR with the x2, x3 and x4 pixelshuffle heads (weights
from seed 0; x2 also in bf16) on the padded measurement of one seeded
256x320 image (x2: 128x192, x3: 128x128, x4: 64x128), it prints the
forward's time (CUDA events, the mean of 5 calls after 2), its device time
by kernel (torch.profiler, as ``chip_smoke.py`` profiles the deblurring
forward), and each of the head's convolutions timed alone on inputs of the
head's shapes in two memory layouts: channels-last (the layout the trunk's
NHWC output gives the convolution after it) and contiguous NCHW; with
cuDNN held to its deterministic algorithms as the port holds it, and, for
comparison only, without.  The card's name and power limit come first.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def events_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    import chip_smoke as cs
    from sei_tpu_torch.evaluate import degraded_pair
    from sei_tpu_torch.models import get_model
    from sei_tpu_torch.models.swinir import reflect_pad
    from sei_tpu_torch.physics import get_physics

    if not torch.cuda.is_available():
        print("sr_head_profile: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(f"gpu: {cs.nvidia_smi()}; torch {torch.__version__}")
    x = torch.as_tensor(cs.make_images(1, cs.H, cs.W, seed=0)[0], device="cuda")
    for factor, dtype in ((2, None), (2, torch.bfloat16), (3, None), (4, None)):
        label = f"SR x{factor} " + ("bf16" if dtype is not None else "f32")
        model = get_model(task="sr", sr_factor=factor, seed=0, dtype=dtype)
        y = degraded_pair(get_physics(task="sr", sr_factor=factor), x, 0)[1][None]
        y = reflect_pad(y, (-y.shape[-2]) % 64, (-y.shape[-1]) % 64)
        ms = events_ms(lambda: model(y))
        print(f"{label}: forward at {y.shape[-2]}x{y.shape[-1]} {ms:.3f} ms")
        cs.profile_forward(model, y)
        m = model.module
        h, w = y.shape[-2:]
        cdt = dtype or torch.float32
        convs = [("conv_before_upsample", m.conv_before_upsample[0], 180, h, w)]
        size = (h, w)
        for i in range(0, len(m.upsample), 2):
            convs.append((f"upsample.{i}", m.upsample[i], 64, *size))
            r = m.upsample[i + 1].upscale_factor
            size = (size[0] * r, size[1] * r)
        convs.append(("conv_last", m.conv_last, 64, *size))
        for name, conv, cin, ch, cw in convs:
            t = torch.randn((1, cin, ch, cw), device="cuda", dtype=cdt)
            times = []
            for deterministic in (True, False):
                torch.backends.cudnn.deterministic = deterministic
                with torch.no_grad():
                    for fmt in (torch.channels_last, torch.contiguous_format):
                        u = t.contiguous(memory_format=fmt)
                        times.append(events_ms(lambda: conv(u)))
            torch.backends.cudnn.deterministic = True
            print(f"  {name} ({cin} -> {conv.out_channels} at {ch}x{cw}): deterministic "
                  f"channels-last {times[0]:.3f} ms, NCHW {times[1]:.3f} ms; not "
                  f"deterministic channels-last {times[2]:.3f} ms, NCHW {times[3]:.3f} ms")
        del model
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
