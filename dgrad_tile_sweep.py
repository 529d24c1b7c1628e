#!/usr/bin/env python3
"""Tile-width sweep of the bf16 ``gemm_dgrad`` tensor-core kernel on one card.

    python3 dgrad_tile_sweep.py

The kernel's output tile is 64 rows by ``SEI_DGRAD_TN`` columns of K
(``sei_tpu_torch/ops/csrc/gemm_bwd.cu``; 96 in the library the port loads).
A wider tile runs the gather / scale / rounding prologue over each element of
dy fewer times (ceil(K / TN) at K = 180 / 360: 3 / 6 at 64 columns, 2 / 4 at
96, 1 / 2 at 192) at the cost of more accumulator registers.  This script builds the kernel library
once per width (``-DSEI_DGRAD_TN``), holds each build against the plain
version on the bf16 step's four data-grad calls (the 2B graph, T = 36864:
the variants and tolerance of ``chip_smoke.py``), and times each call queued
behind a sleeping kernel (device time alone), the widths in turns (64, 96,
192, 192, 96, 64).  Prints the card, each build's ptxas lines for the
kernel, and one JSON line of the times (ms, mean of the two turns).
"""

from __future__ import annotations

import json
import sys

import chip_smoke as cs

WIDTHS = (64, 96, 192)
DEFAULT_TN = 96  # the width the port's library is built with


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dgrad_tile_sweep: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    from sei_tpu_torch.device import resolve_device
    from sei_tpu_torch.ops import _build
    from sei_tpu_torch.ops import swin_trunk as st

    smi = cs.nvidia_smi()
    print(f"gpu: {smi}")
    resolve_device("cuda")
    load = _build.library
    builds = {}
    for tn in WIDTHS:
        built = load(() if tn == DEFAULT_TN else (f"SEI_DGRAD_TN={tn}",))
        builds[tn] = built
        print(f"TN={tn}: built in {built.seconds:.2f} s -> {built.path.name}")
        for line in cs.ptxas_report(built.log):
            if "gemm_dgrad_mma" in line:
                print(f"  {line}")

    def use(tn):  # the kernel wrappers (and check) load this build
        _build.library = lambda defines=(): builds[tn]

    g = torch.Generator(device="cuda").manual_seed(2)
    bf, f32 = torch.bfloat16, torch.float32
    b = cs.TRAIN_GRAPHS[0]
    t = b * cs.CROP * cs.CROP
    wm = st.WindowMap(cs.CROP, cs.CROP, cs.WS, cs.WS // 2)
    dpm = (torch.rand(b, generator=g, device="cuda") < 0.9).float() / 0.9

    def rnd(*shape, s=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)

    calls = {}
    for variant, kk, nn, dy_dtype, out_dtype, scale, wmap, with_gp in (
            ("fc2_saved_gelu_grad", cs.CH, cs.C, bf, f32, dpm, None, True),
            ("fc1", cs.C, cs.CH, f32, f32, None, None, False),
            ("proj_window_dpm", cs.C, cs.C, f32, bf, dpm, wm, False),
            ("qkv", cs.C, 3 * cs.C, bf, bf, None, None, False)):
        dy = rnd(b, cs.CROP, cs.CROP, nn, dtype=dy_dtype) if wmap else rnd(t, nn, dtype=dy_dtype)
        w, gp = rnd(kk, nn, s=0.05), (rnd(t, kk) if with_gp else None)
        calls[variant] = (lambda dy=dy, w=w, scale=scale, wmap=wmap, gp=gp, out_dtype=out_dtype:
                          st.gemm_dgrad(dy, w, scale=scale, window=wmap, gp=gp,
                                        out_dtype=out_dtype),
                          st._torch_gemm_dgrad(dy, w, scale, wmap, gp, out_dtype))
    try:
        for tn in WIDTHS:
            use(tn)
            for variant, (fn, want) in calls.items():
                cs.compare_bf16(f"gemm_dgrad[bf16 TN={tn} {variant} T={t}]", fn(), want,
                                (1e-4, 1e-4))
        times = {tn: {v: [] for v in calls} for tn in WIDTHS}
        for tn in WIDTHS + WIDTHS[::-1]:
            use(tn)
            for variant, (fn, _) in calls.items():
                times[tn][variant].append(cs.queued_ms(fn))
    finally:
        _build.library = load
    result = {}
    for tn in WIDTHS:
        per_call = {v: sum(ts) / len(ts) for v, ts in times[tn].items()}
        result[str(tn)] = {"per_call_queued_ms": per_call,
                           "per_block_queued_ms": sum(per_call.values()),
                           "turns": {v: ts for v, ts in times[tn].items()}}
        print(f"TN={tn}: " + ", ".join(f"{v} {ms:.4f}" for v, ms in per_call.items())
              + f"; per SwinBlock {result[str(tn)]['per_block_queued_ms']:.4f} ms queued")
    print(json.dumps({"dgrad_tile_sweep": result, "T": t, "gpu": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
