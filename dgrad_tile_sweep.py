#!/usr/bin/env python3
"""Tile sweeps of two GEMM kernels on one card.

    python3 dgrad_tile_sweep.py            # bf16 gemm_dgrad, output tile width
    python3 dgrad_tile_sweep.py --fwd-f32  # f32 gemm_bias_epilogue, block tile

Without a flag: the bf16 ``gemm_dgrad`` tensor-core kernel.  Its output tile
is 64 rows by ``SEI_DGRAD_TN`` columns of K
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

With ``--fwd-f32``: the f32 ``gemm_bias_epilogue`` CUDA-core kernel
(``sei_tpu_torch/ops/csrc/gemm_bias_epilogue.cu``), its block tile BM x BN
and slice depth BK (``-DSEI_FWD_F32_BM``, ``_BN``, ``_BK``; 2 BM threads, 8
x BN / 16 accumulators each): 128x96, 64x96, 128x192 and 64x192 at BK 12,
then BK 8, 16 and 20 (the library the port loads) at 128x96.  Each
build is held against the plain version (1e-4, as ``chip_smoke.py``) and
timed queued, the builds in turns, on the eval shape's four calls (one
256x320 image, T = 81920: qkv, proj with the window store, fc1 with GELU,
fc2 with the residual) and the f32 step's fc1 recompute (``gelu_pair``,
T = 36864).
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs

WIDTHS = (64, 96, 192)
DEFAULT_TN = 96  # the width the port's library is built with
# (BM, BN, BK): the block tiles at depth 12 (20 would put 128x192's two
# stages over the 48 KB of static shared memory), then the depths at 128x96
FWD_TILES = ((128, 96, 12), (64, 96, 12), (128, 192, 12), (64, 192, 12), (128, 96, 8),
             (128, 96, 16), (128, 96, 20))
DEFAULT_FWD_TILE = (128, 96, 20)  # the f32 forward GEMM's tile in the port's library


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("dgrad_tile_sweep: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    if "--fwd-f32" in argv:
        return sweep_fwd_f32()
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


def sweep_fwd_f32() -> int:
    import torch

    from sei_tpu_torch.device import resolve_device
    from sei_tpu_torch.ops import _build
    from sei_tpu_torch.ops import swin_trunk as st

    smi = cs.nvidia_smi()
    print(f"gpu: {smi}")
    resolve_device("cuda")
    load = _build.library
    with ThreadPoolExecutor(len(FWD_TILES)) as pool:  # one nvcc per source and build
        built = pool.map(lambda t: load(() if t == DEFAULT_FWD_TILE else tuple(
            f"SEI_FWD_F32_{k}={v}" for k, v in zip(("BM", "BN", "BK"), t))), FWD_TILES)
        builds = {"x".join(map(str, t)): b for t, b in zip(FWD_TILES, built)}
    tiles = list(builds)
    for tile, b in builds.items():
        print(f"tile {tile}: built in {b.seconds:.2f} s -> {b.path.name}")
        for line in cs.ptxas_report(b.log):
            if "gemm_bias_epilogue_kernel" in line:
                print(f"  {line}")

    def use(tile):  # the kernel wrappers (and check) load this build
        _build.library = lambda defines=(): builds[tile]

    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=g, device="cuda") * s

    t_step = cs.TRAIN_GRAPHS[0] * cs.CROP * cs.CROP
    x = rnd(cs.B, cs.H, cs.W, cs.C)
    dpm = torch.full((cs.B,), 0.9, device="cuda")
    wm = st.WindowMap(cs.H, cs.W, cs.WS, cs.WS // 2)
    calls = {}
    for variant, t, k, n, epi, wmap in (
            ("qkv", cs.T, cs.C, 3 * cs.C, "none", None),
            ("proj", cs.T, cs.C, cs.C, "residual", wm),
            ("fc1", cs.T, cs.C, cs.CH, "gelu", None),
            ("fc2", cs.T, cs.CH, cs.C, "residual", None),
            (f"fc1_gelu_pair T={t_step}", t_step, cs.C, cs.CH, "gelu_pair", None)):
        a, w, b = rnd(t, k), rnd(k, n, s=0.05), rnd(n, s=0.05)
        res, d = (x, dpm) if epi == "residual" else (None, None)
        gp = torch.empty(t, n, device="cuda") if epi == "gelu_pair" else None
        gp_p = torch.empty_like(gp) if gp is not None else None
        calls[variant] = (lambda a=a, w=w, b=b, epi=epi, res=res, d=d, wmap=wmap, gp=gp:
                          st.gemm_bias_epilogue(a, w, b, epi, res=res, dpm=d, window=wmap, gp=gp),
                          st._torch_gemm_bias_epilogue(a, w, b, epi, res, d, wmap, gp_p), gp, gp_p)
    try:
        for tile in tiles:
            use(tile)
            for variant, (fn, want, gp, gp_p) in calls.items():
                cs.compare(f"gemm_bias_epilogue[f32 tile {tile} {variant}]", fn(), want, 1e-4, 1e-4)
                if gp is not None:
                    cs.compare(f"gemm_bias_epilogue[f32 tile {tile} {variant} gp]", gp, gp_p,
                               1e-4, 1e-4)
        times = {tile: {v: [] for v in calls} for tile in tiles}
        for tile in tiles + tiles[::-1]:
            use(tile)
            for variant, (fn, *_) in calls.items():
                times[tile][variant].append(cs.queued_ms(fn))
    finally:
        _build.library = load
    result = {}
    for tile in tiles:
        per_call = {v: sum(ts) / len(ts) for v, ts in times[tile].items()}
        eval_block = sum(ms for v, ms in per_call.items() if not v.startswith("fc1_gelu_pair"))
        result[tile] = {"per_call_queued_ms": per_call, "eval_per_block_queued_ms": eval_block,
                        "turns": times[tile]}
        print(f"tile {tile}: " + ", ".join(f"{v} {ms:.4f}" for v, ms in per_call.items())
              + f"; eval per SwinBlock {eval_block:.4f} ms queued")
    print(json.dumps({"fwd_f32_tile_sweep": result, "T_eval": cs.T, "T_step": t_step, "gpu": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
