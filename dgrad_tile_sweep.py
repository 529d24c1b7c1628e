#!/usr/bin/env python3
"""Tile sweeps of three GEMM kernels and the f32 attention backward on one card.

    python3 dgrad_tile_sweep.py                 # bf16 gemm_dgrad, output tile width
    python3 dgrad_tile_sweep.py --fwd-f32       # f32 gemm_bias_epilogue, block tile
    python3 dgrad_tile_sweep.py --dgrad-f32     # f32 gemm_dgrad, block tile
    python3 dgrad_tile_sweep.py --attn-bwd-f32  # f32 window_attn_bwd, block shape

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

With ``--dgrad-f32``: the f32 ``gemm_dgrad`` CUDA-core kernel
(``sei_tpu_torch/ops/csrc/gemm_bwd.cu``, ``gemm_dgrad_f32_kernel``), its
block tile BM x BN over (M, K), slice depth BK and blocks per SM
(``-DSEI_DGRAD_F32_BM``, ``_BN``, ``_BK``, ``_MINB``; 2 BM threads, 8 x BN /
16 accumulators each).  Each build is held against the plain version
(1e-4, as ``chip_smoke.py``) and timed queued, the builds in turns, on the
f32 step's four data-grad calls at both graphs (the SURE forward's 2B = 16
images, T = 36864, and the EI forward's B = 8, T = 18432); the tile is
chosen on the sum over the step's launches: 36 SwinBlocks x (the 2B
graph's four calls + the B graph's).

With ``--attn-bwd-f32``: the f32 ``window_attn_bwd`` CUDA-core kernel
(``sei_tpu_torch/ops/csrc/window_attn_bwd.cu``, ``window_attn_bwd_f32_kernel``),
its threads per block, which set the micro-tile (256: 4 x 4 scores per
thread, 4 x 4 outputs of each 64 x 32 product; 128: 8 x 4 and 8 x 4), and
the blocks per SM it is compiled for, which cap its registers (2 blocks of
256 threads: 128; 1: 255; the 104 KB of shared memory allow 2)
(``-DSEI_ATTN_BWD_F32_THREADS``, ``_MINB``; the wrapper sizes its groups
from the occupancy each build reaches).  Each build is held
against the plain version (``chip_smoke.py``'s tolerances) and timed queued,
the builds in turns, at both graphs with and without the shift mask, as
the trunk calls it (strided, att written beside dq, dk, dv) and without
att; the block is chosen on the f32 step's sum: 36 SwinBlocks per graph,
half of them masked, each one call with att.
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
# (BM, BN, BK, blocks per SM or None for the kernel's default): 96 columns
# (K = 180 in two column tiles) at 96, 128 and 64 rows (64 at 4 and at 3
# blocks per SM), shallower slices, and 192 columns (K = 180 in one: dy
# read once per block row); 128x192 at depth 12 (20 would put its two
# stages over the 48 KB of static shared memory).  At T = 36864 the K = 180
# calls fill 2.91 waves of the card at 96x96 (768 blocks, 264 slots), 2.18
# at 128x96 (576 blocks)
DGRAD_F32_TILES = ((96, 96, 20, None), (128, 96, 20, None), (64, 96, 20, None),
                   (64, 96, 20, 3), (96, 96, 12, None), (128, 192, 12, None),
                   (64, 192, 20, 3))
DEFAULT_DGRAD_F32_TILE = (96, 96, 20, None)  # the f32 data grad's tile in the port's library
# (threads per block, blocks per SM compiled for): 256 threads (4 x 4
# micro-tiles) at 2 blocks (the library's, 128 registers) and at 1 (255),
# 128 threads (8 x 4) at 2 (255)
ATTN_BWD_F32_BLOCKS = ((256, 2), (256, 1), (128, 2))
DEFAULT_ATTN_BWD_F32_BLOCK = (256, 2)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("dgrad_tile_sweep: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    from sei_tpu_torch.device import resolve_device

    smi = cs.nvidia_smi()
    print(f"gpu: {smi}")
    resolve_device("cuda")
    if "--fwd-f32" in argv:
        return sweep_fwd_f32(smi)
    if "--dgrad-f32" in argv:
        return sweep_dgrad_f32(smi)
    if "--attn-bwd-f32" in argv:
        return sweep_attn_bwd_f32(smi)
    return sweep_dgrad_bf16(smi)


def build_all(variants: dict, kernel: str) -> dict:
    """name -> the kernel library built with that variant's ``-D`` macros
    (one nvcc per source and build, all side by side); prints each build's
    ptxas lines for ``kernel``."""
    from sei_tpu_torch.ops import _build

    with ThreadPoolExecutor(len(variants)) as pool:
        builds = dict(zip(variants, pool.map(_build.library, variants.values())))
    for name, b in builds.items():
        print(f"tile {name}: built in {b.seconds:.2f} s -> {b.path.name}")
        for line in cs.ptxas_report(b.log):
            if kernel in line:
                print(f"  {line}")
    return builds


def check_and_time(builds: dict, calls: dict, check) -> dict:
    """Each build's calls held against their plain versions by ``check(name,
    variant, call)``, then each call (``call[0]``) timed queued with the
    builds in turns, forward then backward; the kernel wrappers load the
    build under test.  Returns name -> {variant: mean ms}, and prints them."""
    from sei_tpu_torch.ops import _build

    load = _build.library
    names = list(builds)
    times = {n: {v: [] for v in calls} for n in names}
    try:
        for n in names:
            _build.library = lambda defines=(), b=builds[n]: b
            for variant, call in calls.items():
                check(n, variant, call)
        for n in names + names[::-1]:
            _build.library = lambda defines=(), b=builds[n]: b
            for variant, call in calls.items():
                times[n][variant].append(cs.queued_ms(call[0]))
    finally:
        _build.library = load
    means = {n: {v: sum(ts) / len(ts) for v, ts in times[n].items()} for n in names}
    for n in names:
        print(f"tile {n}: " + ", ".join(f"{v} {ms:.4f}" for v, ms in means[n].items()))
    return means


def sweep_dgrad_bf16(smi: str) -> int:
    import torch

    from sei_tpu_torch.ops import swin_trunk as st

    builds = build_all({str(tn): () if tn == DEFAULT_TN else (f"SEI_DGRAD_TN={tn}",)
                        for tn in WIDTHS}, "gemm_dgrad_mma")
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
    means = check_and_time(builds, calls, lambda n, v, c: cs.compare_bf16(
        f"gemm_dgrad[bf16 TN={n} {v} T={t}]", c[0](), c[1], (1e-4, 1e-4)))
    result = {n: {"per_call_queued_ms": pc, "per_block_queued_ms": sum(pc.values())}
              for n, pc in means.items()}
    for n, r in result.items():
        print(f"TN={n}: per SwinBlock {r['per_block_queued_ms']:.4f} ms queued")
    print(json.dumps({"dgrad_tile_sweep": result, "T": t, "gpu": smi}))
    return 0


def sweep_fwd_f32(smi: str) -> int:
    import torch

    from sei_tpu_torch.ops import swin_trunk as st

    builds = build_all({"x".join(map(str, t)): () if t == DEFAULT_FWD_TILE else tuple(
        f"SEI_FWD_F32_{k}={v}" for k, v in zip(("BM", "BN", "BK"), t)) for t in FWD_TILES},
        "gemm_bias_epilogue_kernel")
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

    def check(tile, variant, call):
        fn, want, gp, gp_p = call
        cs.compare(f"gemm_bias_epilogue[f32 tile {tile} {variant}]", fn(), want, 1e-4, 1e-4)
        if gp is not None:
            cs.compare(f"gemm_bias_epilogue[f32 tile {tile} {variant} gp]", gp, gp_p, 1e-4, 1e-4)

    result = {}
    for tile, per_call in check_and_time(builds, calls, check).items():
        eval_block = sum(ms for v, ms in per_call.items() if not v.startswith("fc1_gelu_pair"))
        result[tile] = {"per_call_queued_ms": per_call, "eval_per_block_queued_ms": eval_block}
        print(f"tile {tile}: eval per SwinBlock {eval_block:.4f} ms queued")
    print(json.dumps({"fwd_f32_tile_sweep": result, "T_eval": cs.T, "T_step": t_step, "gpu": smi}))
    return 0


def sweep_dgrad_f32(smi: str) -> int:
    import torch

    from sei_tpu_torch.ops import swin_trunk as st

    def defines(t):
        if t == DEFAULT_DGRAD_F32_TILE:
            return ()
        d = tuple(f"SEI_DGRAD_F32_{k}={v}" for k, v in zip(("BM", "BN", "BK"), t))
        return d + ((f"SEI_DGRAD_F32_MINB={t[3]}",) if t[3] else ())

    builds = build_all({"x".join(map(str, t[:3])) + (f"b{t[3]}" if t[3] else ""): defines(t)
                        for t in DGRAD_F32_TILES}, "gemm_dgrad_f32_kernel")
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=g, device="cuda") * s

    # the f32 step's four calls per block and graph (chip_smoke's variants)
    calls = {}
    for b in cs.TRAIN_GRAPHS:
        t = b * cs.CROP * cs.CROP
        wm = st.WindowMap(cs.CROP, cs.CROP, cs.WS, cs.WS // 2)
        dpm = (torch.rand(b, generator=g, device="cuda") < 0.9).float() / 0.9
        for variant, kk, nn, scale, wmap, gelu in (
                ("fc2_gelu_grad", cs.CH, cs.C, dpm, None, True),
                ("fc1", cs.C, cs.CH, None, None, False),
                ("proj_window_dpm", cs.C, cs.C, dpm, wm, False),
                ("qkv", cs.C, 3 * cs.C, None, None, False)):
            dy = rnd(b, cs.CROP, cs.CROP, nn) if wmap else rnd(t, nn)
            w, gp = rnd(kk, nn, s=0.05), (rnd(t, kk) if gelu else None)
            calls[f"{variant} T={t}"] = (
                lambda dy=dy, w=w, scale=scale, wmap=wmap, gp=gp:
                st.gemm_dgrad(dy, w, scale=scale, window=wmap, gp=gp),
                st._torch_gemm_dgrad(dy, w, scale, wmap, gp))
    means = check_and_time(builds, calls, lambda n, v, c: cs.compare(
        f"gemm_dgrad[f32 tile {n} {v}]", c[0](), c[1], 1e-4, 1e-4))
    result = {}
    for tile, per_call in means.items():
        per_graph = {f"T={b * cs.CROP * cs.CROP}": sum(
            ms for v, ms in per_call.items() if v.endswith(f"T={b * cs.CROP * cs.CROP}"))
            for b in cs.TRAIN_GRAPHS}
        step = cs.BLOCKS * sum(per_graph.values())
        result[tile] = {"per_call_queued_ms": per_call, "per_block_queued_ms": per_graph,
                        "step_queued_ms": step}
        print(f"tile {tile}: per SwinBlock " + ", ".join(f"{k} {ms:.4f}" for k, ms in per_graph.items())
              + f"; per step ({cs.BLOCKS} blocks x both graphs) {step:.2f} ms queued")
    print(json.dumps({"dgrad_f32_tile_sweep": result, "gpu": smi}))
    return 0


def sweep_attn_bwd_f32(smi: str) -> int:
    import torch

    from sei_tpu_torch.models.swinir import shift_attn_mask
    from sei_tpu_torch.ops import attention as at

    default = DEFAULT_ATTN_BWD_F32_BLOCK
    builds = build_all({"x".join(map(str, blk)): () if blk == default else tuple(
        f"SEI_ATTN_BWD_F32_{k}={v}" for k, v in zip(("THREADS", "MINB"), blk))
        for blk in ATTN_BWD_F32_BLOCKS}, "window_attn_bwd_f32_kernel")
    g = torch.Generator(device="cuda").manual_seed(4)
    n, nh, hd, scale = cs.N, cs.NH, cs.HD, cs.HD ** -0.5
    mask = torch.from_numpy(shift_attn_mask(cs.CROP, cs.CROP, cs.WS, cs.WS // 2)).cuda()
    bias = torch.randn((nh, n, n), generator=g, device="cuda") * 0.1

    def views(buf):
        return tuple(buf[:, :, i].transpose(1, 2) for i in range(3))

    # the f32 step's calls per graph, as the trunk makes them (with att) and
    # as chip_smoke's table row times them (without)
    calls = {}
    for b in cs.TRAIN_GRAPHS:
        t = b * cs.CROP * cs.CROP
        b_ = t // n
        qkv = torch.randn((b_, n, 3, nh, hd), generator=g, device="cuda")
        do = (torch.randn((b_, n, nh, hd), generator=g, device="cuda") * 0.1).transpose(1, 2)
        dqkv, att = torch.empty_like(qkv), torch.empty((b_, n, nh, hd), device="cuda")
        for variant, m in (("no_mask", None), ("shift_mask", mask)):
            want = at._torch_attention_bwd(*views(qkv), bias, m, do, scale, with_att=True)
            for with_att in (False, True):
                calls[f"{variant}{' att_out' if with_att else ''} T={t}"] = (
                    lambda qkv=qkv, do=do, dqkv=dqkv, att=att, m=m, with_att=with_att: (
                        *at.window_attn_bwd(*views(qkv), bias, m, do, scale=scale,
                                            out=views(dqkv),
                                            att_out=att.transpose(1, 2) if with_att else None),
                        att.transpose(1, 2)),
                    want, with_att)

    def check(blk, variant, call):
        fn, want, with_att = call
        got = fn()
        tols = [(2e-5, 1e-4)] * 3 + [(1e-4, 1e-4)] + [(2e-5, 1e-5)] * with_att
        for i, tol in enumerate(tols):
            cs.compare(f"window_attn_bwd[f32 block {blk} {variant}][{i}]", got[i], want[i], *tol)

    result = {}
    for blk, per_call in check_and_time(builds, calls, check).items():
        per_graph = {}
        for b in cs.TRAIN_GRAPHS:
            t = b * cs.CROP * cs.CROP
            for att_key in ("", " att_out"):
                per_graph[f"T={t}{att_key}"] = 0.5 * sum(
                    per_call[f"{v}{att_key} T={t}"] for v in ("no_mask", "shift_mask"))
        step = cs.BLOCKS * sum(ms for k, ms in per_graph.items() if k.endswith("att_out"))
        result[blk] = {"per_call_queued_ms": per_call, "per_block_queued_ms": per_graph,
                       "step_queued_ms": step}
        print(f"block {blk}: per SwinBlock (mean of the masks) "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in per_graph.items())
              + f"; per step ({cs.BLOCKS} blocks x both graphs, with att) {step:.2f} ms queued")
    print(json.dumps({"attn_bwd_f32_sweep": result, "gpu": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
