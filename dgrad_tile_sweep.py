#!/usr/bin/env python3
"""Tile sweeps of four GEMM kernels, four attention kernels and the bf16 LN
backward on one card.

    python3 dgrad_tile_sweep.py                 # bf16 gemm_dgrad, output tile width
    python3 dgrad_tile_sweep.py --fwd-f32       # f32 gemm_bias_epilogue, block tile
    python3 dgrad_tile_sweep.py --dgrad-f32     # f32 gemm_dgrad, block tile
    python3 dgrad_tile_sweep.py --wgrad-f32     # f32 gemm_wgrad, block and thread tile
    python3 dgrad_tile_sweep.py --attn-bwd-f32  # f32 window_attn_bwd, block shape
    python3 dgrad_tile_sweep.py --attn-fwd-f32  # f32 window_attn_fwd, block shape, stages
    python3 dgrad_tile_sweep.py --attn-bwd-bf16 # bf16 window_attn_bwd, warps, stages, blocks
    python3 dgrad_tile_sweep.py --attn-fwd-bf16 # bf16 window_attn_fwd, stages, blocks, p route
    python3 dgrad_tile_sweep.py --ln-bwd-bf16   # bf16 ln_rows_bwd, lanes, stages, warps, sum route

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

With ``--wgrad-f32``: the f32 ``gemm_wgrad`` CUDA-core kernel
(``sei_tpu_torch/ops/csrc/gemm_bwd.cu``, ``gemm_wgrad_f32_kernel``), its
block tile BM x BN over (K, N), slice depth BK, thread tile TM x TN and
blocks per SM (``-DSEI_WGRAD_F32_BM``, ``_BN``, ``_BK``, ``_TM``, ``_TN``,
``_MINB``; (BM / TM) x (BN / TN) threads; the wrapper's split count follows
each build's tile and occupancy).  Each build is held against the plain
version (dW and db, 1e-3 + 1e-4 x |plain|, as ``chip_smoke.py``) and timed
queued (the wrapper's call: the kernel and the two sums of its partials),
the builds in turns, on the f32 step's four weight-grad calls at both
graphs; the tile is chosen on the sum over the step's launches: 36
SwinBlocks x (the 2B graph's four calls + the B graph's).

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

With ``--attn-fwd-f32``: the f32 ``window_attn_fwd`` CUDA-core kernel
(``sei_tpu_torch/ops/csrc/window_attn_fwd.cu``, ``window_attn_fwd_f32_kernel``),
its threads per block (256: 4 x 4 scores per thread; 128: 8 x 4), the blocks
per SM it is compiled for (2 blocks of 256: 128 registers; 3: 80), its
stages (two: the next window copied during this one; one) and the threads
that run the P.V product (all: 4 x 2 outputs each at 256; half: 4 x 4)
(``-DSEI_ATTN_FWD_F32_THREADS``, ``_MINB``, ``_STAGES``, ``_PV``; the
wrapper sizes its groups from the occupancy each build reaches).  Each
build is held against the plain version (2e-5 abs, 1e-5 rel, as
``chip_smoke.py``) and timed queued, the builds in turns, as the trunk
calls it (q, k, v strided from the qkv buffer, the output into the proj
buffer) at the eval shape (one 256x320 image, T = 81920) and at both graphs
of the f32 step, with and without the shift mask; the block is chosen on
the sum of one image's forward and one f32 step: 36 SwinBlocks at the eval
shape and 36 per graph of the step, half of them masked.

With ``--attn-bwd-bf16``: the bf16 ``window_attn_bwd`` tensor-core kernel
(``sei_tpu_torch/ops/csrc/window_attn_bwd.cu``, ``window_attn_bwd_mma_kernel``),
its warps per block (4: one window at a time; 8: two teams of 4, each on
its own window), its stages (three: the next two windows copied during
this one; two: the next; one) and the blocks per SM it is compiled for (``-DSEI_ATTN_BWD_BF16_WARPS``,
``_STAGES``, ``_MINB``; the wrapper sizes its groups from the occupancy
each build reaches).  Each build is held against the plain version
(``chip_smoke.py``'s bf16 gate) and timed queued, the builds in turns, as
the bf16 trunk calls it (K7: the forward's saved p; q, k, v strided from
the qkv buffer, do from the datt buffer, dq, dk, dv into a second qkv
buffer) at both graphs, with and without the shift mask; the block is
chosen on the bf16 step's sum: 36 SwinBlocks per graph, half of them
masked.

With ``--attn-fwd-bf16``: the bf16 ``window_attn_fwd`` tensor-core kernel
(``sei_tpu_torch/ops/csrc/window_attn_fwd.cu``, ``window_attn_fwd_mma_kernel``),
its stages (three: the next two windows copied during this one; two; one),
the blocks per SM it is compiled for, the route of the p store (16-byte
rows through a shared tile, or bf16 pairs straight from the fragments) and
when the mask is loaded (while the window is staged, or after the scores)
(``-DSEI_ATTN_FWD_BF16_STAGES``, ``_MINB``, ``_PTILE``, ``_MASK_EARLY``; the
wrapper sizes its groups from the occupancy each build reaches).  Each build is held
against the plain version (``chip_smoke.py``'s bf16 gate) and timed queued,
the builds in turns, as the bf16 trunk calls it (K5: q, k, v strided from
the qkv buffer, the output into the att buffer, p saved) at both graphs,
with and without the shift mask; the build is chosen on the bf16 step's
sum: 36 SwinBlocks per graph, half of them masked.

With ``--ln-bwd-bf16``: the bf16 ``ln_rows_bwd`` kernel
(``sei_tpu_torch/ops/csrc/ln_rows_bwd.cu``, ``ln_rows_bwd_vec_kernel``), its
lanes per row (16: two rows per warp, 3 quads of 4 channels per lane at C
= 180; 8: four rows, 6 quads; 32: one row, 2 quads), the stages of each
warp's cp.async ring in shared memory, its warps per block and the blocks
per SM its registers are capped for, and the route of the dgamma / dbeta
sum (a second kernel, or the last block to finish)
(``-DSEI_LN_BWD_BF16_LANES``, ``_STAGES``, ``_WARPS``, ``_MINB``, ``_TICKET``;
the wrapper sizes its grid from the occupancy each build reaches).  Each
build is held against the plain version (``chip_smoke.py``'s tolerances)
and timed queued (the wrapper's call, the sum included), the builds in
turns, on the bf16 step's four calls as the trunk makes them: LN2 (f32 dz,
bf16 residual gradient -> f32 dx2) and LN1 (the shifted window map, bf16
da, f32 dx2 -> bf16 dx) at both graphs; the build is chosen on the bf16
step's sum: 36 SwinBlocks per graph, each one LN2 and one LN1 call.
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
# (BM, BN, BK, TM, TN, blocks per SM or None for the kernel's default):
# 96x96 of 8x6 (180, 360, 540 pad to 192, 384, 576) at depths 16 to 28 (32
# would put the two stages over the 48 KB of static shared memory), 64x96
# of 8x6 at depth 32, and the two tiles with a 60 edge (6 x 6 thread tiles,
# 160 threads), which pad K or N not at all
WGRAD_F32_TILES = ((96, 96, 28, 8, 6, None), (96, 96, 16, 8, 6, None), (96, 96, 20, 8, 6, None),
                   (96, 96, 24, 8, 6, None), (64, 96, 32, 8, 6, None), (60, 96, 24, 6, 6, None),
                   (96, 60, 24, 6, 6, None))
DEFAULT_WGRAD_F32_TILE = (96, 96, 28, 8, 6, None)  # the f32 weight grad's in the port's library
# (threads per block, blocks per SM compiled for): 256 threads (4 x 4
# micro-tiles) at 2 blocks (the library's, 128 registers) and at 1 (255),
# 128 threads (8 x 4) at 2 (255)
ATTN_BWD_F32_BLOCKS = ((256, 2), (256, 1), (128, 2))
DEFAULT_ATTN_BWD_F32_BLOCK = (256, 2)
# (threads per block, blocks per SM compiled for, stages, threads of the P.V
# product): 256 threads at 2 blocks (128 registers) with two stages, P.V on
# half of them (4 x 4 outputs each; the library's) or on all (4 x 2), with
# one stage; at 3 blocks (80 registers; 3 x 71 KB of shared memory fit an
# SM) with two and one; 128 threads at 4 blocks (128 registers), P.V on
# half (8 x 4) or all
ATTN_FWD_F32_BLOCKS = ((256, 2, 2, 128), (256, 2, 2, 256), (256, 2, 1, 128), (256, 3, 2, 128),
                       (256, 3, 1, 128), (128, 4, 1, 64), (128, 4, 1, 128))
DEFAULT_ATTN_FWD_F32_BLOCK = (256, 2, 2, 128)
# (warps per block, stages, blocks per SM compiled for): 4 warps with three
# stages (98.3 KB of shared memory: 2 blocks fit an SM; the library's),
# with two (68.6 KB: 3 fit, registers allowing) at 2 and 3, with one (38.9
# KB: 5 fit) at 4 and 5; 8 warps (two teams) with two stages (137 KB: 1)
# and one (77.8 KB: 2)
ATTN_BWD_BF16_BLOCKS = ((4, 3, 2), (4, 2, 2), (4, 2, 3), (4, 1, 4), (4, 1, 5), (8, 2, 1),
                        (8, 1, 2))
DEFAULT_ATTN_BWD_BF16_BLOCK = (4, 3, 2)
# (stages, blocks per SM compiled for, p through the shared tile, mask
# loaded while the window is staged): three stages (46 KB, with the 9 KB p
# tile 55 KB: 4 blocks fit an SM) at 3 blocks (168 registers), two (40 KB)
# and one (25 KB) at 4 (128), each with the mask loaded early and after
# S = Q K^T (32 registers fewer across the product), and p by pairs from
# the fragments (no tile) at three stages
ATTN_FWD_BF16_BLOCKS = ((3, 3, 1, 1), (2, 4, 1, 1), (1, 4, 1, 1), (3, 3, 1, 0), (2, 4, 1, 0),
                        (1, 4, 1, 0), (3, 4, 1, 0), (3, 3, 0, 1))
DEFAULT_ATTN_FWD_BF16_BLOCK = (2, 4, 1, 0)  # the library's
# (lanes per row, stages of each warp's cp.async ring, warps per block,
# blocks per SM the registers are capped for, last block sums): 16 lanes,
# two stages, one block of 16 warps per SM (96 KB of ring at C = 180, 132
# partials summed by the last block; the library's) and the same with a
# second kernel summing; three and four stages each way; two blocks of 8
# warps (264 partials) at two and three stages; 32 lanes (one row per warp)
LN_BWD_BF16_BUILDS = ((16, 2, 16, 1, 1), (16, 2, 16, 1, 0), (16, 3, 16, 1, 1), (16, 3, 16, 1, 0),
                      (16, 4, 16, 1, 1), (16, 2, 8, 2, 1), (16, 3, 8, 2, 1), (32, 2, 16, 1, 1))
DEFAULT_LN_BWD_BF16_BUILD = (16, 2, 16, 1, 1)


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
    if "--wgrad-f32" in argv:
        return sweep_wgrad_f32(smi)
    if "--attn-bwd-f32" in argv:
        return sweep_attn_bwd_f32(smi)
    if "--attn-fwd-f32" in argv:
        return sweep_attn_fwd_f32(smi)
    if "--attn-bwd-bf16" in argv:
        return sweep_attn_bwd_bf16(smi)
    if "--attn-fwd-bf16" in argv:
        return sweep_attn_fwd_bf16(smi)
    if "--ln-bwd-bf16" in argv:
        return sweep_ln_bwd_bf16(smi)
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


def sweep_wgrad_f32(smi: str) -> int:
    import torch

    from sei_tpu_torch.ops import swin_trunk as st

    def defines(t):
        if t == DEFAULT_WGRAD_F32_TILE:
            return ()
        d = tuple(f"SEI_WGRAD_F32_{k}={v}" for k, v in zip(("BM", "BN", "BK", "TM", "TN"), t))
        return d + ((f"SEI_WGRAD_F32_MINB={t[5]}",) if t[5] else ())

    builds = build_all({"x".join(map(str, t[:3])) + f"_{t[3]}x{t[4]}" + (f"b{t[5]}" if t[5] else "")
                        : defines(t) for t in WGRAD_F32_TILES}, "gemm_wgrad_f32_kernel")
    g = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=g, device="cuda") * s

    # the f32 step's four calls per block and graph (chip_smoke's variants)
    calls = {}
    for b in cs.TRAIN_GRAPHS:
        t = b * cs.CROP * cs.CROP
        wm = st.WindowMap(cs.CROP, cs.CROP, cs.WS, cs.WS // 2)
        dpm = (torch.rand(b, generator=g, device="cuda") < 0.9).float() / 0.9
        for variant, kk, nn, scale, wmap in (
                ("fc2_dpm", cs.CH, cs.C, dpm, None), ("fc1", cs.C, cs.CH, None, None),
                ("proj_window_dpm", cs.C, cs.C, dpm, wm), ("qkv", cs.C, 3 * cs.C, None, None)):
            a = rnd(t, kk)
            dy = rnd(b, cs.CROP, cs.CROP, nn) if wmap else rnd(t, nn)
            calls[f"{variant} T={t}"] = (
                lambda a=a, dy=dy, scale=scale, wmap=wmap:
                st.gemm_wgrad(a, dy, scale=scale, window=wmap),
                st._torch_gemm_wgrad(a, dy, scale, wmap))

    def check(n, v, c):
        for i, (got, want) in enumerate(zip(c[0](), c[1])):
            cs.compare(f"gemm_wgrad[f32 tile {n} {v}][{i}]", got, want, 1e-3, 1e-4)

    result = {}
    for tile, per_call in check_and_time(builds, calls, check).items():
        per_graph = {f"T={b * cs.CROP * cs.CROP}": sum(
            ms for v, ms in per_call.items() if v.endswith(f"T={b * cs.CROP * cs.CROP}"))
            for b in cs.TRAIN_GRAPHS}
        step = cs.BLOCKS * sum(per_graph.values())
        result[tile] = {"per_call_queued_ms": per_call, "per_block_queued_ms": per_graph,
                        "step_queued_ms": step}
        print(f"tile {tile}: per SwinBlock " + ", ".join(f"{k} {ms:.4f}" for k, ms in per_graph.items())
              + f"; per step ({cs.BLOCKS} blocks x both graphs) {step:.2f} ms queued")
    print(json.dumps({"wgrad_f32_tile_sweep": result, "gpu": smi}))
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


def sweep_attn_fwd_f32(smi: str) -> int:
    import torch

    from sei_tpu_torch.models.swinir import shift_attn_mask
    from sei_tpu_torch.ops import attention as at

    default = DEFAULT_ATTN_FWD_F32_BLOCK
    builds = build_all({"x".join(map(str, blk[:3])) + f"_pv{blk[3]}": () if blk == default else
                        tuple(f"SEI_ATTN_FWD_F32_{k}={v}"
                              for k, v in zip(("THREADS", "MINB", "STAGES", "PV"), blk))
                        for blk in ATTN_FWD_F32_BLOCKS}, "window_attn_fwd_f32_kernel")
    g = torch.Generator(device="cuda").manual_seed(6)
    n, nh, hd, scale = cs.N, cs.NH, cs.HD, cs.HD ** -0.5
    bias = torch.randn((nh, n, n), generator=g, device="cuda") * 0.1

    def views(buf):
        return tuple(buf[:, :, i].transpose(1, 2) for i in range(3))

    # the trunk's calls: one image at the eval shape, both graphs of the step
    shapes = {"eval": (cs.T, cs.H, cs.W)}
    shapes.update({f"step T={b * cs.CROP * cs.CROP}": (b * cs.CROP * cs.CROP, cs.CROP, cs.CROP)
                   for b in cs.TRAIN_GRAPHS})
    calls = {}
    for shape, (t, hh, ww) in shapes.items():
        b_ = t // n
        mask = torch.from_numpy(shift_attn_mask(hh, ww, cs.WS, cs.WS // 2)).cuda()
        qkv = torch.randn((b_, n, 3, nh, hd), generator=g, device="cuda")
        out = torch.empty((b_, n, nh, hd), device="cuda")
        for variant, m in (("no_mask", None), ("shift_mask", mask)):
            calls[f"{variant} T={t}"] = (
                lambda qkv=qkv, out=out, m=m: at.window_attn_fwd(
                    *views(qkv), bias, m, scale=scale, out=out.transpose(1, 2)),
                at._torch_attention(*views(qkv), bias, m, scale))

    means = check_and_time(builds, calls, lambda blk, v, c: cs.compare(
        f"window_attn_fwd[f32 block {blk} {v}]", c[0](), c[1], 2e-5, 1e-5))
    result = {}
    for blk, per_call in means.items():
        per_block = {shape: 0.5 * sum(per_call[f"{v} T={t}"] for v in ("no_mask", "shift_mask"))
                     for shape, (t, _, _) in shapes.items()}
        image = cs.BLOCKS * per_block["eval"]
        step = cs.BLOCKS * sum(ms for k, ms in per_block.items() if k != "eval")
        result[blk] = {"per_call_queued_ms": per_call, "per_block_queued_ms": per_block,
                       "image_queued_ms": image, "step_queued_ms": step,
                       "image_plus_step_queued_ms": image + step}
        print(f"block {blk}: per SwinBlock (mean of the masks) "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in per_block.items())
              + f"; per image ({cs.BLOCKS} blocks) {image:.2f} ms, per f32 step ({cs.BLOCKS} "
              f"blocks x both graphs) {step:.2f} ms, sum {image + step:.2f} ms queued")
    print(json.dumps({"attn_fwd_f32_sweep": result, "gpu": smi}))
    return 0


def sweep_attn_bwd_bf16(smi: str) -> int:
    import torch

    from sei_tpu_torch.models.swinir import shift_attn_mask
    from sei_tpu_torch.ops import attention as at

    default = DEFAULT_ATTN_BWD_BF16_BLOCK
    builds = build_all({"x".join(map(str, blk)): () if blk == default else tuple(
        f"SEI_ATTN_BWD_BF16_{k}={v}" for k, v in zip(("WARPS", "STAGES", "MINB"), blk))
        for blk in ATTN_BWD_BF16_BLOCKS}, "window_attn_bwd_mma_kernel")
    g = torch.Generator(device="cuda").manual_seed(7)
    bf = torch.bfloat16
    n, nh, hd, scale = cs.N, cs.NH, cs.HD, cs.HD ** -0.5
    mask = torch.from_numpy(shift_attn_mask(cs.CROP, cs.CROP, cs.WS, cs.WS // 2)).cuda()
    bias = torch.randn((nh, n, n), generator=g, device="cuda") * 0.1

    def views(buf):
        return tuple(buf[:, :, i].transpose(1, 2) for i in range(3))

    # the bf16 step's call per graph and mask, as the trunk makes it; p is
    # the forward's save from the same views (the library's forward)
    calls = {}
    for b in cs.TRAIN_GRAPHS:
        t = b * cs.CROP * cs.CROP
        b_ = t // n
        qkv = torch.randn((b_, n, 3, nh, hd), generator=g, device="cuda").to(bf)
        do = (torch.randn((b_, n, nh, hd), generator=g, device="cuda") * 0.1).to(bf)
        do = do.transpose(1, 2)
        dqkv = torch.empty_like(qkv)
        for variant, m in (("no_mask", None), ("shift_mask", mask)):
            p = torch.empty((b_, nh, n, n), device="cuda", dtype=bf)
            at.window_attn_fwd(*views(qkv), bias, m, scale=scale, p_out=p)
            calls[f"{variant} T={t}"] = (
                lambda qkv=qkv, do=do, dqkv=dqkv, m=m, p=p: at.window_attn_bwd(
                    *views(qkv), bias, m, do, scale=scale, p=p, out=views(dqkv)),
                at._torch_attention_bwd(*views(qkv), bias, m, do, scale, p))

    def check(blk, variant, call):
        got = call[0]()
        for i, (x, y) in enumerate(zip(got, call[1])):
            cs.compare_bf16(f"window_attn_bwd[bf16 block {blk} {variant}][{i}]", x, y,
                            (1e-4, 1e-4))

    result = {}
    for blk, per_call in check_and_time(builds, calls, check).items():
        per_block = {f"T={b * cs.CROP * cs.CROP}": 0.5 * sum(
            per_call[f"{v} T={b * cs.CROP * cs.CROP}"] for v in ("no_mask", "shift_mask"))
            for b in cs.TRAIN_GRAPHS}
        step = cs.BLOCKS * sum(per_block.values())
        result[blk] = {"per_call_queued_ms": per_call, "per_block_queued_ms": per_block,
                       "step_queued_ms": step}
        print(f"block {blk}: per SwinBlock (mean of the masks) "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in per_block.items())
              + f"; per bf16 step ({cs.BLOCKS} blocks x both graphs) {step:.2f} ms queued")
    print(json.dumps({"attn_bwd_bf16_sweep": result, "gpu": smi}))
    return 0


def sweep_attn_fwd_bf16(smi: str) -> int:
    import torch

    from sei_tpu_torch.models.swinir import shift_attn_mask
    from sei_tpu_torch.ops import attention as at

    default = DEFAULT_ATTN_FWD_BF16_BLOCK
    builds = build_all({"x".join(map(str, blk[:2])) + ("_tile" if blk[2] else "_pairs")
                        + ("" if blk[3] else "_masklate"): () if blk == default else tuple(
                            f"SEI_ATTN_FWD_BF16_{k}={v}"
                            for k, v in zip(("STAGES", "MINB", "PTILE", "MASK_EARLY"), blk))
                        for blk in ATTN_FWD_BF16_BLOCKS}, "window_attn_fwd_mma_kernel")
    g = torch.Generator(device="cuda").manual_seed(8)
    bf = torch.bfloat16
    n, nh, hd, scale = cs.N, cs.NH, cs.HD, cs.HD ** -0.5
    mask = torch.from_numpy(shift_attn_mask(cs.CROP, cs.CROP, cs.WS, cs.WS // 2)).cuda()
    bias = torch.randn((nh, n, n), generator=g, device="cuda") * 0.1

    def views(buf):
        return tuple(buf[:, :, i].transpose(1, 2) for i in range(3))

    # the bf16 step's forward call per graph and mask, as the trunk makes it
    calls = {}
    for b in cs.TRAIN_GRAPHS:
        t = b * cs.CROP * cs.CROP
        b_ = t // n
        qkv = torch.randn((b_, n, 3, nh, hd), generator=g, device="cuda").to(bf)
        att = torch.empty((b_, n, nh, hd), device="cuda", dtype=bf)
        for variant, m in (("no_mask", None), ("shift_mask", mask)):
            p, p_p = (torch.empty((b_, nh, n, n), device="cuda", dtype=bf) for _ in range(2))
            want = at._torch_attention(*views(qkv), bias, m, scale, p_p)
            calls[f"{variant} T={t}"] = (
                lambda qkv=qkv, att=att, m=m, p=p: (at.window_attn_fwd(
                    *views(qkv), bias, m, scale=scale, out=att.transpose(1, 2), p_out=p), p),
                (want, p_p))
        # not in the step: the same call without the p store (what the store
        # costs), and with the shift mask scaled by 1/10 (no masked score's
        # exp is a subnormal f32) or all zeros (its loads and adds alone)
        calls[f"no_mask no_p T={t}"] = (
            lambda qkv=qkv, att=att: (at.window_attn_fwd(
                *views(qkv), bias, None, scale=scale, out=att.transpose(1, 2)),),
            (at._torch_attention(*views(qkv), bias, None, scale),))
        for variant, m in (("shift_mask/10", 0.1 * mask), ("zero_mask", torch.zeros_like(mask))):
            p, p_p = (torch.empty((b_, nh, n, n), device="cuda", dtype=bf) for _ in range(2))
            want = at._torch_attention(*views(qkv), bias, m, scale, p_p)
            calls[f"{variant} T={t}"] = (
                lambda qkv=qkv, att=att, m=m, p=p: (at.window_attn_fwd(
                    *views(qkv), bias, m, scale=scale, out=att.transpose(1, 2), p_out=p), p),
                (want, p_p))

    def check(blk, variant, call):
        for i, (x, y) in enumerate(zip(call[0](), call[1])):
            cs.compare_bf16(f"window_attn_fwd[bf16 build {blk} {variant}][{i}]", x, y,
                            (1e-4, 1e-4))

    result = {}
    for blk, per_call in check_and_time(builds, calls, check).items():
        per_block = {f"T={b * cs.CROP * cs.CROP}": 0.5 * sum(
            per_call[f"{v} T={b * cs.CROP * cs.CROP}"] for v in ("no_mask", "shift_mask"))
            for b in cs.TRAIN_GRAPHS}
        step = cs.BLOCKS * sum(per_block.values())
        result[blk] = {"per_call_queued_ms": per_call, "per_block_queued_ms": per_block,
                       "step_queued_ms": step}
        print(f"build {blk}: per SwinBlock (mean of the masks) "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in per_block.items())
              + f"; per bf16 step ({cs.BLOCKS} blocks x both graphs) {step:.2f} ms queued")
    print(json.dumps({"attn_fwd_bf16_sweep": result, "gpu": smi}))
    return 0


def sweep_ln_bwd_bf16(smi: str) -> int:
    import torch

    from sei_tpu_torch.ops import swin_trunk as st

    default = DEFAULT_LN_BWD_BF16_BUILD
    builds = build_all({"l{}_s{}_w{}_b{}_".format(*b[:4]) + ("last" if b[4] else "sumk"):
                        () if b == default else tuple(
                            f"SEI_LN_BWD_BF16_{k}={v}"
                            for k, v in zip(("LANES", "STAGES", "WARPS", "MINB", "TICKET"), b))
                        for b in LN_BWD_BF16_BUILDS}, "ln_rows_bwd_")
    g = torch.Generator(device="cuda").manual_seed(9)
    bf, f32, c = torch.bfloat16, torch.float32, cs.C

    # the bf16 step's two calls per graph, as the trunk makes them
    calls = {}
    for b in cs.TRAIN_GRAPHS:
        t = b * cs.CROP * cs.CROP
        wm = st.WindowMap(cs.CROP, cs.CROP, cs.WS, cs.WS // 2)
        x = torch.randn((b, cs.CROP, cs.CROP, c), generator=g, device="cuda").to(bf)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
        for variant, xx, wmap, dz_dtype, res_dtype, out_dtype in (
                ("ln2", x.view(t, c), None, f32, bf, f32), ("ln1_window", x, wm, bf, f32, bf)):
            dz = torch.randn((t, c), generator=g, device="cuda").to(dz_dtype)
            dres = torch.randn(xx.shape, generator=g, device="cuda").to(res_dtype)
            calls[f"{variant} T={t}"] = (
                lambda xx=xx, gm=gamma, dz=dz, wmap=wmap, dres=dres, o=out_dtype: st.ln_rows_bwd(
                    xx, gm, dz, window=wmap, dres=dres, out_dtype=o),
                st._torch_ln_rows_bwd(xx, gamma, dz, wmap, dres, out_dtype))

    def check(build, variant, call):
        for i, (x, y) in enumerate(zip(call[0](), call[1])):
            cs.compare_bf16(f"ln_rows_bwd[bf16 build {build} {variant}][{i}]", x, y, (1e-3, 1e-4))

    result = {}
    for build, per_call in check_and_time(builds, calls, check).items():
        per_block = {f"T={b * cs.CROP * cs.CROP}": sum(
            per_call[f"{v} T={b * cs.CROP * cs.CROP}"] for v in ("ln2", "ln1_window"))
            for b in cs.TRAIN_GRAPHS}
        step = cs.BLOCKS * sum(per_block.values())
        result[build] = {"per_call_queued_ms": per_call, "per_block_queued_ms": per_block,
                         "step_queued_ms": step}
        print(f"build {build}: per SwinBlock (LN2 + LN1) "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in per_block.items())
              + f"; per bf16 step ({cs.BLOCKS} blocks x both graphs) {step:.2f} ms queued")
    print(json.dumps({"ln_bwd_bf16_sweep": result, "gpu": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
