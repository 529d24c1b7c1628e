#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``sei_tpu_torch``) on one card.

    python3 chip_smoke.py            # the whole run (needs one CUDA GPU)
    python3 chip_smoke.py --quick    # build + kernel checks only, no timing
    python3 chip_smoke.py --bits DIR # attention, LN-backward and GELU-epilogue digests of the port in DIR

1. Prints the card (nvidia-smi name and power limit), the torch version, and
   builds the CUDA kernels from ``sei_tpu_torch/ops/csrc`` into
   ``sei_tpu_torch/_build/`` (time and ptxas report printed).
2. Holds each kernel against its plain PyTorch version on the card and
   times kernel, plain version and, as a yardstick only, one PyTorch library
   call of the same function: the forward kernels at the flagship eval
   shapes (one 256x320 image: T = 81920 tokens, C = 180, 6 heads, window 8
   -> 1280 windows), the backward kernels (and the forward GEMM's
   pre-activation epilogue) at the flagship training shapes (batch 8 of
   48x48 crops: the SURE forward on 2B = 16 images, T = 36864, 576 windows;
   the EI forward on B = 8 images, T = 18432, 288 windows).  The f32
   attention backward is also checked as the trunk's recompute backward
   calls it (strided from the qkv and proj buffers, att written from the
   same p: ``att_out``), and the script prints which backend SDPA's
   backward, its library call, ran.  The f32 attention forward is also
   checked and timed as the trunk calls it at both training graphs (q, k, v
   strided from the qkv buffer, the output into the proj buffer; SDPA on
   the same views as its library call), and the script prints whether its
   output equals the backward's ``att_out`` bit for bit.  The bf16
   attention forward (K5, the p store) and backward (K7, the saved p) are
   checked and timed contiguous and as the bf16 trunk calls them at both
   graphs (q, k, v strided from a (T, 540) qkv buffer, the forward's
   output into the (B_, N, nh, hd) att buffer, do from the datt buffer, dq,
   dk, dv into a second (T, 540) buffer), and the backward's dv from its
   recompute form must equal its dv from the forward's p_out bit for bit
   (both kernels take p from one softmax).  The bf16 LN backward's calls
   (LN2 and LN1 at both graphs) also print their device time apart: the
   LN kernel's and the dgamma/dbeta sums' (torch.profiler), beside the
   wrapper's queued time; its completion ticket must be back at 0.  Then
   SHA-256 digests of the attention backward's outputs, the f32 forward's
   and the LN backward's (f32 and bf16, both forms) on seeded inputs
   (``--bits DIR`` prints them alone for the port in DIR, so two trees can
   be compared in one run).  Then the bf16 module path's own attention
   calls (``SwinIR(fused_trunk=False)``: k, v strided views of the qkv
   Linear's output, q scaled from it; the forward with no p store, the
   backward recomputing p) at the eval shape (forward) and the 2B training
   graph (both), against their plain versions and SDPA, timed and queued.
   Then the GELU epilogues in the form that is not their dtype's default
   (``SEI_FAST_GELU``): the f32 kernel with the polynomial (``gelu`` at T =
   81920, ``gelu_pair`` with an f32 gp at T = 36864) and the bf16 kernel
   with the exact erf (``gelu``, ``gelu_pair`` with a bf16 and with an f32
   gp, T = 36864), against their plain versions in that form, timed beside
   the default form on the same inputs; ``--bits`` adds their digests (and
   the default form's).
3. Eval path: ``get_model`` (flagship SwinIR, weights from seed 0) ->
   ``get_physics`` (deblurring, Gaussian_R2, noise 5) -> ``evaluate`` on 4
   seeded 256x320 images; checks the kernels' launch counts, the metrics,
   and one full forward against the plain path, and profiles one forward by
   kernel (torch.profiler).
4. Training path: ``build_device_cache`` of 16 seeded 256x320 images ->
   ``get_loss(method="proposed")`` -> ``Trainer`` (flagship SwinIR at full
   width and depth, batch 8, 48 px loss crops, Adam, delayed-linear LR) for
   3 epochs of 2 steps; per-step loss and ms, img/s and peak memory; checks
   the launch counts per step against the design's, that the loss is finite
   and the weights moved; holds one step's gradients on the kernel path
   against the plain path (same inputs, draws and drop-path); profiles one
   step by kernel, with PyTorch's ``reduce_kernel`` launches attributed to
   the port wrapper that made them (the two after its kernel).
5. Captured training: the same trainer as one CUDA graph per dispatch
   (``Trainer(capture=True)``, the default on CUDA) at ``scan_steps`` 1 and
   2, f32 and bf16, from the same seed-0 weights and streams as the eager
   run of phase 4: each step's loss, the final parameters and Adam state
   must equal the eager run's bit for bit, and the kernels launched at
   capture must be the design's per step; steady ms per step (host clock
   over replays) and the device time of one replayed dispatch beside the
   eager trainer's, peak memory.  The data-parallel step
   (``Trainer(data_parallel=...)``, this process the one rank of an NCCL
   group, f32 at ``scan_steps`` 1 and bf16 at 2, captured with the
   all-reduce of the flat gradient buffer in the graph) must equal the
   one-process eager run bit for bit; its steady ms per step beside
   proposed's, and the all-reduce's device time in a replay's profile and
   alone.  Then R2R-EI (``get_loss(method="proposed",
   sure_alternative="r2r")``) on the same path: eagerly, then captured, f32
   at ``scan_steps`` 1 and bf16 at 2, equal to its eager run bit for bit,
   with ``proposed``'s launches per step and finite losses; its steady ms
   per step and busy share beside proposed's and the nvidia-smi line.
   Then the SR task (x2, the flagship SwinIR with the pixelshuffle head,
   weights from seed 0): ``evaluate`` on the 4 seeded 256x320 images in f32
   and bf16 (measurements 128x160, padded to 128x192: T = 24576), the
   launch counts, PSNR/SSIM and ms per image, one forward against the plain
   forward (f32 1e-3 abs, bf16 3e-2 of the plain output's maximum) and
   profiled by kernel;
   ``Upsample`` on the same pairs; one x3 (128x128) and one x4 (64x128)
   forward against the plain forward.  SR x2 training (48 px crops of the
   measurement, the deblurring step's 2B and B graphs): ``proposed`` with
   SURE in f32 eager then captured at ``scan_steps`` 1, R2R-EI in bf16 eager
   then captured at 2, each equal to its eager run bit for bit with proposed
   deblurring's launches per step; steady ms per step, one dispatch's device
   ms, the busy share and peak memory.  Then ``cli.train --task sr
   --sr_factor 2`` (2 captured steps on 16 PNGs, its losses equal to a
   directly built ``Trainer``'s bit for bit) and ``cli.test --task sr`` on
   its ``weights.pt`` (equal to ``evaluate_pairs``); the SR launches by run.
6. The command lines: 16 seeded dead-leaves-like 512x640 PNGs written by
   the port's writer into a temporary ``gt_folder:`` (the dataset's
   shorter-side-256 resize brings them to 256x320), then
   ``sei_tpu_torch.cli.train.main`` in this process at flagship width and
   depth (deblurring Gaussian_R2, noise 5, ``proposed``, batch 8, one epoch
   of 2 captured steps), once in f32 and once with ``--bf16 --scan_steps
   2``: its per-step losses must equal, bit for bit, those of a ``Trainer``
   built here from the same ``GroundTruthDataset``, seed and arguments, and
   the trunk kernels captured must be the design's per step; its steady ms
   per step and img/s beside the card's name and power limit.  Then
   ``sei_tpu_torch.cli.test.main`` on each run's ``weights.pt`` with
   ``--indices 0,1,2,3``: its PSNR/SSIM must equal ``evaluate_pairs`` on
   the same pairs bit for bit.  Then ``cli.train`` with R2R-EI and
   ``--eval_interval 1 --eval_count 4`` for 2 epochs: two
   ``validation.csv`` rows and ``checkpoints/ckp_best.pt``, the same
   losses as without validation (validation runs eagerly between the
   graph's replays), the hook's last PSNR/SSIM equal to ``evaluate_pairs``
   on the final weights bit for bit, and its ms per validated image.  Then
   ``cli.train --data_parallel_devices 0`` (a process of its own, one
   NCCL rank): its ``training.csv`` and final checkpoint equal the f32
   command line's bit for bit.  Then slice 20's paths (``slice20_phase``): ten training cells, each
   eagerly and then captured (f32 at ``scan_steps`` 1, bf16 at 2) and equal
   to its eager run bit for bit with ``proposed``'s launches per step (two
   trunk graphs) or ``supervised``'s (one): the CT-like task's R2R-EI (f32),
   supervised and noise2inverse-method steps (bf16); CSS (bf16), EI-rotate
   and EI-shift R2R (f32); the normal scaling kind (f32, a graph per rate,
   replayed in the JAX trainer's variant order); fresh measurements (f32);
   supervised L1 (bf16); fine-tuning from the seed-0 weights (SGD at 1e-2,
   ``conv_last`` only, every other tensor bit for bit, the weights-distance
   term printed) on a folder of 16 written PNGs; each cell's steady ms per
   step, replay device ms, busy share, eager ms and peak memory, one JSON
   line.  The CT-like eval (f32, plain and Noise2Inverse: launches,
   PSNR/SSIM, ms per image, the forward against the plain forward,
   ``A_dagger(A x)`` against x), the spatial blur (``--no-physics_v2``)
   against the FFT blur (1e-5) and its eval, ``--r2r --r2r_itercount 4``
   on the deblurring eval, and the CT-like command lines (``cli.train``
   equal to a ``Trainer``, ``cli.test --noise2inverse`` equal to the
   ``eval_apply`` wrapper); the launches by run, one JSON line.  Then the
   tiled eval (``tiled_eval_phase``): one seeded 1356x2040 image (Div2K's
   validation shape) through ``evaluate`` at ``eval_tile_height`` 768, 2
   strips of 678 rows with a halo of 64 (T = 3,296,640 tokens per
   forward): the strips' kernel path against the plain versions
   (FORWARD_ATOL), the forward's ms (CUDA events) and peak memory, ms per
   image, one forward's launches, a profile by kernel, and ``cli.test`` on
   the image as a PNG, equal to ``evaluate_pairs``; slice 21's launches by
   run, one JSON line.  Then slice 23 (``module_path_phase``): SwinIR's
   module path (``fused_trunk=False``, ROADMAP Queue 1 item 7) through
   ``evaluate`` on the 4 seeded 256x320 images in f32 and bf16 (36
   attention launches per forward and no trunk kernel, one forward against
   ``forward(plain=True)``: f32 1e-3 abs, bf16 3e-2 of max; ms per image
   and forward ms beside the fused path's), two bf16 ``proposed`` steps on
   it eagerly (gradients against the plain path's autograd to 3e-2 of each
   max) and captured at ``scan_steps`` 2, equal bit for bit, with 36
   attention forwards and backwards per graph; the global-norm clip
   (``clip_norm``) on the fused bf16 step, captured equal to eager, its
   norm above the bound before the clip and equal to it after (1e-5
   relative); then the native PNG loader (``loader_phase``): 8
   seeded 1356x2040 PNGs with all five row filters through
   ``GroundTruthDataset.load_all`` natively and by the numpy codec, decode
   bit for bit and the resize to 256 within 1e-6, seconds and images per
   second of each, the threads and the host's CPUs.  Then slice 22
   (``baselines_phase``): ``tiled_apply``
   of a 896x320 image (2 strips) over a one-rank NCCL group, equal to the
   call without a group bit for bit; InverseFilter, TV (300 iterations),
   DIP (100 steps) and BM3D on one seeded 256x320 image, each twice (ms of
   both calls, peak memory, PSNR/SSIM, whether the bits repeat), held
   against the port on the CPU (InverseFilter on Gaussian_R1, TV 1e-4 of
   the largest value; BM3D 1e-4 on all but 0.1% of the pixels, 5e-2 on
   all); the Convolutional network at its default blueprint with
   ``proposed`` (batch 8, 48 px, f32), captured equal to eager bit for
   bit, then ``cli.train`` and ``cli.test`` of its ``weights.pt`` equal to
   ``evaluate_pairs``; PnP, DiffPIR_DRUNet, DPS and DiffPIR_DiffUNet
   through ``cli.test`` on seeded random weights at the published widths
   (handed over by ``SEI_DRUNET_WEIGHTS`` / ``SEI_DIFFUNET_WEIGHTS``),
   finite and of y's shape; LPIPS on a seeded random AlexNet, card equal
   to CPU (1e-4); one JSON line.  Then ``SEI_FAST_GELU`` (``fast_gelu_phase``,
   after the module path, before the loader): the f32 eval with
   ``SEI_FAST_GELU=1`` (the polynomial GELU; launches, one forward against
   ``plain=True`` at 1e-3, its max difference from the default forward,
   PSNR/SSIM and ms per image beside the default's); two ``proposed``
   steps in f32 with ``SEI_FAST_GELU=1`` and in bf16 with
   ``SEI_FAST_GELU=0``, eagerly (the gradients against the plain path: f32
   1e-3, bf16 3e-2 of each max) and captured (f32 ``scan_steps`` 1, bf16
   2), equal bit for bit, the design's launches, every GELU launch in the
   knob's form, ms per step beside the default's; the module path's
   forward with the knob equal to the one without, bit for bit (f32 and
   bf16).
7. Launch-overhead probes (K8 ``copy_probe``, K9 ``trunk_skeleton``): each
   held exactly against its plain version and timed at the probes' shapes
   (K8 also at an odd element offset with a ragged count, for its scalar
   head and tail),
   then ``sei_tpu_torch.probes`` (chains of launches eager and captured,
   the skeleton variants, the real trunk as the control).  Then ``python -m
   sei_tpu_torch.bench`` in a subprocess: its JSON line (img/s of the
   captured step, f32 and bf16) is printed before the kernel line.
8. Prints the kernel table as one JSON line, the nvidia-smi line, and, last,
   ``{"ok": true, "device": {...}}``.  Any failed phase raises (exit != 0).
   Each kernel entry names its ``design`` (``mma.sync`` tensor cores for
   the bf16 ``gemm_wgrad``, ``gemm_bias_epilogue``, ``gemm_dgrad``,
   ``window_attn_bwd`` and ``window_attn_fwd``, CUDA-core FMAs for the
   rest; the bf16 ``ln_rows_bwd`` in 4-channel accesses with a cp.async
   ring of rows per warp; the f32
   ``gemm_bias_epilogue`` in 8x6
   register tiles fed by ``cp.async``, the f32 ``gemm_dgrad`` in 8x6
   register tiles fed through registers, the f32 ``gemm_wgrad`` in 8x6
   register tiles, A by ``cp.async`` and dy gathered through registers, the
   f32 ``window_attn_bwd`` and ``window_attn_fwd`` in 4x4 register tiles
   fed by ``cp.async``; the bf16 module path's attention entries,
   ``[bf16 module path]``, as the bf16 attention kernels) and
   carries ``queued_ms``: the device time of the same calls queued behind
   a sleeping kernel, free of the wrapper's host cost; every entry with a
   library call carries
   ``library_queued_ms``, the same for it.  A line before the kernel line
   gives the replaced versions' earlier times, marked as not measured in
   this run; each profiled step prints its device time by kernel.

Imports nothing of JAX and nothing of ``sei_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Optional

# H100 SXM published peaks (NVIDIA H100 datasheet): FP32 on the CUDA
# cores (TF32 is off for the f32 paths), dense bf16 on the tensor cores (the
# bf16 training step's bound), and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# flagship eval shapes: one 256x320 image through SwinIR (embed 180, 6 heads,
# window 8, MLP ratio 2)
B, H, W, C, NH, WS = 1, 256, 320, 180, 6, 8
N, HD, CH = WS * WS, C // NH, 2 * C
T = B * H * W
B_ = T // N
N_IMAGES = 4
BLOCKS = 36  # 6 RSTBs x 6 SwinBlocks
PER_BLOCK = {"ln_rows": 2, "gemm_bias_epilogue": 4, "window_attn_fwd": 1}
FORWARD_ATOL = 1e-3

# flagship training: batch 8, 48 px loss crops from 256 px dataset crops;
# the SURE forward runs on 2B stacked images, the EI forward on B
BATCH, CROP, DATA_CROP = 8, 48, 256
TRAIN_GRAPHS = (2 * BATCH, BATCH)
TRAIN_IMAGES, TRAIN_EPOCHS = 16, 3
# launches per SwinBlock per graph: forward, then backward (recompute of
# LN1, qkv, LN2, fc1 + the backward kernels; the attention backward writes
# att from the p it recomputes, so no attention forward is launched again)
PER_BLOCK_TRAIN = {"ln_rows": 2 + 2, "gemm_bias_epilogue": 4 + 2, "window_attn_fwd": 1,
                   "gemm_dgrad": 4, "gemm_wgrad": 4, "window_attn_bwd": 1, "ln_rows_bwd": 2}
# one step's gradients, kernel path vs plain path: max |diff| per tensor
# over max |plain grad| of that tensor (f32 sums in other orders through 2 x
# 36 blocks of forward and backward; SURE's divergence divides the
# difference of two forwards by tau = 1e-2)
GRAD_RTOL = 1e-3
# the bf16 step (SwinIR(dtype=bfloat16), the JAX package's training recipe):
# the trunk's forward keeps gelu, gelu', p and att per block (mode "full")
# and the backward recomputes only LN1, the qkv GEMM and LN2
PER_BLOCK_TRAIN_BF16 = {"ln_rows": 2 + 2, "gemm_bias_epilogue": 4 + 1, "window_attn_fwd": 1,
                        "gemm_dgrad": 4, "gemm_wgrad": 4, "window_attn_bwd": 1,
                        "ln_rows_bwd": 2}
# a bf16 kernel against its plain version (which rounds where it rounds):
# |d| <= BF16_RTOL * (|plain| + max |plain|) on bf16 outputs -- an f32 sum in
# another order can flip a rounding of the output, or of an intermediate
# that is rounded before a further product (ds before dq, dk), by one bf16
# ulp (2^-8 relative) of the largest such value
BF16_RTOL = 1e-2
# the bf16 trunk's gradients on an MSE loss, kernel path vs autograd through
# the plain trunk: within 3e-2 of each tensor's largest entry, the JAX
# package's bound for its bf16 kernel (tests/test_swin_trunk.py:172-176)
TRUNK_GRAD_FRAC = 3e-2
# one proposed step's loss, the bf16 model against the f32 model on the same
# weights and draws: rtol 5e-2, the JAX package's bound for its bf16 model's
# loss against f32 (tests/test_swin_trunk.py:458).  bf16 rounds each
# activation to 2^-9 relative through 36 blocks, and SURE's divergence
# (f(y + tau b) - f(y)) / tau with tau = 1e-2 multiplies the rounding noise
# of the two forwards by 100 per pixel before the batch mean (55296 values)
# averages it down; its 2 sigma^2 weight (sigma = 5/255) keeps it small
LOSS_RTOL_BF16 = 5e-2
# captured training: the scan_steps values run, and the dispatches timed per
# trainer after the comparison (host clock, one sync at the end)
SCAN_STEPS = (1, 2)
TIMED_DISPATCHES = 4
# the command lines' phase: PNGs of twice the eval size, which the
# GroundTruthDataset's shorter-side-256 resize brings back to 256x320; one
# epoch of 2 steps at batch 8; the test command line on 4 of them
CLI_IMAGES, CLI_TEST_INDICES = 16, (0, 1, 2, 3)
# in-training validation in the command-line phase: the first 4 PNGs
CLI_EVAL_COUNT = 4
# the SR phase: SR x2 (the JAX package's SR recipe, experiments/queue_r3q.sh:
# 54-56); training crops of CROP px on the measurement's side (the dataset
# crops the loss's 48 px directly, demo/train.py:194-201), so the 2B and B
# graphs are the deblurring step's; the eval's 64 bucket on each factor's
# measurement of a 256x320 image: x2 128x160 -> 128x192, x3 85x106 ->
# 128x128, x4 64x80 -> 64x128
SR_FACTOR, SR_OTHER_FACTORS, PAD_BUCKET = 2, (3, 4), 64
# the CT-like task (the separable ramp filter; the JAX package's
# experiments/queue_r3r.sh and queue_r3t.sh run it on Div2K)
CT = "invert_a_tomography_like_filter"
# TASK_ARGS: each task's physics flags on the command lines
TASK_ARGS = {"deblurring": ["--task", "deblurring", "--kernel", "Gaussian_R2"],
             "sr": ["--task", "sr", "--sr_factor", str(SR_FACTOR)],
             CT: ["--task", CT]}
TASK_LABELS = {"deblurring": "", "sr": f" sr x{SR_FACTOR}", CT: " ct"}
# Noise2Inverse's eval ensemble: 4 row combs, one forward per 3-comb sum
N2I_FORWARDS = 4
# --r2r's eval average: forwards per image
R2R_ITERCOUNT = 4
# the spatial blur (--no-physics_v2) against the FFT blur: the same circular
# operator, cuDNN's direct sum against cuFFT's products, within f32 roundoff
SPATIAL_ATOL = 1e-5
# a bf16 forward against the plain bf16 forward (which rounds where the
# kernels round; an f32 sum in another order can flip a bf16 rounding,
# which the blocks after it carry on): within 3e-2 of the plain output's
# largest value, the JAX package's bound for its bf16 kernel
# (tests/test_swin_trunk.py:172-176)
FORWARD_FRAC_BF16 = 3e-2
# the probes' shape (experiments/perf_probe_r3*.py: b, h, w, c) and depth
PROBE_SHAPE, PROBE_DEPTH = (8, 48, 48, 180), 6
PROBE_BLOCKS = (1, 4, 8, 24, 132, 1056)
# the tiled eval: one image of Div2K's validation shape above the eval tile
# height (demo/test.py:157-167): 2 strips of 678 rows, halo 64, windows of
# 806 rows (808 after SwinIR's window pad), T = 2 x 808 x 2040 tokens
TILED_H, TILED_W, TILE_HEIGHT = 1356, 2040, 768
# SwinIR's module path (fused_trunk=False) per block and graph: the
# attention forward and backward only (LN and Linear layers in PyTorch)
PER_BLOCK_MODULE = {"ln_rows": 0, "gemm_bias_epilogue": 0, "window_attn_fwd": 1, "gemm_dgrad": 0,
                    "gemm_wgrad": 0, "window_attn_bwd": 1, "ln_rows_bwd": 0}
# the global-norm clip's bound in its training cell: below the flagship
# step's gradient norm at seed 0, so every step clips
CLIP_NORM = 1e-2
# the clipped gradients' global norm (f64 sums) against CLIP_NORM, relative:
# two f32 roundings of each gradient (g / norm * max_norm) and the f32 norm
CLIP_RTOL = 1e-5
# the native PNG loader: Div2K-shaped PNGs (the tiled eval's shape), the
# dataset's load_all threads, and the resize's bound against the numpy path
# (f32 sums of the same products in another order)
LOADER_IMAGES, LOADER_THREADS, LOADER_RESIZE_ATOL = 8, 16, 1e-6


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    queued behind a sleeping kernel: for calls shorter than their launch,
    which ``time_ms`` would time at the host's launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clock: longer than the enqueueing
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def library_times(fn) -> dict:
    """The library call's ``library_ms`` (``time_ms``) and
    ``library_queued_ms`` (``queued_ms``: its device time alone, apart from
    the host work of the call, autograd's included); None without one."""
    if fn is None:
        return {"library_ms": None, "library_queued_ms": None}
    return {"library_ms": time_ms(fn), "library_queued_ms": queued_ms(fn)}


def fmt_library(r: dict) -> str:
    if r["library_ms"] is None:
        return "library None"
    return f"library {r['library_ms']:.4f} ms (queued {r['library_queued_ms']:.4f})"


def ptxas_report(log: str) -> list[str]:
    """One line per kernel of nvcc's ``-Xptxas -v`` log: its source, its name
    (demangled where ``c++filt`` is found, without the parameter list), its
    registers, barriers and shared memory, and its stack and spills."""
    rows, src, name, frame = [], "", "", ""
    for line in log.splitlines():
        s = line.strip()
        if s.startswith("== "):
            src = s[3:]
        elif "Compiling entry function" in s:
            name = s.split("'")[1]
        elif "spill" in s:
            frame = s
        elif s.startswith("ptxas info") and "Used" in s and "registers" in s:
            rows.append((src, name, s.split(":", 1)[1].strip(), frame))
    names = [r[1] for r in rows]
    if names and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True, timeout=60).stdout.splitlines()
        names = [n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
                 for n in names]
    return [f"{src} {n}: {used}; {frame}" for (src, _, used, frame), n in zip(rows, names)]


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(name: str, got, want, atol: float, rtol: float) -> float:
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} vs plain {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    ok = bool((err <= atol + rtol * want.abs()).all())
    print(f"  {name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
          f"tolerance |d| <= {atol:g} + {rtol:g}*|plain| -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_abs


def compare_bf16(name: str, got, want, f32_tol: tuple) -> float:
    """A bf16 kernel's output: bf16 tensors to BF16_RTOL (relative and of the
    largest entry), its f32 outputs to ``f32_tol`` (atol, rtol)."""
    import torch

    if got.dtype != want.dtype:
        fail(f"{name}: dtype {got.dtype} vs plain {want.dtype}")
    if want.dtype == torch.bfloat16:
        got, want = got.float(), want.float()
        return compare(name, got, want, BF16_RTOL * float(want.abs().max()), BF16_RTOL)
    return compare(name, got, want, *f32_tol)


def check_kernels(timed: bool) -> dict:
    """Each kernel against its plain version at the flagship shapes; returns
    per-kernel sums over the variants one SwinBlock runs."""
    import torch
    import torch.nn.functional as F

    from sei_tpu_torch.models.swinir import shift_attn_mask
    from sei_tpu_torch.ops import attention as at
    from sei_tpu_torch.ops import swin_trunk as st

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=dev) * s

    rows = {}

    def record(kernel, variant, err, fn_k, fn_p, fn_lib, flops, nbytes):
        b_ms, b_by = bound_ms(flops, nbytes)
        r = {"variant": variant, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
             "flops": flops, "bytes": nbytes, "per_block": True}
        if timed:
            r["ms"] = time_ms(fn_k)
            r["queued_ms"] = queued_ms(fn_k)
            r["plain_ms"] = time_ms(fn_p)
            r.update(library_times(fn_lib))
            print(f"    {kernel}[{variant}]: kernel {r['ms']:.4f} ms (queued {r['queued_ms']:.4f}), "
                  f"plain {r['plain_ms']:.4f} ms, {fmt_library(r)}, bound {b_ms:.4f} ms ({b_by}), "
                  f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB")
        rows.setdefault(kernel, []).append(r)

    print("kernel checks (flagship shapes: T=%d tokens, C=%d, %d heads, window %d)" % (T, C, NH, WS))
    x = rnd(B, H, W, C)
    gamma, beta = 1.0 + rnd(C, s=0.1), rnd(C, s=0.1)
    wm_shift = st.WindowMap(H, W, WS, WS // 2)
    for variant, inp, wm in (("ln1_shift_window", x, wm_shift), ("ln2", x.view(T, C), None)):
        got = st.ln_rows(inp, gamma, beta, window=wm)
        err = compare(f"ln_rows[{variant}]", got, st._torch_ln_rows(inp, gamma, beta, wm), 1e-5, 1e-5)
        record("ln_rows", variant, err,
               lambda: st.ln_rows(inp, gamma, beta, window=wm),
               lambda: st._torch_ln_rows(inp, gamma, beta, wm),
               lambda: F.layer_norm(x.view(T, C), (C,), gamma, beta, 1e-5),
               8.0 * T * C, 4.0 * (2 * T * C + 2 * C))

    dpm = torch.full((B,), 0.9, device=dev)
    shapes = (("qkv", C, 3 * C, "none", None), ("proj", C, C, "residual", wm_shift),
              ("fc1", C, CH, "gelu", None), ("fc2", CH, C, "residual", None))
    for variant, k, n, epi, wm in shapes:
        a = rnd(T, k, s=1.0)
        w = rnd(k, n, s=0.05)
        b = rnd(n, s=0.05)
        res = x if epi == "residual" else None
        d = dpm if epi == "residual" else None
        got = st.gemm_bias_epilogue(a, w, b, epi, res=res, dpm=d, window=wm)
        want = st._torch_gemm_bias_epilogue(a, w, b, epi, res, d, wm)
        err = compare(f"gemm_bias_epilogue[{variant}]", got, want, 1e-4, 1e-4)
        nbytes = 4.0 * (T * k + k * n + n + T * n * (2 if epi == "residual" else 1))
        record("gemm_bias_epilogue", variant, err,
               lambda: st.gemm_bias_epilogue(a, w, b, epi, res=res, dpm=d, window=wm),
               lambda: st._torch_gemm_bias_epilogue(a, w, b, epi, res, d, wm),
               lambda: torch.addmm(b, a, w), 2.0 * T * k * n, nbytes)
        del a, w, b, got, want

    q = rnd(B_, NH, N, HD, s=HD ** -0.5)
    kk = rnd(B_, NH, N, HD)
    v = rnd(B_, NH, N, HD)
    bias = rnd(NH, N, N, s=0.1)
    mask = torch.from_numpy(shift_attn_mask(H, W, WS, WS // 2)).to(dev)
    for variant, m in (("no_mask", None), ("shift_mask", mask)):
        got = at.window_attn_fwd(q, kk, v, bias, m)
        err = compare(f"window_attn_fwd[{variant}]", got, at._torch_attention(q, kk, v, bias, m),
                      2e-5, 1e-5)
        full_mask = (bias[None] if m is None else bias[None] + m[:, None]).expand(B_, NH, N, N)
        nbytes = 4.0 * (4 * B_ * NH * N * HD + NH * N * N + (0 if m is None else m.numel()))
        record("window_attn_fwd", variant, err,
               lambda: at.window_attn_fwd(q, kk, v, bias, m),
               lambda: at._torch_attention(q, kk, v, bias, m),
               lambda: F.scaled_dot_product_attention(q, kk, v, attn_mask=full_mask, scale=1.0),
               4.0 * B_ * NH * N * N * HD, nbytes)
    return rows


def sdpa_backend(out, inputs, grad) -> str:
    """Which backend SDPA's backward ran on the card: the device kernels of
    one ``torch.autograd.grad`` through its output, by time (torch.profiler),
    and the backend they name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(out, inputs, grad, retain_graph=True)
        torch.cuda.synchronize()
    names = [e.key for e in sorted(device_events(prof), key=lambda e: -e.self_device_time_total)]
    text = " ".join(names).lower()
    kind = next((k for k, tags in (("flash", ("flash",)), ("efficient", ("fmha", "efficient")),
                                   ("cudnn", ("cudnn",))) if any(t in text for t in tags)),
                "math (matmuls and softmax)")
    return f"{kind}; kernels {[n[:60] for n in names[:3]]}"


def check_train_kernels(timed: bool) -> dict:
    """The backward kernels (and the fc1 pre-activation epilogue) against
    their plain versions at the flagship training shapes, both graphs; the
    per-SwinBlock sums of the 2B graph go into the JSON line."""
    import torch
    import torch.nn.functional as F

    from sei_tpu_torch.models.swinir import shift_attn_mask
    from sei_tpu_torch.ops import _build
    from sei_tpu_torch.ops import attention as at
    from sei_tpu_torch.ops import swin_trunk as st

    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=dev) * s

    rows = {}

    def record(kernel, variant, errs, fn_k, fn_p, fn_lib, flops, nbytes, per_block):
        b_ms, b_by = bound_ms(flops, nbytes)
        r = {"variant": variant, "max_abs_err": max(errs), "bound_ms": b_ms, "bound_by": b_by,
             "flops": flops, "bytes": nbytes, "per_block": per_block}
        if timed:
            r["ms"] = time_ms(fn_k)
            r["queued_ms"] = queued_ms(fn_k)
            r["plain_ms"] = time_ms(fn_p)
            r.update(library_times(fn_lib))
            print(f"    {kernel}[{variant}]: kernel {r['ms']:.4f} ms (queued {r['queued_ms']:.4f}), "
                  f"plain {r['plain_ms']:.4f} ms, {fmt_library(r)}, bound {b_ms:.4f} ms ({b_by}), "
                  f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB")
        rows.setdefault(kernel, []).append(r)

    def cmp_all(name, got, want, tols):
        return [compare(f"{name}[{i}]", a, b, *tol)
                for i, (a, b, tol) in enumerate(zip(got, want, tols))]

    for b in TRAIN_GRAPHS:
        t = b * CROP * CROP
        b_ = t // N
        main = b == TRAIN_GRAPHS[0]  # the 2B graph: the per-block sums
        print(f"training kernel checks: {b} images {CROP}x{CROP}, T={t}, {b_} windows")
        wm = st.WindowMap(CROP, CROP, WS, WS // 2)
        dpm = (torch.rand(b, generator=g, device=dev) < 0.9).float() / 0.9
        x4 = rnd(b, CROP, CROP, C)

        # fc1 with gelu'(h) stored beside gelu(h) (the recompute)
        z, w1, b1 = rnd(t, C), rnd(C, CH, s=0.05), rnd(CH, s=0.05)
        gp, gp_p = torch.empty(t, CH, device=dev), torch.empty(t, CH, device=dev)
        errs = cmp_all(f"gemm_bias_epilogue[fc1_gelu_pair T={t}]",
                       (st.gemm_bias_epilogue(z, w1, b1, "gelu_pair", gp=gp), gp),
                       (st._torch_gemm_bias_epilogue(z, w1, b1, "gelu_pair", gp=gp_p), gp_p),
                       [(1e-4, 1e-4)] * 2)
        record("gemm_bias_epilogue", f"fc1_gelu_pair T={t}", errs,
               lambda: st.gemm_bias_epilogue(z, w1, b1, "gelu_pair", gp=gp),
               lambda: st._torch_gemm_bias_epilogue(z, w1, b1, "gelu_pair", gp=gp_p),
               lambda: torch.addmm(b1, z, w1), 2.0 * t * C * CH,
               4.0 * (t * C + C * CH + CH + 2 * t * CH), False)

        # data-grad products, in the order one block's backward runs them
        for variant, kk, nn, scale, wmap, gelu in (
                ("fc2_gelu_grad", CH, C, dpm, None, True), ("fc1", C, CH, None, None, False),
                ("proj_window_dpm", C, C, dpm, wm, False), ("qkv", C, 3 * C, None, None, False)):
            dy = x4[..., :nn].contiguous() if wmap else rnd(t, nn)
            w = rnd(kk, nn, s=0.05)
            gp = rnd(t, kk) if gelu else None
            dy2 = dy.reshape(t, nn)
            errs = [compare(f"gemm_dgrad[{variant} T={t}]",
                            st.gemm_dgrad(dy, w, scale=scale, window=wmap, gp=gp),
                            st._torch_gemm_dgrad(dy, w, scale, wmap, gp), 1e-4, 1e-4)]
            record("gemm_dgrad", f"{variant} T={t}", errs,
                   lambda: st.gemm_dgrad(dy, w, scale=scale, window=wmap, gp=gp),
                   lambda: st._torch_gemm_dgrad(dy, w, scale, wmap, gp),
                   lambda: torch.mm(dy2, w.t()), 2.0 * t * nn * kk,
                   4.0 * (t * nn + kk * nn + t * kk * (2 if gelu else 1)), main)
            del dy, w, gp, dy2

        # weight-grad products (sums over T tokens in another order: 1e-3),
        # each written as partials over splits of T that the wrapper sums
        for variant, kk, nn, scale, wmap in (
                ("fc2_dpm", CH, C, dpm, None), ("fc1", C, CH, None, None),
                ("proj_window_dpm", C, C, dpm, wm), ("qkv", C, 3 * C, None, None)):
            splits = st._wgrad_f32_splits(_build.library(), torch.cuda.current_device(), t, kk,
                                          nn)
            print(f"  gemm_wgrad[{variant} T={t}]: {splits} splits, partials "
                  f"{4 * splits * (kk * nn + nn)} bytes")
            a = rnd(t, kk)
            dy = x4[..., :nn].contiguous() if wmap else rnd(t, nn)
            dy2 = dy.reshape(t, nn)
            errs = cmp_all(f"gemm_wgrad[{variant} T={t}]",
                           st.gemm_wgrad(a, dy, scale=scale, window=wmap),
                           st._torch_gemm_wgrad(a, dy, scale, wmap), [(1e-3, 1e-4)] * 2)
            record("gemm_wgrad", f"{variant} T={t}", errs,
                   lambda: st.gemm_wgrad(a, dy, scale=scale, window=wmap),
                   lambda: st._torch_gemm_wgrad(a, dy, scale, wmap),
                   lambda: torch.mm(a.t(), dy2), 2.0 * t * kk * nn + t * nn,
                   4.0 * (t * kk + t * nn + kk * nn + nn), main)
            del a, dy, dy2

        # attention backward, with and without the shift mask; then as the
        # trunk's recompute backward calls it: q, k, v and do strided from its
        # qkv and proj buffers, dq, dk, dv into one qkv-shaped buffer, and att
        # written from the same p (one more 64x64x30 product per pair)
        q = rnd(b_, NH, N, HD, s=HD ** -0.5)
        kt, v, do = rnd(b_, NH, N, HD), rnd(b_, NH, N, HD), rnd(b_, NH, N, HD, s=0.1)
        bias = rnd(NH, N, N, s=0.1)
        mask = torch.from_numpy(shift_attn_mask(CROP, CROP, WS, WS // 2)).to(dev)
        qkv = rnd(b_, N, 3, NH, HD)
        qkv[:, :, 0] *= HD ** -0.5
        qv, kv, vv = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        dov = do.transpose(1, 2).contiguous().transpose(1, 2)
        dqkv = torch.empty_like(qkv)
        att = torch.empty(b_, N, NH, HD, device=dev)
        scale = HD ** -0.5
        for variant, m in (("no_mask", None), ("shift_mask", mask)):
            errs = cmp_all(f"window_attn_bwd[{variant} T={t}]",
                           at.window_attn_bwd(q, kt, v, bias, m, do, scale=scale),
                           at._torch_attention_bwd(q, kt, v, bias, m, do, scale),
                           [(2e-5, 1e-4)] * 3 + [(1e-4, 1e-4)])
            full = (bias[None] if m is None else
                    (bias[None] + m[:, None]).repeat(b_ // m.shape[0], 1, 1, 1)).expand(b_, NH, N, N)
            ql, kl, vl = (u.detach().clone().requires_grad_() for u in (q, kt, v))
            out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=full, scale=scale)
            if main and m is None:
                print(f"    SDPA backward (library call) ran: {sdpa_backend(out, (ql, kl, vl), do)}")
            nbytes = 4.0 * (7 * b_ * NH * N * HD + 2 * NH * N * N + (0 if m is None else m.numel()))
            record("window_attn_bwd", f"{variant} T={t}", errs,
                   lambda: at.window_attn_bwd(q, kt, v, bias, m, do, scale=scale),
                   lambda: at._torch_attention_bwd(q, kt, v, bias, m, do, scale),
                   lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True),
                   10.0 * b_ * NH * N * N * HD, nbytes, main)

            def fused(m=m):  # the trunk's call: grads into dqkv's views, att beside them
                return (*at.window_attn_bwd(qv, kv, vv, bias, m, dov, scale=scale,
                                            out=tuple(dqkv[:, :, i].transpose(1, 2)
                                                      for i in range(3)),
                                            att_out=att.transpose(1, 2)),
                        att.transpose(1, 2))

            errs = cmp_all(f"window_attn_bwd[{variant} att_out trunk_views T={t}]", fused(),
                           at._torch_attention_bwd(qv, kv, vv, bias, m, dov, scale,
                                                   with_att=True),
                           [(2e-5, 1e-4)] * 3 + [(1e-4, 1e-4), (2e-5, 1e-5)])

            def sdpa_fwd_bwd(full=full):  # att and dq, dk, dv: SDPA's forward and backward
                ql2, kl2, vl2 = (u.detach().requires_grad_() for u in (qv, kv, vv))
                out2 = F.scaled_dot_product_attention(ql2, kl2, vl2, attn_mask=full, scale=scale)
                return out2, torch.autograd.grad(out2, (ql2, kl2, vl2), dov)

            record("window_attn_bwd", f"{variant} att_out trunk_views T={t}", errs, fused,
                   lambda m=m: at._torch_attention_bwd(qv, kv, vv, bias, m, dov, scale,
                                                       with_att=True),
                   sdpa_fwd_bwd, 12.0 * b_ * NH * N * N * HD, nbytes + 4.0 * b_ * NH * N * HD,
                   False)

            # the f32 forward as the trunk calls it: q, k, v strided from the
            # qkv buffer, the output into the (B_, N, nh, hd) proj buffer;
            # then against the backward's att from the same inputs
            fwd_out = torch.empty(b_, N, NH, HD, device=dev)

            def fwd(m=m):
                return at.window_attn_fwd(qv, kv, vv, bias, m, scale=scale,
                                          out=fwd_out.transpose(1, 2))

            err = compare(f"window_attn_fwd[{variant} trunk_views T={t}]", fwd(),
                          at._torch_attention(qv, kv, vv, bias, m, scale), 2e-5, 1e-5)
            fused()
            torch.cuda.synchronize()
            print(f"    window_attn_fwd[{variant} trunk_views T={t}] against window_attn_bwd's "
                  f"att_out: bit for bit {torch.equal(fwd_out, att)}, max |d| "
                  f"{float((fwd_out - att).abs().max()):.3e}")
            record("window_attn_fwd", f"{variant} trunk_views T={t}", [err], fwd,
                   lambda m=m: at._torch_attention(qv, kv, vv, bias, m, scale),
                   lambda: F.scaled_dot_product_attention(qv, kv, vv, attn_mask=full, scale=scale),
                   4.0 * b_ * NH * N * N * HD,
                   4.0 * (4 * b_ * NH * N * HD + NH * N * N + (0 if m is None else m.numel())),
                   False)
            del ql, kl, vl, out, full
        del q, kt, v, do, qkv, qv, kv, vv, dov, dqkv, att, fwd_out

        # LayerNorm backward: LN1 (window scatter + residual), LN2 (residual)
        gamma = 1.0 + rnd(C, s=0.1)
        for variant, x, wmap in (("ln1_window", x4, wm), ("ln2", x4.view(t, C), None)):
            dz, dres = rnd(t, C), rnd(*x.shape)
            x2d = x4.view(t, C)
            _, mean, rstd = torch.ops.aten.native_layer_norm(x2d, [C], gamma, None, 1e-5)
            errs = cmp_all(f"ln_rows_bwd[{variant} T={t}]",
                           st.ln_rows_bwd(x, gamma, dz, window=wmap, dres=dres),
                           st._torch_ln_rows_bwd(x, gamma, dz, wmap, dres),
                           [(1e-5, 1e-5), (1e-3, 1e-4), (1e-3, 1e-4)])
            record("ln_rows_bwd", f"{variant} T={t}", errs,
                   lambda: st.ln_rows_bwd(x, gamma, dz, window=wmap, dres=dres),
                   lambda: st._torch_ln_rows_bwd(x, gamma, dz, wmap, dres),
                   lambda: torch.ops.aten.native_layer_norm_backward(
                       dz, x2d, [C], mean, rstd, gamma, None, [True, True, False]),
                   12.0 * t * C, 4.0 * (4 * t * C + 3 * C), main)
            del dz, dres
    return rows


def check_bf16_kernels(timed: bool) -> dict:
    """Every kernel's bf16 instantiation and the save behaviours of the bf16
    step (the gelu_pair epilogue, the p store, the saved-p attention
    backward, dgrad's saved-gelu' epilogue) against their plain versions in
    bf16, at the training shapes of both graphs, in the order one block of
    the bf16 step runs them; bounds at the bf16 peak, library calls in bf16.
    ``per_block`` is how often one block of the 2B graph runs the variant."""
    import torch
    import torch.nn.functional as F

    from sei_tpu_torch.models.swinir import shift_attn_mask
    from sei_tpu_torch.ops import attention as at
    from sei_tpu_torch.ops import swin_trunk as st

    g = torch.Generator(device="cuda").manual_seed(2)
    dev, bf, f32 = "cuda", torch.bfloat16, torch.float32

    def rnd(*shape, s=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dtype)

    rows = {}

    def record(kernel, variant, errs, fn_k, fn_p, fn_lib, flops, nbytes, per_block):
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        r = {"variant": variant, "max_abs_err": max(errs), "bound_ms": b_ms, "bound_by": b_by,
             "flops": flops, "bytes": nbytes, "per_block": per_block}
        if timed:
            r["ms"] = time_ms(fn_k)
            # the same calls queued behind a sleeping kernel: device time
            # alone, where a call (~0.1 ms) is shorter than its wrapper's host work
            r["queued_ms"] = queued_ms(fn_k)
            r["plain_ms"] = time_ms(fn_p)
            r.update(library_times(fn_lib))
            print(f"    {kernel}[bf16 {variant}]: kernel {r['ms']:.4f} ms (queued {r['queued_ms']:.4f}), "
                  f"plain {r['plain_ms']:.4f} ms, {fmt_library(r)}, bound {b_ms:.4f} ms ({b_by}), "
                  f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB")
        rows.setdefault(kernel, []).append(r)

    def cmp_all(name, got, want, f32_tol=(1e-4, 1e-4)):
        return [compare_bf16(f"{name}[{i}]", a, b, f32_tol)
                for i, (a, b) in enumerate(zip(got, want))]

    def nb(*tensors):  # bytes of tensors read or written once
        return float(sum(t.numel() * t.element_size() for t in tensors))

    for b in TRAIN_GRAPHS:
        t = b * CROP * CROP
        b_ = t // N
        main = b == TRAIN_GRAPHS[0]  # the 2B graph: the per-block sums
        print(f"bf16 kernel checks: {b} images {CROP}x{CROP}, T={t}, {b_} windows "
              f"(tolerance on bf16 outputs |d| <= {BF16_RTOL:g}*(|plain| + max|plain|))")
        wm = st.WindowMap(CROP, CROP, WS, WS // 2)
        dpm = (torch.rand(b, generator=g, device=dev) < 0.9).float() / 0.9
        x4 = rnd(b, CROP, CROP, C)
        gamma, beta = 1.0 + rnd(C, s=0.1, dtype=f32), rnd(C, s=0.1, dtype=f32)

        # forward: LN1 (window gather) and LN2, bf16 out
        for variant, inp, wmap in (("ln1_shift_window", x4, wm), ("ln2", x4.view(t, C), None)):
            errs = cmp_all(f"ln_rows[bf16 {variant} T={t}]",
                           [st.ln_rows(inp, gamma, beta, window=wmap)],
                           [st._torch_ln_rows(inp, gamma, beta, wmap)])
            x2d, gb, bb = x4.view(t, C), gamma.to(bf), beta.to(bf)
            record("ln_rows", f"{variant} T={t}", errs,
                   lambda: st.ln_rows(inp, gamma, beta, window=wmap),
                   lambda: st._torch_ln_rows(inp, gamma, beta, wmap),
                   lambda: F.layer_norm(x2d, (C,), gb, bb, 1e-5),
                   8.0 * t * C, 2.0 * nb(x4) + nb(gamma, beta), 2 if main else 0)

        # forward GEMMs: qkv (run twice per block: forward and the backward's
        # recompute), proj + window store + double rounding, fc1 + gelu pair
        # (the save), fc2 + residual
        for variant, k, n, epi, wmap, reps in (
                ("qkv", C, 3 * C, "none", None, 2), ("proj_residual_window", C, C, "residual", wm, 1),
                ("fc1_gelu_pair", C, CH, "gelu_pair", None, 1),
                ("fc2_residual", CH, C, "residual", None, 1)):
            a, w, bias = rnd(t, k), rnd(k, n, s=0.05), rnd(n, s=0.05, dtype=f32)
            res = x4 if epi == "residual" else None
            d = dpm if epi == "residual" else None
            gp, gp_p = ((torch.empty(t, n, device=dev, dtype=bf) for _ in range(2))
                        if epi == "gelu_pair" else (None, None))
            got = st.gemm_bias_epilogue(a, w, bias, epi, res=res, dpm=d, window=wmap, gp=gp)
            want = st._torch_gemm_bias_epilogue(a, w, bias, epi, res, d, wmap, gp_p)
            errs = cmp_all(f"gemm_bias_epilogue[bf16 {variant} T={t}]",
                           [got] + ([gp] if gp is not None else []),
                           [want] + ([gp_p] if gp_p is not None else []))
            bias_bf = bias.to(bf)
            record("gemm_bias_epilogue", f"{variant} T={t}", errs,
                   lambda: st.gemm_bias_epilogue(a, w, bias, epi, res=res, dpm=d, window=wmap, gp=gp),
                   lambda: st._torch_gemm_bias_epilogue(a, w, bias, epi, res, d, wmap, gp_p),
                   lambda: torch.addmm(bias_bf, a, w), 2.0 * t * k * n,
                   nb(a, w, got, bias) + (nb(res) if res is not None else 0.0)
                   + (nb(gp) if gp is not None else 0.0), reps if main else 0)
            del a, w, got, want, gp, gp_p

        # attention forward with the p store
        q = rnd(b_, NH, N, HD, s=HD ** -0.5)
        kt, v, do = rnd(b_, NH, N, HD), rnd(b_, NH, N, HD), rnd(b_, NH, N, HD, s=0.1)
        bias = rnd(NH, N, N, s=0.1, dtype=f32)
        mask = torch.from_numpy(shift_attn_mask(CROP, CROP, WS, WS // 2)).to(dev)
        saved = {}
        for variant, m in (("no_mask", None), ("shift_mask", mask)):
            p, p_p = (torch.empty(b_, NH, N, N, device=dev, dtype=bf) for _ in range(2))
            got = at.window_attn_fwd(q, kt, v, bias, m, p_out=p)
            errs = cmp_all(f"window_attn_fwd[bf16 {variant} p_store T={t}]", [got, p],
                           [at._torch_attention(q, kt, v, bias, m, 1.0, p_p), p_p])
            full = (bias[None] if m is None else
                    (bias[None] + m[:, None]).repeat(b_ // m.shape[0], 1, 1, 1)).expand(
                        b_, NH, N, N).to(bf)
            record("window_attn_fwd", f"{variant} p_store T={t}", errs,
                   lambda: at.window_attn_fwd(q, kt, v, bias, m, p_out=p),
                   lambda: at._torch_attention(q, kt, v, bias, m, 1.0, p_p),
                   lambda: F.scaled_dot_product_attention(q, kt, v, attn_mask=full, scale=1.0),
                   4.0 * b_ * NH * N * N * HD,
                   nb(q, kt, v, got, p, bias) + (nb(m) if m is not None else 0.0), 1 if main else 0)
            saved[variant] = p
            del got, p_p, full

            # as the bf16 trunk calls it (swin_trunk.py, _attention): q, k, v
            # strided from its (T, 540) qkv buffer, the output into the
            # transposed (B_, N, nh, hd) att buffer, p saved
            qkv = rnd(b_, N, 3, NH, HD)
            views = tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))
            att = torch.empty(b_, N, NH, HD, device=dev, dtype=bf)
            tp, tp_p = (torch.empty(b_, NH, N, N, device=dev, dtype=bf) for _ in range(2))
            scale = HD ** -0.5

            def trunk_fwd(m=m, views=views, att=att, tp=tp, sc=scale):
                return at.window_attn_fwd(*views, bias, m, scale=sc, out=att.transpose(1, 2),
                                          p_out=tp)

            errs = cmp_all(f"window_attn_fwd[bf16 {variant} p_store trunk_views T={t}]",
                           [trunk_fwd(), tp],
                           [at._torch_attention(*views, bias, m, scale, tp_p), tp_p])
            full = (bias[None] if m is None else
                    (bias[None] + m[:, None]).repeat(b_ // m.shape[0], 1, 1, 1)).expand(
                        b_, NH, N, N).to(bf)
            record("window_attn_fwd", f"{variant} p_store trunk_views T={t}", errs, trunk_fwd,
                   lambda m=m, views=views, tp_p=tp_p, sc=scale: at._torch_attention(
                       *views, bias, m, sc, tp_p),
                   lambda views=views, full=full, sc=scale: F.scaled_dot_product_attention(
                       *views, attn_mask=full, scale=sc),
                   4.0 * b_ * NH * N * N * HD,
                   nb(q, kt, v, q, tp, bias) + (nb(m) if m is not None else 0.0), 0)
            del qkv, views, att, tp, tp_p, full

        # data-grad products, in the order one block's backward runs them
        for variant, kk, nn, dy_dtype, out_dtype, scale, wmap, with_gp in (
                ("fc2_saved_gelu_grad", CH, C, bf, f32, dpm, None, True),
                ("fc1", C, CH, f32, f32, None, None, False),
                ("proj_window_dpm", C, C, f32, bf, dpm, wm, False),
                ("qkv", C, 3 * C, bf, bf, None, None, False)):
            dy = (rnd(b, CROP, CROP, nn, dtype=dy_dtype) if wmap else rnd(t, nn, dtype=dy_dtype))
            w = rnd(kk, nn, s=0.05)
            gp = rnd(t, kk) if with_gp else None
            got = st.gemm_dgrad(dy, w, scale=scale, window=wmap, gp=gp, out_dtype=out_dtype)
            errs = cmp_all(f"gemm_dgrad[bf16 {variant} T={t}]", [got],
                           [st._torch_gemm_dgrad(dy, w, scale, wmap, gp, out_dtype)])
            dy2 = dy.reshape(t, nn).to(bf)
            record("gemm_dgrad", f"{variant} T={t}", errs,
                   lambda: st.gemm_dgrad(dy, w, scale=scale, window=wmap, gp=gp, out_dtype=out_dtype),
                   lambda: st._torch_gemm_dgrad(dy, w, scale, wmap, gp, out_dtype),
                   lambda: torch.mm(dy2, w.t()), 2.0 * t * nn * kk,
                   nb(dy, w, got) + (nb(gp) if gp is not None else 0.0), 1 if main else 0)
            del dy, w, gp, got, dy2

        # weight-grad products (f32 sums over T tokens in another order: 1e-3)
        for variant, kk, nn, dy_dtype, scale, wmap, db_rounded in (
                ("fc2_dpm", CH, C, bf, dpm, None, False), ("fc1", C, CH, f32, None, None, False),
                ("proj_window_dpm", C, C, f32, dpm, wm, True), ("qkv", C, 3 * C, bf, None, None, True)):
            a = rnd(t, kk)
            dy = (rnd(b, CROP, CROP, nn, dtype=dy_dtype) if wmap else rnd(t, nn, dtype=dy_dtype))
            dy2 = dy.reshape(t, nn).to(bf)
            errs = cmp_all(f"gemm_wgrad[bf16 {variant} T={t}]",
                           st.gemm_wgrad(a, dy, scale=scale, window=wmap, db_rounded=db_rounded),
                           st._torch_gemm_wgrad(a, dy, scale, wmap, db_rounded), (1e-3, 1e-4))
            record("gemm_wgrad", f"{variant} T={t}", errs,
                   lambda: st.gemm_wgrad(a, dy, scale=scale, window=wmap, db_rounded=db_rounded),
                   lambda: st._torch_gemm_wgrad(a, dy, scale, wmap, db_rounded),
                   lambda: torch.mm(a.t(), dy2), 2.0 * t * kk * nn + t * nn,
                   nb(a, dy) + 4.0 * (kk * nn + nn), 1 if main else 0)
            del a, dy, dy2

        # attention backward from the saved p (no q k^T, no softmax)
        scale = HD ** -0.5
        for variant, m in (("no_mask", None), ("shift_mask", mask)):
            p = saved[variant]
            outs = at.window_attn_bwd(q, kt, v, bias, m, do, scale=scale, p=p)
            errs = cmp_all(f"window_attn_bwd[bf16 {variant} saved_p T={t}]", outs,
                           at._torch_attention_bwd(q, kt, v, bias, m, do, scale, p))
            full = (bias[None] if m is None else
                    (bias[None] + m[:, None]).repeat(b_ // m.shape[0], 1, 1, 1)).expand(
                        b_, NH, N, N).to(bf)
            ql, kl, vl = (u.detach().clone().requires_grad_() for u in (q, kt, v))
            out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=full, scale=scale)
            record("window_attn_bwd", f"{variant} saved_p T={t}", errs,
                   lambda: at.window_attn_bwd(q, kt, v, bias, m, do, scale=scale, p=p),
                   lambda: at._torch_attention_bwd(q, kt, v, bias, m, do, scale, p),
                   lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True),
                   8.0 * b_ * NH * N * N * HD, nb(q, kt, v, do, p, *outs), 1 if main else 0)
            del outs, ql, kl, vl, out, full

            # as the bf16 trunk calls it (swin_trunk.py, _block_bwd): q, k, v
            # strided from its (T, 540) qkv buffer, do the transposed (B_, N,
            # nh, hd) datt, dq, dk, dv into a second (T, 540) buffer, p the
            # forward's save from the same views
            qkv = rnd(b_, N, 3, NH, HD)
            qkv[:, :, 0] *= HD ** -0.5
            datt = rnd(b_, N, NH, HD, s=0.1)
            dov = datt.transpose(1, 2)
            dqkv = torch.empty_like(qkv)
            views = tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))
            tp = torch.empty(b_, NH, N, N, device=dev, dtype=bf)
            at.window_attn_fwd(*views, bias, m, scale=scale, p_out=tp)

            def trunk(m=m, views=views, dov=dov, dqkv=dqkv, tp=tp):
                return at.window_attn_bwd(*views, bias, m, dov, scale=scale, p=tp,
                                          out=tuple(dqkv[:, :, i].transpose(1, 2)
                                                    for i in range(3)))

            outs = trunk()
            errs = cmp_all(f"window_attn_bwd[bf16 {variant} saved_p trunk_views T={t}]", outs,
                           at._torch_attention_bwd(*views, bias, m, dov, scale, tp))
            # the forward's p is the backward's recompute of it: dv from the
            # recompute form equals dv from the forward's p_out, bit for bit
            dv_recompute = at.window_attn_bwd(*views, bias, m, dov, scale=scale)[2]
            torch.cuda.synchronize()
            same = torch.equal(outs[2], dv_recompute)
            print(f"  window_attn_bwd[bf16 {variant} trunk_views T={t}] dv, recompute form "
                  f"against the forward's p_out: bit for bit {same} (max |d| "
                  f"{float((outs[2].float() - dv_recompute.float()).abs().max()):.3e}) -> "
                  f"{'ok' if same else 'FAIL'}")
            if not same:
                fail("the bf16 forward's p differs from the backward's recompute of it")
            del dv_recompute
            record("window_attn_bwd", f"{variant} saved_p trunk_views T={t}", errs, trunk,
                   lambda m=m, views=views, dov=dov, tp=tp: at._torch_attention_bwd(
                       *views, bias, m, dov, scale, tp),
                   None, 8.0 * b_ * NH * N * N * HD, nb(q, kt, v, do, tp) + 3 * nb(q), 0)
            del qkv, datt, dov, dqkv, views, tp, outs
        del q, kt, v, do, saved

        # LayerNorm backward: LN2 (f32 dz + bf16 block gradient -> f32 dx2),
        # LN1 (window scatter, bf16 da + f32 dx2 -> bf16 dx)
        for variant, x, wmap, dz_dtype, res_dtype, out_dtype in (
                ("ln2", x4.view(t, C), None, f32, bf, f32),
                ("ln1_window", x4, wm, bf, f32, bf)):
            dz, dres = rnd(t, C, dtype=dz_dtype), rnd(*x.shape, dtype=res_dtype)
            outs = st.ln_rows_bwd(x, gamma, dz, window=wmap, dres=dres, out_dtype=out_dtype)
            errs = cmp_all(f"ln_rows_bwd[bf16 {variant} T={t}]", outs,
                           st._torch_ln_rows_bwd(x, gamma, dz, wmap, dres, out_dtype), (1e-3, 1e-4))
            x2d, gb, dzb = x4.view(t, C), gamma.to(bf), dz.to(bf)
            _, mean, rstd = torch.ops.aten.native_layer_norm(x2d, [C], gb, None, 1e-5)

            def call(x=x, dz=dz, wmap=wmap, dres=dres, out_dtype=out_dtype):
                return st.ln_rows_bwd(x, gamma, dz, window=wmap, dres=dres, out_dtype=out_dtype)

            record("ln_rows_bwd", f"{variant} T={t}", errs, call,
                   lambda: st._torch_ln_rows_bwd(x, gamma, dz, wmap, dres, out_dtype),
                   lambda: torch.ops.aten.native_layer_norm_backward(
                       dzb, x2d, [C], mean, rstd, gb, None, [True, True, False]),
                   12.0 * t * C, nb(x, dz, dres, outs[0], gamma) + 8.0 * C, 1 if main else 0)
            if timed:  # the call's device time apart: the LN kernel, and the dgamma/dbeta sums
                r = rows["ln_rows_bwd"][-1]
                split = device_ms_by_name(call)
                r["kernel_ms"] = sum(ms for k, ms in split.items() if "ln_rows_bwd" in k
                                     and "ln_rows_bwd_sum" not in k)
                r["sums_ms"] = sum(ms for k, ms in split.items() if "reduce_kernel" in k
                                   or "ln_rows_bwd_sum" in k)
                print(f"    ln_rows_bwd[bf16 {variant} T={t}] apart: LN kernel {r['kernel_ms']:.4f} "
                      f"ms, dgamma/dbeta sums {r['sums_ms']:.4f} ms (profiler, per call), "
                      f"the wrapper queued {r['queued_ms']:.4f} ms; by name {json.dumps(split)}")
            del dz, dres, outs
    ticket = ln_bwd_ticket()
    print(f"  ln_rows_bwd[bf16] completion ticket after every call: {ticket} -> "
          f"{'ok' if ticket in (0, None) else 'FAIL'}")
    if ticket not in (0, None):
        fail("the bf16 LN backward's ticket is not back at 0")
    return rows


def ln_bwd_config(built) -> str:
    """The bf16 LN backward's build switches in the library ``built``, and
    the blocks per SM of its occupancy in the bf16 step's two forms (C = 180)."""
    import torch

    if not hasattr(built.lib, "sei_ln_rows_bwd_bf16_config"):
        return "not in this library (an earlier tree's)"
    cfg = [built.lib.sei_ln_rows_bwd_bf16_config(i) for i in range(5)]
    per_sm = [built.lib.sei_ln_rows_bwd_bf16_blocks_per_sm(torch.cuda.current_device(), *f, C)
              for f in ((0, 1, 0), (1, 0, 1))]
    return (f"{cfg[0]} lanes per row ({32 // cfg[0]} rows per warp), a cp.async ring of up to "
            f"{cfg[1]} stages per warp, {cfg[2]} warps per block, registers capped for {cfg[3]} "
            f"block(s) per SM, "
            f"occupancy {per_sm[0]} (LN2) / {per_sm[1]} (LN1) blocks per SM, partials summed by "
            + ("the last block" if cfg[4] else "a second kernel"))


def ln_bwd_ticket():
    """The bf16 LN backward's completion ticket on the current device (0
    between calls); None for a library without one (an earlier tree's, when
    this script measures it)."""
    import ctypes

    import torch

    from sei_tpu_torch.ops import _build

    lib = _build.library().lib
    if not hasattr(lib, "sei_ln_rows_bwd_bf16_ticket"):
        return None
    value = ctypes.c_uint(1)
    code = lib.sei_ln_rows_bwd_bf16_ticket(torch.cuda.current_device(), ctypes.addressof(value))
    _build.check(code, "sei_ln_rows_bwd_bf16_ticket")
    return value.value


def device_ms_by_name(fn, iters: int = 20) -> dict:
    """Device ms per call of ``fn`` by kernel name (torch.profiler over
    ``iters`` calls after one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / 1e3 / iters for e in device_events(prof)}


def digest(tensors) -> str:
    """The first 16 hex digits of the SHA-256 of ``tensors``' bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy())
    return h.hexdigest()[:16]


def attention_bits() -> None:
    """SHA-256 of the attention backward's outputs (dq, dk, dv, dbias) and
    of the f32 forward's on seeded inputs as the trunk lays them out, at T =
    36864, f32 and bf16, both masks, both forms (p recomputed; p saved, the
    plain version's); the same lines from two trees in one run say whether
    those outputs moved by a bit."""
    import torch

    from sei_tpu_torch.models.swinir import shift_attn_mask
    from sei_tpu_torch.ops import attention as at

    g = torch.Generator(device="cuda").manual_seed(15)
    b_, scale = TRAIN_GRAPHS[0] * CROP * CROP // N, HD ** -0.5
    mask = torch.from_numpy(shift_attn_mask(CROP, CROP, WS, WS // 2)).cuda()
    bias = torch.randn((NH, N, N), generator=g, device="cuda") * 0.1
    qkv = torch.randn((b_, N, 3, NH, HD), generator=g, device="cuda")
    do = (torch.randn((b_, N, NH, HD), generator=g, device="cuda") * 0.1).transpose(1, 2)

    for dtype in (torch.float32, torch.bfloat16):
        buf = qkv.to(dtype)
        q, k, v = (buf[:, :, i].transpose(1, 2) for i in range(3))
        dd = do.to(dtype)
        for variant, m in (("no_mask", None), ("shift_mask", mask)):
            p = at._probs(q, k, bias, m, scale).to(dtype)
            for form, pp in (("recompute", None), ("saved_p", p)):
                print(f"bits: window_attn_bwd[{dtype} {variant} {form}] "
                      + digest(at.window_attn_bwd(q, k, v, bias, m, dd, scale=scale, p=pp)))
            if dtype == torch.float32:
                print(f"bits: window_attn_fwd[{dtype} {variant}] "
                      + digest([at.window_attn_fwd(q, k, v, bias, m, scale=scale)]))


def ln_bwd_bits() -> None:
    """SHA-256 of ln_rows_bwd's outputs (dx, dgamma, dbeta) on seeded inputs
    at the 2B graph's shape (T = 36864), f32 and bf16, in the trunk's two
    forms and dtypes: LN2 (rows in pixel order, the residual gradient added)
    and LN1 (the shifted window map, the residual gradient added)."""
    import torch

    from sei_tpu_torch.ops import swin_trunk as st

    g = torch.Generator(device="cuda").manual_seed(16)
    b = TRAIN_GRAPHS[0]
    t = b * CROP * CROP
    wm = st.WindowMap(CROP, CROP, WS, WS // 2)
    x = torch.randn((b, CROP, CROP, C), generator=g, device="cuda") + 0.5
    gamma = 1.0 + 0.1 * torch.randn(C, generator=g, device="cuda")
    dz = torch.randn((t, C), generator=g, device="cuda")
    dres = torch.randn((b, CROP, CROP, C), generator=g, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        xd, low = x.to(dtype), (lambda u: u.to(dtype))
        for form, args in (("ln2", (xd.view(t, C), gamma, dz, None, low(dres).view(t, C),
                                    torch.float32)),
                           ("ln1_window", (xd, gamma, low(dz), wm, dres, dtype))):
            xx, gg, zz, wmap, rr, out_dtype = args
            print(f"bits: ln_rows_bwd[{dtype} {form}] " + digest(
                st.ln_rows_bwd(xx, gg, zz, window=wmap, dres=rr, out_dtype=out_dtype)))


def gelu_bits() -> None:
    """SHA-256 of the GELU epilogues' outputs (out, and gp for "gelu_pair")
    on seeded inputs at the 2B graph's fc1 shape (T = 36864, K 180, N 360),
    f32 and bf16 (gp in bf16 and in f32), in each dtype's default form (the
    call without ``fast_gelu``: comparable with a port that has no knob) and
    in the other form (``SEI_FAST_GELU``; "not in this port" without it)."""
    import inspect

    import torch

    from sei_tpu_torch.ops import swin_trunk as st

    g = torch.Generator(device="cuda").manual_seed(18)
    t = TRAIN_GRAPHS[0] * CROP * CROP
    a = torch.randn((t, C), generator=g, device="cuda")
    w = torch.randn((C, CH), generator=g, device="cuda") * 0.05
    b = torch.randn(CH, generator=g, device="cuda") * 0.05
    knob = "fast_gelu" in inspect.signature(st.gemm_bias_epilogue).parameters
    for dtype in (torch.float32, torch.bfloat16):
        gps = (None, torch.float32) if dtype == torch.float32 else (None, torch.bfloat16,
                                                                    torch.float32)
        for gp_dtype in gps:
            epi = "gelu" if gp_dtype is None else "gelu_pair"
            tag = f"{dtype} {epi}" + ("" if gp_dtype is None else f" gp {gp_dtype}")
            for form, kw in (("default form", {}), ("other form", {"fast_gelu": dtype == torch.float32})):
                if kw and not knob:
                    print(f"bits: gemm_bias_epilogue[{tag} {form}] not in this port")
                    continue
                gp = None if gp_dtype is None else torch.empty(t, CH, device="cuda", dtype=gp_dtype)
                out = st.gemm_bias_epilogue(a.to(dtype), w.to(dtype), b, epi, gp=gp, **kw)
                print(f"bits: gemm_bias_epilogue[{tag} {form}] "
                      + digest([out] + ([gp] if gp is not None else [])))


def check_probe_kernels(timed: bool) -> dict:
    """K8 (``copy_probe``) at each block count and K9 (``trunk_skeleton``)
    in each variant against their plain versions at the probes' shape,
    exactly (an f32 add and one rounding per stored value), in bf16 (the
    probes' type) and f32; bounds by bytes (no operation counts against
    them); times queued (``queued_ms``): a call is shorter than its launch;
    returns one row per variant, as the other checks do."""
    import torch

    from sei_tpu_torch.models.swinir import shift_attn_mask
    from sei_tpu_torch.ops import launch_probe as lp
    from sei_tpu_torch.ops import swin_trunk as st

    g = torch.Generator(device="cuda").manual_seed(3)
    b, h, w, c = PROBE_SHAPE
    d = PROBE_DEPTH
    rows = {}

    def exact(name, got, want):
        torch.cuda.synchronize()
        for a, b_ in zip(got, want):
            if a.dtype != b_.dtype or not torch.equal(a, b_):
                fail(f"{name} differs from its plain version")
        print(f"  {name}: equal to its plain version")

    def record(kernel, variant, fn_k, fn_p, fn_lib, nbytes):
        b_ms, b_by = bound_ms(0.0, nbytes)
        r = {"variant": variant, "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
             "flops": 0.0, "bytes": nbytes, "per_block": 0}
        if timed:
            r["ms"] = queued_ms(fn_k)
            r["plain_ms"] = queued_ms(fn_p)
            r["library_ms"] = queued_ms(fn_lib) if fn_lib is not None else None
            lib = "None" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"    {kernel}[{variant}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {lib} ms, bound {b_ms:.4f} ms ({b_by}), {nbytes / 1e6:.1f} MB")
        rows.setdefault(kernel, []).append(r)

    params = {k: torch.randn((d, c), generator=g, device="cuda") * 0.02 for k in st.PARAM_LEAVES}
    rpb = torch.randn((d, NH, N, N), generator=g, device="cuda") * 0.02
    mask = torch.from_numpy(shift_attn_mask(h, w, WS, WS // 2)).cuda()
    dpm = (torch.rand((d, 2, b), generator=g, device="cuda") < 0.9).float() / 0.9
    print(f"probe kernel checks: x {PROBE_SHAPE}, D={d} (exact: |d| = 0)")
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        x = (torch.randn(PROBE_SHAPE, generator=g, device="cuda") * 8).to(dtype)
        size = float(x.numel() * x.element_size())
        for blocks in PROBE_BLOCKS:
            for add in (True, False):
                exact(f"copy_probe[{dt} {blocks} blocks add={add}]",
                      [lp.copy_probe(x, blocks=blocks, add=add)], [lp._torch_copy_probe(x, add)])
            record("copy_probe", f"{dt} {blocks} blocks", lambda: lp.copy_probe(x, blocks=blocks),
                   lambda: lp._torch_copy_probe(x), lambda: torch.add(x, 1.0), 2.0 * size)
        # the scalar head and tail: x at an odd element offset, a ragged count
        xo = x.view(-1)[3:x.numel() - 2]
        for blocks in (1, 1056):
            exact(f"copy_probe[{dt} {blocks} blocks, x at element offset 3, {xo.numel()} "
                  f"elements]", [lp.copy_probe(xo, blocks=blocks)], [lp._torch_copy_probe(xo)])
        for tag, flags, outs in (("v_e", None, 0), ("v_a", {}, 0), ("v_b", {"outputs": True}, 2),
                                 ("v_d", {"outputs": True, "body": True}, 2),
                                 ("v_g", {"outputs": True, "body": True, "dpm_reads": True}, 2)):
            if flags is None:
                def run():
                    return lp.trunk_skeleton(x)

                def plain():
                    return lp._torch_trunk_skeleton(x, None, 0, False, False, False)
            else:
                def run(flags=flags):
                    return lp.trunk_skeleton(x, params, rpb, mask, dpm, **flags)

                def plain(flags=flags):
                    return lp._torch_trunk_skeleton(x, dpm, d, flags.get("outputs", False),
                                                    flags.get("body", False),
                                                    flags.get("dpm_reads", False))
            got = run()
            got = got if isinstance(got, tuple) else (got,)
            want = [t for t in plain() if t is not None]
            exact(f"trunk_skeleton[{dt} {tag}]", got, want)
            record("trunk_skeleton", f"{dt} {tag}", run, plain, None,
                   (2.0 + outs * d) * size + (dpm.numel() * 4.0 if tag == "v_g" else 0.0))
        del x
    return rows


def probe_phase() -> dict:
    """The probes' own path (``sei_tpu_torch.probes``): K8 and K9 chains,
    eager and captured, and the real trunk as the control; returns the K8/K9
    launch counts over it and the measurements."""
    from sei_tpu_torch import probes
    from sei_tpu_torch.ops import launch_probe as lp

    lp.reset_launch_counts()
    out = {"copy": probes.copy_probes(), "skeleton": probes.skeleton_probes()}
    counts = lp.launch_counts()
    out["trunk"] = probes.trunk_control()
    print(f"  probe launch counts {counts}")
    for name, n in counts.items():
        if n == 0:
            fail(f"{name} was not launched on the probe path")
    return counts


def make_images(n: int, h: int, w: int, seed: int):
    """Dead-leaves-like test images: coloured discs over a flat background."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    images = []
    for _ in range(n):
        img = np.empty((3, h, w), np.float32)
        img[:] = rng.random((3, 1, 1))
        for _ in range(80):
            cy, cx, r = rng.random() * h, rng.random() * w, rng.uniform(4, 48)
            img[:, (yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.random((3, 1))
        images.append(img)
    return images


def device_events(prof) -> list:
    """The profile's device activity by name: kernels, copies and fills, but
    not the GPU ranges of user annotations (``Optimizer.step#Adam.step``),
    which span kernels that are counted already."""
    import torch

    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_forward(model, y) -> None:
    """Device time by kernel over one forward (torch.profiler / CUPTI), and
    the device's busy share: kernel time over the host-clock wall time of an
    unprofiled forward."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model(y)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad(), profile(activities=acts, acc_events=True) as prof:
        model(y)
        torch.cuda.synchronize()
    events = device_events(prof)
    total = sum(e.self_device_time_total for e in events) / 1e3
    if total <= 0.0:
        fail("profiler recorded no device time")
    print(f"  profile: one forward {wall_ms:.2f} ms wall (unprofiled), {total:.2f} ms of "
          f"device kernels (busy share {total / wall_ms:.3f})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


# the port's kernels, by the names of their CUDA functions
PORT_KERNELS = ("ln_rows", "gemm_bias_epilogue", "window_attn_fwd", "gemm_dgrad", "gemm_wgrad",
                "window_attn_bwd", "ln_rows_bwd")


# a port kernel's CUDA function name, ``<kernel>_<form>kernel``: the form's
# label in a profile split
KERNEL_FORMS = {"": "", "f32_": "", "mma_": "[mma]", "vec_": "[vec]", "sum_": "[sum]"}
# the kernels whose wrappers sum their partials with two torch reductions
# (name fragment -> wrapper): every weight grad, and the f32 LN backward
REDUCE_CALLERS = {"gemm_wgrad_": "gemm_wgrad", "ln_rows_bwd_kernel": "ln_rows_bwd"}


def kernel_split(events) -> dict:
    """Device ms of a profile by kernel: each of the port's kernels (its
    tensor-core version as ``name[mma]``, the bf16 LN backward's as
    ``ln_rows_bwd[vec]`` and its partials' sum kernel as ``ln_rows_bwd[sum]``;
    ``name_f32_kernel`` counts as ``name``), then the rest (cuDNN, cuFFT,
    cuBLAS, PyTorch's reductions and elementwise kernels) as ``other_ms``
    with its five largest entries by name."""
    split, other = {}, {}
    for e in events:
        ms = e.self_device_time_total / 1e3
        name = next((k + label for k in PORT_KERNELS for v, label in KERNEL_FORMS.items()
                     if f"{k}_{v}kernel" in e.key), None)
        if name is None:
            other[e.key[:80]] = other.get(e.key[:80], 0.0) + ms
        else:
            split[name] = split.get(name, 0.0) + ms
    split = dict(sorted(split.items(), key=lambda kv: -kv[1]))
    split["other_ms"] = sum(other.values())
    split["other_largest"] = dict(sorted(other.items(), key=lambda kv: -kv[1])[:5])
    return split


def reduce_callers(events) -> dict:
    """The profile's ``at::native::reduce_kernel`` launches by the port
    wrapper that made them: the two that follow a kernel named in
    ``REDUCE_CALLERS`` on the device (its wrapper's two torch sums of the
    kernel's partials), ``other`` for the rest; launches and device ms."""
    out, owner, left = {}, None, 0
    for e in sorted(events, key=lambda e: e.time_range.start):
        if "reduce_kernel" in e.name:
            r = out.setdefault(owner if left > 0 else "other", {"launches": 0, "ms": 0.0})
            r["launches"] += 1
            r["ms"] += (e.time_range.end - e.time_range.start) / 1e3
            left -= 1
        else:
            owner = next((w for k, w in REDUCE_CALLERS.items() if k in e.name), None)
            left = 2 if owner else 0
    return out


def profile_step(step_fn, label: str) -> tuple[float, float]:
    """Device time by kernel over one call of ``step_fn`` (torch.profiler /
    CUPTI), and the device's busy share: kernel time over the host-clock
    wall time of an unprofiled call; PyTorch's ``reduce_kernel`` launches by
    the port wrapper that made them.  Returns (wall ms, device ms); where
    the profiler sees no kernel (a graph replay it cannot trace), the device
    span of one call by CUDA events stands in."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True) as prof:
        step_fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    total = sum(e.self_device_time_total for e in events) / 1e3
    if total <= 0.0:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step_fn()
        end.record()
        end.synchronize()
        total = start.elapsed_time(end)
        print(f"  profile: {label} {wall_ms:.2f} ms wall (unprofiled); the profiler saw no "
              f"kernel; CUDA events: {total:.2f} ms device span (busy share "
              f"{total / wall_ms:.3f})")
        return wall_ms, total
    print(f"  profile: {label} {wall_ms:.2f} ms wall (unprofiled), {total:.2f} ms of "
          f"device kernels (busy share {total / wall_ms:.3f})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:16]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    print(f"  device ms by kernel, {label}: {json.dumps(kernel_split(events))}")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    print(f"  reduce_kernel by caller, {label}: {json.dumps(reduce_callers(kernels))}")
    return wall_ms, total


def timed_dispatches(trainer, n: int = TIMED_DISPATCHES) -> float:
    """Steady ms per training step: the host clock over ``n`` dispatches
    issued back to back, ending in one synchronize."""
    import torch

    trainer.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        trainer.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (n * trainer.scan_steps)


def train_state(trainer) -> list:
    """Copies of what a step updates: params, Adam state, step counter."""
    opt = [v for s_ in trainer.opt.state.values() for v in s_.values()]
    return [t.detach().clone() for t in (*trainer.model.module.parameters(), *opt,
                                         trainer.step_t)]


def proposed_draws(trainer, physics, seed: int):
    """One step's batch and explicit loss draws (crop offsets, SURE probe,
    scaling parameters) from ``seed``, as the gradient and loss checks feed
    both sides of a comparison."""
    import torch

    from sei_tpu_torch.losses import LossDraws, compute_sure_margin, sample_probe
    from sei_tpu_torch.transforms import ScalingTransform, crop_offsets, crop_pair_batch

    x, y = trainer.batch(0)
    g = torch.Generator(device="cuda").manual_seed(seed)
    offsets = crop_offsets(torch.Generator().manual_seed(seed), [DATA_CROP] * BATCH,
                           [DATA_CROP] * BATCH, CROP)
    _, y_crop = crop_pair_batch(x, y, size=CROP, offsets=offsets)
    rates, _, centers = ScalingTransform().sample_params(g, BATCH)
    margin = compute_sure_margin(partial_sure=True, sure_margin=None, task="deblurring",
                                 kernel_shape=tuple(physics.kernel.shape))
    draws = LossDraws(crop=offsets, probe=sample_probe(g, y_crop, margin), rates=rates,
                      centers=centers)
    return x, y, draws


def task_physics(task: str, factor: int = SR_FACTOR, **kw):
    """The cells' physics: deblurring Gaussian_R2 (``kw``: ``physics_v2``), SR
    by ``factor`` or the CT-like filter, noise 5."""
    from sei_tpu_torch.physics import get_physics

    if task == "sr":
        return get_physics(task="sr", sr_factor=factor, noise_level=5)
    if task == CT:
        return get_physics(task=CT, noise_level=5)
    return get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, **kw)


def task_model(task: str, dtype=None, factor: int = SR_FACTOR, fused_trunk: bool = True):
    """The flagship SwinIR for ``task`` (SR: the pixelshuffle head by
    ``factor``), weights from seed 0; ``fused_trunk=False``: the module
    path."""
    from sei_tpu_torch.models import get_model

    return get_model(kind="Proposed", architecture="Transformer", task=task,
                     sr_factor=factor if task == "sr" else None, seed=0, dtype=dtype,
                     fused_trunk=fused_trunk)


@dataclasses.dataclass
class Recipe:
    """One training cell: its label, task and compute dtype (None: f32), the
    ``get_loss`` and ``Trainer`` keywords beyond the common ones, the trunk
    graphs one step runs (2: a 2B and a B forward, as ``proposed``; 1: one B
    forward, as ``supervised``), the normal kind's rates (one loss each),
    fine-tuning's folder of measurement PNGs (its cache one 256 px crop of
    each) and trainable mask, whether one step's gradients are held against
    the plain path (and to what bound), SwinIR's path (``fused_trunk``), the
    kernels' launches per block and graph where they are not the trunk's,
    and the epochs of 2 steps."""

    label: str
    task: str = "deblurring"
    dtype: object = None
    loss: dict = dataclasses.field(default_factory=lambda: {"method": "proposed"})
    trainer: dict = dataclasses.field(default_factory=dict)
    graphs: int = len(TRAIN_GRAPHS)
    normal_rates: tuple = ()
    folder: Optional[str] = None
    conv_last_only: bool = False
    grad_check: bool = False
    grad_tol: float = GRAD_RTOL  # the gradient check's bound, of each tensor's max
    fused_trunk: Optional[bool] = None  # False: SwinIR's module path
    per_block: Optional[dict] = None  # launches per block and graph; None: the trunk's
    epochs: int = TRAIN_EPOCHS


def default_recipe(dtype, sure_alternative, task: str) -> Recipe:
    """``proposed`` (SURE, or R2R-EI with ``sure_alternative="r2r"``)."""
    return Recipe(run_label(dtype, sure_alternative, task), task=task, dtype=dtype,
                  loss={"method": "proposed", "sure_alternative": sure_alternative},
                  grad_check=dtype is None and sure_alternative is None and task == "deblurring")


def training_setup(recipe: Recipe):
    """The training cell's model, physics, device cache, loss and dataset
    crop (y side: deblurring and the CT-like task 256 px dataset crops then
    the loss's 48, SR the loss's 48 directly), and its Trainer keywords."""
    import numpy as np

    from sei_tpu_torch.data import build_device_cache, build_finetuning_cache
    from sei_tpu_torch.losses import get_loss
    from sei_tpu_torch.train.optim import trainable_mask

    model = task_model(recipe.task, recipe.dtype,
                       fused_trunk=recipe.fused_trunk is not False)
    physics = task_physics(recipe.task)
    if recipe.folder is None:
        cache = build_device_cache(make_images(TRAIN_IMAGES, H, W, seed=1), physics, seed=0)
    else:
        cache = build_finetuning_cache(recipe.folder, DATA_CROP, np.random.default_rng(0))
    kw = dict(recipe.trainer)
    if recipe.normal_rates:
        kw["normal_rate_losses"] = [
            get_loss(physics=physics, crop_size=CROP, scaling_kind="normal",
                     fixed_normal_rate=r, **recipe.loss) for r in recipe.normal_rates]
        loss_fn = kw["normal_rate_losses"][0]
    else:
        loss_fn = get_loss(physics=physics, crop_size=CROP, **recipe.loss)
    if recipe.conv_last_only:
        kw["trainable_mask"] = trainable_mask(model.module)
    return model, physics, cache, loss_fn, CROP if recipe.task == "sr" else DATA_CROP, kw


def run_label(dtype, sure_alternative, task: str) -> str:
    return (("bf16" if dtype is not None else "f32") + (" r2r" if sure_alternative else "")
            + TASK_LABELS[task])


def train_path(dtype=None, sure_alternative=None, task: str = "deblurring",
               recipe: Optional[Recipe] = None) -> tuple[dict, object, dict]:
    """The training path on the card, eagerly (one launch at a time,
    ``capture=False``): ``proposed`` with SwinIR's compute dtype ``dtype``
    (None: f32; bfloat16: the JAX package's training recipe) and SURE or,
    with ``sure_alternative="r2r"``, R2R-EI, or the cell ``recipe``; returns
    the kernels' launch counts over the run, the trainer, and the run's
    per-step losses, final state and timings (what the captured runs are
    held against).  One step's gradients are held against the plain path
    for f32 SURE deblurring.  ``task="sr"``: the SR x2 SwinIR on the SR
    measurements."""
    import numpy as np
    import torch

    from sei_tpu_torch.losses import weights_distance_loss
    from sei_tpu_torch.ops import swin_trunk as st
    from sei_tpu_torch.train import Trainer

    recipe = recipe or default_recipe(dtype, sure_alternative, task)
    dtype, label = recipe.dtype, recipe.label
    per_block = recipe.per_block or (PER_BLOCK_TRAIN_BF16 if dtype is not None
                                     else PER_BLOCK_TRAIN)
    loss_args = ", ".join(f"{k}={v!r}" for k, v in recipe.loss.items() if v is not None)
    cache_fn = "build_device_cache" if recipe.folder is None else "build_finetuning_cache"
    print(f"training path ({label}): {cache_fn} -> get_loss({loss_args}) -> Trainer "
          f"({TRAIN_IMAGES} images {H}x{W}, flagship SwinIR, compute dtype "
          f"{'bf16' if dtype is not None else 'f32'}, "
          f"{'module path' if recipe.fused_trunk is False else 'fused trunk'}, batch {BATCH}, "
          f"{CROP} px crops, {recipe.epochs} epochs{''.join(f', {k}={v!r}' for k, v in recipe.trainer.items())}"
          f"{f', normal kind at rates {recipe.normal_rates}' if recipe.normal_rates else ''}"
          f"{', conv_last only' if recipe.conv_last_only else ''})")
    t0 = time.perf_counter()
    model, physics, cache, loss_fn, data_crop, kw = training_setup(recipe)
    trainer = Trainer(model, loss_fn, physics, cache, batch_size=BATCH, epochs=recipe.epochs,
                      crop_size=data_crop, seed=0, capture=False, **kw)
    torch.cuda.synchronize()
    print(f"  set-up {time.perf_counter() - t0:.2f} s; {trainer.steps_per_epoch} steps/epoch")
    before = {k: v.clone() for k, v in model.module.state_dict().items()}

    times, losses = [], []
    last = [time.perf_counter()]

    def on_step(step, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append((now - last[0]) * 1e3)
        losses.append(float(loss))
        last[0] = now
        print(f"  step {step}: loss {losses[-1]!r}, {times[-1]:.2f} ms")

    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    st.reset_launch_counts()
    stats = trainer.train(on_step=on_step, log_every_epoch=False)
    counts = st.launch_counts()
    gelu_counts = st.gelu_launch_counts()
    print(f"  launch counts {counts}; GELU epilogues by form {gelu_counts}")
    steps = stats["steps"]
    for name, per in per_block.items():
        want = per * BLOCKS * recipe.graphs * steps
        if counts[name] != want:  # 0 included: every kernel must run on this path
            fail(f"{label} {name}: {counts[name]} launches over {steps} training steps, "
                 f"expected {want}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite {label} training loss: {losses}")
    after = model.module.state_dict()
    moved = sum(not torch.equal(before[k], after[k]) for k in before)
    mask = kw.get("trainable_mask")
    if mask is None and moved != len(before):
        fail(f"{label}: only {moved} of {len(before)} parameter tensors changed")
    if mask is not None:
        frozen = [k for k in mask if not mask[k]]
        changed = [k for k in frozen if not torch.equal(before[k], after[k])]
        trained = [k for k in mask if mask[k] and not torch.equal(before[k], after[k])]
        distance = float(weights_distance_loss([after[k] for k in mask], [before[k] for k in mask]))
        print(f"  trainable mask: {len(trained)} of {sum(mask.values())} trained tensors moved "
              f"({', '.join(trained)}); frozen tensors changed: {len(changed)} of {len(frozen)}; "
              f"weights-distance term after the run {distance!r}")
        if changed or len(trained) != sum(mask.values()):
            fail(f"{label}: the mask let frozen tensors move ({changed}) or held trained ones")
    if recipe.normal_rates:
        rng = np.random.default_rng(0)
        order = [int(rng.integers(len(recipe.normal_rates))) for _ in trainer.variants]
        print(f"  normal-kind variants by dispatch {trainer.variants} (rates "
              f"{list(recipe.normal_rates)}); the JAX trainer's order {order}")
        if trainer.variants != order or len(set(order)) != len(recipe.normal_rates):
            fail(f"{label}: the variant order is not the JAX trainer's, or a variant never ran")
    f32_state = all(t.dtype == torch.float32 for t in after.values()) and all(
        v.dtype == torch.float32 for s_ in trainer.opt.state.values() for v in s_.values()
        if torch.is_tensor(v) and v.dim())
    if not f32_state:
        fail(f"{label}: parameters or Adam state left f32")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    print(f"  {steps} steps in {stats['wall_time_s']:.2f} s ({stats['images_per_sec']:.3f} img/s "
          f"over the run, first step included); steady step {steady:.2f} ms "
          f"(median of steps 1..{steps - 1}) = {BATCH * 1e3 / steady:.3f} img/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({base_gib:.3f} "
          f"allocated before the run); "
          f"{moved} of {len(before)} parameter tensors moved; params and Adam state f32; "
          f"epoch losses {stats['epoch_losses']}")
    clip_check(trainer, label)
    eager = {"losses": losses, "state": train_state(trainer), "base_gib": base_gib,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "variants": list(trainer.variants), "gelu_launches": gelu_counts}
    eager["steady_ms"] = timed_dispatches(trainer)
    print(f"  eager steady step {eager['steady_ms']:.2f} ms ({TIMED_DISPATCHES} dispatches "
          f"back to back, one sync)")

    if recipe.grad_check:
        # one step's gradients: kernel path against the plain path, same draws
        x, y, draws = proposed_draws(trainer, physics, 7)
        grads = {}
        model.module.train()
        for plain in (False, True):
            drop = torch.Generator(device="cuda").manual_seed(11)
            model.module.zero_grad(set_to_none=True)
            loss = loss_fn(x, y, lambda im: model.module(im, plain=plain, generator=drop), None,
                           draws)
            loss.backward()
            grads[plain] = (float(loss.detach()),
                            {n: p.grad.clone() for n, p in model.module.named_parameters()})
        worst = max(((grads[False][1][n] - gp).abs().max() / gp.abs().max().clamp_min(1e-30)).item()
                    for n, gp in grads[True][1].items())
        print(f"  one step, kernel path vs plain path: loss {grads[False][0]!r} vs {grads[True][0]!r}; "
              f"worst max|diff|/max|plain grad| over {len(grads[True][1])} tensors {worst:.3e} "
              f"(tolerance {recipe.grad_tol:g})")
        if not worst <= recipe.grad_tol:
            fail("kernel-path gradients disagree with the plain path")
        del grads
    model.module.zero_grad(set_to_none=True)
    eager["wall_ms"], eager["device_ms"] = profile_step(trainer.step, f"one {label} training step")
    return counts, trainer, eager


def captured_train(dtype, scan_steps: int, eager: dict, sure_alternative=None,
                   task: str = "deblurring", recipe: Optional[Recipe] = None,
                   record: Optional[dict] = None) -> tuple[dict, float]:
    """The training path as ``Trainer`` runs it by default on CUDA: one CUDA
    graph per dispatch of ``scan_steps`` steps (one per normal-kind variant),
    from the eager run's seed-0 weights and streams and for as many steps.
    Each step's loss, the final parameters and optimizer state must equal
    the eager run's bit for bit (the same kernels in the same order on the
    same draws); the trunk kernels captured must be the design's per step.
    Returns the kernels' launch counts over the run (one eager warm-up
    dispatch and the capture per graph: the wrappers count where they
    launch, and a replay calls no wrapper) and the steady ms per step;
    ``record`` takes the cell's timings and memory."""
    import torch

    from sei_tpu_torch.ops import swin_trunk as st
    from sei_tpu_torch.train import Trainer

    recipe = recipe or default_recipe(dtype, sure_alternative, task)
    label = recipe.label
    per_block = recipe.per_block or (PER_BLOCK_TRAIN_BF16 if recipe.dtype is not None
                                     else PER_BLOCK_TRAIN)
    print(f"captured training ({label}, scan_steps {scan_steps}): the same run as one CUDA "
          f"graph per dispatch")
    model, physics, cache, loss_fn, data_crop, kw = training_setup(recipe)
    trainer = Trainer(model, loss_fn, physics, cache, batch_size=BATCH, epochs=recipe.epochs,
                      crop_size=data_crop, seed=0, scan_steps=scan_steps, **kw)
    if not trainer.graphed or trainer.scan_steps != scan_steps:
        fail(f"{label}: Trainer did not take the captured path at scan_steps {scan_steps}")
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st.reset_launch_counts()
    t0 = time.perf_counter()
    stats = trainer.train(log_every_epoch=False, on_step=lambda s_, loss: losses.append(loss))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = st.launch_counts()
    gelu_counts = st.gelu_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    want = {k: v * BLOCKS * recipe.graphs * scan_steps for k, v in per_block.items()}
    graphs = len(trainer.graphs)
    print(f"  {stats['steps']} steps in {trainer.replays} replays of {graphs} graph(s), "
          f"{seconds:.2f} s with the warm-up and the capture; launches captured "
          f"{trainer.capture_launches}; peak memory {peak:.3f} GiB (eager {eager['peak_gib']:.3f})")
    if trainer.replays * scan_steps != stats["steps"]:
        fail(f"{label}: {trainer.replays} replays for {stats['steps']} steps at scan_steps "
             f"{scan_steps}")
    if trainer.capture_launches != want:
        fail(f"{label} scan_steps {scan_steps}: captured launches {trainer.capture_launches}, "
             f"expected {want}")
    if counts != {k: 2 * graphs * v for k, v in want.items()}:
        fail(f"{label}: launches over the warm-up and the capture {counts}, expected "
             f"{2 * graphs} times {want}")
    if recipe.normal_rates and (trainer.variants != eager["variants"]
                                or graphs != len(recipe.normal_rates)):
        fail(f"{label}: variants {trainer.variants} in {graphs} graphs, eager "
             f"{eager['variants']}")
    got = train_state(trainer)
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, eager["state"])]
    unequal = sum(not torch.equal(a, b) for a, b in zip(got, eager["state"]))
    print(f"  losses {losses}; eager {eager['losses']}; state tensors unequal to the eager "
          f"run's: {unequal} of {len(got)} (max |diff| {max(diffs):.3e})")
    if losses != eager["losses"] or unequal or len(got) != len(eager["state"]):
        fail(f"{label} scan_steps {scan_steps}: the captured run differs from the eager run")
    clip_check(trainer, label)
    steady = timed_dispatches(trainer)
    wall, device = profile_step(trainer.step, f"one replayed {label} dispatch "
                                              f"({scan_steps} steps)")
    print(f"  steady step {steady:.2f} ms captured vs {eager['steady_ms']:.2f} ms eager "
          f"({TIMED_DISPATCHES} dispatches back to back); one dispatch {wall / scan_steps:.2f} "
          f"ms wall and {device / scan_steps:.2f} ms device per step (busy "
          f"{device / wall:.3f}) vs eager {eager['wall_ms']:.2f} / {eager['device_ms']:.2f} ms "
          f"(busy {eager['device_ms'] / eager['wall_ms']:.3f})")
    if record is not None:
        record.update({"captured_ms": steady, "replay_device_ms": device / scan_steps,
                       "replay_busy": device / wall, "eager_ms": eager["steady_ms"],
                       "eager_device_ms": eager["device_ms"], "peak_gib": eager["peak_gib"],
                       "allocated_before_gib": eager["base_gib"],
                       "captured_peak_gib": peak, "scan_steps": scan_steps,
                       "gelu_launches": gelu_counts})
    return counts, steady


def r2r_phase(smi: str, proposed_ms: dict) -> None:
    """R2R-EI (``sure_alternative="r2r"``) on the training path: eagerly,
    then captured (f32 at ``scan_steps`` 1, bf16 at 2) and equal to the
    eager run bit for bit, with the design's launches per step (those of
    ``proposed``: the same 2B and B forwards and backward) and finite
    losses; the steady step beside proposed's of this run."""
    import torch

    for dtype, scan_steps in ((None, 1), (torch.bfloat16, 2)):
        label = "bf16" if dtype is not None else "f32"
        _, trainer, eager = train_path(dtype, sure_alternative="r2r")
        del trainer
        _, steady = captured_train(dtype, scan_steps, eager, sure_alternative="r2r")
        print(f"  R2R-EI {label} captured at scan_steps {scan_steps}: {steady:.2f} ms/step = "
              f"{BATCH * 1e3 / steady:.3f} img/s; proposed (SURE) in this run "
              f"{proposed_ms[label, scan_steps]:.2f} ms/step; {smi}")


def bf16_trunk_grads() -> None:
    """The bf16 trunk (saves on: K5 forward, K7 backward) at flagship width
    (C 180, 6 heads, window 8, one RSTB of 6 blocks with the seed-0 model's
    weights) on the 2B graph's shape, MSE loss: every gradient of the kernel
    path against autograd through the plain trunk in bf16."""
    import torch

    from sei_tpu_torch.models import get_model
    from sei_tpu_torch.models.swinir import shift_attn_mask
    from sei_tpu_torch.ops import swin_trunk as st

    b = TRAIN_GRAPHS[0]
    model = get_model(kind="Proposed", architecture="Transformer", task="deblurring", seed=0)
    params, rpb = model.module.layers[0].stacked_params()
    params = {k: v.detach().clone() for k, v in params.items()}
    rpb = rpb.detach().clone()
    del model
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((b, CROP, CROP, C), generator=g, device="cuda").to(torch.bfloat16)
    tgt = torch.randn((b, CROP, CROP, C), generator=g, device="cuda")
    d = params["ln1_s"].shape[0]
    dpm = (torch.rand((d, 2, b), generator=g, device="cuda") < 0.9).float() / 0.9
    mask = torch.from_numpy(shift_attn_mask(CROP, CROP, WS, WS // 2)).cuda()

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, rpb, *params.values())]
        y = fn(leaves[0], dict(zip(params, leaves[2:])), leaves[1], mask, dpm,
               num_heads=NH, window_size=WS)
        loss = ((y.float() - tgt) ** 2).mean()
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    st.reset_launch_counts()
    loss_k, gk = grads(st.swin_trunk)
    if st.launch_counts()["window_attn_bwd"] != d or st.launch_counts()["window_attn_fwd"] != d:
        fail(f"bf16 trunk: launches {st.launch_counts()} are not the saves mode's")
    loss_p, gp = grads(st.trunk_reference)
    names = ["x", "rpb", *params]
    fracs = {n: float((a.float() - p_.float()).abs().max() / p_.float().abs().max().clamp_min(1e-30))
             for n, a, p_ in zip(names, gk, gp)}
    worst = max(fracs, key=fracs.get)
    print(f"bf16 trunk gradients (D={d}, {b} images {CROP}x{CROP}, C={C}, MSE loss), kernel path "
          f"vs plain path: loss {loss_k!r} vs {loss_p!r}; max|diff|/max|plain grad| per tensor "
          + ", ".join(f"{n} {v:.2e}" for n, v in fracs.items())
          + f"; worst {worst} {fracs[worst]:.3e} (tolerance {TRUNK_GRAD_FRAC:g})")
    if not fracs[worst] <= TRUNK_GRAD_FRAC:
        fail("bf16 trunk gradients disagree with the plain path")


def bf16_loss_vs_f32(trainer) -> None:
    """One proposed step's loss with the bf16 model against the f32 model:
    the same seed-0 weights, batch, loss draws and drop-path draws."""
    import torch

    from sei_tpu_torch.models import get_model

    x, y, draws = proposed_draws(trainer, trainer.physics, 9)
    losses = {}
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model = get_model(kind="Proposed", architecture="Transformer", task="deblurring", seed=0,
                          dtype=dtype)
        module = model.module.train()
        drop = torch.Generator(device="cuda").manual_seed(13)
        with torch.no_grad():
            losses[label] = float(trainer.loss_fn(
                x, y, lambda im: module(im, generator=drop), None, draws))
        del model, module
    rel = abs(losses["bf16"] - losses["f32"]) / abs(losses["f32"])
    print(f"one proposed step's loss, bf16 model vs f32 model (same weights and draws): "
          f"{losses['bf16']!r} vs {losses['f32']!r}, relative difference {rel:.3e} "
          f"(tolerance {LOSS_RTOL_BF16:g})")
    if not rel <= LOSS_RTOL_BF16:
        fail("the bf16 step's loss disagrees with the f32 step's")


def main_path() -> dict:
    """The eval path on the card; returns the kernels' launch counts."""
    import numpy as np
    import torch

    from sei_tpu_torch.evaluate import evaluate
    from sei_tpu_torch.metrics import compute_metrics, quantize_and_clamp
    from sei_tpu_torch.models import get_model
    from sei_tpu_torch.ops import swin_trunk as st
    from sei_tpu_torch.physics import get_physics

    print("main path: get_model -> get_physics -> evaluate "
          f"({N_IMAGES} images {H}x{W}, flagship SwinIR, deblurring Gaussian_R2, noise 5)")
    t0 = time.perf_counter()
    model = get_model(kind="Proposed", architecture="Transformer", task="deblurring", seed=0)
    physics = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    images = make_images(N_IMAGES, H, W, seed=0)
    print(f"  set-up {time.perf_counter() - t0:.2f} s; params "
          f"{sum(p.numel() for p in model.module.parameters())}")
    evaluate(model, physics, images[:1])  # warm-up: cuFFT plans, cuDNN choice
    torch.cuda.synchronize()

    st.reset_launch_counts()
    t0 = time.perf_counter()
    result = evaluate(model, physics, images)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = st.launch_counts()
    print(f"  launch counts {counts}")
    for name, per in PER_BLOCK.items():
        want = per * BLOCKS * N_IMAGES
        if counts[name] != want:  # 0 included: the path must launch every kernel
            fail(f"{name}: {counts[name]} launches on the main path, expected {want}")
    for i, (p, s) in enumerate(zip(result.psnr, result.ssim)):
        xq = quantize_and_clamp(torch.as_tensor(images[i], device="cuda"))
        y = physics.randomly_degrade(torch.as_tensor(images[i], device="cuda")[None], i)[0]
        p_in, s_in, _ = compute_metrics(xq, quantize_and_clamp(y))
        print(f"  image {i}: PSNR {p!r} SSIM {s!r} (measurement itself: PSNR {p_in!r} SSIM {s_in!r})")
        if not (np.isfinite(p) and np.isfinite(s) and 0.0 < p < 100.0 and -1.0 <= s <= 1.0):
            fail(f"image {i}: metrics out of range")
    print(f"  mean PSNR {result.psnr_mean!r} SSIM {result.ssim_mean!r}; "
          f"{seconds * 1e3 / N_IMAGES:.2f} ms/image end to end, {N_IMAGES / seconds:.3f} img/s")

    # one full forward: kernel path against the plain path, both on the card
    y = physics.randomly_degrade(torch.as_tensor(images[0], device="cuda")[None], 0)
    with torch.no_grad():
        out_k = model(y)
        out_p = model.module(y, plain=True)
        fwd_ms = time_ms(lambda: model(y), iters=3, warmup=1)
        plain_fwd_ms = time_ms(lambda: model.module(y, plain=True), iters=3, warmup=1)
    compare("full forward (kernels vs plain)", out_k, out_p, FORWARD_ATOL, 0.0)
    print(f"  forward {H}x{W}: kernel path {fwd_ms:.2f} ms, plain path {plain_fwd_ms:.2f} ms")
    profile_forward(model, y)
    return counts


def cli_train_run(folder: str, out: str, dtype, scan_steps: int, smi: str,
                  task: str = "deblurring") -> None:
    """``cli.train.main`` in-process at flagship width and depth (one epoch
    of 2 captured steps); its per-step losses must equal, bit for bit, those
    of a ``Trainer`` built here from the same ``GroundTruthDataset``, seed
    and arguments, and the trunk kernels captured must be the design's per
    step.  ``task="sr"``: SR x2 (48 px crops of the measurement, the SR
    learning rate 2e-4); ``task=CT``: the CT-like filter's measurements."""
    import torch

    from sei_tpu_torch.cli import train as cli_train
    from sei_tpu_torch.data import GroundTruthDataset, build_device_cache
    from sei_tpu_torch.losses import get_loss
    from sei_tpu_torch.ops import swin_trunk as st
    from sei_tpu_torch.train import Trainer

    label = ("bf16" if dtype is not None else "f32") + TASK_LABELS[task]
    per_block = PER_BLOCK_TRAIN_BF16 if dtype is not None else PER_BLOCK_TRAIN
    argv = [*TASK_ARGS[task], "--noise_level", "5",
            "--dataset", f"gt_folder:{folder}", "--method", "proposed", "--batch_size",
            str(BATCH), "--epochs", "1", "--out_dir", out, "--scan_steps", str(scan_steps)]
    argv += ["--bf16"] if dtype is not None else []
    print(f"command line ({label}): python -m sei_tpu_torch.cli.train {' '.join(argv)}")
    st.reset_launch_counts()
    t0 = time.perf_counter()
    run = cli_train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    trainer, counts = run["trainer"], st.launch_counts()
    losses = [float(v) for v in run["losses"]]
    want = {k: v * BLOCKS * len(TRAIN_GRAPHS) * scan_steps for k, v in per_block.items()}
    print(f"  {run['stats']['steps']} steps in {trainer.replays} replays, {seconds:.2f} s with "
          f"the data, the warm-up and the capture; losses {losses}; launches captured "
          f"{trainer.capture_launches}")
    if not trainer.graphed or trainer.capture_launches != want:
        fail(f"cli {label}: captured launches {trainer.capture_launches}, expected {want}")
    if counts != {k: 2 * v for k, v in want.items()}:
        fail(f"cli {label}: launches over the warm-up and the capture {counts}, expected "
             f"twice {want}")
    for name in ("training.csv", "weights.pt", "checkpoints/ckp_0.pt", "checkpoints/ckp_1.pt"):
        if not os.path.isfile(os.path.join(out, name)):
            fail(f"cli {label}: no {name} under --out_dir")
    steady = timed_dispatches(trainer)
    print(f"  steady step {steady:.2f} ms = {BATCH * 1e3 / steady:.3f} img/s ({TIMED_DISPATCHES} "
          f"dispatches back to back, one sync); {smi}")
    del run, trainer

    physics = task_physics(task)
    model = task_model(task, dtype)
    t0 = time.perf_counter()
    gt = GroundTruthDataset(f"gt_folder:{folder}")
    gt.load_all()  # memoized: the cache below reads nothing again
    read_s = time.perf_counter() - t0
    cache = build_device_cache(gt, physics, seed=0)
    torch.cuda.synchronize()
    print(f"  {len(gt)} PNGs read and resized to {tuple(cache.x.shape[-2:])} in {read_s:.2f} s "
          f"(host); degraded into the device cache in {time.perf_counter() - t0 - read_s:.2f} s")
    trainer = Trainer(model, get_loss(method="proposed", physics=physics, noise_level=5),
                      physics, cache, batch_size=BATCH, epochs=1,
                      lr=2e-4 if task == "sr" else 1e-4,
                      crop_size=CROP if task == "sr" else DATA_CROP,
                      seed=0, scan_steps=scan_steps)
    direct = []
    trainer.train(log_every_epoch=False, on_step=lambda s_, loss: direct.append(loss))
    direct = [float(v) for v in direct]
    print(f"  a Trainer built directly: losses {direct}")
    if direct != losses:
        fail(f"cli {label}: the command line's losses differ from the Trainer's")


def cli_test_run(folder: str, weights: str, task: str = "deblurring",
                 noise2inverse: bool = False) -> None:
    """``cli.test.main`` on ``weights``: its PSNR/SSIM must equal
    ``evaluate_pairs`` on the same pairs bit for bit (with
    ``noise2inverse``: ``--noise2inverse``, equal to ``score_pair`` through
    the ``eval_apply`` wrapper called here), its summary lines those values,
    and its launches the eval design's (4 forwards per image for
    Noise2Inverse)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from sei_tpu_torch.cli import test as cli_test
    from sei_tpu_torch.data import GroundTruthDataset, image_seed
    from sei_tpu_torch.evaluate import (EvalResult, degraded_pair, eval_apply, evaluate_pairs,
                                        score_pair)
    from sei_tpu_torch.models import get_model
    from sei_tpu_torch.ops import swin_trunk as st

    argv = [*TASK_ARGS[task], "--noise_level", "5",
            "--dataset", f"gt_folder:{folder}", "--weights", weights,
            "--indices", ",".join(map(str, CLI_TEST_INDICES))]
    argv += ["--noise2inverse"] if noise2inverse else []
    print(f"command line: python -m sei_tpu_torch.cli.test {' '.join(argv)}")
    st.reset_launch_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        got = cli_test.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = st.launch_counts()
    print("  " + printed.getvalue().strip().replace("\n", "\n  "))
    forwards = len(CLI_TEST_INDICES) * (N2I_FORWARDS if noise2inverse else 1)
    want_counts = {k: v * BLOCKS * forwards for k, v in PER_BLOCK.items()}
    if {k: counts[k] for k in PER_BLOCK} != want_counts:
        fail(f"cli test: launches {counts}, expected {want_counts}")
    gt = GroundTruthDataset(f"gt_folder:{folder}", split="val", memoize_gt=False)
    physics = task_physics(task)
    model = get_model(kind="Proposed", architecture="Transformer", task=task,
                      sr_factor=SR_FACTOR if task == "sr" else None)
    model.load_weights(torch.load(weights, weights_only=False))
    even = noise2inverse and task == "deblurring"

    def pairs():
        for i in CLI_TEST_INDICES:
            x = torch.as_tensor(gt[i], device=model.device)
            yield degraded_pair(physics, x, image_seed(0, gt.unique_id(i)), even=even)

    if noise2inverse:
        apply = eval_apply(model, physics, noise2inverse=True)
        scored = [score_pair(model, x, y, apply=apply)[:2] for x, y in pairs()]
        want = EvalResult([p for p, _ in scored], [s_ for _, s_ in scored])
    else:
        want = evaluate_pairs(model, pairs())
    print(f"  PSNR {got.psnr}, SSIM {got.ssim}; "
          f"{'the eval_apply wrapper' if noise2inverse else 'evaluate_pairs'} PSNR {want.psnr}, "
          f"SSIM {want.ssim}; {seconds * 1e3 / len(CLI_TEST_INDICES):.2f} ms/image with the reads")
    lines = printed.getvalue().splitlines()
    if (got.psnr, got.ssim) != (want.psnr, want.ssim) or not all(np.isfinite(got.psnr)):
        fail("cli test: its metrics differ from evaluate_pairs'")
    if f"PSNR: {np.mean(want.psnr):.2f}" not in lines or f"SSIM: {np.mean(want.ssim):.4f}" not in lines:
        fail("cli test: its summary lines do not print evaluate_pairs' means")


def cli_validate_run(folder: str, out: str, smi: str) -> None:
    """``cli.train`` with R2R-EI and in-training validation (every epoch, the
    first ``CLI_EVAL_COUNT`` images, 2 epochs of 2 captured steps): two
    ``validation.csv`` rows and ``ckp_best.pt``; the same losses as the run
    without validation, bit for bit (validating between replays touches no
    state of the graph); the hook's last PSNR/SSIM equal to
    ``evaluate_pairs`` on the same pairs and the final weights, bit for bit,
    with the eval design's launches per image."""
    import numpy as np
    import torch

    from sei_tpu_torch.cli import train as cli_train
    from sei_tpu_torch.data import GroundTruthDataset, image_seed
    from sei_tpu_torch.evaluate import evaluate_pairs
    from sei_tpu_torch.models import get_model
    from sei_tpu_torch.ops import swin_trunk as st
    from sei_tpu_torch.physics import get_physics

    base = ["--task", "deblurring", "--kernel", "Gaussian_R2", "--noise_level", "5",
            "--dataset", f"gt_folder:{folder}", "--method", "proposed",
            "--ProposedLoss__sure_alternative", "r2r", "--batch_size", str(BATCH),
            "--epochs", "2"]
    argv = base + ["--eval_interval", "1", "--eval_count", str(CLI_EVAL_COUNT), "--out_dir", out]
    print(f"command line (f32, R2R-EI, validation): python -m sei_tpu_torch.cli.train "
          f"{' '.join(argv)}")
    t0 = time.perf_counter()
    run = cli_train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    trainer = run["trainer"]
    losses = [float(v) for v in run["losses"]]
    validation = run["stats"]["validation"]
    print(f"  {run['stats']['steps']} steps in {trainer.replays} replays, {seconds:.2f} s with "
          f"the data, the warm-up, the capture and {len(validation)} validations; losses "
          f"{losses}; validation {validation}")
    rows = open(os.path.join(out, "validation.csv")).read().splitlines()
    if not trainer.graphed or rows[0] != "Epoch,PSNR,SSIM" or \
            [r.split(",")[0] for r in rows[1:]] != ["1", "2"] or len(validation) != 2:
        fail(f"cli validation: validation.csv {rows}, validations {validation}")
    if not os.path.isfile(os.path.join(out, "checkpoints", "ckp_best.pt")):
        fail("cli validation: no checkpoints/ckp_best.pt")
    if not np.all(np.isfinite(losses)):
        fail(f"cli validation: non-finite losses {losses}")
    plain = cli_train.main(base + ["--out_dir", out + "_plain"])
    plain = [float(v) for v in plain["losses"]]
    print(f"  the same run without validation: losses {plain}")
    if plain != losses:
        fail("cli validation: validating between replays changed the training")

    hook = trainer.eval_hook
    st.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = hook(trainer.model)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(hook)
    counts = st.launch_counts()
    want_counts = {k: v * BLOCKS * len(hook) for k, v in PER_BLOCK.items()}
    if {k: counts[k] for k in PER_BLOCK} != want_counts:
        fail(f"cli validation: the hook's launches {counts}, expected {want_counts}")
    gt = GroundTruthDataset(f"gt_folder:{folder}", split="all", memoize_gt=False)
    physics = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    model = get_model(kind="Proposed", architecture="Transformer", task="deblurring")
    model.load_weights(torch.load(os.path.join(out, "weights.pt"), weights_only=False))

    def pairs():
        for i in range(CLI_EVAL_COUNT):
            x = torch.as_tensor(gt[i], device=model.device)
            yield x, physics.randomly_degrade(x[None], image_seed(0, gt.unique_id(i)))[0]

    want = evaluate_pairs(model, pairs())
    print(f"  the hook's last PSNR/SSIM {validation[-1][1:]!r}, again {again!r}; "
          f"evaluate_pairs on the final weights ({want.psnr_mean!r}, {want.ssim_mean!r}); "
          f"{ms:.2f} ms per validated image ({len(hook)} images, eval mode, between replays); "
          f"{smi}")
    if validation[-1][1:] != again or again != (want.psnr_mean, want.ssim_mean):
        fail("cli validation: the hook's scores differ from evaluate_pairs'")


def sr_forward_check(model, y, label: str, dtype) -> tuple[float, float, float]:
    """One forward of the padded measurement ``y`` (1, 3, h, w): the kernel
    path against the plain path (f32 to FORWARD_ATOL, bf16 to
    FORWARD_FRAC_BF16 of the plain output's largest value), each timed;
    the trunk's launches must be one forward's.  Returns (max |diff|, ms,
    plain ms)."""
    import torch

    from sei_tpu_torch.ops import swin_trunk as st

    with torch.no_grad():
        st.reset_launch_counts()
        out_k = model(y)
        counts = st.launch_counts()
        out_p = model.module(y, plain=True)
        fwd_ms = time_ms(lambda: model(y), iters=3, warmup=1)
        plain_fwd_ms = time_ms(lambda: model.module(y, plain=True), iters=3, warmup=1)
    want = {k: v * BLOCKS for k, v in PER_BLOCK.items()}
    if {k: counts[k] for k in PER_BLOCK} != want:
        fail(f"{label}: one forward launched {counts}, expected {want}")
    if dtype is None:
        err = compare(f"{label} forward (kernels vs plain)", out_k, out_p, FORWARD_ATOL, 0.0)
    else:
        err = float((out_k - out_p).abs().max())
        tol = FORWARD_FRAC_BF16 * float(out_p.abs().max())
        print(f"  {label} forward (kernels vs plain): max |diff| {err:.3e} (tolerance {tol:.3e}"
              f" = {FORWARD_FRAC_BF16:g} of max |plain|)")
        if not err <= tol:
            fail(f"{label}: the bf16 forward disagrees with the plain forward")
    t = y.shape[-2] * y.shape[-1]
    print(f"  {label} forward at {y.shape[-2]}x{y.shape[-1]} (T = {t}) -> "
          f"{tuple(out_k.shape[-2:])}: kernel path {fwd_ms:.2f} ms, plain path "
          f"{plain_fwd_ms:.2f} ms")
    return err, fwd_ms, plain_fwd_ms


def sr_eval(smi: str) -> dict:
    """SR eval on the card: the flagship SwinIR with the x2 head (weights
    from seed 0), f32 and bf16, through ``evaluate`` on 4 seeded 256x320
    images (each measurement 128x160, padded to the 128x192 bucket): the
    launch counts, PSNR/SSIM and ms per image, one forward against the
    plain forward and profiled by kernel; ``Upsample`` on the same pairs; one x3 and one x4
    forward against the plain forward.  Returns the launches over the two
    ``evaluate`` runs."""
    import numpy as np
    import torch

    from sei_tpu_torch.evaluate import degraded_pair, evaluate
    from sei_tpu_torch.models import get_model
    from sei_tpu_torch.models.swinir import reflect_pad
    from sei_tpu_torch.ops import swin_trunk as st

    images = make_images(N_IMAGES, H, W, seed=0)
    physics = task_physics("sr")
    total = {}

    def padded(phys, i):
        x = torch.as_tensor(images[i], device=phys.device)
        y = degraded_pair(phys, x, i)[1][None]
        return reflect_pad(y, (-y.shape[-2]) % PAD_BUCKET, (-y.shape[-1]) % PAD_BUCKET)

    for dtype in (None, torch.bfloat16):
        label = f"SR x{SR_FACTOR} " + ("bf16" if dtype is not None else "f32")
        print(f"SR eval ({label}): get_model(task='sr', sr_factor={SR_FACTOR}) -> "
              f"get_physics(task='sr') -> evaluate ({N_IMAGES} images {H}x{W}, flagship SwinIR "
              f"with the pixelshuffle head, noise 5)")
        model = task_model("sr", dtype)
        evaluate(model, physics, images[:1])  # warm-up: cuDNN choices, masks
        torch.cuda.synchronize()
        st.reset_launch_counts()
        t0 = time.perf_counter()
        result = evaluate(model, physics, images)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = st.launch_counts()
        add_counts(total, counts)
        print(f"  launch counts {counts}")
        for name, per in PER_BLOCK.items():
            want = per * BLOCKS * N_IMAGES
            if counts[name] != want:
                fail(f"{label} {name}: {counts[name]} launches over {N_IMAGES} images, "
                     f"expected {want}")
        for i, (p, s_) in enumerate(zip(result.psnr, result.ssim)):
            print(f"  image {i}: PSNR {p!r} SSIM {s_!r}")
            if not (np.isfinite(p) and np.isfinite(s_) and 0.0 < p < 100.0 and -1.0 <= s_ <= 1.0):
                fail(f"{label} image {i}: metrics out of range")
        print(f"  mean PSNR {result.psnr_mean!r} SSIM {result.ssim_mean!r}; "
              f"{seconds * 1e3 / N_IMAGES:.2f} ms/image end to end; {smi}")
        y = padded(physics, 0)
        sr_forward_check(model, y, label, dtype)
        profile_forward(model, y)
        del model
    up = get_model(kind="Upsample", task="sr", sr_factor=SR_FACTOR)
    t0 = time.perf_counter()
    result = evaluate(up, physics, images)
    torch.cuda.synchronize()
    print(f"  Upsample (bicubic x{SR_FACTOR}) on the same pairs: PSNR {result.psnr} SSIM "
          f"{result.ssim}; mean {result.psnr_mean!r} / {result.ssim_mean!r}; "
          f"{(time.perf_counter() - t0) * 1e3 / N_IMAGES:.2f} ms/image")
    if not all(np.isfinite(result.psnr)):
        fail("Upsample: non-finite PSNR")
    for factor in SR_OTHER_FACTORS:
        model = task_model("sr", None, factor)
        sr_forward_check(model, padded(task_physics("sr", factor), 0), f"SR x{factor} f32", None)
        del model
    return total


def sr_phase(smi: str, proposed_ms: dict) -> None:
    """The SR task on the card: the eval (:func:`sr_eval`); SR x2 training at
    flagship width and depth (batch 8, 48 px crops of the measurement),
    ``proposed`` with SURE in f32 eager then captured at ``scan_steps`` 1,
    R2R-EI in bf16 eager then captured at 2, each equal to its eager run bit
    for bit with proposed deblurring's launches per step; then the command
    lines: ``cli.train --task sr`` (2 captured steps, its losses equal to a
    directly built ``Trainer``'s) and ``cli.test --task sr`` on its
    ``weights.pt`` (equal to ``evaluate_pairs``)."""
    import tempfile

    import torch

    from sei_tpu_torch.data import write_image

    total = {"eval": sr_eval(smi)}
    for dtype, alt, scan_steps in ((None, None, 1), (torch.bfloat16, "r2r", 2)):
        counts, trainer, eager = train_path(dtype, sure_alternative=alt, task="sr")
        del trainer
        captured, steady = captured_train(dtype, scan_steps, eager, sure_alternative=alt,
                                          task="sr")
        label = run_label(dtype, alt, "sr")
        add_counts(total.setdefault("train " + label, {}), counts)
        add_counts(total["train " + label], captured)
        key = ("bf16" if dtype is not None else "f32", scan_steps)
        print(f"  {label} captured at scan_steps {scan_steps}: {steady:.2f} ms/step = "
              f"{BATCH * 1e3 / steady:.3f} img/s; proposed deblurring (SURE) in this run "
              f"{proposed_ms[key]:.2f} ms/step; {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "gt")
        for i, im in enumerate(make_images(CLI_IMAGES, 2 * H, 2 * W, seed=2)):
            write_image(os.path.join(folder, f"{i:02d}.png"), im)
        out = os.path.join(tmp, "sr")
        cli_train_run(folder, out, None, 1, smi, task="sr")
        cli_test_run(folder, os.path.join(out, "weights.pt"), task="sr")
    print(f"SR launches by run (eval: f32 + bf16 evaluate; train: eager + captured): "
          f"{json.dumps(total)}")


def slice20_training(smi: str, proposed_ms: dict) -> dict:
    """The training cells of the CT-like task and of ROADMAP Queue 1 item 4
    on the card, each eagerly and then captured (f32 at ``scan_steps`` 1,
    bf16 at 2) and equal to its eager run bit for bit, with ``proposed``'s
    launches per step (2 trunk graphs) or ``supervised``'s (1): CT-like
    R2R-EI f32, supervised bf16 and the noise2inverse method bf16
    (``experiments/queue_r3r.sh``, ``queue_r3t.sh``); CSS bf16, EI-rotate
    and EI-shift R2R f32 (``queue_r3q.sh``, ``queue_r3v.sh``); the normal
    scaling kind (f32 SURE, a graph per rate, replayed in the JAX trainer's
    variant order), fresh measurements (f32), supervised L1 (bf16), and
    fine-tuning from the seed-0 weights (SGD at 1e-2, ``conv_last`` only,
    the weights-distance term) on a folder of 16 written PNGs.  Returns the
    launches by cell (eager + captured)."""
    import tempfile

    import torch

    from sei_tpu_torch.data import write_image

    bf = torch.bfloat16
    cells, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "predictors")
        for i, im in enumerate(make_images(CLI_IMAGES, H, W, seed=3)):
            write_image(os.path.join(folder, f"{i:02d}.png"), im)
        recipes = [
            (Recipe("f32 r2r ct", task=CT, loss={"method": "proposed", "sure_alternative": "r2r"}),
             1),
            (Recipe("bf16 supervised ct", task=CT, dtype=bf, loss={"method": "supervised"},
                    graphs=1), 2),
            (Recipe("bf16 noise2inverse ct", task=CT, dtype=bf,
                    loss={"method": "noise2inverse"}, graphs=1), 2),
            (Recipe("bf16 css", dtype=bf, loss={"method": "css"}, trainer={"css": True},
                    graphs=1), 2),
            (Recipe("f32 r2r ei-rotate", loss={"method": "ei-rotate", "sure_alternative": "r2r"}),
             1),
            (Recipe("f32 r2r ei-shift", loss={"method": "ei-shift", "sure_alternative": "r2r"}),
             1),
            (Recipe("f32 normal kind", normal_rates=(0.75, 0.5)), 1),
            (Recipe("f32 fresh measurements", trainer={"fresh_measurements": True}), 1),
            (Recipe("bf16 supervised l1", dtype=bf,
                    loss={"method": "supervised", "supervised_l1": True}, graphs=1), 2),
            (Recipe("f32 fine-tuning", folder=folder, conv_last_only=True,
                    trainer={"optimizer": "SGD", "lr": 1e-2, "weights_distance_lambda": 1.0}), 1),
        ]
        for recipe, scan_steps in recipes:
            counts, trainer, eager = train_path(recipe=recipe)
            del trainer
            cells[recipe.label] = record = {}
            captured, steady = captured_train(recipe.dtype, scan_steps, eager, recipe=recipe,
                                              record=record)
            launches[recipe.label] = dict(counts)
            add_counts(launches[recipe.label], captured)
            del eager  # its state copies: not part of the next cell's memory
            ref = ("bf16" if recipe.dtype is not None else "f32", scan_steps)
            print(f"  {recipe.label} captured at scan_steps {scan_steps}: {steady:.2f} ms/step = "
                  f"{BATCH * 1e3 / steady:.3f} img/s; proposed deblurring (SURE) in this run "
                  f"{proposed_ms[ref]:.2f} ms/step; {smi}")
    print(f"slice 20 training cells (ms per step; peak GiB): {json.dumps(cells)}; {smi}")
    return launches


def ct_eval(smi: str) -> dict:
    """The CT-like task's eval on the card (flagship SwinIR, weights from
    seed 0, f32): ``evaluate`` on the 4 seeded images (launches, PSNR/SSIM,
    ms per image), one forward against the plain forward (1e-3 abs),
    ``A_dagger(A x)`` against x (printed), and the Noise2Inverse eval
    (``eval_apply(noise2inverse=True)``: 4 forwards per image).  Returns the
    launches of the two evals."""
    import numpy as np
    import torch

    from sei_tpu_torch.evaluate import degraded_pair, eval_apply, evaluate, score_pair
    from sei_tpu_torch.models.swinir import reflect_pad
    from sei_tpu_torch.ops import swin_trunk as st

    images = make_images(N_IMAGES, H, W, seed=0)
    physics = task_physics(CT)
    model = task_model(CT)
    print(f"CT-like eval (f32): get_model -> get_physics(task={CT!r}) -> evaluate ({N_IMAGES} "
          f"images {H}x{W}, flagship SwinIR, noise 5)")
    x = torch.as_tensor(np.stack(images), device=physics.device)
    back = physics.A_dagger(physics.A(x))
    print(f"  A_dagger(A x) against x: max |diff| {float((back - x).abs().max()):.3e} "
          f"(max |x| {float(x.abs().max()):.3f}); A x spans "
          f"[{float(physics.A(x).min()):.4f}, {float(physics.A(x).max()):.4f}]")
    evaluate(model, physics, images[:1])
    torch.cuda.synchronize()
    out = {}
    for label, n2i in (("plain", False), ("noise2inverse", True)):
        apply = eval_apply(model, physics, noise2inverse=n2i)
        st.reset_launch_counts()
        t0 = time.perf_counter()
        if n2i:
            pairs = (degraded_pair(physics, torch.as_tensor(im, device=physics.device), i)
                     for i, im in enumerate(images))
            scored = [score_pair(model, x_, y_, apply=apply)[:2] for x_, y_ in pairs]
        else:
            result = evaluate(model, physics, images)
            scored = list(zip(result.psnr, result.ssim))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = out[label] = st.launch_counts()
        forwards = N_IMAGES * (N2I_FORWARDS if n2i else 1)
        want = {k: v * BLOCKS * forwards for k, v in PER_BLOCK.items()}
        if {k: counts[k] for k in PER_BLOCK} != want:
            fail(f"CT-like eval {label}: launches {counts}, expected {want}")
        psnr, ssim = [p for p, _ in scored], [s_ for _, s_ in scored]
        if not (np.all(np.isfinite(psnr)) and np.all(np.isfinite(ssim))):
            fail(f"CT-like eval {label}: non-finite metrics")
        print(f"  {label}: PSNR {psnr} SSIM {ssim}; mean {float(np.mean(psnr))!r} / "
              f"{float(np.mean(ssim))!r}; {seconds * 1e3 / N_IMAGES:.2f} ms/image end to end; "
              f"launches {counts}; {smi}")
    y = physics.randomly_degrade(x[:1], 0)
    y = reflect_pad(y, (-y.shape[-2]) % PAD_BUCKET, (-y.shape[-1]) % PAD_BUCKET)
    sr_forward_check(model, y, "CT-like f32", None)
    return out


def spatial_blur_eval(smi: str) -> dict:
    """``--no-physics_v2`` on the card: the spatial blur's degradation of the
    4 seeded images against the FFT blur's (the same circular operator and
    the same seeded noise: to SPATIAL_ATOL), each operator timed, then
    ``evaluate`` with the spatial physics (PSNR/SSIM, ms per image, beside
    the FFT physics' on the same images).  Returns the eval's launches."""
    import numpy as np
    import torch

    from sei_tpu_torch.evaluate import evaluate
    from sei_tpu_torch.ops import swin_trunk as st

    images = make_images(N_IMAGES, H, W, seed=0)
    fft, spatial = task_physics("deblurring"), task_physics("deblurring", physics_v2=False)
    x = torch.as_tensor(np.stack(images), device=fft.device)
    err = float((spatial.A(x) - fft.A(x)).abs().max())
    err_t = float((spatial.A_adjoint(x) - fft.A_adjoint(x)).abs().max())
    err_y = max(float((spatial.randomly_degrade(x[i:i + 1], i) - fft.randomly_degrade(
        x[i:i + 1], i)).abs().max()) for i in range(N_IMAGES))
    ms_sp, ms_fft = time_ms(lambda: spatial.A(x)), time_ms(lambda: fft.A(x))
    print(f"spatial blur (--no-physics_v2) on {N_IMAGES} images {H}x{W}: A against the FFT blur "
          f"max |diff| {err:.3e}, A^T {err_t:.3e}, the seeded measurements {err_y:.3e} "
          f"(tolerance {SPATIAL_ATOL:g}); A {ms_sp:.4f} ms (cuDNN depthwise) vs {ms_fft:.4f} ms "
          f"(cuFFT) for the batch")
    if not max(err, err_t, err_y) <= SPATIAL_ATOL:
        fail("the spatial blur disagrees with the FFT blur")
    model = task_model("deblurring")
    evaluate(model, spatial, images[:1])
    torch.cuda.synchronize()
    st.reset_launch_counts()
    t0 = time.perf_counter()
    result = evaluate(model, spatial, images)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = st.launch_counts()
    want = {k: v * BLOCKS * N_IMAGES for k, v in PER_BLOCK.items()}
    if {k: counts[k] for k in PER_BLOCK} != want:
        fail(f"spatial blur eval: launches {counts}, expected {want}")
    ref = evaluate(model, fft, images)
    print(f"  evaluate with the spatial physics: PSNR {result.psnr} SSIM {result.ssim}; mean "
          f"{result.psnr_mean!r} / {result.ssim_mean!r} (FFT physics {ref.psnr_mean!r} / "
          f"{ref.ssim_mean!r}); {seconds * 1e3 / N_IMAGES:.2f} ms/image; {smi}")
    if not np.all(np.isfinite(result.psnr)):
        fail("spatial blur eval: non-finite PSNR")
    return counts


def r2r_eval(smi: str) -> dict:
    """``--r2r --r2r_itercount 4`` on the deblurring eval: each of the 4
    seeded images scored on the mean of 4 restorations of y + sigma / 2 * n
    (one generator seeded 1 for the eval), 4 forwards per image; ms per
    image beside the plain eval's.  Returns the launches."""
    import numpy as np
    import torch

    from sei_tpu_torch.evaluate import degraded_pair, eval_apply, evaluate, r2r_average, score_pair
    from sei_tpu_torch.ops import swin_trunk as st

    images = make_images(N_IMAGES, H, W, seed=0)
    physics = task_physics("deblurring")
    model = task_model("deblurring")
    restore_one = eval_apply(model, physics)
    gen = torch.Generator(device=physics.device).manual_seed(1)

    def apply(y):
        return r2r_average(restore_one, y, sigma=physics.sigma, itercount=R2R_ITERCOUNT,
                           generator=gen)

    evaluate(model, physics, images[:1])
    torch.cuda.synchronize()
    st.reset_launch_counts()
    t0 = time.perf_counter()
    pairs = (degraded_pair(physics, torch.as_tensor(im, device=physics.device), i)
             for i, im in enumerate(images))
    scored = [score_pair(model, x_, y_, apply=apply)[:2] for x_, y_ in pairs]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = st.launch_counts()
    want = {k: v * BLOCKS * N_IMAGES * R2R_ITERCOUNT for k, v in PER_BLOCK.items()}
    if {k: counts[k] for k in PER_BLOCK} != want:
        fail(f"--r2r eval: launches {counts}, expected {want}")
    t0 = time.perf_counter()
    plain = evaluate(model, physics, images)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / N_IMAGES
    psnr = [p for p, _ in scored]
    if not np.all(np.isfinite(psnr)):
        fail("--r2r eval: non-finite PSNR")
    print(f"--r2r eval (itercount {R2R_ITERCOUNT}, deblurring, {N_IMAGES} images {H}x{W}): PSNR "
          f"{psnr} SSIM {[s_ for _, s_ in scored]}; {seconds * 1e3 / N_IMAGES:.2f} ms/image vs "
          f"{plain_ms:.2f} plain (PSNR {plain.psnr_mean!r}); {smi}")
    return counts


def ct_cli_phase(smi: str) -> None:
    """The CT-like task's command lines: ``cli.train --task
    invert_a_tomography_like_filter`` for 2 captured steps (its losses equal
    to a directly built ``Trainer``'s bit for bit), then ``cli.test
    --noise2inverse`` on its ``weights.pt``, equal to the ``eval_apply``
    wrapper called directly."""
    import tempfile

    from sei_tpu_torch.data import write_image

    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "gt")
        for i, im in enumerate(make_images(CLI_IMAGES, 2 * H, 2 * W, seed=2)):
            write_image(os.path.join(folder, f"{i:02d}.png"), im)
        out = os.path.join(tmp, "ct")
        cli_train_run(folder, out, None, 1, smi, task=CT)
        cli_test_run(folder, os.path.join(out, "weights.pt"), task=CT, noise2inverse=True)


def slice20_phase(smi: str, proposed_ms: dict) -> None:
    """Every path of slice 20 on the card: the training cells, the CT-like
    eval (plain and Noise2Inverse), the spatial blur, ``--r2r`` and the
    CT-like command lines; the launches by run, one JSON line."""
    launches = {"train " + k: v for k, v in slice20_training(smi, proposed_ms).items()}
    for label, counts in ct_eval(smi).items():
        launches["eval ct " + label] = counts
    launches["eval spatial blur"] = spatial_blur_eval(smi)
    launches[f"eval r2r x{R2R_ITERCOUNT}"] = r2r_eval(smi)
    ct_cli_phase(smi)
    print(f"slice 20 launches by run (train: eager + captured): {json.dumps(launches)}")


def tiled_eval_phase(smi: str) -> dict:
    """One seeded dead-leaves-like 1356x2040 image (Div2K's validation shape)
    through ``evaluate`` with ``eval_tile_height`` 768 (flagship SwinIR,
    weights from seed 0, f32, deblurring Gaussian_R2 at noise 5): the kernel
    path's output on the strips against the plain versions on the same
    strips (FORWARD_ATOL), the strips' forward (CUDA events) and its peak
    memory, T, ms per image, PSNR/SSIM, the trunk kernels' launches (one
    forward's), the forward profiled by kernel; then ``cli.test`` on the
    image written as a PNG, equal to ``evaluate_pairs`` on the same pair
    with one forward's launches.  Returns the launches by run."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from sei_tpu_torch.cli import test as cli_test
    from sei_tpu_torch.data import GroundTruthDataset, image_seed, write_image
    from sei_tpu_torch.evaluate import degraded_pair, evaluate, evaluate_pairs, tile_plan
    from sei_tpu_torch.ops import swin_trunk as st
    from sei_tpu_torch.parallel.tiling import strips

    t0 = time.perf_counter()
    image = make_images(1, TILED_H, TILED_W, seed=4)[0]
    physics = task_physics("deblurring")
    model = task_model("deblurring")
    n_tiles, halo = tile_plan(TILED_H, TILE_HEIGHT)
    strip, win, parts = strips(TILED_H, n_tiles, halo)
    tokens = n_tiles * (win + (-win) % WS) * (TILED_W + (-TILED_W) % WS)
    x = torch.as_tensor(image, device=physics.device)
    _, y = degraded_pair(physics, x, 0)
    tiles = torch.cat([y[None, :, s_:s_ + win] for s_, _, _ in parts])
    torch.cuda.synchronize()
    print(f"tiled eval (f32): one {TILED_H}x{TILED_W} image, evaluate(eval_tile_height="
          f"{TILE_HEIGHT}): {n_tiles} strips of {strip} rows, halo {halo}, windows of {win} "
          f"rows at {[s_ for s_, _, _ in parts]}, {win + (-win) % WS} after the window pad: "
          f"T = {tokens} tokens per forward (256x320: {H * W}); set-up "
          f"{time.perf_counter() - t0:.2f} s")
    launches, err = {}, 0.0
    with torch.no_grad():
        st.reset_launch_counts()
        out_k = model.module(tiles)
        launches["forward"] = st.launch_counts()
        torch.cuda.empty_cache()
        # the plain versions one strip at a time: their intermediates (the
        # scores, qkv) of both strips outgrow the card's 80 GB at T = 3.3M
        for i in range(n_tiles):
            out_p = model.module(tiles[i:i + 1], plain=True)
            err = max(err, compare(f"tiled strip {i}, kernel path (both strips in one batch) "
                                   "vs plain versions (this strip alone)", out_k[i:i + 1],
                                   out_p, FORWARD_ATOL, 0.0))
            del out_p
    del out_k
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    model(tiles)
    end.record()
    end.synchronize()
    fwd_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 2**30
    st.reset_launch_counts()
    t0 = time.perf_counter()
    result = evaluate(model, physics, [image], eval_tile_height=TILE_HEIGHT)
    torch.cuda.synchronize()
    ms_image = (time.perf_counter() - t0) * 1e3
    counts = launches["evaluate"] = st.launch_counts()
    want = {k: v * BLOCKS for k, v in PER_BLOCK.items()}
    for label, got in launches.items():
        if {k: got[k] for k in PER_BLOCK} != want:
            fail(f"tiled eval {label}: launches {got}, expected one forward's {want}")
    if not (np.isfinite(result.psnr[0]) and np.isfinite(result.ssim[0])):
        fail("tiled eval: non-finite metrics")
    print(f"  forward of the strips {fwd_ms:.2f} ms (CUDA events); peak memory {peak:.3f} GiB "
          f"({base:.3f} allocated before); evaluate {ms_image:.2f} ms per image end to end; "
          f"PSNR {result.psnr[0]!r} SSIM {result.ssim[0]!r}; launches {counts}; max_abs_err "
          f"{err:.3e}; {smi}")
    profile_forward(model, tiles)
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "gt")
        t0 = time.perf_counter()
        write_image(os.path.join(folder, "0.png"), image)
        write_s = time.perf_counter() - t0
        argv = [*TASK_ARGS["deblurring"], "--noise_level", "5", "--dataset",
                f"gt_folder:{folder}", "--GroundTruthDataset__no_resize", "--indices", "0",
                "--eval_tile_height", str(TILE_HEIGHT)]
        print(f"  command line: python -m sei_tpu_torch.cli.test {' '.join(argv)} (PNG written "
              f"in {write_s:.2f} s)")
        st.reset_launch_counts()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            got = cli_test.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launches["cli.test"] = st.launch_counts()
        gt = GroundTruthDataset(f"gt_folder:{folder}", split="val", size=None)
        pair = degraded_pair(physics, torch.as_tensor(gt[0], device=physics.device),
                             image_seed(0, gt.unique_id(0)))
        want_eval = evaluate_pairs(model, [pair], eval_tile_height=TILE_HEIGHT)
    print(f"  cli.test: PSNR {got.psnr} SSIM {got.ssim}, {seconds:.2f} s with the read; "
          f"evaluate_pairs PSNR {want_eval.psnr} SSIM {want_eval.ssim}; launches {counts}")
    if {k: counts[k] for k in PER_BLOCK} != want:
        fail(f"tiled cli.test: launches {counts}, expected one forward's {want}")
    if (got.psnr, got.ssim) != (want_eval.psnr, want_eval.ssim):
        fail("tiled cli.test: its metrics differ from evaluate_pairs'")
    return launches


# the baselines phase (slice 22): the strips over a one-rank NCCL group on an
# image of 2 strips; each training-free baseline on one seeded 256x320
# deblurring image (Gaussian_R2, noise 5), DIP cut to 100 iterations, the
# others as the JAX package runs them; the Convolutional network at its
# default blueprint; the denoiser priors on seeded random weights at the
# published widths; LPIPS on a seeded random AlexNet checkpoint
STRIPS_H = 896
DIP_SMOKE_ITERATIONS = 100
# a baseline on the card against the port's CPU result on the same y: 1e-4
# of the CPU output's largest value (cuFFT against pocketfft, cuDNN / cuBLAS
# against the CPU's sums; TV iterates 300 times).  The inverse filter is
# gated on Gaussian_R1: Gaussian_R2's smallest OTF bins lie below f32's
# resolution (2.9e-10 in f32 against 8.3e-12 in f64 at 256x341), so two
# f32 FFT libraries' inverse filters agree in no digit there (printed, not
# gated).  BM3D is discontinuous in its input: a hard threshold at 2.7 sigma
# and the 8 closest of 81 candidates, so the two libraries' f32 roundoff
# (cuFFT's regularized inverse, cuBLAS's DCTs against the CPU's) flips a
# few coefficients or candidates, each moving the patches it touches
# (tools_torch/bm3d_roundoff.py shows a change of y by one rounding doing
# the same).  This image's reading on the H100 was 1.37e-3 at most, on
# 7.2e-4 of the pixels beyond BASELINE_FRAC: BM3D is held to BASELINE_FRAC
# on all but BM3D_SHARE of its pixels and to BM3D_MAX_FRAC, about 3 times
# that largest reading, on all
BASELINE_FRAC = 1e-4
BM3D_SHARE, BM3D_MAX_FRAC = 1e-3, 4e-3
LPIPS_ATOL = 1e-4
DENOISER_KINDS = ("PlugAndPlay", "DiffPIR_DRUNet", "DPS", "DiffPIR_DiffUNet")


def timed_call(fn):
    """(fn(), ms by the host clock ending in a sync, peak GiB allocated during
    the call above what was allocated before it, GiB allocated before)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, (torch.cuda.max_memory_allocated() - base) / 2**30, base / 2**30


def strips_over_ranks(smi: str) -> None:
    """``tiled_apply`` over a world-size-1 NCCL group (the process group a
    data-parallel run makes) equals the call without a group bit for bit:
    one seeded 896x320 image, 2 strips of 448 rows, halo 64, the flagship
    SwinIR."""
    import torch

    from sei_tpu_torch.evaluate import degraded_pair, tile_plan
    from sei_tpu_torch.parallel.tiling import tiled_apply

    physics, model = task_physics("deblurring"), task_model("deblurring")
    image = make_images(1, STRIPS_H, W, seed=5)[0]
    _, y = degraded_pair(physics, torch.as_tensor(image, device=physics.device), 0)
    n_tiles, halo = tile_plan(STRIPS_H, TILE_HEIGHT)
    want, ms, _, _ = timed_call(lambda: tiled_apply(model, y[None], n_tiles=n_tiles, halo=halo))
    dp_group()
    try:
        got, ms_group, _, _ = timed_call(lambda: tiled_apply(
            model, y[None], n_tiles=n_tiles, halo=halo, group=torch.distributed.group.WORLD))
        world = torch.distributed.get_world_size()
    finally:
        torch.distributed.destroy_process_group()
    equal = torch.equal(got, want)
    print(f"strips over ranks: tiled_apply of one {STRIPS_H}x{W} image, {n_tiles} strips, halo "
          f"{halo}, over an NCCL group of {world} rank(s): {ms_group:.2f} ms; without a group "
          f"{ms:.2f} ms; equal bit for bit: {equal}; {smi}")
    if not equal:
        fail("tiled_apply over a one-rank group differs from the call without one")


def functional_baselines(smi: str) -> dict:
    """InverseFilter, TV (300 iterations), DIP (``DIP_SMOKE_ITERATIONS``) and
    BM3D on one seeded 256x320 deblurring image, each run twice: ms per
    image of the first call (cuFFT plans, cuDNN's choices) and of the
    second, peak memory, PSNR/SSIM, whether the second call repeats the
    first's bits; InverseFilter (Gaussian_R1), TV and BM3D held against the
    port's CPU result on the same y."""
    import torch

    from sei_tpu_torch.evaluate import degraded_pair
    from sei_tpu_torch.metrics import compute_metrics, quantize_and_clamp
    from sei_tpu_torch.models import get_model
    from sei_tpu_torch.physics import get_physics

    image = make_images(1, H, W, seed=6)[0]
    results = {}
    for kind, kernel in (("InverseFilter", "Gaussian_R1"), ("InverseFilter", "Gaussian_R2"),
                         ("TV", "Gaussian_R2"), ("DeepImagePrior", "Gaussian_R2"),
                         ("BM3D", "Gaussian_R2")):
        label = f"{kind} {kernel}"
        physics = get_physics(task="deblurring", kernel=kernel, noise_level=5)
        x, y = degraded_pair(physics, torch.as_tensor(image, device=physics.device), 0)
        kw = dict(kind=kind, task="deblurring", noise_level=5, kernel_name=kernel,
                  dip_iterations=DIP_SMOKE_ITERATIONS)
        model = get_model(physics=physics, **kw)
        out, ms_first, peak, base = timed_call(lambda: model(y[None]))
        again, ms, _, _ = timed_call(lambda: model(y[None]))
        if out.shape != (1, 3, H, W) or not torch.isfinite(out).all():
            fail(f"{label}: output {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
        p, s, _ = compute_metrics(quantize_and_clamp(x), quantize_and_clamp(out)[0])
        rec = results[label] = {"ms": ms, "ms_first": ms_first, "peak_gib": peak, "psnr": p,
                                "ssim": s, "repeats_bit_for_bit": bool(torch.equal(again, out))}
        line = (f"{label}: {ms:.2f} ms per image (first call {ms_first:.2f}; the same bits: "
                f"{rec['repeats_bit_for_bit']}), peak {peak:.3f} GiB above {base:.3f}; PSNR "
                f"{p!r} SSIM {s!r}")
        if kind != "DeepImagePrior":
            cpu_physics = get_physics(task="deblurring", kernel=kernel, noise_level=5,
                                      device="cpu")
            cpu = get_model(physics=cpu_physics, device="cpu", **kw)(y[None].cpu())
            err = (out.cpu() - cpu).abs() / cpu.abs().max()
            frac, share = float(err.max()), float((err > BASELINE_FRAC).float().mean())
            rec.update(err_frac_of_cpu_max=frac, share_beyond=share)
            line += (f"; against the port on the CPU {frac:.3e} of its largest value "
                     f"{float(cpu.abs().max()):.4g}, {share:.3e} of the pixels beyond "
                     f"{BASELINE_FRAC:g}")
            if kind == "BM3D":
                line += f" (gates: share {BM3D_SHARE:g}, max {BM3D_MAX_FRAC:g})"
                ok = share <= BM3D_SHARE and frac <= BM3D_MAX_FRAC
            elif kernel == "Gaussian_R1" or kind != "InverseFilter":
                line += f" (gate {BASELINE_FRAC:g})"
                ok = frac <= BASELINE_FRAC
            else:
                line += " (not gated)"
                ok = True
            if not ok:
                print(f"  {line}; {smi}")
                fail(f"{label}: the card's result differs from the CPU's")
        print(f"  {line}; {smi}")
    return results


def convolutional_phase(smi: str) -> dict:
    """The Convolutional network at its default blueprint (hidden 32, 5
    scales, 1 block: 8192 channels at the bottom) with ``proposed``, batch 8
    of 48 px crops, f32: 2 steps eagerly, then captured from the same seed-0
    weights and streams, each loss and the final state equal bit for bit;
    steady ms per step of both, peak memory.  Then ``cli.train`` (one epoch
    of 2 captured steps on 16 written PNGs) and ``cli.test`` of its
    ``weights.pt``, equal to ``evaluate_pairs``."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from sei_tpu_torch.cli import test as cli_test
    from sei_tpu_torch.cli import train as cli_train
    from sei_tpu_torch.data import GroundTruthDataset, build_device_cache, image_seed, write_image
    from sei_tpu_torch.evaluate import degraded_pair, evaluate_pairs
    from sei_tpu_torch.losses import get_loss
    from sei_tpu_torch.models import get_model
    from sei_tpu_torch.train import Trainer

    physics = task_physics("deblurring")
    cache = build_device_cache(make_images(TRAIN_IMAGES, H, W, seed=1), physics, seed=0)
    loss_fn = get_loss(method="proposed", physics=physics, crop_size=CROP)
    runs = {}
    for capture in (False, True):
        model = get_model(architecture="Convolutional", seed=0)
        n_params = sum(p.numel() for p in model.module.parameters())
        trainer = Trainer(model, loss_fn, physics, cache, batch_size=BATCH, epochs=1,
                          crop_size=DATA_CROP, seed=0, capture=capture)
        losses = []
        torch.cuda.reset_peak_memory_stats()
        trainer.train(log_every_epoch=False, on_step=lambda s_, loss: losses.append(loss))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        state = train_state(trainer)
        steady = timed_dispatches(trainer)
        runs[capture] = {"losses": [float(v) for v in losses], "state": state,
                         "ms_per_step": steady, "peak_gib": peak, "graphed": trainer.graphed}
        del trainer, model
        torch.cuda.empty_cache()
    eager, captured = runs[False], runs[True]
    unequal = sum(not torch.equal(a, b) for a, b in zip(eager["state"], captured["state"]))
    print(f"Convolutional (default blueprint, {n_params} parameters), proposed, batch {BATCH} of "
          f"{CROP} px crops, f32: losses eager {eager['losses']} captured {captured['losses']}; "
          f"state tensors unequal {unequal} of {len(eager['state'])}; steady {eager['ms_per_step']:.2f} "
          f"ms/step eager, {captured['ms_per_step']:.2f} captured; peak {eager['peak_gib']:.3f} / "
          f"{captured['peak_gib']:.3f} GiB; {smi}")
    if (not captured["graphed"] or eager["losses"] != captured["losses"] or unequal
            or not np.all(np.isfinite(eager["losses"]))):
        fail("Convolutional: the captured step differs from the eager step")
    record = {"params": n_params, "losses": eager["losses"], "unequal": unequal,
              **{f"{k}_{'captured' if c else 'eager'}": runs[c][k]
                 for c in runs for k in ("ms_per_step", "peak_gib")}}
    del runs, eager, captured
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "gt")
        for i, im in enumerate(make_images(CLI_IMAGES, 2 * H, 2 * W, seed=2)):
            write_image(os.path.join(folder, f"{i:02d}.png"), im)
        arch = ["--ProposedModel__architecture", "Convolutional"]
        common = [*TASK_ARGS["deblurring"], "--noise_level", "5", "--dataset",
                  f"gt_folder:{folder}", *arch]
        out = os.path.join(tmp, "run")
        argv = [*common, "--method", "proposed", "--batch_size", str(BATCH), "--epochs", "1",
                "--out_dir", out]
        print(f"command line: python -m sei_tpu_torch.cli.train {' '.join(argv)}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            result = cli_train.main(argv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        losses = [float(v) for v in result["losses"]]
        del result
        weights = os.path.join(out, "weights.pt")
        test_argv = [*common, "--weights", weights, "--indices",
                     ",".join(map(str, CLI_TEST_INDICES))]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            got = cli_test.main(test_argv)
        torch.cuda.synchronize()
        test_ms = (time.perf_counter() - t0) * 1e3 / len(CLI_TEST_INDICES)
        model = get_model(architecture="Convolutional")
        model.load_weights(torch.load(weights, weights_only=False))
        gt = GroundTruthDataset(f"gt_folder:{folder}", split="val", memoize_gt=False)
        want = evaluate_pairs(model, [degraded_pair(physics, torch.as_tensor(
            gt[i], device=physics.device), image_seed(0, gt.unique_id(i)))
            for i in CLI_TEST_INDICES])
    print(f"  cli.train: {len(losses)} steps, losses {losses}, {train_s:.2f} s with the data, "
          f"warm-up and capture; cli.test on its weights.pt: PSNR {got.psnr} SSIM {got.ssim}, "
          f"{test_ms:.2f} ms/image with the reads; evaluate_pairs PSNR {want.psnr} SSIM "
          f"{want.ssim}; {smi}")
    if not np.all(np.isfinite(losses)) or (got.psnr, got.ssim) != (want.psnr, want.ssim):
        fail("Convolutional command lines: non-finite losses, or cli.test differs from "
             "evaluate_pairs")
    record.update(cli_losses=losses, cli_test_ms_per_image=test_ms, psnr=got.psnr)
    return record


def seeded_denoisers(folder: str) -> tuple[str, str]:
    """A DRUNet at the published widths under the published names
    (``drunet_color.pth``) and a DiffUNet at the JAX ``DiffUNetConfig``
    defaults (the FFHQ width) as a guided-diffusion checkpoint, both drawn
    from seed 0: every conv / linear weight N(0, 1 / fan in) and biases 0,
    a DRUNet block's second conv scaled by 0.1 so the 28 residual blocks do
    not compound, DiffUNet's GroupNorms 1 / 0 and its zero-initialised
    output convs drawn at 0.01 of that scale, so nothing is trivial."""
    import torch

    from sei_tpu_torch.models.diffunet import DiffUNet
    from sei_tpu_torch.models.drunet import DRUNet

    g = torch.Generator().manual_seed(0)

    def draw(net, small):
        with torch.no_grad():
            for name, m in net.named_modules():
                if isinstance(m, torch.nn.GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                                    torch.nn.Linear)):
                    std = (1.0 / m.weight[0].numel()) ** 0.5 * small(name)
                    m.weight.copy_(torch.randn(m.weight.shape, generator=g) * std)
                    if m.bias is not None:
                        m.bias.zero_()
        return net

    drunet = draw(DRUNet(), lambda n: 0.1 if n.endswith("res.2") else 1.0)
    unet = draw(DiffUNet(), lambda n: 0.01 if (n == "out.2" or n.endswith("out_layers.3")
                                               or n.endswith("proj_out")) else 1.0)
    paths = (os.path.join(folder, "drunet_color.pth"), os.path.join(folder, "diffunet.pt"))
    torch.save(drunet.state_dict(), paths[0])
    torch.save(unet.state_dict(), paths[1])
    return paths


def denoiser_baselines(smi: str) -> dict:
    """PlugAndPlay, DiffPIR_DRUNet, DPS and DiffPIR_DiffUNet through
    ``cli.test`` on one written 256x320 PNG (deblurring Gaussian_R2, noise
    5), the weights :func:`seeded_denoisers` writes handed over by
    ``SEI_DRUNET_WEIGHTS`` / ``SEI_DIFFUNET_WEIGHTS``: ms per image, peak
    memory, and the restoration finite and of the measurement's shape."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from sei_tpu_torch import models
    from sei_tpu_torch.cli import test as cli_test
    from sei_tpu_torch.data import write_image

    results = {}
    seen = []
    call = models.FunctionalModel.__call__

    def spy(self, y):
        out = call(self, y)
        seen.append((tuple(y.shape), tuple(out.shape), bool(torch.isfinite(out).all())))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "gt")
        write_image(os.path.join(folder, "0.png"), make_images(1, H, W, seed=7)[0])
        t0 = time.perf_counter()
        drunet, unet = seeded_denoisers(tmp)
        print(f"denoiser priors: seeded DRUNet and DiffUNet checkpoints written in "
              f"{time.perf_counter() - t0:.2f} s ({os.path.getsize(drunet) / 2**20:.1f} MiB, "
              f"{os.path.getsize(unet) / 2**20:.1f} MiB)")
        env = {"SEI_DRUNET_WEIGHTS": drunet, "SEI_DIFFUNET_WEIGHTS": unet}
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        models.FunctionalModel.__call__ = spy
        try:
            for kind in DENOISER_KINDS:
                argv = [*TASK_ARGS["deblurring"], "--noise_level", "5", "--dataset",
                        f"gt_folder:{folder}", "--GroundTruthDataset__no_resize",
                        "--model_kind", kind]
                seen.clear()
                with contextlib.redirect_stdout(io.StringIO()):
                    got, ms, peak, base = timed_call(lambda: cli_test.main(argv))
                results[kind] = {"ms": ms, "peak_gib": peak, "psnr": got.psnr[0],
                                 "ssim": got.ssim[0]}
                print(f"  python -m sei_tpu_torch.cli.test {' '.join(argv)}: {ms:.2f} ms per "
                      f"image with the read and the weights' load, peak {peak:.3f} GiB above "
                      f"{base:.3f}; PSNR {got.psnr[0]!r} SSIM {got.ssim[0]!r}; restored "
                      f"{seen}; {smi}")
                if seen != [((1, 3, H, W), (1, 3, H, W), True)] or not np.isfinite(got.psnr[0]):
                    fail(f"{kind}: the restoration is not finite or not of y's shape")
        finally:
            models.FunctionalModel.__call__ = call
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return results


def lpips_check(smi: str) -> float:
    """LPIPS on a seeded random AlexNet checkpoint: the card's distance of
    two seeded 256x320 images equals the CPU's to ``LPIPS_ATOL``."""
    import tempfile

    import torch

    from sei_tpu_torch.metrics.lpips import LPIPS

    g = torch.Generator().manual_seed(0)
    sd = {}
    for i, (idx, cout, cin, k) in enumerate(((0, 64, 3, 11), (3, 192, 64, 5), (6, 384, 192, 3),
                                             (8, 256, 384, 3), (10, 256, 256, 3))):
        sd[f"features.{idx}.weight"] = torch.randn(cout, cin, k, k, generator=g) * (
            1.0 / (cin * k * k)) ** 0.5
        sd[f"features.{idx}.bias"] = 0.1 * torch.randn(cout, generator=g)
        sd[f"lin{i}.model.1.weight"] = torch.rand(1, cout, 1, 1, generator=g)
    a, b = (torch.as_tensor(im) for im in make_images(2, H, W, seed=8))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "alexnet_lpips.pt")
        torch.save(sd, path)
        gpu, ms, _, _ = timed_call(lambda: LPIPS(path, "cuda")(a.cuda(), b.cuda()))
        cpu = LPIPS(path, "cpu")(a, b)
    print(f"LPIPS (seeded random AlexNet): card {gpu!r}, CPU {cpu!r}, |d| {abs(gpu - cpu):.3e} "
          f"(gate {LPIPS_ATOL:g}); {ms:.2f} ms with the load; {smi}")
    if not abs(gpu - cpu) <= LPIPS_ATOL:
        fail("LPIPS on the card differs from the CPU")
    return gpu


def baselines_phase(smi: str) -> None:
    """Slice 22: the strips over ranks, the training-free baselines, the
    Convolutional network, the denoiser priors and LPIPS (one JSON line of
    their numbers)."""
    t0 = time.perf_counter()
    strips_over_ranks(smi)
    record = {"functional": functional_baselines(smi), "convolutional": convolutional_phase(smi),
              "denoisers": denoiser_baselines(smi), "lpips": lpips_check(smi)}
    print(f"slice 22 baselines phase in {time.perf_counter() - t0:.1f} s: {json.dumps(record)}; "
          f"{smi}")


def dp_group():
    """This process as the one rank of an NCCL process group (file
    rendezvous in a temporary directory)."""
    import tempfile

    import torch

    from sei_tpu_torch import parallel

    tmp = tempfile.mkdtemp()
    return parallel.init(0, 1, os.path.join(tmp, "dist_init"), torch.device("cuda", 0))


def dp_train(dtype, scan_steps: int, eager: dict, dp, proposed_ms: float, smi: str) -> dict:
    """The data-parallel step (``Trainer(data_parallel=...)``, this process
    the one rank of an NCCL group) captured at ``scan_steps``: from the eager
    run's seed-0 weights and streams and for as many steps, each step's loss
    and the final parameters and Adam state must equal the one-process
    eager run's bit for bit (an all-reduce over one rank, divided by 1, is
    exact), with the design's launches per step; steady ms per step beside
    proposed's of this run, the all-reduce's device time in the profile of
    one replayed dispatch and timed alone (CUDA events).  Returns the
    launches (warm-up and capture) and the numbers."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from sei_tpu_torch.ops import swin_trunk as st
    from sei_tpu_torch.train import Trainer

    recipe = default_recipe(dtype, None, "deblurring")
    label = recipe.label
    per_block = PER_BLOCK_TRAIN_BF16 if dtype is not None else PER_BLOCK_TRAIN
    print(f"data-parallel training ({label}, scan_steps {scan_steps}): Trainer(data_parallel="
          f"rank 0 of {dp.world}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}), "
          f"captured")
    model, physics, cache, loss_fn, data_crop, kw = training_setup(recipe)
    trainer = Trainer(model, loss_fn, physics, cache, batch_size=BATCH, epochs=TRAIN_EPOCHS,
                      crop_size=data_crop, seed=0, scan_steps=scan_steps, data_parallel=dp, **kw)
    losses = []
    st.reset_launch_counts()
    stats = trainer.train(log_every_epoch=False, on_step=lambda s_, loss: losses.append(loss))
    torch.cuda.synchronize()
    counts = st.launch_counts()
    losses = [float(v) for v in losses]
    want = {k: v * BLOCKS * recipe.graphs * scan_steps for k, v in per_block.items()}
    got = train_state(trainer)
    unequal = sum(not torch.equal(a, b) for a, b in zip(got, eager["state"]))
    print(f"  {stats['steps']} steps in {trainer.replays} replays; losses {losses}; eager "
          f"one-process {eager['losses']}; state tensors unequal: {unequal} of {len(got)}; "
          f"launches captured {trainer.capture_launches}")
    if not trainer.graphed or trainer.capture_launches != want:
        fail(f"data parallel {label}: captured launches {trainer.capture_launches}, expected "
             f"{want}")
    if losses != eager["losses"] or unequal or len(got) != len(eager["state"]):
        fail(f"data parallel {label}: differs from the one-process run")
    steady = timed_dispatches(trainer)
    wall, device = profile_step(trainer.step, f"one replayed data-parallel {label} dispatch "
                                              f"({scan_steps} steps)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        trainer.step()
        torch.cuda.synchronize()
    # the all-reduce's device activity: NCCL's kernels, device-to-device copies
    in_graph = {e.key[:60]: (e.count, e.self_device_time_total / 1e3) for e in device_events(prof)
                if "nccl" in e.key.lower() or "DtoD" in e.key}
    flat = trainer.flat_grads
    alone = time_ms(lambda: dist.all_reduce(flat), iters=20, warmup=3)
    record = {"captured_ms": steady, "replay_device_ms": device / scan_steps,
              "replay_busy": device / wall, "proposed_ms": proposed_ms,
              "allreduce_in_graph": in_graph, "allreduce_alone_ms": alone,
              "flat_mb": flat.numel() * 4 / 1e6}
    print(f"  steady step {steady:.2f} ms captured (proposed one-process in this run "
          f"{proposed_ms:.2f}; PERF.md section 5: 199.55 f32 / 86.04 bf16); replay "
          f"{device / scan_steps:.2f} ms device per step (busy {device / wall:.3f}); "
          f"all-reduce of the flat buffer "
          f"({record['flat_mb']:.2f} MB) in the replayed graph {in_graph}, alone "
          f"{alone:.4f} ms (CUDA events, 20 calls); {smi}")
    return {"launches": counts, **record}


def cli_dp_run(folder: str, one: str, out: str) -> None:
    """``cli.train --data_parallel_devices 0`` (one rank in a process of its
    own, NCCL) with the flags of the f32 command-line run written to
    ``one``: its ``training.csv`` and final checkpoint (parameters, Adam
    state, streams' step) must equal the one-process run's bit for bit."""
    import torch

    from sei_tpu_torch.cli import train as cli_train

    argv = [*TASK_ARGS["deblurring"], "--noise_level", "5", "--dataset", f"gt_folder:{folder}",
            "--method", "proposed", "--batch_size", str(BATCH), "--epochs", "1", "--out_dir",
            out, "--scan_steps", "1", "--data_parallel_devices", "0"]
    print(f"command line (f32, data parallel): python -m sei_tpu_torch.cli.train "
          f"{' '.join(argv)}")
    t0 = time.perf_counter()
    if cli_train.main(argv) is not None:
        fail("cli.train --data_parallel_devices: main returned a result in the parent")
    seconds = time.perf_counter() - t0
    rows = [open(os.path.join(d, "training.csv")).read() for d in (one, out)]
    ckp = [torch.load(os.path.join(d, "checkpoints", "ckp_1.pt"), map_location="cpu",
                      weights_only=False) for d in (one, out)]
    params = sum(not torch.equal(v, ckp[1]["params"][k]) for k, v in ckp[0]["params"].items())
    opt = [v for st_ in ckp[0]["optimizer"]["state"].values() for v in st_.values()]
    opt_dp = [v for st_ in ckp[1]["optimizer"]["state"].values() for v in st_.values()]
    unequal = sum(not torch.equal(a, b) for a, b in zip(opt, opt_dp))
    print(f"  {seconds:.2f} s with the process start, the data, the warm-up and the capture; "
          f"training.csv {rows[1].split()[1:]} vs one process {rows[0].split()[1:]}; unequal "
          f"parameter tensors {params}, Adam state tensors {unequal} of {len(opt)}")
    if rows[0] != rows[1] or params or unequal or len(opt) != len(opt_dp) or (
            ckp[0]["step"] != ckp[1]["step"]):
        fail("cli.train --data_parallel_devices 0 differs from the one-process command line")


def cli_phase(smi: str) -> None:
    """The command lines on the card: PNGs written by the port's writer
    into a temporary ``gt_folder:``, the training command line in f32 and in
    bf16 (``--scan_steps 2``), each held against a directly built Trainer,
    and the test command line on each run's ``weights.pt``."""
    import tempfile

    import torch

    from sei_tpu_torch.data import write_image

    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "gt")
        t0 = time.perf_counter()
        for i, im in enumerate(make_images(CLI_IMAGES, 2 * H, 2 * W, seed=2)):
            write_image(os.path.join(folder, f"{i:02d}.png"), im)
        print(f"command lines: {CLI_IMAGES} PNGs {2 * H}x{2 * W} written in "
              f"{time.perf_counter() - t0:.2f} s")
        for dtype, scan_steps in ((None, 1), (torch.bfloat16, 2)):
            out = os.path.join(tmp, "f32" if dtype is None else "bf16")
            cli_train_run(folder, out, dtype, scan_steps, smi)
            cli_test_run(folder, os.path.join(out, "weights.pt"))
        cli_validate_run(folder, os.path.join(tmp, "r2r_val"), smi)
        cli_dp_run(folder, os.path.join(tmp, "f32"), os.path.join(tmp, "dp"))


def clip_check(trainer, label: str) -> None:
    """A trainer with ``clip_norm``: its last step's gradient norm before the
    clip must lie above the bound, and the global norm of the gradients the
    optimizer received (each ``.grad`` after the step) must equal the bound
    to CLIP_RTOL, so the clip acted."""
    if trainer.clip_norm is None:
        return
    import torch

    norm = float(trainer.grad_norm)
    grads = [p.grad for p in trainer.model.module.parameters() if p.grad is not None]
    after = float(torch.linalg.vector_norm(torch.stack([g.double().norm() for g in grads])))
    rel = abs(after - trainer.clip_norm) / trainer.clip_norm
    print(f"  {label}: global gradient norm of the last step {norm!r} before the clip, "
          f"{after!r} after it, against clip_norm {trainer.clip_norm:g} (relative "
          f"difference {rel:.3e}, gate {CLIP_RTOL:g})")
    if not norm >= trainer.clip_norm:
        fail(f"{label}: the gradient norm {norm} is below clip_norm, so the clip did nothing")
    if not rel <= CLIP_RTOL:
        fail(f"{label}: the clipped gradients' norm {after} is not clip_norm "
             f"{trainer.clip_norm}")


def check_module_attention(timed: bool) -> dict:
    """The module path's own attention calls in bf16 (``SwinIR(dtype=
    bfloat16, fused_trunk=False)``: q scaled by the Linear's output, k and v
    strided views of it; the forward with no p store, the backward
    recomputing p), against their plain versions and SDPA (forward; its
    autograd backward), at the eval shape (one 256x320 image, T = 81920:
    forward only, listed) and the 2B training graph (T = 36864: the
    per-block sums), both masks; bounds at the bf16 peak."""
    import torch
    import torch.nn.functional as F

    from sei_tpu_torch.models.swinir import shift_attn_mask
    from sei_tpu_torch.ops import attention as at

    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    rows = {}

    def nb(*tensors):
        return float(sum(t.numel() * t.element_size() for t in tensors))

    def record(kernel, variant, errs, fn_k, fn_p, fn_lib, flops, nbytes, per_block):
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        r = {"variant": variant, "max_abs_err": max(errs), "bound_ms": b_ms, "bound_by": b_by,
             "flops": flops, "bytes": nbytes, "per_block": per_block}
        if timed:
            r["ms"], r["queued_ms"], r["plain_ms"] = time_ms(fn_k), queued_ms(fn_k), time_ms(fn_p)
            r.update(library_times(fn_lib))
            print(f"    {kernel}[bf16 module path {variant}]: kernel {r['ms']:.4f} ms (queued "
                  f"{r['queued_ms']:.4f}), plain {r['plain_ms']:.4f} ms, {fmt_library(r)}, bound "
                  f"{b_ms:.4f} ms ({b_by}), {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB")
        rows.setdefault(kernel, []).append(r)

    scale = float(torch.tensor(HD ** -0.5).to(bf))  # rounded to bf16 first, as the module does
    for label, b, h, w, backward in (("eval", B, H, W, False),
                                     ("train", TRAIN_GRAPHS[0], CROP, CROP, True)):
        t = b * h * w
        b_ = t // N
        print(f"module-path attention checks ({label}): {b} image(s) {h}x{w}, T={t}, {b_} windows, "
              f"bf16 (tolerance on bf16 outputs |d| <= {BF16_RTOL:g}*(|plain| + max|plain|))")
        qkv = (torch.randn((b_, N, 3 * C), generator=g, device="cuda")).to(bf)
        parts = qkv.reshape(b_, N, 3, NH, HD).permute(2, 0, 3, 1, 4)
        q, k, v = parts[0] * scale, parts[1], parts[2]
        do = (torch.randn((b_, NH, N, HD), generator=g, device="cuda") * 0.1).to(bf)
        bias = torch.randn((NH, N, N), generator=g, device="cuda") * 0.1
        mask = torch.from_numpy(shift_attn_mask(h, w, WS, WS // 2)).cuda()
        for variant, m in (("no_mask", None), ("shift_mask", mask)):
            tag = f"{variant} T={t}"
            full = (bias[None] if m is None else
                    (bias[None] + m[:, None]).repeat(b_ // m.shape[0], 1, 1, 1)).expand(
                        b_, NH, N, N).to(bf)
            got = at.window_attn_fwd(q, k, v, bias, m)
            errs = [compare_bf16(f"window_attn_fwd[bf16 module path {tag}]", got,
                                 at._torch_attention(q, k, v, bias, m), (1e-4, 1e-4))]
            record("window_attn_fwd", tag, errs,
                   lambda m=m: at.window_attn_fwd(q, k, v, bias, m),
                   lambda m=m: at._torch_attention(q, k, v, bias, m),
                   lambda full=full: F.scaled_dot_product_attention(q, k, v, attn_mask=full,
                                                                    scale=1.0),
                   4.0 * b_ * NH * N * N * HD,
                   nb(q, k, v, got, bias) + (nb(m) if m is not None else 0.0),
                   1 if backward else 0)
            if not backward:
                continue
            outs = at.window_attn_bwd(q, k, v, bias, m, do)
            errs = [compare_bf16(f"window_attn_bwd[bf16 module path {tag}][{i}]", a, b2,
                                 (1e-4, 1e-4))
                    for i, (a, b2) in enumerate(zip(outs, at._torch_attention_bwd(
                        q, k, v, bias, m, do)))]
            ql, kl, vl = (u.detach().clone().requires_grad_() for u in (q, k, v))
            out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=full, scale=1.0)
            record("window_attn_bwd", tag, errs,
                   lambda m=m: at.window_attn_bwd(q, k, v, bias, m, do),
                   lambda m=m: at._torch_attention_bwd(q, k, v, bias, m, do),
                   lambda out=out, ql=ql, kl=kl, vl=vl: torch.autograd.grad(
                       out, (ql, kl, vl), do, retain_graph=True),
                   10.0 * b_ * NH * N * N * HD,
                   nb(q, k, v, do, *outs[:3]) + 4.0 * NH * N * N * 2
                   + (nb(m) if m is not None else 0.0), 1)
            del outs, ql, kl, vl, out
        del qkv, parts, q, k, v, do, got
    return rows


def check_gelu_forms(timed: bool) -> dict:
    """The GELU epilogues in the form that is not their dtype's default
    (``SEI_FAST_GELU``): the f32 CUDA-core kernel with the polynomial
    (``gelu`` at the eval shape, T = 81920, K3's fc1 call; ``gelu_pair``
    with an f32 gp at T = 36864, K4's recompute) and the bf16 ``mma.sync``
    kernel with the exact erf (``gelu``, ``gelu_pair`` with a bf16 gp, K5's
    save, and with an f32 gp, at T = 36864), each against its plain version
    in the same form at the gates of the default form's checks; timed beside
    the default form on the same inputs (``default_form_queued_ms``), with
    the bound and ``torch.addmm``.  Returns rows by kernel-line entry."""
    import torch

    from sei_tpu_torch.ops import swin_trunk as st

    g = torch.Generator(device="cuda").manual_seed(17)
    bf, f32 = torch.bfloat16, torch.float32
    t_step = TRAIN_GRAPHS[0] * CROP * CROP
    fast_entry, exact_entry = SOURCES_FORMS
    rows = {}
    print("GELU form checks (SEI_FAST_GELU: f32 with the polynomial, bf16 with the exact erf)")
    for entry, dtype, variant, t, epi, gp_dtype, per_block in (
            (fast_entry, f32, "fc1_gelu", T, "gelu", None, 1),
            (fast_entry, f32, "fc1_gelu_pair", t_step, "gelu_pair", f32, 0),
            (exact_entry, bf, "fc1_gelu_pair", t_step, "gelu_pair", bf, 1),
            (exact_entry, bf, "fc1_gelu", t_step, "gelu", None, 0),
            (exact_entry, bf, "fc1_gelu_pair_f32", t_step, "gelu_pair", f32, 0)):
        fast = dtype == f32
        tag = f"{'f32' if fast else 'bf16'} {'fast' if fast else 'exact'} {variant} T={t}"
        a = torch.randn((t, C), generator=g, device="cuda").to(dtype)
        w = (torch.randn((C, CH), generator=g, device="cuda") * 0.05).to(dtype)
        b = torch.randn(CH, generator=g, device="cuda") * 0.05
        gp, gp_p, gp_d = ((torch.empty(t, CH, device="cuda", dtype=gp_dtype) for _ in range(3))
                          if gp_dtype is not None else (None, None, None))
        got = st.gemm_bias_epilogue(a, w, b, epi, gp=gp, fast_gelu=fast)
        want = st._torch_gemm_bias_epilogue(a, w, b, epi, gp=gp_p, fast_gelu=fast)
        pairs = [(got, want)] + ([(gp, gp_p)] if gp is not None else [])
        errs = [compare_bf16(f"gemm_bias_epilogue[{tag}][{i}]", x, y, (1e-4, 1e-4))
                for i, (x, y) in enumerate(pairs)]
        default = st.gemm_bias_epilogue(a, w, b, epi, gp=gp_d, fast_gelu=not fast)
        torch.cuda.synchronize()
        moved = float((got.float() - default.float()).abs().max())
        print(f"    {tag}: max |d| from the default form's output {moved:.3e}")
        nbytes = float(sum(x.numel() * x.element_size() for x in (a, w, b, got))
                       + (gp.numel() * gp.element_size() if gp is not None else 0))
        flops = 2.0 * t * C * CH
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_FP32_FLOPS if fast else PEAK_BF16_FLOPS)
        r = {"variant": f"{variant} T={t}", "max_abs_err": max(errs), "bound_ms": b_ms,
             "bound_by": b_by, "flops": flops, "bytes": nbytes, "per_block": per_block}
        if timed:
            b_lib = b if fast else b.to(bf)
            r["ms"] = time_ms(lambda: st.gemm_bias_epilogue(a, w, b, epi, gp=gp, fast_gelu=fast))
            r["queued_ms"] = queued_ms(
                lambda: st.gemm_bias_epilogue(a, w, b, epi, gp=gp, fast_gelu=fast))
            r["default_form_queued_ms"] = queued_ms(
                lambda: st.gemm_bias_epilogue(a, w, b, epi, gp=gp_d, fast_gelu=not fast))
            r["plain_ms"] = time_ms(
                lambda: st._torch_gemm_bias_epilogue(a, w, b, epi, gp=gp_p, fast_gelu=fast))
            r.update(library_times(lambda: torch.addmm(b_lib, a, w)))
            print(f"    gemm_bias_epilogue[{tag}]: kernel {r['ms']:.4f} ms (queued "
                  f"{r['queued_ms']:.4f}; the default form {r['default_form_queued_ms']:.4f} "
                  f"queued), plain {r['plain_ms']:.4f} ms, {fmt_library(r)}, bound {b_ms:.4f} ms "
                  f"({b_by}), {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB")
        rows.setdefault(entry, []).append(r)
        del a, w, got, want, default, gp, gp_p, gp_d
    return rows


def module_eval(smi: str) -> dict:
    """The module path (``fused_trunk=False``) on the eval path: flagship
    SwinIR (weights from seed 0) through ``evaluate`` on the 4 seeded
    256x320 images, f32 and bf16; the attention forward's launches (36 per
    forward, nothing of the trunk); one forward against ``forward(plain=
    True)`` (f32 FORWARD_ATOL, bf16 FORWARD_FRAC_BF16 of max |plain|); ms
    per image and forward ms beside the fused path's on the same weights.
    Returns the launches by run."""
    import numpy as np
    import torch

    from sei_tpu_torch.evaluate import evaluate
    from sei_tpu_torch.ops import swin_trunk as st

    images = make_images(N_IMAGES, H, W, seed=0)
    physics = task_physics("deblurring")
    total = {}
    want = {k: 0 for k in PORT_KERNELS} | {"window_attn_fwd": BLOCKS * N_IMAGES}
    for dtype in (None, torch.bfloat16):
        label = "bf16" if dtype is not None else "f32"
        print(f"module path eval ({label}): get_model(fused_trunk=False) -> evaluate "
              f"({N_IMAGES} images {H}x{W}, flagship SwinIR, deblurring Gaussian_R2, noise 5)")
        times = {}
        for path, fused in (("module", False), ("fused", True)):
            model = task_model("deblurring", dtype, fused_trunk=fused)
            evaluate(model, physics, images[:1])  # warm-up: cuDNN, cuBLAS, masks
            torch.cuda.synchronize()
            st.reset_launch_counts()
            t0 = time.perf_counter()
            result = evaluate(model, physics, images)
            torch.cuda.synchronize()
            times[path] = (time.perf_counter() - t0) * 1e3 / N_IMAGES
            counts = st.launch_counts()
            y = physics.randomly_degrade(torch.as_tensor(images[0], device=physics.device)[None],
                                         0)
            with torch.no_grad():
                times[path + " forward"] = time_ms(lambda: model(y), iters=3, warmup=1)
            if fused:
                continue
            total[f"eval module path {label}"] = counts
            print(f"  launch counts {counts}")
            if counts != want:
                fail(f"module path {label}: launches {counts} over {N_IMAGES} images, "
                     f"expected {want}")
            if not all(np.isfinite(result.psnr)) or not all(0 < p < 100 for p in result.psnr):
                fail(f"module path {label}: PSNR out of range {result.psnr}")
            print(f"  PSNR {result.psnr} SSIM {result.ssim}; mean {result.psnr_mean!r} / "
                  f"{result.ssim_mean!r}")
            with torch.no_grad():
                out_k, out_p = model(y), model.module(y, plain=True)
                times["plain forward"] = time_ms(lambda: model.module(y, plain=True), iters=3,
                                                 warmup=1)
            if dtype is None:
                compare(f"module path {label} forward (kernels vs plain)", out_k, out_p,
                        FORWARD_ATOL, 0.0)
            else:
                err = float((out_k - out_p).abs().max())
                tol = FORWARD_FRAC_BF16 * float(out_p.abs().max())
                print(f"  module path {label} forward (kernels vs plain): max |diff| {err:.3e} "
                      f"(tolerance {tol:.3e} = {FORWARD_FRAC_BF16:g} of max |plain|)")
                if not err <= tol:
                    fail(f"module path {label}: the forward disagrees with the plain forward")
            profile_forward(model, y)
            del model, out_k, out_p
        print(f"  module path {label}: {times['module']:.2f} ms/image, forward "
              f"{times['module forward']:.2f} ms (plain {times['plain forward']:.2f}); fused "
              f"path {times['fused']:.2f} ms/image, forward {times['fused forward']:.2f} ms; "
              f"{smi}")
    return total


def module_path_phase(smi: str, proposed_ms: dict) -> dict:
    """ROADMAP Queue 1 item 7 on the card: :func:`module_eval`; then two
    ``proposed`` steps on the module path in bf16 (batch 8, 48 px crops)
    eagerly, the first step's gradients against autograd through the plain
    path (TRUNK_GRAD_FRAC of each max), then captured at ``scan_steps`` 2,
    equal to the eager run bit for bit, with the attention kernels' launches
    per step (36 forward and 36 backward per graph, none of the trunk's);
    then the global-norm clip (``clip_norm``) on the fused bf16 step, eager
    then captured at 2, equal bit for bit, its norm above the bound before
    the clip and equal to it after.
    Returns the launches by run."""
    import torch

    total = module_eval(smi)
    module = Recipe("bf16 module path", dtype=torch.bfloat16, fused_trunk=False, epochs=1,
                    per_block=PER_BLOCK_MODULE, grad_check=True, grad_tol=TRUNK_GRAD_FRAC)
    clip = Recipe("bf16 clip", dtype=torch.bfloat16, epochs=1,
                  trainer={"clip_norm": CLIP_NORM})
    for recipe in (module, clip):
        counts, trainer, eager = train_path(recipe=recipe)
        del trainer
        captured, steady = captured_train(recipe.dtype, 2, eager, recipe=recipe)
        add_counts(total.setdefault("train " + recipe.label, {}), counts)
        add_counts(total["train " + recipe.label], captured)
        print(f"  {recipe.label} captured at scan_steps 2: {steady:.2f} ms/step = "
              f"{BATCH * 1e3 / steady:.3f} img/s; the fused bf16 step (SURE) in this run "
              f"{proposed_ms['bf16', 2]:.2f} ms/step; {smi}")
    print(f"module path and clip launches by run: {json.dumps(total)}")
    return total


def set_env(name: str, value: Optional[str]) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


@contextlib.contextmanager
def env_var(name: str, value: Optional[str]):
    """``os.environ[name] = value`` inside the block (None: unset), restored
    after it."""
    before = os.environ.get(name)
    set_env(name, value)
    try:
        yield
    finally:
        set_env(name, before)


def fast_gelu_eval(smi: str) -> dict:
    """The flagship f32 eval (4 seeded 256x320 images) with
    ``SEI_FAST_GELU=1`` (the polynomial GELU in the f32 trunk), beside the
    default (exact) model on the same weights: the launches (the trunk's,
    every GELU launch in the polynomial form), one forward against
    ``forward(plain=True)`` (FORWARD_ATOL), its max difference from the
    default forward, PSNR/SSIM and ms per image of both.  Returns the GELU
    launches by form over the knob's eval."""
    import numpy as np
    import torch

    from sei_tpu_torch.evaluate import evaluate
    from sei_tpu_torch.ops import swin_trunk as st

    images = make_images(N_IMAGES, H, W, seed=0)
    physics = task_physics("deblurring")
    y = physics.randomly_degrade(torch.as_tensor(images[0], device="cuda")[None], 0)
    want = {k: v * BLOCKS * N_IMAGES for k, v in PER_BLOCK.items()}
    runs, outs, gelu = {}, {}, {}
    for label, env in (("default", None), ("SEI_FAST_GELU=1", "1")):
        with env_var("SEI_FAST_GELU", env):
            model = task_model("deblurring")
        if model.module.fast_gelu is not (env == "1"):
            fail(f"f32 eval {label}: SwinIR took fast_gelu={model.module.fast_gelu}")
        evaluate(model, physics, images[:1])
        torch.cuda.synchronize()
        st.reset_launch_counts()
        t0 = time.perf_counter()
        result = evaluate(model, physics, images)
        torch.cuda.synchronize()
        runs[label] = (result, (time.perf_counter() - t0) * 1e3 / N_IMAGES)
        counts, gelu[label] = st.launch_counts(), st.gelu_launch_counts()
        form = "fast" if env == "1" else "exact"
        if {k: counts[k] for k in want} != want or gelu[label][form] != BLOCKS * N_IMAGES:
            fail(f"f32 eval {label}: launches {counts}, GELU launches by form {gelu[label]}, "
                 f"expected {want} and {BLOCKS * N_IMAGES} {form}")
        if not all(np.isfinite(result.psnr)) or not all(0 < p < 100 for p in result.psnr):
            fail(f"f32 eval {label}: PSNR out of range {result.psnr}")
        with torch.no_grad():
            outs[label] = model(y)
            if env == "1":
                compare("f32 forward with SEI_FAST_GELU=1 (kernels vs plain)", outs[label],
                        model.module(y, plain=True), FORWARD_ATOL, 0.0)
                fwd_ms = time_ms(lambda: model(y), iters=3, warmup=1)
        del model
    moved = float((outs["default"] - outs["SEI_FAST_GELU=1"]).abs().max())
    print(f"  f32 eval: SEI_FAST_GELU=1 against the default (exact) forward: max |d| {moved:.3e}; "
          f"forward {fwd_ms:.2f} ms; launches {want}, GELU by form {gelu}")
    for label, (result, ms) in runs.items():
        print(f"  f32 eval {label}: PSNR {result.psnr} SSIM {result.ssim}; mean "
              f"{result.psnr_mean!r} / {result.ssim_mean!r}; {ms:.2f} ms/image; {smi}")
    return gelu["SEI_FAST_GELU=1"]


def fast_gelu_phase(smi: str, proposed_ms: dict) -> dict:
    """``SEI_FAST_GELU`` (ROADMAP Queue 1's last item) on the card: the f32
    eval with the polynomial (:func:`fast_gelu_eval`); two ``proposed``
    steps in f32 with ``SEI_FAST_GELU=1`` and two in bf16 with
    ``SEI_FAST_GELU=0`` (batch 8, 48 px crops), each eagerly with the first
    step's gradients against the plain path (f32 GRAD_RTOL, bf16
    TRUNK_GRAD_FRAC of each max) and the design's launches, then captured
    (f32 at ``scan_steps`` 1, bf16 at 2) and equal to the eager run bit for
    bit, every GELU launch in the knob's form; ms per step beside the
    default's; then the module path (``fused_trunk=False``), whose exact
    GELU the knob does not touch: its forward with the knob equals the one
    without, bit for bit, in f32 and bf16.  Returns the knob's GELU launches
    by kernel-line entry (the eval's and the training runs', warm-up and
    capture included)."""
    import torch

    fast_entry, exact_entry = SOURCES_FORMS
    launches = {fast_entry: fast_gelu_eval(smi)["fast"], exact_entry: 0}
    for dtype, env, scan_steps, entry in ((None, "1", 1, fast_entry),
                                          (torch.bfloat16, "0", 2, exact_entry)):
        label = ("bf16" if dtype is not None else "f32") + f" SEI_FAST_GELU={env}"
        recipe = Recipe(label, dtype=dtype, epochs=1, grad_check=True,
                        grad_tol=TRUNK_GRAD_FRAC if dtype is not None else GRAD_RTOL)
        form = "fast" if env == "1" else "exact"
        record = {}
        with env_var("SEI_FAST_GELU", env):
            _, trainer, eager = train_path(recipe=recipe)
            if trainer.model.module.fast_gelu is not (env == "1"):
                fail(f"{label}: SwinIR took fast_gelu={trainer.model.module.fast_gelu}")
            del trainer
            _, steady = captured_train(dtype, scan_steps, eager, recipe=recipe, record=record)
        for run, counts in (("eager", eager["gelu_launches"]), ("captured", record["gelu_launches"])):
            if counts[form] == 0 or sum(counts.values()) != counts[form]:
                fail(f"{label} {run}: GELU launches by form {counts}, all expected {form}")
            launches[entry] += counts[form]
        default = proposed_ms["bf16" if dtype is not None else "f32", scan_steps]
        print(f"  {label} captured at scan_steps {scan_steps}: {steady:.2f} ms/step = "
              f"{BATCH * 1e3 / steady:.3f} img/s; the default form in this run {default:.2f} "
              f"ms/step; {smi}")

    images = make_images(1, H, W, seed=0)
    physics = task_physics("deblurring")
    y = physics.randomly_degrade(torch.as_tensor(images[0], device="cuda")[None], 0)
    for dtype, env in ((None, "1"), (torch.bfloat16, "0")):
        outs = []
        for value in (None, env):
            with env_var("SEI_FAST_GELU", value):
                model = task_model("deblurring", dtype, fused_trunk=False)
            with torch.no_grad():
                outs.append(model(y))
            del model
        torch.cuda.synchronize()
        same = torch.equal(*outs)
        label = "bf16" if dtype is not None else "f32"
        print(f"  module path {label}: forward with SEI_FAST_GELU={env} equal to the forward "
              f"without it, bit for bit: {same} -> {'ok' if same else 'FAIL'}")
        if not same:
            fail(f"SEI_FAST_GELU moved the {label} module path")
    print(f"SEI_FAST_GELU launches by kernel-line entry: {json.dumps(launches)}")
    return launches


def write_filtered_png(path: str, arr) -> None:
    """An 8-bit RGB PNG of ``arr`` (H, W, 3) uint8 whose rows take the five
    row filters in turn, as Pillow's adaptive filtering mixes them."""
    import struct
    import zlib

    import numpy as np

    h, w, c = arr.shape
    x = arr.astype(np.int16)
    a, b, cc = (np.zeros_like(x) for _ in range(3))  # left, up, up-left
    a[:, 1:], b[1:], cc[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = np.arange(h) % 5
    out = rows[:, 1:].reshape(h, w, c)
    for kind in range(5):  # rows kind, kind + 5, ...: that filter
        r = slice(kind, None, 5)
        xa, xb, xc = a[r], b[r], cc[r]
        if kind == 4:
            p = xa + xb - xc
            pa, pb, pc = np.abs(p - xa), np.abs(p - xb), np.abs(p - xc)
            pred = np.where((pa <= pb) & (pa <= pc), xa, np.where(pb <= pc, xb, xc))
        else:
            pred = (0, xa, xb, (xa + xb) >> 1)[kind]
        out[r] = (x[r] - pred) & 0xFF

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def loader_phase(smi: str) -> None:
    """The native PNG loader on the card's host: 8 seeded 1356x2040 PNGs
    (Div2K's shape, rows filtered by all five filters) through
    ``GroundTruthDataset.load_all`` (the native loader on its threads) and
    by the numpy codec (``read_image`` one file after another, then
    ``resize_shorter_side_np``), without a resize (equal bit for bit) and at
    the dataset's shorter side 256 (within 1e-6; the numpy path's resize of
    its decoded images timed apart and added to its decode); seconds and
    images per second of each, the threads and the host's CPUs."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from sei_tpu_torch.data import GroundTruthDataset, native, read_image
    from sei_tpu_torch.ops.resize import resize_shorter_side_np

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rng = np.random.default_rng(4)
        arrays = []
        # dead leaves at a quarter of the size, each pixel repeated 4x4, plus
        # noise: something for every filter to predict
        for im in make_images(LOADER_IMAGES, TILED_H // 4, TILED_W // 4, seed=4):
            im = im.repeat(4, axis=1).repeat(4, axis=2).transpose(1, 2, 0)
            noise = rng.integers(-8, 9, im.shape)
            arrays.append(np.clip(im * 255.0 + noise + 0.5, 0, 255).astype(np.uint8))
        with ThreadPoolExecutor(LOADER_IMAGES) as pool:  # zlib releases the GIL
            list(pool.map(lambda i: write_filtered_png(os.path.join(tmp, f"{i:04d}.png"),
                                                       arrays[i]), range(LOADER_IMAGES)))
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        native.library()
        t_build = time.perf_counter() - t0
        threads = min(LOADER_THREADS, LOADER_IMAGES)
        print(f"native PNG loader: {LOADER_IMAGES} PNGs {TILED_H}x{TILED_W} (five row filters) "
              f"written in {t_write:.2f} s; library built or loaded in {t_build:.2f} s; "
              f"load_all(n_threads={LOADER_THREADS}): {threads} threads on a host of "
              f"{os.cpu_count()} CPUs")
        result = {"threads": threads, "cpus": os.cpu_count()}
        runs = {}
        for size in (None, 256):
            ds = GroundTruthDataset(f"gt_folder:{tmp}", size=size)
            t0 = time.perf_counter()
            runs["native", size] = ds.load_all(n_threads=LOADER_THREADS)
            runs["native", size, "s"] = time.perf_counter() - t0
        # the numpy path: read_image of each file, then resize_shorter_side_np
        # at size 256, timed apart on the same decoded images
        t0 = time.perf_counter()
        runs["numpy", None] = [read_image(ds.source.path(i)) for i in range(len(ds))]
        runs["numpy", None, "s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs["numpy", 256] = [resize_shorter_side_np(x, 256) for x in runs["numpy", None]]
        runs["numpy", 256, "s"] = runs["numpy", None, "s"] + time.perf_counter() - t0
        for size in (None, 256):
            pairs = list(zip(runs["native", size], runs["numpy", size]))
            if len(pairs) != LOADER_IMAGES or any(a.shape != b.shape or a.dtype != b.dtype
                                                  for a, b in pairs):
                fail(f"native loader, size {size}: shapes or dtypes differ from the numpy path")
            err = max(float(np.abs(a - b).max()) for a, b in pairs)
            same = all(np.array_equal(a, b) for a, b in pairs)
            ok = same if size is None else err <= LOADER_RESIZE_ATOL
            key = "decode" if size is None else f"decode + resize to {size}"
            t_nat, t_np = runs["native", size, "s"], runs["numpy", size, "s"]
            result[key] = {"native_s": t_nat, "numpy_s": t_np,
                           "native_img_per_s": LOADER_IMAGES / t_nat,
                           "numpy_img_per_s": LOADER_IMAGES / t_np,
                           "bit_for_bit": same, "max_abs_diff": err,
                           "shape": list(runs["native", size][0].shape)}
            print(f"  {key}: native {t_nat:.3f} s ({LOADER_IMAGES / t_nat:.2f} img/s), numpy "
                  f"{t_np:.3f} s ({LOADER_IMAGES / t_np:.2f} img/s), {t_np / t_nat:.1f}x; bit for "
                  f"bit {same}, max |d| {err:.3e} (gate: "
                  f"{'equal' if size is None else f'<= {LOADER_RESIZE_ATOL:g}'}) -> "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"native loader, size {size}: disagrees with the numpy path")
        print(f"native loader: {json.dumps(result)}; {smi}")


def bench_line() -> str:
    """``python -m sei_tpu_torch.bench``'s line (a subprocess on this card)."""
    out = subprocess.run([sys.executable, "-m", "sei_tpu_torch.bench"], check=True,
                         capture_output=True, text=True, timeout=900)
    line = out.stdout.strip().splitlines()[-1]
    json.loads(line)
    return line


SOURCES = {
    "ln_rows": ("sei_tpu_torch/ops/csrc/ln_rows.cu", "sei_tpu/ops/swin_trunk.py:931"),
    "gemm_bias_epilogue": ("sei_tpu_torch/ops/csrc/gemm_bias_epilogue.cu",
                           "sei_tpu/ops/swin_trunk.py:931"),
    "window_attn_fwd": ("sei_tpu_torch/ops/csrc/window_attn_fwd.cu", "sei_tpu/ops/attention.py:65"),
    "window_attn_bwd": ("sei_tpu_torch/ops/csrc/window_attn_bwd.cu",
                        "sei_tpu/ops/attention.py:117"),
    "ln_rows_bwd": ("sei_tpu_torch/ops/csrc/ln_rows_bwd.cu", "sei_tpu/ops/swin_trunk.py:979"),
    "gemm_dgrad": ("sei_tpu_torch/ops/csrc/gemm_bwd.cu", "sei_tpu/ops/swin_trunk.py:979"),
    "gemm_wgrad": ("sei_tpu_torch/ops/csrc/gemm_bwd.cu", "sei_tpu/ops/swin_trunk.py:979"),
}
# K8 and K9: the launch-overhead probes; their JSON entries are those of the
# probes' main configuration (bf16 as the TPU probes ran; the copy on all
# 132 SMs, the skeleton with the staged body v_d), every variant listed
SOURCES_PROBES = {
    "copy_probe": ("sei_tpu_torch/ops/csrc/launch_probe.cu", "experiments/perf_probe_r3q.py:52",
                   "bf16 1056 blocks"),
    "trunk_skeleton": ("sei_tpu_torch/ops/csrc/launch_probe.cu",
                       "experiments/perf_probe_r3s.py:136", "bf16 v_d"),
}
# the GELU epilogues in the other form (SEI_FAST_GELU) replace the trunk
# kernel's fc1 in that form: the f32 eval forward's (K3) and the bf16
# step's save (K5)
SOURCES_FORMS = {name: ("sei_tpu_torch/ops/csrc/gemm_bias_epilogue.cu",
                        "sei_tpu/ops/swin_trunk.py:931")
                 for name in ("gemm_bias_epilogue[fast gelu]",
                              "gemm_bias_epilogue[bf16 exact gelu]")}
# the module path's attention calls replace the JAX attention kernel's
# forward and backward (K1, K2), the path's only TPU kernels
SOURCES_MODULE = {name: SOURCES[name] for name in ("window_attn_fwd", "window_attn_bwd")}
# the bf16 instantiations replace the trunk kernel's mode "full" forward (K5)
# and saved-tensor backward (K7), attention included
SOURCES_BF16 = {name: (src, "sei_tpu/ops/swin_trunk.py:979" if name in (
    "window_attn_bwd", "ln_rows_bwd", "gemm_dgrad", "gemm_wgrad") else "sei_tpu/ops/swin_trunk.py:931")
    for name, (src, _) in SOURCES.items()}


# how each kernel computes: the bf16 GEMMs (weight grad, forward, data
# grad) and the bf16 attention forward and backward on the tensor cores,
# every other kernel on the CUDA cores
DESIGNS = {"gemm_wgrad[bf16]": "mma.sync bf16, f32 acc",
           "window_attn_bwd[bf16]": "mma.sync bf16, f32 acc, 4 warps of 16 rows per head, "
                                    "dS from the accumulators into dQ's A fragments, "
                                    "ldmatrix.trans for P^T and dS^T, three cp.async stages",
           "window_attn_fwd[bf16]": "mma.sync bf16, f32 acc, 4 warps of 16 rows per head, "
                                    "softmax in the accumulators, p packed into P.V's A "
                                    "fragments, ldmatrix.trans for V, p out through a shared "
                                    "tile, cp.async stage ring",
           "ln_rows_bwd[bf16]": "cuda-core fma, 4 channels per access, a row to a group of "
                                "lanes, a cp.async ring of rows per warp in shared memory, "
                                "dgamma/dbeta summed on the device in block order",
           "gemm_bias_epilogue[bf16]": "mma.sync bf16, f32 acc",
           "gemm_dgrad[bf16]": "mma.sync bf16, f32 acc",
           "gemm_bias_epilogue": "cuda-core fma, 8x6 register tiles, cp.async",
           "gemm_dgrad": "cuda-core fma, 8x6 register tiles, operands transposed through registers",
           "gemm_wgrad": "cuda-core fma, 8x6 register tiles, A by cp.async, dy gathered through "
                         "registers, splits from the kernel's occupancy",
           "window_attn_bwd": "cuda-core fma, 4x4 register tiles of S/P/dP/dS, shuffle row "
                              "reductions, P/dS tiles in shared memory, cp.async",
           "window_attn_fwd": "cuda-core fma, 4x4 register tiles of S/P, shuffle row "
                              "reductions, P tile in shared memory, one head per block, "
                              "two cp.async stages"}
DESIGNS["gemm_bias_epilogue[fast gelu]"] = (DESIGNS["gemm_bias_epilogue"]
                                            + ", the polynomial GELU pair in the epilogue")
DESIGNS["gemm_bias_epilogue[bf16 exact gelu]"] = (DESIGNS["gemm_bias_epilogue[bf16]"]
                                                  + ", the exact (erf) GELU pair in the epilogue")
DESIGNS["copy_probe"] = ("cuda-core, 16-byte accesses in a grid-stride loop over the blocks "
                         "given, the head before x's first 16-byte boundary and the tail "
                         "one element at a time")
DESIGNS["window_attn_fwd[bf16 module path]"] = DESIGNS["window_attn_fwd[bf16]"]
DESIGNS["window_attn_bwd[bf16 module path]"] = DESIGNS["window_attn_bwd[bf16]"]
DESIGN_CUDA_CORES = "cuda-core fma"
# the times of the versions a redesign replaced, ms per SwinBlock, as an
# earlier run of this script measured them on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md section 6 names the run); printed apart from the kernels
# line, which holds only this run's measurements
HISTORICAL = ("historical, not measured in this run: gemm_wgrad[bf16] cuda-core fma 1.1579 ms; "
              "gemm_bias_epilogue[bf16] cuda-core fma 1.2657 ms; "
              "gemm_dgrad[bf16] cuda-core fma 0.8734 ms; "
              "gemm_bias_epilogue cuda-core fma, 4x4 register tiles 2.1481 ms (eval shape), "
              "0.2782 ms (fc1_gelu_pair T=36864); "
              "gemm_dgrad cuda-core fma, 4x4 register tiles 0.9315 ms, 0.9162 queued (T=36864); "
              "window_attn_bwd cuda-core fma, operands from shared memory 0.5821 ms, 0.5729 "
              "queued (T=36864, mean of the masks); "
              "gemm_wgrad cuda-core fma, 4x4 register tiles 1.0928 ms, 1.0794 queued (T=36864); "
              "window_attn_fwd cuda-core fma, operands from shared memory 0.4818 ms, 0.4775 "
              "queued (eval shape, mean of the masks); "
              "window_attn_bwd[bf16] cuda-core fma, operands from shared memory 0.4311 ms, "
              "0.4213 queued (T=36864, saved p, mean of the masks); "
              "window_attn_fwd[bf16] cuda-core fma, one block per (window, head) 0.2268 ms, "
              "0.2219 queued (T=36864, p store, mean of the masks); "
              "ln_rows_bwd[bf16] cuda-core fma, one warp per row, scalar loads, dgamma/dbeta "
              "partials summed by two torch reductions 0.2046 ms, 0.1109 queued (T=36864: ln2 "
              "0.0577, ln1_window 0.0532; T=18432: 0.0359, 0.0353); "
              "copy_probe one 2- or 4-byte element per access 0.0052 ms queued (bf16, 1056 "
              "blocks)")


def kernel_entries(rows: dict, sources: dict, launches: dict, suffix: str, peak: float,
                   extra: dict) -> list:
    """One entry per kernel: times and bounds summed over the variants one
    SwinBlock runs (weighted by ``per_block``), attention as the mean of its
    unmasked and masked variants, since blocks alternate; every variant
    listed with its own numbers."""
    out = []
    for name, (source, replaces) in sources.items():
        variants = [r for r in rows[name] if r["per_block"]]
        scale = 0.5 if name.startswith("window_attn") else 1.0

        def total(key):
            vals = [r[key] * r["per_block"] if r.get(key) is not None else None for r in variants]
            return None if any(v is None for v in vals) else scale * sum(vals)

        b_ms, b_by = bound_ms(total("flops"), total("bytes"), peak)
        full = name + suffix
        out.append({"name": full, "route": "cuda", "source": source, "replaces": replaces,
                    "design": DESIGNS.get(full, DESIGN_CUDA_CORES),
                    "launches": launches[name], **{k: v[name] for k, v in extra.items()},
                    "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
                    "ms": total("ms"), "queued_ms": total("queued_ms"), "plain_ms": total("plain_ms"),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": total("library_ms"),
                    "library_queued_ms": total("library_queued_ms"),
                    "variants": [{k: r.get(k) for k in ("variant", "per_block", "max_abs_err", "ms",
                                                        "queued_ms", "kernel_ms", "sums_ms",
                                                        "plain_ms", "bound_ms", "bound_by",
                                                        "library_ms", "library_queued_ms")
                                  if k in r or k not in ("kernel_ms", "sums_ms")}
                                 for r in rows[name]]})
    return out


def form_entries(rows: dict, counts: dict) -> list:
    """One entry per GELU form that is not its dtype's default: the numbers
    of the variant one SwinBlock runs (the f32 eval forward's fc1, the bf16
    step's fc1 with its gelu' save), every variant listed."""
    out = []
    for name, (source, replaces) in SOURCES_FORMS.items():
        r = next(v for v in rows[name] if v["per_block"])
        main = r["variant"]
        keys = ("ms", "queued_ms", "default_form_queued_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_queued_ms")
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "design": DESIGNS[name], "launches": counts[name], "variant": main,
                    "max_abs_err": max(v["max_abs_err"] for v in rows[name]),
                    **{k: r.get(k) for k in keys},
                    "variants": [{k: v.get(k) for k in ("variant", "max_abs_err", *keys)}
                                 for v in rows[name]]})
    return out


def probe_entries(rows: dict, counts: dict) -> list:
    out = []
    for name, (source, replaces, main) in SOURCES_PROBES.items():
        r = next(v for v in rows[name] if v["variant"] == main)
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "design": DESIGNS.get(name, DESIGN_CUDA_CORES),
                    "launches": counts[name], "variant": main,
                    "max_abs_err": max(v["max_abs_err"] for v in rows[name]),
                    **{k: r.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms")},
                    "variants": [{k: v.get(k) for k in ("variant", "max_abs_err", "ms", "plain_ms",
                                                        "bound_ms", "bound_by", "library_ms")}
                                 for v in rows[name]]})
    return out


def kernel_line(rows: dict, rows_bf16: dict, rows_probe: dict, eval_counts: dict,
                train_counts: dict, bf16_counts: dict, probe_counts: dict,
                captured: dict, rows_module: dict, module_counts: dict, rows_forms: dict,
                form_counts: dict) -> dict:
    """The f32 kernels (eval shapes for the forward kernels, the 2B training
    graph for the backward kernels; launches over the eval and eager f32
    training paths) and their bf16 instantiations (the 2B graph; launches
    over the eager bf16 training path), bounds at the FP32 and the bf16
    peak; ``launches_captured``: their launches over the captured runs (one
    eager warm-up dispatch and the capture each).  Then the bf16 module
    path's attention forward (no p store) and backward (p recomputed) at
    its 2B graph, launches over its bf16 eval and its eager and captured
    training runs; then the GELU epilogues in the form that is not their
    dtype's default (``SEI_FAST_GELU``), launches over the knob's eval and
    training runs; then K8 and K9, launches over the probe path."""
    f32 = kernel_entries(rows, SOURCES, {k: eval_counts[k] + train_counts[k] for k in SOURCES},
                         "", PEAK_FP32_FLOPS,
                         {"launches_eval": eval_counts, "launches_train": train_counts,
                          "launches_captured": captured["f32"]})
    bf16 = kernel_entries(rows_bf16, SOURCES_BF16, bf16_counts, "[bf16]", PEAK_BF16_FLOPS,
                          {"launches_captured": captured["bf16"]})
    module = kernel_entries(rows_module, SOURCES_MODULE, module_counts, "[bf16 module path]",
                            PEAK_BF16_FLOPS, {})
    return {"kernels": f32 + bf16 + module + form_entries(rows_forms, form_counts)
            + probe_entries(rows_probe, probe_counts)}


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    if "--bits" in argv:  # the attention outputs' digests of the tree at the path given
        sys.path.insert(0, argv[argv.index("--bits") + 1])
        from sei_tpu_torch.ops import attention

        print(f"gpu: {nvidia_smi()}; port from {attention.__file__}")
        attention_bits()
        ln_bwd_bits()
        gelu_bits()
        return 0
    from sei_tpu_torch.device import resolve_device
    from sei_tpu_torch.ops import _build

    quick = "--quick" in argv
    smi = nvidia_smi()
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    resolve_device("cuda")
    built = _build.library()
    print(f"kernels built in {built.seconds:.2f} s -> {built.path}")
    report = ptxas_report(built.log)
    for line in report:
        print(f"  {line}")
    for label, kernel in (("f32 forward GEMM", "gemm_bias_epilogue_kernel"),
                          ("bf16 forward GEMM", "gemm_bias_epilogue_mma_kernel"),
                          ("copy probe", "copy_probe_kernel"),
                          ("f32 data grad", "gemm_dgrad_f32_kernel"),
                          ("f32 weight grad", "gemm_wgrad_f32_kernel"),
                          ("f32 attention backward", "window_attn_bwd_f32_kernel"),
                          ("f32 attention forward", "window_attn_fwd_f32_kernel"),
                          ("bf16 attention backward", "window_attn_bwd_mma_kernel"),
                          ("bf16 attention forward", "window_attn_fwd_mma_kernel"),
                          ("bf16 LN backward", "ln_rows_bwd_vec_kernel"),
                          ("bf16 LN backward's sum", "ln_rows_bwd_sum_kernel")):
        print(f"ptxas, {label}: " + " | ".join(
            line.split(" ", 1)[1] for line in report if kernel in line))
    print(f"bf16 LN backward build: {ln_bwd_config(built)}")

    rows = check_kernels(timed=not quick)
    for name, variants in check_train_kernels(timed=not quick).items():
        rows.setdefault(name, []).extend(variants)
    rows_bf16 = check_bf16_kernels(timed=not quick)
    rows_module = check_module_attention(timed=not quick)
    rows_forms = check_gelu_forms(timed=not quick)
    attention_bits()
    ln_bwd_bits()
    gelu_bits()
    rows_probe = check_probe_kernels(timed=not quick)
    if quick:
        print("quick: kernel checks passed")
        return 0
    eval_counts = main_path()
    captured, steady = {}, {}
    train_counts, trainer, eager = train_path()
    del trainer
    for scan_steps in SCAN_STEPS:
        counts, steady["f32", scan_steps] = captured_train(None, scan_steps, eager)
        add_counts(captured.setdefault("f32", {}), counts)
    dp = dp_group()
    dp_runs = {"f32": dp_train(None, 1, eager, dp, steady["f32", 1], smi)}
    bf16_counts, trainer, eager = train_path(torch.bfloat16)
    for scan_steps in SCAN_STEPS:
        counts, steady["bf16", scan_steps] = captured_train(torch.bfloat16, scan_steps, eager)
        add_counts(captured.setdefault("bf16", {}), counts)
    dp_runs["bf16"] = dp_train(torch.bfloat16, 2, eager, dp, steady["bf16", 2], smi)
    torch.distributed.destroy_process_group()
    del eager
    bf16_trunk_grads()
    bf16_loss_vs_f32(trainer)
    del trainer
    r2r_phase(smi, steady)
    sr_phase(smi, steady)
    cli_phase(smi)
    slice20_phase(smi, steady)
    slice21 = {"train data parallel " + k: v.pop("launches") for k, v in dp_runs.items()}
    for label, counts in tiled_eval_phase(smi).items():
        slice21["eval tiled " + label] = counts
    print(f"slice 21 launches by run: {json.dumps(slice21)}; data-parallel steps: "
          f"{json.dumps(dp_runs)}")
    module_runs = module_path_phase(smi, steady)
    module_counts = {}
    for run in ("eval module path bf16", "train bf16 module path"):
        add_counts(module_counts, module_runs[run])
    form_counts = fast_gelu_phase(smi, steady)
    loader_phase(smi)
    baselines_phase(smi)
    probe_counts = probe_phase()
    bench = bench_line()
    print(HISTORICAL)
    print(bench)
    print(json.dumps(kernel_line(rows, rows_bf16, rows_probe, eval_counts, train_counts,
                                 bf16_counts, probe_counts, captured, rows_module,
                                 module_counts, rows_forms, form_counts)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
