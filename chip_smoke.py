#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``sei_tpu_torch``) on one card.

    python3 chip_smoke.py            # the whole run (needs one CUDA GPU)
    python3 chip_smoke.py --quick    # build + kernel checks only, no timing

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
   the EI forward on B = 8 images, T = 18432, 288 windows).
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
   step by kernel.
5. Prints the kernel table as one JSON line, the nvidia-smi line, and, last,
   ``{"ok": true, "device": {...}}``.  Any failed phase raises (exit != 0).

Imports nothing of JAX and nothing of ``sei_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA H100 datasheet): FP32 on the CUDA
# cores (TF32 is off for this f32 eval) and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
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
# LN1, qkv, attention, LN2, fc1 + the backward kernels)
PER_BLOCK_TRAIN = {"ln_rows": 2 + 2, "gemm_bias_epilogue": 4 + 2, "window_attn_fwd": 1 + 1,
                   "gemm_dgrad": 4, "gemm_wgrad": 4, "window_attn_bwd": 1, "ln_rows_bwd": 2}
# one step's gradients, kernel path vs plain path: max |diff| per tensor
# over max |plain grad| of that tensor (f32 sums in other orders through 2 x
# 36 blocks of forward and backward; SURE's divergence divides the
# difference of two forwards by tau = 1e-2)
GRAD_RTOL = 1e-3


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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
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
            r["plain_ms"] = time_ms(fn_p)
            r["library_ms"] = time_ms(fn_lib) if fn_lib is not None else None
            print(f"    {kernel}[{variant}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}), {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB")
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


def check_train_kernels(timed: bool) -> dict:
    """The backward kernels (and the fc1 pre-activation epilogue) against
    their plain versions at the flagship training shapes, both graphs; the
    per-SwinBlock sums of the 2B graph go into the JSON line."""
    import torch
    import torch.nn.functional as F

    from sei_tpu_torch.models.swinir import shift_attn_mask
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
            r["plain_ms"] = time_ms(fn_p)
            r["library_ms"] = time_ms(fn_lib) if fn_lib is not None else None
            lib = "None" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"    {kernel}[{variant}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {lib} ms, bound {b_ms:.4f} ms ({b_by}), "
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

        # fc1 with the pre-activation stored beside gelu(h) (the recompute)
        z, w1, b1 = rnd(t, C), rnd(C, CH, s=0.05), rnd(CH, s=0.05)
        pre, pre_p = torch.empty(t, CH, device=dev), torch.empty(t, CH, device=dev)
        errs = cmp_all(f"gemm_bias_epilogue[fc1_gelu_pre T={t}]",
                       (st.gemm_bias_epilogue(z, w1, b1, "gelu", pre=pre), pre),
                       (st._torch_gemm_bias_epilogue(z, w1, b1, "gelu", pre=pre_p), pre_p),
                       [(1e-4, 1e-4)] * 2)
        record("gemm_bias_epilogue", f"fc1_gelu_pre T={t}", errs,
               lambda: st.gemm_bias_epilogue(z, w1, b1, "gelu", pre=pre),
               lambda: st._torch_gemm_bias_epilogue(z, w1, b1, "gelu", pre=pre_p),
               lambda: torch.addmm(b1, z, w1), 2.0 * t * C * CH,
               4.0 * (t * C + C * CH + CH + 2 * t * CH), False)

        # data-grad products, in the order one block's backward runs them
        for variant, kk, nn, scale, wmap, gelu in (
                ("fc2_gelu_grad", CH, C, dpm, None, True), ("fc1", C, CH, None, None, False),
                ("proj_window_dpm", C, C, dpm, wm, False), ("qkv", C, 3 * C, None, None, False)):
            dy = x4[..., :nn].contiguous() if wmap else rnd(t, nn)
            w = rnd(kk, nn, s=0.05)
            pre = rnd(t, kk) if gelu else None
            dy2 = dy.reshape(t, nn)
            errs = [compare(f"gemm_dgrad[{variant} T={t}]",
                            st.gemm_dgrad(dy, w, scale=scale, window=wmap, pre=pre),
                            st._torch_gemm_dgrad(dy, w, scale, wmap, pre), 1e-4, 1e-4)]
            record("gemm_dgrad", f"{variant} T={t}", errs,
                   lambda: st.gemm_dgrad(dy, w, scale=scale, window=wmap, pre=pre),
                   lambda: st._torch_gemm_dgrad(dy, w, scale, wmap, pre),
                   lambda: torch.mm(dy2, w.t()), 2.0 * t * nn * kk,
                   4.0 * (t * nn + kk * nn + t * kk * (2 if gelu else 1)), main)
            del dy, w, pre, dy2

        # weight-grad products (sums over T tokens in another order: 1e-3)
        for variant, kk, nn, scale, wmap in (
                ("fc2_dpm", CH, C, dpm, None), ("fc1", C, CH, None, None),
                ("proj_window_dpm", C, C, dpm, wm), ("qkv", C, 3 * C, None, None)):
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

        # attention backward, with and without the shift mask
        q = rnd(b_, NH, N, HD, s=HD ** -0.5)
        kt, v, do = rnd(b_, NH, N, HD), rnd(b_, NH, N, HD), rnd(b_, NH, N, HD, s=0.1)
        bias = rnd(NH, N, N, s=0.1)
        mask = torch.from_numpy(shift_attn_mask(CROP, CROP, WS, WS // 2)).to(dev)
        for variant, m in (("no_mask", None), ("shift_mask", mask)):
            scale = HD ** -0.5
            errs = cmp_all(f"window_attn_bwd[{variant} T={t}]",
                           at.window_attn_bwd(q, kt, v, bias, m, do, scale=scale),
                           at._torch_attention_bwd(q, kt, v, bias, m, do, scale),
                           [(2e-5, 1e-4)] * 3 + [(1e-4, 1e-4)])
            full = (bias[None] if m is None else
                    (bias[None] + m[:, None]).repeat(b_ // m.shape[0], 1, 1, 1)).expand(b_, NH, N, N)
            ql, kl, vl = (u.detach().clone().requires_grad_() for u in (q, kt, v))
            out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=full, scale=scale)
            nbytes = 4.0 * (7 * b_ * NH * N * HD + 2 * NH * N * N + (0 if m is None else m.numel()))
            record("window_attn_bwd", f"{variant} T={t}", errs,
                   lambda: at.window_attn_bwd(q, kt, v, bias, m, do, scale=scale),
                   lambda: at._torch_attention_bwd(q, kt, v, bias, m, do, scale),
                   lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True),
                   10.0 * b_ * NH * N * N * HD, nbytes, main)
            del ql, kl, vl, out, full
        del q, kt, v, do

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
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    if total <= 0.0:
        fail("profiler recorded no device time")
    print(f"  profile: one forward {wall_ms:.2f} ms wall (unprofiled), {total:.2f} ms of "
          f"device kernels (busy share {total / wall_ms:.3f})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def profile_step(step_fn, label: str) -> None:
    """Device time by kernel over one call of ``step_fn`` (torch.profiler /
    CUPTI), and the device's busy share: kernel time over the host-clock
    wall time of an unprofiled call."""
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
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    if total <= 0.0:
        fail("profiler recorded no device time")
    print(f"  profile: {label} {wall_ms:.2f} ms wall (unprofiled), {total:.2f} ms of "
          f"device kernels (busy share {total / wall_ms:.3f})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:16]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def train_path() -> dict:
    """The proposed training path on the card; returns the kernels' launch
    counts over the run."""
    import numpy as np
    import torch

    from sei_tpu_torch.data import build_device_cache
    from sei_tpu_torch.losses import LossDraws, compute_sure_margin, get_loss, sample_probe
    from sei_tpu_torch.models import get_model
    from sei_tpu_torch.ops import swin_trunk as st
    from sei_tpu_torch.physics import get_physics
    from sei_tpu_torch.train import Trainer
    from sei_tpu_torch.transforms import ScalingTransform, crop_offsets, crop_pair_batch

    print(f"training path: build_device_cache -> get_loss(proposed) -> Trainer "
          f"({TRAIN_IMAGES} images {H}x{W}, flagship SwinIR, batch {BATCH}, {CROP} px crops, "
          f"{TRAIN_EPOCHS} epochs)")
    t0 = time.perf_counter()
    model = get_model(kind="Proposed", architecture="Transformer", task="deblurring", seed=0)
    physics = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    cache = build_device_cache(make_images(TRAIN_IMAGES, H, W, seed=1), physics, seed=0)
    loss_fn = get_loss(method="proposed", physics=physics, crop_size=CROP)
    trainer = Trainer(model, loss_fn, physics, cache, batch_size=BATCH, epochs=TRAIN_EPOCHS,
                      crop_size=DATA_CROP, seed=0)
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
    st.reset_launch_counts()
    stats = trainer.train(on_step=on_step, log_every_epoch=False)
    counts = st.launch_counts()
    print(f"  launch counts {counts}")
    steps = stats["steps"]
    for name, per in PER_BLOCK_TRAIN.items():
        want = per * BLOCKS * len(TRAIN_GRAPHS) * steps
        if counts[name] != want:  # 0 included: every kernel must run on this path
            fail(f"{name}: {counts[name]} launches over {steps} training steps, expected {want}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    after = model.module.state_dict()
    moved = sum(not torch.equal(before[k], after[k]) for k in before)
    if moved != len(before):
        fail(f"only {moved} of {len(before)} parameter tensors changed")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    print(f"  {steps} steps in {stats['wall_time_s']:.2f} s ({stats['images_per_sec']:.3f} img/s "
          f"over the run, first step included); steady step {steady:.2f} ms "
          f"(median of steps 1..{steps - 1}) = {BATCH * 1e3 / steady:.3f} img/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"all {moved} parameter tensors moved; epoch losses {stats['epoch_losses']}")

    # one step's gradients: kernel path against the plain path, same draws
    x, y = trainer.batch(0)
    g = torch.Generator(device="cuda").manual_seed(7)
    offsets = crop_offsets(torch.Generator().manual_seed(7), [DATA_CROP] * BATCH,
                           [DATA_CROP] * BATCH, CROP)
    _, y_crop = crop_pair_batch(x, y, size=CROP, offsets=offsets)
    rates, _, centers = ScalingTransform().sample_params(g, BATCH)
    margin = compute_sure_margin(partial_sure=True, sure_margin=None, task="deblurring",
                                 kernel_shape=tuple(physics.kernel.shape))
    draws = LossDraws(crop=offsets, probe=sample_probe(g, y_crop, margin), rates=rates,
                      centers=centers)
    grads = {}
    model.module.train()
    for plain in (False, True):
        drop = torch.Generator(device="cuda").manual_seed(11)
        model.module.zero_grad(set_to_none=True)
        loss = loss_fn(x, y, lambda im: model.module(im, plain=plain, generator=drop), None, draws)
        loss.backward()
        grads[plain] = (float(loss.detach()), {n: p.grad.clone() for n, p in model.module.named_parameters()})
    worst = max(((grads[False][1][n] - gp).abs().max() / gp.abs().max().clamp_min(1e-30)).item()
                for n, gp in grads[True][1].items())
    print(f"  one step, kernel path vs plain path: loss {grads[False][0]!r} vs {grads[True][0]!r}; "
          f"worst max|diff|/max|plain grad| over {len(grads[True][1])} tensors {worst:.3e} "
          f"(tolerance {GRAD_RTOL:g})")
    if not worst <= GRAD_RTOL:
        fail("kernel-path gradients disagree with the plain path")
    del grads
    model.module.zero_grad(set_to_none=True)
    profile_step(trainer.step, "one training step")
    return counts


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


def kernel_line(rows: dict, eval_counts: dict, train_counts: dict) -> dict:
    """One entry per kernel: times and bounds summed over the variants one
    SwinBlock runs (eval shapes for the forward kernels, the 2B training
    graph for the backward kernels; attention as the mean of its unmasked
    and masked variants, since blocks alternate); launches over both paths."""
    out = []
    for name, (source, replaces) in SOURCES.items():
        variants = [r for r in rows[name] if r["per_block"]]
        scale = 0.5 if name.startswith("window_attn") else 1.0

        def total(key):
            vals = [r[key] for r in variants]
            return None if any(v is None for v in vals) else scale * sum(vals)

        flops, nbytes = total("flops"), total("bytes")
        b_ms, b_by = bound_ms(flops, nbytes)
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": eval_counts[name] + train_counts[name],
                    "launches_eval": eval_counts[name], "launches_train": train_counts[name],
                    "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
                    "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": total("library_ms")})
    return {"kernels": out}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    from sei_tpu_torch.device import resolve_device
    from sei_tpu_torch.ops import _build

    quick = "--quick" in argv
    smi = nvidia_smi()
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    resolve_device("cuda")
    built = _build.library()
    print(f"kernels built in {built.seconds:.2f} s -> {built.path}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    rows = check_kernels(timed=not quick)
    for name, variants in check_train_kernels(timed=not quick).items():
        rows.setdefault(name, []).extend(variants)
    if quick:
        print("quick: kernel checks passed")
        return 0
    eval_counts = main_path()
    train_counts = train_path()
    print(json.dumps(kernel_line(rows, eval_counts, train_counts)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
