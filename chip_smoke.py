#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``sei_tpu_torch``) on one card.

    python3 chip_smoke.py            # the whole run (needs one CUDA GPU)
    python3 chip_smoke.py --quick    # build + kernel checks only, no timing
    python3 chip_smoke.py --bits DIR # attention and LN-backward digests of the port in DIR

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
   be compared in one run).
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
   eager trainer's, peak memory.
6. Launch-overhead probes (K8 ``copy_probe``, K9 ``trunk_skeleton``): each
   held exactly against its plain version and timed at the probes' shapes,
   then ``sei_tpu_torch.probes`` (chains of launches eager and captured,
   the skeleton variants, the real trunk as the control).
7. Prints the kernel table as one JSON line, the nvidia-smi line, and, last,
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
   fed by ``cp.async``) and
   carries ``queued_ms``: the device time of the same calls queued behind
   a sleeping kernel, free of the wrapper's host cost; every entry with a
   library call carries
   ``library_queued_ms``, the same for it.  A line before the kernel line
   gives the replaced versions' earlier times, marked as not measured in
   this run; each profiled step prints its device time by kernel.

Imports nothing of JAX and nothing of ``sei_tpu``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

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
# the probes' shape (experiments/perf_probe_r3*.py: b, h, w, c) and depth
PROBE_SHAPE, PROBE_DEPTH = (8, 48, 48, 180), 6
PROBE_BLOCKS = (1, 4, 8, 24, 132, 1056)


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
            record("window_attn_bwd", f"{variant} att_out trunk_views T={t}", errs, fused,
                   lambda m=m: at._torch_attention_bwd(qv, kv, vv, bias, m, dov, scale,
                                                       with_att=True),
                   None, 12.0 * b_ * NH * N * N * HD, nbytes + 4.0 * b_ * NH * N * HD, False)

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


def train_path(dtype=None) -> tuple[dict, object, dict]:
    """The proposed training path on the card, eagerly (one launch at a
    time, ``capture=False``), with SwinIR's compute dtype ``dtype`` (None:
    f32; bfloat16: the JAX package's training recipe); returns the kernels'
    launch counts over the run, the trainer, and the run's per-step losses,
    final state and timings (what the captured runs are held against)."""
    import numpy as np
    import torch

    from sei_tpu_torch.data import build_device_cache
    from sei_tpu_torch.losses import get_loss
    from sei_tpu_torch.models import get_model
    from sei_tpu_torch.ops import swin_trunk as st
    from sei_tpu_torch.physics import get_physics
    from sei_tpu_torch.train import Trainer

    label = "bf16" if dtype is not None else "f32"
    per_block = PER_BLOCK_TRAIN_BF16 if dtype is not None else PER_BLOCK_TRAIN
    print(f"training path ({label}): build_device_cache -> get_loss(proposed) -> Trainer "
          f"({TRAIN_IMAGES} images {H}x{W}, flagship SwinIR, compute dtype {label}, batch "
          f"{BATCH}, {CROP} px crops, {TRAIN_EPOCHS} epochs)")
    t0 = time.perf_counter()
    model = get_model(kind="Proposed", architecture="Transformer", task="deblurring", seed=0,
                      dtype=dtype)
    physics = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    cache = build_device_cache(make_images(TRAIN_IMAGES, H, W, seed=1), physics, seed=0)
    loss_fn = get_loss(method="proposed", physics=physics, crop_size=CROP)
    trainer = Trainer(model, loss_fn, physics, cache, batch_size=BATCH, epochs=TRAIN_EPOCHS,
                      crop_size=DATA_CROP, seed=0, capture=False)
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
    for name, per in per_block.items():
        want = per * BLOCKS * len(TRAIN_GRAPHS) * steps
        if counts[name] != want:  # 0 included: every kernel must run on this path
            fail(f"{label} {name}: {counts[name]} launches over {steps} training steps, "
                 f"expected {want}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite {label} training loss: {losses}")
    after = model.module.state_dict()
    moved = sum(not torch.equal(before[k], after[k]) for k in before)
    if moved != len(before):
        fail(f"{label}: only {moved} of {len(before)} parameter tensors changed")
    f32_state = all(t.dtype == torch.float32 for t in after.values()) and all(
        v.dtype == torch.float32 for s_ in trainer.opt.state.values() for v in s_.values()
        if torch.is_tensor(v) and v.dim())
    if not f32_state:
        fail(f"{label}: parameters or Adam state left f32")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    print(f"  {steps} steps in {stats['wall_time_s']:.2f} s ({stats['images_per_sec']:.3f} img/s "
          f"over the run, first step included); steady step {steady:.2f} ms "
          f"(median of steps 1..{steps - 1}) = {BATCH * 1e3 / steady:.3f} img/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"all {moved} parameter tensors moved; params and Adam state f32; "
          f"epoch losses {stats['epoch_losses']}")
    eager = {"losses": losses, "state": train_state(trainer),
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    eager["steady_ms"] = timed_dispatches(trainer)
    print(f"  eager steady step {eager['steady_ms']:.2f} ms ({TIMED_DISPATCHES} dispatches "
          f"back to back, one sync)")

    if dtype is None:
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
              f"(tolerance {GRAD_RTOL:g})")
        if not worst <= GRAD_RTOL:
            fail("kernel-path gradients disagree with the plain path")
        del grads
    model.module.zero_grad(set_to_none=True)
    eager["wall_ms"], eager["device_ms"] = profile_step(trainer.step, f"one {label} training step")
    return counts, trainer, eager


def captured_train(dtype, scan_steps: int, eager: dict) -> dict:
    """The training path as ``Trainer`` runs it by default on CUDA: one CUDA
    graph per dispatch of ``scan_steps`` steps, from the eager run's seed-0
    weights and streams and for as many steps.  Each step's loss, the final
    parameters and Adam state must equal the eager run's bit for bit (the
    same kernels in the same order on the same draws); the trunk kernels
    captured must be the design's per step.  Returns the kernels' launch
    counts over the run (one eager warm-up dispatch and the capture: the
    wrappers count where they launch, and a replay calls no wrapper)."""
    import torch

    from sei_tpu_torch.data import build_device_cache
    from sei_tpu_torch.losses import get_loss
    from sei_tpu_torch.models import get_model
    from sei_tpu_torch.ops import swin_trunk as st
    from sei_tpu_torch.physics import get_physics
    from sei_tpu_torch.train import Trainer

    label = "bf16" if dtype is not None else "f32"
    per_block = PER_BLOCK_TRAIN_BF16 if dtype is not None else PER_BLOCK_TRAIN
    print(f"captured training ({label}, scan_steps {scan_steps}): the same run as one CUDA "
          f"graph per dispatch")
    model = get_model(kind="Proposed", architecture="Transformer", task="deblurring", seed=0,
                      dtype=dtype)
    physics = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    cache = build_device_cache(make_images(TRAIN_IMAGES, H, W, seed=1), physics, seed=0)
    loss_fn = get_loss(method="proposed", physics=physics, crop_size=CROP)
    trainer = Trainer(model, loss_fn, physics, cache, batch_size=BATCH, epochs=TRAIN_EPOCHS,
                      crop_size=DATA_CROP, seed=0, scan_steps=scan_steps)
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    want = {k: v * BLOCKS * len(TRAIN_GRAPHS) * scan_steps for k, v in per_block.items()}
    print(f"  {stats['steps']} steps in {trainer.replays} replays, {seconds:.2f} s with the "
          f"warm-up and the capture; launches captured {trainer.capture_launches}; "
          f"peak memory {peak:.3f} GiB (eager {eager['peak_gib']:.3f})")
    if trainer.replays * scan_steps != stats["steps"]:
        fail(f"{label}: {trainer.replays} replays for {stats['steps']} steps at scan_steps "
             f"{scan_steps}")
    if trainer.capture_launches != want:
        fail(f"{label} scan_steps {scan_steps}: captured launches {trainer.capture_launches}, "
             f"expected {want}")
    if counts != {k: 2 * v for k, v in want.items()}:
        fail(f"{label}: launches over the warm-up and the capture {counts}, expected twice {want}")
    got = train_state(trainer)
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, eager["state"])]
    unequal = sum(not torch.equal(a, b) for a, b in zip(got, eager["state"]))
    print(f"  losses {losses}; eager {eager['losses']}; state tensors unequal to the eager "
          f"run's: {unequal} of {len(got)} (max |diff| {max(diffs):.3e})")
    if losses != eager["losses"] or unequal or len(got) != len(eager["state"]):
        fail(f"{label} scan_steps {scan_steps}: the captured run differs from the eager run")
    steady = timed_dispatches(trainer)
    wall, device = profile_step(trainer.step, f"one replayed {label} dispatch "
                                              f"({scan_steps} steps)")
    print(f"  steady step {steady:.2f} ms captured vs {eager['steady_ms']:.2f} ms eager "
          f"({TIMED_DISPATCHES} dispatches back to back); one dispatch {wall / scan_steps:.2f} "
          f"ms wall and {device / scan_steps:.2f} ms device per step (busy "
          f"{device / wall:.3f}) vs eager {eager['wall_ms']:.2f} / {eager['device_ms']:.2f} ms "
          f"(busy {eager['device_ms'] / eager['wall_ms']:.3f})")
    return counts


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
              "0.0577, ln1_window 0.0532; T=18432: 0.0359, 0.0353)")


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
                captured: dict) -> dict:
    """The f32 kernels (eval shapes for the forward kernels, the 2B training
    graph for the backward kernels; launches over the eval and eager f32
    training paths) and their bf16 instantiations (the 2B graph; launches
    over the eager bf16 training path), bounds at the FP32 and the bf16
    peak; ``launches_captured``: their launches over the captured runs (one
    eager warm-up dispatch and the capture each).  Then K8 and K9, launches
    over the probe path."""
    f32 = kernel_entries(rows, SOURCES, {k: eval_counts[k] + train_counts[k] for k in SOURCES},
                         "", PEAK_FP32_FLOPS,
                         {"launches_eval": eval_counts, "launches_train": train_counts,
                          "launches_captured": captured["f32"]})
    bf16 = kernel_entries(rows_bf16, SOURCES_BF16, bf16_counts, "[bf16]", PEAK_BF16_FLOPS,
                          {"launches_captured": captured["bf16"]})
    return {"kernels": f32 + bf16 + probe_entries(rows_probe, probe_counts)}


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
    attention_bits()
    ln_bwd_bits()
    rows_probe = check_probe_kernels(timed=not quick)
    if quick:
        print("quick: kernel checks passed")
        return 0
    eval_counts = main_path()
    captured = {}
    train_counts, trainer, eager = train_path()
    del trainer
    for scan_steps in SCAN_STEPS:
        add_counts(captured.setdefault("f32", {}), captured_train(None, scan_steps, eager))
    bf16_counts, trainer, eager = train_path(torch.bfloat16)
    for scan_steps in SCAN_STEPS:
        add_counts(captured.setdefault("bf16", {}), captured_train(torch.bfloat16, scan_steps,
                                                                  eager))
    del eager
    bf16_trunk_grads()
    bf16_loss_vs_f32(trainer)
    del trainer
    probe_counts = probe_phase()
    print(HISTORICAL)
    print(json.dumps(kernel_line(rows, rows_bf16, rows_probe, eval_counts, train_counts,
                                 bf16_counts, probe_counts, captured)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
