#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``sei_tpu_torch``) on one card.

    python3 chip_smoke.py            # the whole run (needs one CUDA GPU)
    python3 chip_smoke.py --quick    # build + kernel checks only, no timing

1. Prints the card (nvidia-smi name and power limit), the torch version, and
   builds the CUDA kernels from ``sei_tpu_torch/ops/csrc`` into
   ``sei_tpu_torch/_build/`` (time and ptxas report printed).
2. Holds each kernel against its plain PyTorch version on the card, at the
   flagship eval shapes (one 256x320 image: T = 81920 tokens, C = 180,
   6 heads, window 8 -> 1280 windows), and times kernel, plain version and,
   as a yardstick only, one PyTorch library call of the same function.
3. Drives the port's main path: ``get_model`` (flagship SwinIR, weights from
   seed 0) -> ``get_physics`` (deblurring, Gaussian_R2, noise 5) ->
   ``evaluate`` on 4 seeded 256x320 images; checks the kernels' launch
   counts, the metrics, and one full forward against the plain path, and
   profiles one forward by kernel (torch.profiler).
4. Prints the kernel table as one JSON line, the nvidia-smi line, and, last,
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
             "flops": flops, "bytes": nbytes}
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


def kernel_line(rows: dict, counts: dict) -> dict:
    sources = {
        "ln_rows": ("sei_tpu_torch/ops/csrc/ln_rows.cu", "sei_tpu/ops/swin_trunk.py:931"),
        "gemm_bias_epilogue": ("sei_tpu_torch/ops/csrc/gemm_bias_epilogue.cu",
                               "sei_tpu/ops/swin_trunk.py:931"),
        "window_attn_fwd": ("sei_tpu_torch/ops/csrc/window_attn_fwd.cu",
                            "sei_tpu/ops/attention.py:65"),
    }
    out = []
    for name, variants in rows.items():
        # per SwinBlock: both LNs, all four GEMMs, and the mean of the
        # unmasked and masked attention (blocks alternate)
        scale = 0.5 if name == "window_attn_fwd" else 1.0

        def total(key):
            vals = [r[key] for r in variants]
            return None if any(v is None for v in vals) else scale * sum(vals)

        flops, nbytes = total("flops"), total("bytes")
        b_ms, b_by = bound_ms(flops, nbytes)
        out.append({"name": name, "route": "cuda", "source": sources[name][0],
                    "replaces": sources[name][1], "launches": counts[name],
                    "max_abs_err": max(r["max_abs_err"] for r in variants),
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
    if quick:
        print("quick: kernel checks passed")
        return 0
    counts = main_path()
    print(json.dumps(kernel_line(rows, counts)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
