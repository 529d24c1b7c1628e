"""Launch-overhead probes on the card (counterpart of the JAX package's
``experiments/perf_probe_r3{m,p,q,r,s}.py``).

    python -m sei_tpu_torch.probes          # needs a CUDA GPU

At the probes' shapes (b, h, w, c = 8, 48, 48, 180; D = 6 blocks, 6 heads,
window 8) it times chains of launches three ways: the host clock around
eager launches ending in ``synchronize()``; CUDA events around the same
launches queued behind a sleeping kernel, so the device never waits for the
host (device time, and the host's enqueue time beside it); and one replay
of a CUDA graph of the same chain (host clock and events).  Each run adds a
new scalar to its input first (``t += 1; x + t``, as r3q perturbs), so no
run repeats the one before; that add is in every chain and in the baseline.

* K8 (``copy_probe``): chains of 0, 1, 2, 6, 12 and 24 copies at 4 blocks
  (the TPU probes' grid; there a copy's work dominates) and at 1056 blocks
  (8 per SM: the slope over N is the cost of one more launch, the host's
  from the enqueue time, the device's from its time), 1 copy at 24 blocks,
  6 copies at 1 block, r3m's 18 copies ``y = x``, one copy at 1, 4, 8, 24,
  132 and 1056 blocks (per-block against per-launch cost), and 24
  ``torch.add`` calls (r3p's "24 XLA adds").
* K9 (``trunk_skeleton``): six-call chains of v_e, v_a, v_b, v_d and v_g.
* v_h: the real trunk (``swin_trunk``) over 6 RSTBs of 6 blocks, forward
  and forward + backward, f32 and bf16, eager and captured: real minus
  skeleton is compute, eager minus captured the host's cost of the chain of
  7 launches per block forward (and 14 or 16 backward).

Each function returns its measurements as dicts; ``chip_smoke.py`` calls
them.  Every number is a device measurement: there is no CPU path.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional

import torch

from .device import resolve_device
from .models.swinir import shift_attn_mask
from .ops import launch_probe as lp
from .ops import swin_trunk as st

B, H, W, C, D, NH, WS = 8, 48, 48, 180, 6, 6, 8
RSTBS = 6
COPY_CHAINS = (0, 1, 2, 6, 12, 24)  # copies per run
CHAIN_BLOCKS = (4, 1056)
QUEUED_LAUNCHES = 512  # launches queued behind the sleep: well inside the launch queue
BLOCK_SWEEP = (1, 4, 8, 24, 132, 1056)
SKELETON_VARIANTS = {  # r3r / r3s tag -> trunk_skeleton flags
    "v_e": dict(full_args=False),
    "v_a": dict(),
    "v_b": dict(outputs=True),
    "v_d": dict(outputs=True, body=True),
    "v_g": dict(outputs=True, body=True, dpm_reads=True),
}
_SLEEP_CYCLES_PER_S = 2.0e9  # the H100's boost clock: a sleep of >= the asked time


def measure(name: str, run: Callable[[], object], *, iters: int, launches: int) -> dict:
    """Time ``run`` (one chain) eagerly and as one CUDA graph replay; ms per
    run.  ``launches``: kernel launches per run, for the line."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / iters

    runs = max(1, min(iters, QUEUED_LAUNCHES // max(launches, 1)))

    def queued(fn) -> tuple[float, Optional[float]]:
        """(device ms, host enqueue ms) per run, ``runs`` runs queued behind a
        sleep long enough to cover the enqueueing.  A chain of more than
        ``QUEUED_LAUNCHES`` launches can fill the launch queue, and the host
        then waits for the sleep: its enqueue time is not measured."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2.0 * host * runs * 1e-3 * _SLEEP_CYCLES_PER_S) + 1000)
        start.record()
        t1 = time.perf_counter()
        for _ in range(runs):
            fn()
        enqueue = (time.perf_counter() - t1) * 1e3 / runs
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / runs, (enqueue if launches <= QUEUED_LAUNCHES else None)

    device, enqueue = queued(run)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the capture stream's handles
        run()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        graph.replay()
    torch.cuda.synchronize()
    graph_host = (time.perf_counter() - t0) * 1e3 / iters
    graph_device, graph_enqueue = queued(graph.replay)
    del graph
    r = {"name": name, "launches": launches, "host_ms": host, "enqueue_ms": enqueue,
         "device_ms": device, "graph_host_ms": graph_host, "graph_device_ms": graph_device,
         "graph_enqueue_ms": graph_enqueue}
    enq = "not measured" if enqueue is None else f"{enqueue:8.4f}"
    print(f"  {name:44s} {launches:5d} launches: eager host {host:9.4f} ms (enqueue "
          f"{enq}), device {device:9.4f} ms; graph host {graph_host:9.4f} ms, "
          f"device {graph_device:9.4f} ms", flush=True)
    return r


def slope(xs, ys) -> float:
    """Least-squares slope of ys over xs."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sum((x - mx) ** 2 for x in xs)


def _perturbed(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    t.add_(1.0)
    return x + t


def copy_probes(dtype=torch.bfloat16, iters: int = 20) -> dict:
    """K8 chains; returns the measurements and the per-launch slopes."""
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, H, W, C), generator=g, device=dev).to(dtype)
    t = torch.zeros((), device=dev)

    def chain(n, blocks, add=True):
        def run():
            y = _perturbed(x, t)
            for _ in range(n):
                y = lp.copy_probe(y, blocks=blocks, add=add)
            return y
        return run

    print(f"K8 copy_probe chains: x {tuple(x.shape)} {dtype}, {iters} runs each "
          f"(each run: t += 1, x + t, then the chain)")
    rows, slopes = [], {}
    for blocks in CHAIN_BLOCKS:
        chain_rows = [measure(f"{n} copies, {blocks} blocks", chain(n, blocks), iters=iters,
                              launches=n + 2) for n in COPY_CHAINS]
        rows += chain_rows
        slopes[blocks] = {k: slope(COPY_CHAINS, [r[k] for r in chain_rows]) * 1e3
                          for k in ("host_ms", "enqueue_ms", "device_ms", "graph_host_ms",
                                    "graph_device_ms")}
    rows.append(measure("1 copy, 24 blocks", chain(1, 24), iters=iters, launches=3))
    rows.append(measure("6 copies, 1 block", chain(6, 1), iters=iters, launches=8))
    rows.append(measure("18 copies y = x (r3m), 4 blocks", chain(18, 4, add=False), iters=iters,
                        launches=20))
    base = rows[0]["device_ms"]
    sweep = {}
    for blocks in BLOCK_SWEEP:
        r = measure(f"1 copy, {blocks} blocks", chain(1, blocks), iters=iters, launches=3)
        rows.append(r)
        sweep[blocks] = r["device_ms"] - base

    def adds():
        y = _perturbed(x, t)
        for _ in range(24):
            y = torch.add(y, 1.0)
        return y

    rows.append(measure("24 torch.add (control)", adds, iters=iters, launches=26))
    for blocks, sl in slopes.items():
        print(f"  per added copy (slope over 0-24 copies at {blocks} blocks, us): "
              + ", ".join(f"{k} {v:.3f}" for k, v in sl.items()))
    print("  one copy's device time by blocks (us, over the 0-copy run): "
          + ", ".join(f"{b}: {v * 1e3:.2f}" for b, v in sweep.items()))
    return {"rows": rows, "slope_us": slopes, "block_sweep_ms": sweep}


def _trunk_inputs(g, dev, dtype):
    def w(*shape):
        return torch.randn(shape, generator=g, device=dev) * 0.02

    params = []
    for _ in range(RSTBS):
        p = {"ln1_s": 1.0 + w(D, C), "ln1_b": w(D, C), "qkv_w": w(D, C, 3 * C),
             "qkv_b": w(D, 3 * C), "proj_w": w(D, C, C), "proj_b": w(D, C),
             "ln2_s": 1.0 + w(D, C), "ln2_b": w(D, C), "fc1_w": w(D, C, 2 * C),
             "fc1_b": w(D, 2 * C), "fc2_w": w(D, 2 * C, C), "fc2_b": w(D, C)}
        params.append((p, w(D, NH, WS * WS, WS * WS)))
    mask = torch.from_numpy(shift_attn_mask(H, W, WS, WS // 2)).to(dev)
    dpm = (torch.rand((D, 2, B), generator=g, device=dev) < 0.9).float() / 0.9
    x = torch.randn((B, H, W, C), generator=g, device=dev).to(dtype)
    return x, params, mask, dpm


def skeleton_probes(dtype=torch.bfloat16, iters: int = 20) -> dict:
    """K9 six-call chains, one per variant."""
    dev = resolve_device("cuda")
    x, params, mask, dpm = _trunk_inputs(torch.Generator(device=dev).manual_seed(1), dev, dtype)
    p, rpb = params[0]
    t = torch.zeros((), device=dev)

    def chain(full_args=True, **flags):
        def run():
            y = _perturbed(x, t)
            for _ in range(6):
                if full_args:
                    y = lp.trunk_skeleton(y, p, rpb, mask, dpm, **flags)
                else:
                    y = lp.trunk_skeleton(y)
                if flags.get("outputs"):
                    y = y[0]
            return y
        return run

    print(f"K9 trunk_skeleton six-call chains: x {tuple(x.shape)} {dtype}, D={D}, {iters} runs each")
    rows = {tag: measure(f"{tag}: 6 skeleton calls", chain(**flags), iters=iters, launches=8)
            for tag, flags in SKELETON_VARIANTS.items()}
    return {"rows": rows}


def trunk_control(iters: int = 5) -> dict:
    """v_h: the real trunk over 6 RSTBs, forward and forward + backward, f32
    and bf16, eager and captured."""
    dev = resolve_device("cuda")
    rows = {}
    print(f"v_h real trunk: {RSTBS} RSTBs x {D} blocks on ({B}, {H}, {W}, {C}), {iters} runs each")
    for dtype in (torch.float32, torch.bfloat16):
        x, params, mask, dpm = _trunk_inputs(torch.Generator(device=dev).manual_seed(2), dev,
                                             dtype)
        t = torch.zeros((), device=dev)
        label = "bf16" if dtype == torch.bfloat16 else "f32"

        def forward(y):
            for p, rpb in params:
                y = st.swin_trunk(y, p, rpb, mask, dpm, num_heads=NH, window_size=WS)
            return y

        def fwd():
            return forward(_perturbed(x, t))

        def fwd_bwd():
            y0 = _perturbed(x, t).detach().requires_grad_()
            y = forward(y0)
            return torch.autograd.grad(y.float().square().sum(), y0)[0]

        for tag, run in (("forward", fwd), ("forward + backward", fwd_bwd)):
            st.reset_launch_counts()
            run()
            launches = sum(st.launch_counts().values())
            rows[f"{label} {tag}"] = measure(f"v_h {label} {tag}", run, iters=iters,
                                             launches=launches + 2)
        del x, params
    return {"rows": rows}


def main() -> int:
    resolve_device("cuda")
    print(f"gpu: {torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    copy_probes()
    skeleton_probes()
    trunk_control()
    return 0


if __name__ == "__main__":
    sys.exit(main())
