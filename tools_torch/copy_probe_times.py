#!/usr/bin/env python
"""K8 ``copy_probe``'s queued times for the port found in a tree, on one
CUDA GPU.

    python tools_torch/copy_probe_times.py TREE [--unroll 1,2,4,8]

TREE is a checkout of the repo (``.`` for this one; a ``git archive`` of
another commit unpacked in a gitignored directory to compare the two in
one call, run in the order parent, change, change, parent).  With this
checkout's ``chip_smoke.py`` helpers and TREE's ``sei_tpu_torch`` (its
kernels built into TREE), it prints one line ``COPY {...}``: at the probes'
shape (8, 48, 48, 180), in bf16 and f32, ``y = x + 1`` at each block count
of ``chip_smoke.PROBE_BLOCKS`` (``queued_ms``: 20 calls queued behind a
sleeping kernel, ms per call), equal to the plain version bit for bit, and
``torch.add(x, 1.0)`` the same way, with the byte bound (one read and one
write of x at 3.35 TB/s); then the card's name and power limit.  With
``--unroll``, one such line per value, each from a library built with
``-DSEI_COPY_PROBE_UNROLL`` at that value (the packs a thread loads before
it stores; the builds side by side).
"""

import importlib.util
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
import torch  # noqa: E402

import sei_tpu_torch  # noqa: E402
from sei_tpu_torch.ops import _build  # noqa: E402
from sei_tpu_torch.ops import launch_probe as lp  # noqa: E402

assert sei_tpu_torch.__file__.startswith(tree), sei_tpu_torch.__file__
smi = cs.nvidia_smi()
variants = {"": ()}
if "--unroll" in sys.argv:
    values = sys.argv[sys.argv.index("--unroll") + 1].split(",")
    variants = {f"unroll {u}": (f"SEI_COPY_PROBE_UNROLL={u}",) for u in values}
with ThreadPoolExecutor(len(variants)) as pool:
    builds = dict(zip(variants, pool.map(_build.library, variants.values())))
default = _build.library
for label, built in builds.items():
    _build.library = lambda defines=(), b=built: b
    g = torch.Generator(device="cuda").manual_seed(3)
    out = {"tree": sys.argv[1], "build": label or "default"}
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        x = (torch.randn(cs.PROBE_SHAPE, generator=g, device="cuda") * 8).to(dtype)
        for blocks in cs.PROBE_BLOCKS:
            if not torch.equal(lp.copy_probe(x, blocks=blocks), lp._torch_copy_probe(x)):
                raise SystemExit(f"copy_probe {dt} {blocks} blocks differs from its plain version")
            out[f"{dt} {blocks} blocks"] = cs.queued_ms(lambda: lp.copy_probe(x, blocks=blocks))
        out[f"{dt} torch.add"] = cs.queued_ms(lambda: torch.add(x, 1.0))
        out[f"{dt} bound"] = cs.bound_ms(0.0, 2.0 * x.numel() * x.element_size())[0]
    print("COPY " + json.dumps(out) + "; " + smi, flush=True)
_build.library = default
