#!/usr/bin/env python
"""The LayerNorm kernels' times for the port found in a tree, on one CUDA GPU.

    python tools_torch/ln_times.py TREE

TREE is a checkout of the repo (``.`` for this one; a ``git archive`` of
another commit unpacked in a gitignored directory to compare the two in
one call, run in the order parent, change, change, parent).  With this
checkout's ``chip_smoke.py`` helpers and TREE's ``sei_tpu_torch`` (its
kernels built into TREE), it prints one line ``LN {...}``: at both training
graphs (T = 36864 and 18432 tokens, C = 180), the f32 step's LN backward
calls (LN2 in pixel order, LN1 through the shifted window map, the residual
gradient added; the wrapper's call, its dgamma/dbeta sums included) and the
bf16 step's LN forward calls (LN1 windowed, LN2), each held against its
plain version at ``chip_smoke.py``'s tolerances and timed queued (20 calls
behind a sleeping kernel, ms per call); the backward's device time apart
(torch.profiler: the LN kernel, the sums); the library calls
(``native_layer_norm_backward``, ``F.layer_norm`` in bf16) queued; the
sums per SwinBlock (backward: LN2 + LN1; forward: twice LN1 + LN2, the
forward and the backward's recompute) and the byte bounds; then the
card's name and power limit.
"""

import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import sei_tpu_torch  # noqa: E402
from sei_tpu_torch.ops import _build  # noqa: E402
from sei_tpu_torch.ops import swin_trunk as st  # noqa: E402

assert sei_tpu_torch.__file__.startswith(tree), sei_tpu_torch.__file__
smi = cs.nvidia_smi()
_build.library()
g = torch.Generator(device="cuda").manual_seed(25)
c, bf = cs.C, torch.bfloat16
out = {"tree": sys.argv[1]}
block = {}
for b in cs.TRAIN_GRAPHS:
    t = b * cs.CROP * cs.CROP
    wm = st.WindowMap(cs.CROP, cs.CROP, cs.WS, cs.WS // 2)
    x = torch.randn((b, cs.CROP, cs.CROP, c), generator=g, device="cuda")
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
    beta = 0.1 * torch.randn(c, generator=g, device="cuda")
    for variant, xx, wmap in (("ln2", x.view(t, c), None), ("ln1_window", x, wm)):
        dz, dres = torch.randn((t, c), generator=g, device="cuda"), torch.randn_like(xx)

        def call(xx=xx, dz=dz, wmap=wmap, dres=dres):
            return st.ln_rows_bwd(xx, gamma, dz, window=wmap, dres=dres)

        for i, (a, p, tol) in enumerate(zip(call(), st._torch_ln_rows_bwd(xx, gamma, dz, wmap, dres),
                                            ((1e-5, 1e-5), (1e-3, 1e-4), (1e-3, 1e-4)))):
            cs.compare(f"ln_rows_bwd[f32 {variant} T={t}][{i}]", a, p, *tol)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x.view(t, c), [c], gamma, None, 1e-5)
        key = f"ln_rows_bwd f32 {variant} T={t}"
        out[key] = cs.queued_ms(call)
        split = cs.device_ms_by_name(call)
        out[key + " kernel"] = sum(ms for k, ms in split.items() if "ln_rows_bwd" in k)
        out[key + " sums"] = sum(ms for k, ms in split.items() if "reduce_kernel" in k)
        out[key + " library"] = cs.queued_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dz, x.view(t, c), [c], mean, rstd, gamma, None, [True, True, False]))
        block.setdefault(f"ln_rows_bwd f32 T={t}", [0.0, 0.0, 0.0])
        bound = cs.bound_ms(12.0 * t * c, 4.0 * (4 * t * c + 3 * c))[0]
        for j, v in enumerate((out[key], out[key + " library"], bound)):
            block[f"ln_rows_bwd f32 T={t}"][j] += v
    xb = x.to(bf)
    for variant, xx, wmap in (("ln1_shift_window", xb, wm), ("ln2", xb.view(t, c), None)):
        cs.compare_bf16(f"ln_rows[bf16 {variant} T={t}]", st.ln_rows(xx, gamma, beta, window=wmap),
                        st._torch_ln_rows(xx, gamma, beta, wmap), (0, 0))
        key = f"ln_rows bf16 {variant} T={t}"
        out[key] = cs.queued_ms(lambda xx=xx, wmap=wmap: st.ln_rows(xx, gamma, beta, window=wmap))
        gb, bb = gamma.to(bf), beta.to(bf)
        out[key + " library"] = cs.queued_ms(lambda: F.layer_norm(xb.view(t, c), (c,), gb, bb, 1e-5))
        block.setdefault(f"ln_rows bf16 T={t}", [0.0, 0.0, 0.0])
        bound = cs.bound_ms(8.0 * t * c, 4.0 * t * c + 8.0 * c)[0]
        for j, v in enumerate((out[key], out[key + " library"], bound)):
            block[f"ln_rows bf16 T={t}"][j] += 2 * v
out["per SwinBlock (queued, library queued, bound)"] = block
print("LN " + json.dumps(out) + "; " + smi, flush=True)
