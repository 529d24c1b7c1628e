#!/usr/bin/env python
"""The module path's times (``fused_trunk=False``) for the port found in a
tree, on one CUDA GPU.

    python tools_torch/module_path_times.py TREE

TREE is a checkout of the repo (``.`` for this one; a ``git archive`` of
another commit unpacked in a gitignored directory to compare the two in
one call, run in the order parent, change, change, parent).  With this
checkout's ``chip_smoke.py`` helpers and TREE's ``sei_tpu_torch`` (its
kernels built into TREE), it prints one line ``FORMS {...}``: the flagship
SwinIR's forward on one seeded 256x320 deblurring measurement (weights from
seed 0; CUDA events, the mean of 10 calls after 2) in f32 and in bf16, and
the bf16 ``proposed`` step (batch 8, 48 px crops, 2 steps) eager and
captured at ``scan_steps`` 2 (chip_smoke's ``train_path`` and
``captured_train``, with their gates), then the card's name and power
limit.
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

import sei_tpu_torch  # noqa: E402
from sei_tpu_torch.ops import _build  # noqa: E402

assert sei_tpu_torch.__file__.startswith(tree), sei_tpu_torch.__file__
smi = cs.nvidia_smi()
_build.library()
images = cs.make_images(1, cs.H, cs.W, seed=0)
physics = cs.task_physics("deblurring")
y = physics.randomly_degrade(torch.as_tensor(images[0], device=physics.device)[None], 0)
out = {"tree": sys.argv[1]}
for dtype in (None, torch.bfloat16):
    model = cs.task_model("deblurring", dtype, fused_trunk=False)
    with torch.no_grad():
        out["forward " + ("bf16" if dtype else "f32")] = cs.time_ms(lambda: model(y), iters=10,
                                                                    warmup=2)
    del model
recipe = cs.Recipe("bf16 module path", dtype=torch.bfloat16, fused_trunk=False, epochs=1,
                   per_block=cs.PER_BLOCK_MODULE)
counts, trainer, eager = cs.train_path(recipe=recipe)
del trainer
captured, steady = cs.captured_train(torch.bfloat16, 2, eager, recipe=recipe)
out["step bf16 captured"] = steady
out["step bf16 eager steady"] = eager["steady_ms"]
print("FORMS " + json.dumps(out) + "; " + smi, flush=True)
