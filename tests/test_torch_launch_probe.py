"""Launch-overhead probes (K8, K9): the port's plain versions against the JAX
package's TPU probes on the CPU.

* K8 ``copy_probe`` against the copy kernel of
  ``experiments/perf_probe_r3q.py`` run by ``pl.pallas_call(...,
  interpret=True)`` with r3q's grid and block specs.  The module itself is
  not imported: at import it points JAX's compilation cache at a directory
  outside the repository, which the rest of the suite cannot bear, so its
  one-line body (:46-47, ``y = x + 1``; r3m's ``y = x``,
  ``perf_probe_r3m.py:95-96``) is restated here.
* K9 ``trunk_skeleton`` against a ``jnp`` statement of r3s's staged body
  (``perf_probe_r3s.py:114-133``; v_d without and v_g with the per-image
  drop-path reads) and r3r's body-less kernel (``perf_probe_r3r.py:160-163``,
  ``y = x + 1``, xs/xs2 zeros).  Those kernels are closures inside
  ``main()`` and cannot be imported.

All comparisons are exact: both sides add in f32 and round once per stored
value (bf16 included).  The CUDA kernels are held against these plain
versions on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sei_tpu_torch.ops import launch_probe as lp
from sei_tpu_torch.ops.swin_trunk import PARAM_LEAVES

B, H, W, C, D = 8, 8, 8, 24, 4
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _x(dtype_key, seed=0):
    x = np.random.default_rng(seed).standard_normal((B, H, W, C)).astype(np.float32) * 4
    jdt, tdt = DTYPES[dtype_key]
    jx = jnp.asarray(x).astype(jdt)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jax_copy(x, steps, add=True):
    """r3q's ``one_copy`` (:50-60) with its body (:46-47), in interpret mode."""

    def kernel(x_ref, y_ref):
        y_ref[...] = x_ref[...] + 1.0 if add else x_ref[...]

    b = x.shape[0]
    gsz = b // steps if steps <= b else b
    spec = pl.BlockSpec((gsz, *x.shape[1:]), lambda i: (i % (b // gsz), 0, 0, 0))
    return pl.pallas_call(kernel, grid=(steps,), in_specs=[spec], out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), interpret=True)(x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("blocks", [1, 4, 24])
def test_copy_probe_matches_the_tpu_probe(dtype, blocks):
    jx, tx = _x(dtype)
    for add in (True, False):
        want = np.asarray(_jax_copy(jx, blocks, add).astype(jnp.float32))
        got = lp.copy_probe(tx, blocks=blocks, add=add)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(_np(got), want)


def _jax_skeleton(x, dpm, *, body, dpm_reads):
    """r3s's staged body (:114-133) over D blocks, dpm indexed per image as
    ``_dpm_group`` (:96-102) reads it; without ``body`` r3r's copy
    (:160-163)."""
    if not body:
        zeros = jnp.zeros((D, *x.shape), x.dtype)
        return x + 1.0, zeros, zeros
    xv, xs, xs2 = x, [], []
    for j in range(D):
        da = dpm[j, 0][:, None, None, None] if dpm_reads else 1.0
        dm = dpm[j, 1][:, None, None, None] if dpm_reads else 1.0
        xs.append(xv)
        x2 = (xv.astype(jnp.float32) * 1.0 + da * 0.5).astype(xv.dtype)
        xs2.append(x2)
        xv = (x2.astype(jnp.float32) + dm * 0.25).astype(xv.dtype)
    return xv, jnp.stack(xs), jnp.stack(xs2)


def _trunk_args(seed=1):
    rng = np.random.default_rng(seed)
    params = {k: torch.from_numpy(rng.standard_normal((D, C)).astype(np.float32))
              for k in PARAM_LEAVES}
    rpb = torch.zeros((D, 2, 16, 16))
    mask = torch.zeros((4, 16, 16))
    dpm = ((rng.random((D, 2, B)) < 0.7) / 0.7).astype(np.float32)
    return params, rpb, mask, dpm


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant,flags", [
    ("v_a", dict()), ("v_b", dict(outputs=True)), ("v_d", dict(outputs=True, body=True)),
    ("v_g", dict(outputs=True, body=True, dpm_reads=True)), ("v_d_no_outputs", dict(body=True))])
def test_trunk_skeleton_matches_the_tpu_probe(dtype, variant, flags):
    jx, tx = _x(dtype)
    params, rpb, mask, dpm = _trunk_args()
    want = _jax_skeleton(jx, jnp.asarray(dpm), body=flags.get("body", False),
                         dpm_reads=flags.get("dpm_reads", False))
    got = lp.trunk_skeleton(tx, params, rpb, mask, torch.from_numpy(dpm), **flags)
    if not flags.get("outputs"):
        got = (got,)
    for g, w in zip(got, want):
        assert g.dtype == tx.dtype
        np.testing.assert_array_equal(_np(g), np.asarray(w.astype(jnp.float32)))


def test_skeleton_with_x_alone_and_argument_checks():
    jx, tx = _x("f32")
    np.testing.assert_array_equal(_np(lp.trunk_skeleton(tx)), np.asarray(jx + 1.0))
    params, rpb, mask, dpm = _trunk_args()
    with pytest.raises(ValueError, match="without params"):
        lp.trunk_skeleton(tx, outputs=True)
    with pytest.raises(ValueError, match="dpm_reads"):
        lp.trunk_skeleton(tx, params, rpb, mask, torch.from_numpy(dpm), dpm_reads=True)
    with pytest.raises(ValueError, match="dpm"):
        lp.trunk_skeleton(tx, params, rpb, mask, torch.ones(D, 2, B + 1), body=True)
    with pytest.raises(ValueError, match="blocks"):
        lp.copy_probe(tx, blocks=0)


def test_cpu_tensors_launch_nothing():
    lp.reset_launch_counts()
    _, tx = _x("f32")
    params, rpb, mask, dpm = _trunk_args()
    lp.copy_probe(tx, blocks=4)
    lp.trunk_skeleton(tx, params, rpb, mask, torch.from_numpy(dpm), outputs=True, body=True)
    assert lp.launch_counts() == {"copy_probe": 0, "trunk_skeleton": 0}
