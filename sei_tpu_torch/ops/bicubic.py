"""Bicubic tap weights with PyTorch's conventions (counterpart of
``sei_tpu/ops/bicubic.py``).

Only what the padded, non-antialiased scaling transform needs is ported:
the four cubic-convolution weights (A = -0.75) of a fractional offset.  The
dense resize matrices (``resize_matrix``, antialiased and not) wait for the
antialiased and ``normal`` scaling kinds (ROADMAP, Queue 1).
"""

from __future__ import annotations

_A = -0.75  # torch's cubic convolution constant


def cubic_weights_from_frac(t):
    """The 4 tap weights for fractional offset ``t`` in [0, 1), taps at
    offsets (-1, 0, 1, 2) from floor(src); pure arithmetic on tensors (the
    same expression order as the JAX package, so f32 results agree)."""
    a = _A
    x1 = t + 1.0
    w0 = (((x1 - 5.0) * x1 + 8.0) * x1 - 4.0) * a
    w1 = ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    t2 = 1.0 - t
    w2 = ((a + 2.0) * t2 - (a + 3.0)) * t2 * t2 + 1.0
    x2 = t2 + 1.0
    w3 = (((x2 - 5.0) * x2 + 8.0) * x2 - 4.0) * a
    return w0, w1, w2, w3
