"""Full-precision matmuls around every factorization path.

The reference pins ``jax.default_matmul_precision("highest")`` around
its factorizations. On an NVIDIA card the matching hazard is TF32:
float32 matmuls and convolutions may run with a 10-bit mantissa. ``accurate_matmuls``
turns TF32 off for cuBLAS and cuDNN, sets the float32 matmul precision to
"highest" and keeps bfloat16 products' reductions in float32 (cuBLAS may
otherwise reduce them in bfloat16; the reference's bf16 products
accumulate in f32 at HIGHEST) for the duration of a call, restoring the
caller's settings on exit. ``Options.update_precision`` has no effect in
the port: no factorization path runs below full precision, and a lower
factor precision is asked for only through a refine policy.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def full_precision():
    """Context: TF32 off, float32 matmul precision "highest", bfloat16
    products reduced in float32."""
    mm = torch.backends.cuda.matmul
    saved = (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision(),
             mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
        mm.allow_bf16_reduced_precision_reduction = saved[3]


def accurate_matmuls(fn):
    """Decorator: run ``fn`` under :func:`full_precision`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_precision():
            return fn(*args, **kwargs)

    return wrapped
