"""Full-precision matmuls around every factorization path.

The reference pins ``jax.default_matmul_precision("highest")`` around
its factorizations. On an NVIDIA card the matching hazard is TF32:
float32 matmuls and convolutions may run with a 10-bit mantissa. ``accurate_matmuls``
turns TF32 off for cuBLAS and cuDNN and sets the float32 matmul
precision to "highest" for the duration of a call, restoring the
caller's settings on exit. ``Options.update_precision`` has no effect in
the port: no factorization path runs below full precision.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def full_precision():
    """Context: TF32 off, float32 matmul precision "highest"."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def accurate_matmuls(fn):
    """Decorator: run ``fn`` under :func:`full_precision`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_precision():
            return fn(*args, **kwargs)

    return wrapped
