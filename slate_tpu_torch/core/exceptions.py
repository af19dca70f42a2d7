"""Error type of the port (own copy of ``slate_tpu/core/exceptions.py``)."""

from __future__ import annotations


class SlateError(RuntimeError):
    """Host-side argument or state error; numerical failures are
    reported as ``info`` values, as in the reference."""
