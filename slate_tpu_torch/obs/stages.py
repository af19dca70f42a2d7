"""Stage hooks of the eigensolver drivers, for the scripts that time
(``chip_smoke.py``) and profile (``profile_factors.py``) heev and hegv.

heev and hegv call each stage through its module's global name (potrf
through ``linalg/cholesky.py``, imported inside hegv), so replacing that
name reaches every call a driver makes. ``EIG_STAGES`` is the one list
of them; ``tests/test_torch_eig_drivers.py`` checks that each driver arm
calls the stages it should through these names."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator

EIG_STAGES = ("potrf", "hegst", "he2td", "he2hb", "hb2td", "steqr",
              "stedc", "unmtr_he2td", "unmtr_hb2td", "unmtr_he2hb")


@contextlib.contextmanager
def wrapped_stages(wrap: Callable[[str, Callable], Callable]
                   ) -> Iterator[Dict[str, Callable]]:
    """Replace each stage function of ``EIG_STAGES`` by
    ``wrap(name, fn)`` while in use and restore it after; yields the
    original functions by name."""
    from ..linalg import cholesky, eig
    mods = {k: (cholesky if k == "potrf" else eig) for k in EIG_STAGES}
    saved = {k: getattr(m, k) for k, m in mods.items()}
    for k, m in mods.items():
        setattr(m, k, wrap(k, saved[k]))
    try:
        yield saved
    finally:
        for k, m in mods.items():
            setattr(m, k, saved[k])
