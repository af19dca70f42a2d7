"""Stage hooks of the eigensolver and SVD drivers, for the scripts that
time (``chip_smoke.py``) and profile (``profile_factors.py``) them.

heev and hegv call each stage through its module's global name (potrf
through ``linalg/cholesky.py``, imported inside hegv), and svd through
``linalg/svd.py``'s, so replacing that name reaches every call a driver
makes. ``EIG_STAGES`` and ``SVD_STAGES`` are the lists of them;
``tests/test_torch_eig_drivers.py`` and ``tests/test_torch_svd_drivers.py``
check that each driver arm calls the stages it should through these
names. Nested stages are timed inside each other: svd's bdsqr includes
its stedc."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator

EIG_STAGES = ("potrf", "hegst", "he2td", "he2hb", "hb2td", "steqr",
              "stedc", "unmtr_he2td", "unmtr_hb2td", "unmtr_he2hb")
SVD_STAGES = ("ge2bd", "ge2tb", "bdsqr", "stedc", "hb2td", "unmtr_hb2td",
              "geqrf", "unmqr", "unmbr_ge2bd", "unmbr_ge2tb")


@contextlib.contextmanager
def _wrapped(mods, wrap: Callable[[str, Callable], Callable]
             ) -> Iterator[Dict[str, Callable]]:
    saved = {k: getattr(m, k) for k, m in mods.items()}
    for k, m in mods.items():
        setattr(m, k, wrap(k, saved[k]))
    try:
        yield saved
    finally:
        for k, m in mods.items():
            setattr(m, k, saved[k])


def wrapped_stages(wrap: Callable[[str, Callable], Callable]):
    """Replace each stage function of ``EIG_STAGES`` by
    ``wrap(name, fn)`` while in use and restore it after; yields the
    original functions by name."""
    from ..linalg import cholesky, eig
    return _wrapped({k: (cholesky if k == "potrf" else eig)
                     for k in EIG_STAGES}, wrap)


def wrapped_svd_stages(wrap: Callable[[str, Callable], Callable]):
    """``wrapped_stages`` for svd: each name of ``SVD_STAGES`` in
    ``linalg/svd.py``."""
    from ..linalg import svd
    return _wrapped({k: svd for k in SVD_STAGES}, wrap)
