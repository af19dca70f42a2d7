"""slate_tpu_torch.spectral — two-stage heev/svd served as resident
eigendecompositions (counterpart of ``slate_tpu/spectral/``).

- :mod:`.mesh` — the staged two-stage pipelines (``heev_staged`` /
  ``svd_staged``) on one device: he2hb/ge2tb, the bulge chase, stedc,
  the back-transforms.
- :mod:`.types` — the ``EigFactors`` / ``SVDFactors`` residents and the
  served matrix-function catalog (solve-with-shift, psd projection,
  whitening, low-rank truncate, …).
- :mod:`.apply` — the served two-gemm + diagonal-scale apply and the
  sampled eigen-residual probe.
"""

from .types import (EigFactors, SVDFactors, EIG_FUNCTIONS,
                    SVD_FUNCTIONS, function_catalog)
from .mesh import (heev_staged, svd_staged, eig_level_offsets,
                   svd_level_offsets)
from .apply import make_apply_fn, make_probe_fn

__all__ = [
    "EigFactors", "SVDFactors", "EIG_FUNCTIONS", "SVD_FUNCTIONS",
    "function_catalog", "heev_staged", "svd_staged",
    "eig_level_offsets", "svd_level_offsets", "make_apply_fn",
    "make_probe_fn",
]
