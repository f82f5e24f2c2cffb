from .lanczos import lanczos_eigsh, svd_via_lanczos
from .randsvd import randomized_range_finder, randomized_svd
from .svd import (GRAM_THRESHOLD, RANDOMIZED_K_THRESHOLD, SVDResult,
                  compute_pca, compute_svd)
from .tsqr import tsqr

__all__ = ["GRAM_THRESHOLD", "RANDOMIZED_K_THRESHOLD", "SVDResult",
           "compute_pca", "compute_svd", "lanczos_eigsh",
           "randomized_range_finder", "randomized_svd", "svd_via_lanczos",
           "tsqr"]
