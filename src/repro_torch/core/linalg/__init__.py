from .svd import GRAM_THRESHOLD, SVDResult, compute_pca, compute_svd
from .tsqr import tsqr

__all__ = ["GRAM_THRESHOLD", "SVDResult", "compute_pca", "compute_svd", "tsqr"]
