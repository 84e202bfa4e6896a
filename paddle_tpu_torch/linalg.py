"""`paddle.linalg` of the port (the reference's `paddle_tpu/linalg.py`:
the linear-algebra ops of `ops.linalg`, `inv` an alias of `inverse`)."""
from .ops.linalg import (  # noqa: F401
    cholesky, cholesky_solve, corrcoef, cov, cross, det, eigh, eigvalsh,
    inverse, lstsq, matrix_power, matrix_rank, multi_dot, mv, norm, pinv, qr,
    slogdet, solve, svd, triangular_solve,
)
from .ops.linalg import inverse as inv  # noqa: F401

__all__ = ["cholesky", "cholesky_solve", "corrcoef", "cov", "cross", "det",
           "eigh", "eigvalsh", "inverse", "inv", "lstsq", "matrix_power",
           "matrix_rank", "multi_dot", "mv", "norm", "pinv", "qr",
           "slogdet", "solve", "svd", "triangular_solve"]
