"""Linear algebra: the port of `paddle_tpu/ops/linalg.py`.

`matmul` (with `transpose_x` / `transpose_y`), `mm`, `bmm`, `addmm` and
`einsum` consult `amp` (they compute in the amp dtype when the policy
names them and give float32 back). `norm(x, p="fro", axis=None)` is the
reference's: the Frobenius norm of everything with no axis, a vector
p-norm over one axis (inf / -inf / 0 included) and a matrix norm over
two; `dist` the p-norm of x - y; `slogdet` stacks [sign, log|det|];
`lstsq` gives numpy's residuals (the squared residual of each column
when the system is overdetermined and of full rank, else empty).
"""
from __future__ import annotations

import torch

from .. import amp


def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    (x, y), back = amp.cast_inputs("matmul", x, y)
    return back(torch.matmul(x, y))


def mm(x, y):
    (x, y), back = amp.cast_inputs("mm", x, y)
    return back(torch.matmul(x, y))


def bmm(x, y):
    (x, y), back = amp.cast_inputs("bmm", x, y)
    return back(torch.matmul(x, y))


def dot(x, y):
    return (x * y).sum(-1)


def addmm(input, x, y, beta=1.0, alpha=1.0):  # noqa: A002
    (input, x, y), back = amp.cast_inputs("addmm", input, x, y)
    return back(beta * input + alpha * torch.matmul(x, y))


def outer(x, y):
    return torch.outer(x, y)


def inner(x, y):
    return torch.inner(x, y)


def multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    operands, back = amp.cast_inputs("einsum", *operands)
    return back(torch.einsum(equation, *operands))


def _inf(p):
    return p == float("inf")


def norm(x, p="fro", axis=None, keepdim=False):
    if p == "fro" and axis is None:
        return torch.sqrt(torch.sum(torch.square(x)))
    if axis is None:
        x, axis = x.reshape(-1), 0
    if isinstance(axis, (list, tuple)) and len(axis) == 2:
        return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                        keepdim=keepdim)
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    if _inf(p):
        return torch.amax(torch.abs(x), dim=axis, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=axis, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=axis, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                               keepdim=keepdim), 1.0 / p)


p_norm = norm


def dist(x, y, p=2):
    d = torch.abs(x - y)
    if p == 0:
        return torch.sum((d != 0).to(x.dtype))
    if _inf(p):
        return torch.amax(d)
    if p == float("-inf"):
        return torch.amin(d)
    return torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)


def cholesky(x, upper=False):
    return torch.linalg.cholesky(x, upper=upper)


def cholesky_solve(x, y, upper=False):
    return torch.cholesky_solve(x, y, upper=upper)


def inverse(x):
    return torch.linalg.inv(x)


def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(x, rtol=tol, hermitian=hermitian)


def det(x):
    return torch.linalg.det(x)


def slogdet(x):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


def qr(x, mode="reduced"):
    return tuple(torch.linalg.qr(x, mode=mode))


def eigh(x, UPLO="L"):
    w, v = torch.linalg.eigh(x, UPLO=UPLO)
    return w, v


def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def solve(x, y):
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(
        a, y, upper=upper != transpose, unitriangular=unitriangular)


def lstsq(x, y, rcond=None):
    sol = torch.linalg.lstsq(x, y, rcond=rcond).solution
    rank = torch.linalg.matrix_rank(x)
    m, n = x.shape[-2], x.shape[-1]
    if m > n and int(rank.min()) == n:
        res = torch.sum(torch.square(y - x @ sol), dim=-2)
    else:
        res = x.new_zeros((0,))
    return sol, res, rank, torch.linalg.svdvals(x)


def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def cross(x, y, axis=-1):
    return torch.linalg.cross(x, y, dim=axis)


def bincount(x, weights=None, minlength=0):
    return torch.bincount(x.reshape(-1), weights, minlength)


def mv(x, vec):
    return torch.matmul(x, vec)


def corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.transpose(-1, -2),
                     correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


__all__ = ["matmul", "mm", "bmm", "dot", "addmm", "outer", "inner",
           "multi_dot", "einsum", "norm", "p_norm", "dist", "cholesky",
           "cholesky_solve", "inverse", "matrix_power", "matrix_rank", "det",
           "slogdet", "svd", "qr", "eigh", "eigvalsh", "solve",
           "triangular_solve", "lstsq", "pinv", "cross", "bincount", "mv",
           "corrcoef", "cov"]
