"""Dense linear algebra helpers for the GP hot path, on ``torch.linalg``
(cuSOLVER and cuBLAS on a CUDA device). Counterpart of
``romcomma_tpu/ops/linalg.py``."""

from __future__ import annotations

import ctypes
import math
import os
from pathlib import Path

import torch

#: cuBLAS's 32-bit (legacy) trmm is not trusted to address a factor of more
#: elements than a 32-bit index holds: one of this many or more keeps
#: torch.cholesky_inverse.
IN_PLACE_MAX_ELEMENTS = 2 ** 31
#: Order of the diagonal blocks the triangular inverse inverts whole, and rows
#: of the product's panels: the card's fastest of 256-2048 at L N = 12288 and
#: 44280, float64 (PERF.md).
BLOCK = 1024

#: Number of K^-1 formed in place (potri's algorithm) by this process.
IN_PLACE_INVERSES = 0

_CUBLAS = None


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, batched over leading dims. Like the JAX
    package's, a factorization that breaks down yields NaN instead of raising,
    so an optimizer sees a non-finite objective and backs off."""
    chol, info = torch.linalg.cholesky_ex(a)
    return chol.masked_fill((info > 0)[..., None, None], math.nan)


def _cublas() -> ctypes.CDLL:
    """cuBLAS's shared library: the one PyTorch loaded where it is found by
    name, else the CUDA toolkit's."""
    global _CUBLAS
    if _CUBLAS is None:
        lib64 = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'lib64'
        names = ['libcublas.so.12', 'libcublas.so.13', 'libcublas.so',
                 *map(str, sorted(lib64.glob('libcublas.so*')))]
        for name in names:
            try:
                library = ctypes.CDLL(name)
                break
            except OSError:
                continue
        else:
            raise RuntimeError(f'cho_inverse_lower_: no cuBLAS library among {names}.')
        v, i = ctypes.c_void_p, ctypes.c_int
        for t, scalar in (('S', ctypes.c_float), ('D', ctypes.c_double)):
            trmm = getattr(library, f'cublas{t}trmm_v2')
            trmm.argtypes = [v, i, i, i, i, i, i, ctypes.POINTER(scalar), v, i, v, i, v, i]
            trmm.restype = ctypes.c_int
        _CUBLAS = library
    return _CUBLAS


def _trmm_(T: torch.Tensor, B: torch.Tensor, right: bool, alpha: float):
    """B := alpha T B (alpha B T where ``right``) in place, T lower
    triangular: its strict upper triangle is not read. T and B are blocks of
    one (n, n) buffer, row- or column-major. On a CUDA device cuBLAS's trmm on
    PyTorch's current stream; elsewhere its plain version."""
    if T.device.type != 'cuda':
        B.copy_(alpha * (B @ T.tril() if right else T.tril() @ B))
        return
    row, ld = T.stride(1) == 1, max(T.stride())
    m, n = B.shape
    if row:      # the memory holds B^T and T^T, upper, column-major
        side, uplo, m, n = int(not right), 1, n, m
    else:
        side, uplo = int(right), 0
    t, scalar = ('D', ctypes.c_double) if T.dtype == torch.float64 else ('S', ctypes.c_float)
    status = getattr(_cublas(), f'cublas{t}trmm_v2')(
        torch.cuda.current_blas_handle(), side, uplo, 0, 0, m, n, ctypes.byref(scalar(alpha)),
        T.data_ptr(), ld, B.data_ptr(), ld, B.data_ptr(), ld)
    if status != 0:
        raise RuntimeError(f'cho_inverse_lower_: cublas{t}trmm_v2 returned cublasStatus_t {status}.')


def _tri_inverse_(A: torch.Tensor) -> torch.Tensor:
    """X = A^-1 in place for lower triangular A (LAPACK's trtri): every
    diagonal block of BLOCK rows, and the shorter last one, inverted whole
    (one batched solve against an identity), then joined recursively: with
    A = [[A11, 0], [A21, A22]] and X11, X22 already inverted,
    X21 = -X22 A21 X11, two triangular products. n^3/3 flops."""
    n, (s0, s1) = A.shape[0], A.stride()
    k, r = divmod(n, BLOCK)
    for rows, count, at in ((BLOCK, k, 0), (r, 1 if r else 0, k * BLOCK)):
        if count:
            D = A.as_strided((count, rows, rows), (rows * (s0 + s1), s0, s1),
                             A.storage_offset() + at * (s0 + s1))
            D.copy_(torch.linalg.solve_triangular(
                D, torch.eye(rows, dtype=A.dtype, device=A.device), upper=False))

    def join(A: torch.Tensor):
        n = A.shape[0]
        if n > BLOCK:
            h = -(-n // BLOCK) // 2 * BLOCK          # a half, in whole blocks
            A11, A21, A22 = A[:h, :h], A[h:, :h], A[h:, h:]
            join(A11)
            join(A22)
            _trmm_(A22, A21, right=False, alpha=1.0)
            _trmm_(A11, A21, right=True, alpha=-1.0)

    join(A)
    return A


def _lauum_(X: torch.Tensor) -> torch.Tensor:
    """The lower triangle of X^T X in place for lower triangular X (LAPACK's
    lauum), BLOCK rows at a time from the top: row panel I becomes
    X_II^T X_I,<I + X_>I,I^T X_>I,<=I, which reads only rows below it, not yet
    overwritten. n^3/3 flops, nearly all in one GEMM a panel."""
    n = X.shape[0]
    for i in range(0, n, BLOCK):
        e = min(i + BLOCK, n)
        D = X[i:e, i:e]
        D_lower = D.tril()
        if i:
            X[i:e, :i] = D_lower.mT @ X[i:e, :i]
        D.copy_(D_lower.mT @ D_lower)
        if e < n:
            X[i:e, :e].addmm_(X[e:, i:e].mT, X[e:, :e])
    return X


def _cho_inverse_in_place_(chol: torch.Tensor) -> torch.Tensor:
    """The lower triangle of K^-1 = L^-T L^-1 in L's own buffer: potri's
    algorithm, the triangular inverse X = L^-1 then X^T X, 2n^3/3 flops."""
    global IN_PLACE_INVERSES
    _lauum_(_tri_inverse_(chol))
    IN_PLACE_INVERSES += 1
    return chol


def cho_inverse_lower_(chol: torch.Tensor) -> torch.Tensor:
    """Overwrite a lower Cholesky factor L of K with the lower triangle of
    K^-1 = L^-T L^-1, and return it; the strict upper triangle is not read
    and holds no part of the answer.

    On a CUDA device this is LAPACK's potri algorithm in the factor's own
    buffer: the triangular inverse X = L^-1 (recursive, cuBLAS's trmm), then
    the lower triangle of X^T X (row panels, one GEMM each): 2n^3/3 flops and
    no (n, n) buffer besides the factor. ``torch.cholesky_inverse`` solves
    against an identity instead (2n^3 flops, two more (n, n) buffers), and
    cuSOLVER's own potri and trtri ran slower on the card (PERF.md).
    cholesky_inverse stays the route on the CPU (LAPACK's potri) and for a
    CUDA factor of ``IN_PLACE_MAX_ELEMENTS`` or more. A CUDA factor is one
    (n, n) matrix, float32 or float64, row-major or column-major (as
    torch.linalg.cholesky leaves it). A zero on its diagonal gives a
    non-finite result, as ``cholesky`` gives NaN for a breakdown: no
    exception."""
    n = chol.shape[-1]
    if chol.device.type != 'cuda' or n * n >= IN_PLACE_MAX_ELEMENTS:
        return chol.copy_(torch.cholesky_inverse(chol))
    if chol.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'cho_inverse_lower_: float32 or float64 on a CUDA device, got {chol.dtype}.')
    if chol.dim() != 2 or chol.shape[0] != n or not (chol.is_contiguous()
                                                     or chol.mT.is_contiguous()):
        raise ValueError(f'cho_inverse_lower_: one dense (n, n) factor on a CUDA device, got shape '
                         f'{tuple(chol.shape)}, strides {chol.stride()}.')
    return _cho_inverse_in_place_(chol)


def tri_solve(chol: torch.Tensor, b: torch.Tensor, lower: bool = True,
              trans: bool = False) -> torch.Tensor:
    """Solve chol x = b (or cholᵀ x = b) for triangular chol; batch
    dimensions broadcast against each other."""
    dt = torch.promote_types(chol.dtype, b.dtype)
    chol, b = chol.to(dt), b.to(dt)
    if trans:
        return torch.linalg.solve_triangular(chol.mT, b, upper=lower)
    return torch.linalg.solve_triangular(chol, b, upper=not lower)


def cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (chol cholᵀ) x = b given the lower Cholesky factor; batched."""
    return tri_solve(chol, tri_solve(chol, b, lower=True, trans=False),
                     lower=True, trans=True)


def add_diag(a: torch.Tensor, d) -> torch.Tensor:
    """Add d (scalar or (N,) vector) to the diagonal of (..., N, N) a."""
    n = a.shape[-1]
    d = torch.as_tensor(d, dtype=a.dtype, device=a.device)
    return a + torch.eye(n, dtype=a.dtype, device=a.device) * d[..., None]


def mvn_logpdf(y: torch.Tensor, mean: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """Multivariate-normal log density of columns of y (N,D) under N(mean, chol cholᵀ).

    Matches gpflow.logdensities.multivariate_normal: returns (D,) — one log
    density per column of y (reference call: gpf/models.py:82).
    """
    alpha = tri_solve(chol, y - mean, lower=True)
    num_dims = y.shape[0]
    p = -0.5 * torch.sum(alpha * alpha, dim=0)
    p = p - 0.5 * num_dims * math.log(2.0 * math.pi)
    return p - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)))
