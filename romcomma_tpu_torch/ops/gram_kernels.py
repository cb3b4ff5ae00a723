"""The fused ARD-RBF unit-gram kernel for Hopper, its plain version, and the
grams built on it.

Counterpart of ``romcomma_tpu/ops/pallas_kernels.py``. The TPU tile kernel
``_gram_kernel`` becomes the hand-written CUDA C++ kernel in
``csrc/unit_gram.cu`` (built for ``sm_90a`` by nvcc at first use, loaded with
ctypes). The differentiable core is

    unit_gram(u, v)[a, b] = exp(-1/2 |u_a - v_b|^2)

with the analytic backward of the JAX custom VJP: with W = gbar * E,

    dL/du = W v - u * rowsum(W),    dL/dv = W^T u - v * colsum(W),

two plain float32 matmuls, never an (A, B, M) tensor. Lengthscale scaling and
the variance factor sit outside the op, so autograd carries gradients to every
hyperparameter.

A tensor on the CPU takes the plain version ``unit_gram_plain``. A CUDA tensor
always launches the kernel, or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

#: The kernel's source, and where its shared library is built (a directory
#: at the root of the checkout that .gitignore lists).
SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'unit_gram.cu'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

#: Number of kernel launches made by this process (one per unit_gram_cuda call).
LAUNCHES = 0

_LIBRARY = None
_INT_MAX = 2 ** 31 - 1
_GRID_Y_MAX = 65535 * 64        # the kernel's B tiles run on grid.y


def _nvcc() -> str:
    return shutil.which('nvcc') or str(
        Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc')


def build() -> Path:
    """Compile csrc/unit_gram.cu into a shared library, once per source and
    flag set (the file name carries their hash), and return its path."""
    digest = hashlib.sha256(SOURCE.read_bytes() + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    library = BUILD_DIR / f'unit_gram-{digest[:16]}.so'
    if not library.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = library.with_suffix(f'.{os.getpid()}.tmp')
        done = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(partial), str(SOURCE)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f'nvcc failed to build {SOURCE}:\n{done.stdout}{done.stderr}')
        os.replace(partial, library)
    return library


def _library() -> ctypes.CDLL:
    global _LIBRARY
    if _LIBRARY is None:
        library = ctypes.CDLL(str(build()))
        library.unit_gram_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
        library.unit_gram_f32.restype = ctypes.c_int
        _LIBRARY = library
    return _LIBRARY


def unit_gram_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """exp(-1/2 |u_a - v_b|^2) by the matmul expansion: the kernel's oracle and
    its CPU version."""
    uu = torch.sum(u * u, dim=-1)
    vv = torch.sum(v * v, dim=-1)
    sqd = torch.clamp(uu[:, None] + vv[None, :] - 2.0 * (u @ v.T), min=0.0)
    return torch.exp(-0.5 * sqd)


def _check(t: torch.Tensor, name: str):
    if not t.is_cuda:
        raise ValueError(f'unit_gram kernel: {name} must be a CUDA tensor, got {t.device}.')
    if t.dtype != torch.float32:
        raise TypeError(f'unit_gram kernel: {name} must be float32, got {t.dtype}.')
    if t.dim() != 2:
        raise ValueError(f'unit_gram kernel: {name} must be 2-D, got shape {tuple(t.shape)}.')
    if not t.is_contiguous():
        raise ValueError(f'unit_gram kernel: {name} must be contiguous.')


def unit_gram_cuda(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream: u (A,M), v (B,M)
    float32, contiguous, on one CUDA device -> (A,B) float32."""
    global LAUNCHES
    _check(u, 'u')
    _check(v, 'v')
    if u.device != v.device:
        raise ValueError(f'unit_gram kernel: u on {u.device} but v on {v.device}.')
    (A, M), B = u.shape, v.shape[0]
    if v.shape[1] != M or M < 1:
        raise ValueError(f'unit_gram kernel: shapes {tuple(u.shape)} and {tuple(v.shape)} '
                         'need one common, non-empty M.')
    if max(A * M, B * M) > _INT_MAX or B > _GRID_Y_MAX:
        raise ValueError(f'unit_gram kernel: shapes {tuple(u.shape)}, {tuple(v.shape)} '
                         'exceed the kernel\'s 32-bit indexing or grid.')
    out = torch.empty((A, B), dtype=torch.float32, device=u.device)
    if A == 0 or B == 0:
        return out
    library = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        error = library.unit_gram_f32(u.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      A, B, M, stream)
    if error != 0:
        raise RuntimeError(f'unit_gram kernel launch failed with CUDA error {error}.')
    LAUNCHES += 1
    return out


def _unit_gram_forward(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return unit_gram_cuda(u, v) if u.is_cuda or v.is_cuda else unit_gram_plain(u, v)


class UnitGram(torch.autograd.Function):
    """E = exp(-1/2 |u_a - v_b|^2), with the analytic backward of
    romcomma_tpu's ``_unit_gram_bwd``."""

    @staticmethod
    def forward(ctx, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        E = _unit_gram_forward(u, v)
        ctx.save_for_backward(u, v, E)
        return E

    @staticmethod
    def backward(ctx, gbar: torch.Tensor):
        u, v, E = ctx.saved_tensors
        W = gbar * E
        du = W @ v - u * torch.sum(W, dim=1)[:, None]
        dv = W.T @ u - v * torch.sum(W, dim=0)[:, None]
        return du, dv


def unit_gram(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """E[a,b] = exp(-1/2 |u_a - v_b|^2) for u (A,M), v (B,M); differentiable."""
    return UnitGram.apply(u, v)


def rbf_gram_kernel(x1: torch.Tensor, x2: torch.Tensor, lengthscales: torch.Tensor,
                    variance: torch.Tensor) -> torch.Tensor:
    """Single-output ARD-RBF gram variance * unit_gram(x1/ls, x2/ls): (A,B).
    lengthscales (M,) or scalar; variance scalar. Differentiable in all four."""
    ls = torch.broadcast_to(lengthscales, (x1.shape[-1],))
    return variance * unit_gram((x1 / ls).contiguous(), (x2 / ls).contiguous())


def rbf_gram_variant_kernel(x1: torch.Tensor, x2: torch.Tensor, lengthscales: torch.Tensor,
                            variance: torch.Tensor) -> torch.Tensor:
    """Per-output grams (L,A,B), one kernel launch per output.
    lengthscales (L,M) or (L,1); variance (L,)."""
    return torch.stack([rbf_gram_kernel(x1, x2, lengthscales[l], variance[l])
                        for l in range(lengthscales.shape[0])])
