"""The fused ARD-RBF unit-gram kernel for Hopper, its plain version, and the
grams built on it.

Counterpart of ``romcomma_tpu/ops/pallas_kernels.py``. The TPU tile kernel
``_gram_kernel`` becomes the hand-written CUDA C++ kernel in
``csrc/unit_gram.cu`` (built for ``sm_90a`` by nvcc at first use, loaded with
ctypes): a pack pre-pass splits each operand for a 3xTF32 ``wgmma`` cross
term, and persistent CTAs store the tiles with TMA (see the note at the top
of the source). The differentiable core is

    unit_gram(u, v)[a, b] = exp(-1/2 |u_a - v_b|^2)

with the analytic backward of the JAX custom VJP: with W = gbar * E,

    dL/du = W v - u * rowsum(W),    dL/dv = W^T u - v * colsum(W),

two plain float32 matmuls, never an (A, B, M) tensor. Lengthscale scaling and
the variance factor sit outside the op, so autograd carries gradients to every
hyperparameter. Every function here also takes a leading batch axis, u
(B, A, M) and v (B, Bv, M) giving (B, A, Bv), which the kernel computes in one
launch: the counterpart of the grid axis that JAX's vmap adds to the
pallas_call, where romcomma_tpu vmaps its LML over outputs and folds.

A tensor on the CPU takes the plain version ``unit_gram_plain``. A CUDA tensor
always launches the kernel, or raises: there is no fallback.
"""

from __future__ import annotations

import contextlib
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

#: Number of kernel launches made by this process (one per unit_gram_cuda call,
#: whatever its batch), and how many of them were of a batch of two or more.
LAUNCHES = 0
BATCHED_LAUNCHES = 0

_LIBRARY = None
_INT_MAX = 2 ** 31 - 1
#: The kernel's packed operand layout: 128-row blocks, M in chunks of 32.
BLOCK_ROWS, CHUNK = 128, 32


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
        library.unit_gram_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        library.unit_gram_f32.restype = ctypes.c_int
        _LIBRARY = library
    return _LIBRARY


def unit_gram_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """exp(-1/2 |u_a - v_b|^2) by the matmul expansion, over any leading batch
    axes: the kernel's oracle and its CPU version."""
    uu = torch.sum(u * u, dim=-1)
    vv = torch.sum(v * v, dim=-1)
    sqd = torch.clamp(uu[..., :, None] + vv[..., None, :] - 2.0 * (u @ v.mT), min=0.0)
    return torch.exp(-0.5 * sqd)


def _check(t: torch.Tensor, name: str):
    if not t.is_cuda:
        raise ValueError(f'unit_gram kernel: {name} must be a CUDA tensor, got {t.device}.')
    if t.dtype != torch.float32:
        raise TypeError(f'unit_gram kernel: {name} must be float32, got {t.dtype}.')
    if t.dim() not in (2, 3):
        raise ValueError(f'unit_gram kernel: {name} must be 2-D or 3-D (a batch), got shape '
                         f'{tuple(t.shape)}.')
    if not t.is_contiguous():
        raise ValueError(f'unit_gram kernel: {name} must be contiguous.')


def scratch_floats(rows: int, M: int) -> int:
    """Floats of packed scratch the kernel needs for one operand of `rows`
    rows: the tf32 hi and lo parts of every 128-row block, chunk by chunk,
    then one squared norm per padded row."""
    blocks = -(-rows // BLOCK_ROWS)
    return blocks * (-(-M // CHUNK) * 2 * BLOCK_ROWS * CHUNK + BLOCK_ROWS)


#: The kernel's packed scratch, one buffer per (device, stream), kept and
#: grown as calls need: calls on one stream run in order, so each may reuse
#: it. A second allocation per call would add to the wrapper's host time,
#: which at the main path's smaller shape is close to the kernel's own.
_SCRATCH: dict = {}


def _scratch(index: int, stream: int, floats: int) -> torch.Tensor:
    buffer = _SCRATCH.get((index, stream))
    if buffer is None or buffer.numel() < floats:
        buffer = _SCRATCH[(index, stream)] = torch.empty(
            floats, dtype=torch.float32, device=torch.device('cuda', index))
    return buffer


def unit_gram_cuda(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream: u (A,M), v (B,M)
    float32, contiguous, on one CUDA device -> (A,B) float32; or a batch, u
    (n,A,M), v (n,B,M) -> (n,A,B), in one launch. When u and v are one tensor,
    it is packed once."""
    global LAUNCHES, BATCHED_LAUNCHES
    _check(u, 'u')
    _check(v, 'v')
    if u.device != v.device:
        raise ValueError(f'unit_gram kernel: u on {u.device} but v on {v.device}.')
    batched = u.dim() == 3
    n = u.shape[0] if batched else 1
    (A, M), B = u.shape[-2:], v.shape[-2]
    if v.dim() != u.dim() or v.shape[-1] != M or M < 1 or (batched and v.shape[0] != n):
        raise ValueError(f'unit_gram kernel: shapes {tuple(u.shape)} and {tuple(v.shape)} '
                         'need one common batch and one common, non-empty M.')
    # The kernel takes the batch, A, B and M as 32-bit ints, indexes rows and
    # columns with them and counts every member's 128 x 128 tiles in one; every
    # offset into the operands, the packed scratch and the output is size_t,
    # so the output holds any n x A x B, the covariant path's (L*N)^2 included.
    tiles = n * -(-A // BLOCK_ROWS) * -(-B // BLOCK_ROWS)
    if max(A * M, B * M, tiles) > _INT_MAX:
        raise ValueError(f'unit_gram kernel: shapes {tuple(u.shape)}, {tuple(v.shape)} '
                         'exceed the kernel\'s 32-bit indexing.')
    shape = (n, A, B) if batched else (A, B)
    if n == 0 or A == 0 or B == 0:
        return torch.empty(shape, dtype=torch.float32, device=u.device)
    library = _library()
    out = torch.empty(shape, dtype=torch.float32, device=u.device)
    shared = u.data_ptr() == v.data_ptr() and u.shape == v.shape
    at_v = 0 if shared else -(-n * scratch_floats(A, M) // 64) * 64   # 256-byte aligned
    # The C entry launches on the current device; switch only when u is elsewhere.
    index = u.device.index
    with contextlib.nullcontext() if index == torch.cuda.current_device() else torch.cuda.device(index):
        stream = torch._C._cuda_getCurrentRawStream(index)
        base = _scratch(index, stream, at_v + n * scratch_floats(B, M)).data_ptr()
        error = library.unit_gram_f32(u.data_ptr(), v.data_ptr(), base, base + 4 * at_v,
                                      out.data_ptr(), n, A, B, M, stream)
    if error != 0:
        raise RuntimeError(f'unit_gram kernel launch failed with CUDA error {error} '
                           '(-1: CUDA refused the output\'s TMA descriptor).')
    LAUNCHES += 1
    BATCHED_LAUNCHES += int(n > 1)
    return out


def _unit_gram_forward(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return unit_gram_cuda(u, v) if u.is_cuda or v.is_cuda else unit_gram_plain(u, v)


class UnitGram(torch.autograd.Function):
    """E = exp(-1/2 |u_a - v_b|^2), with the analytic backward of
    romcomma_tpu's ``_unit_gram_bwd``, member by member of a batch."""

    @staticmethod
    def forward(ctx, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        E = _unit_gram_forward(u, v)
        ctx.save_for_backward(u, v, E)
        return E

    @staticmethod
    def backward(ctx, gbar: torch.Tensor):
        u, v, E = ctx.saved_tensors
        W = gbar * E
        du = W @ v - u * torch.sum(W, dim=-1)[..., None]
        dv = W.mT @ u - v * torch.sum(W, dim=-2)[..., None]
        return du, dv


def unit_gram(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """E[a,b] = exp(-1/2 |u_a - v_b|^2) for u (A,M), v (B,M), or for each
    member of u (n,A,M), v (n,B,M); differentiable."""
    return UnitGram.apply(u, v)


def rbf_gram_kernel(x1: torch.Tensor, x2: torch.Tensor, lengthscales: torch.Tensor,
                    variance: torch.Tensor) -> torch.Tensor:
    """Single-output ARD-RBF gram variance * unit_gram(x1/ls, x2/ls): (A,B).
    lengthscales (M,) or scalar; variance scalar. Differentiable in all four.
    A training gram (x1 is x2) scales its inputs once and hands the kernel one
    tensor; autograd then sums the two input gradients into it. Where no
    gradient is recorded (an engine's gram, a custom backward's forward) the
    variance scales the kernel's output in place, so that no second (A, B)
    buffer lives beside it."""
    ls = torch.broadcast_to(lengthscales, (x1.shape[-1],))
    u = (x1 / ls).contiguous()
    E = unit_gram(u, u if x2 is x1 else (x2 / ls).contiguous())
    if torch.is_grad_enabled() and (E.requires_grad or variance.requires_grad):
        return variance * E
    return E.mul_(variance)


def stack_scaled(x: torch.Tensor, lengthscales: torch.Tensor) -> torch.Tensor:
    """x (A,M) scaled by each output's lengthscales (L,M) and stacked
    output-major, contiguous: (L*A, M), row l*A + a = x_a / lam_l."""
    L, M = lengthscales.shape
    return (x[None, :, :] / lengthscales[:, None, :]).reshape(L * x.shape[0], M).contiguous()


def rbf_gram_covariant_kernel(x1: torch.Tensor, x2: torch.Tensor, lengthscales: torch.Tensor,
                              F: torch.Tensor) -> torch.Tensor:
    """Covariant gram (L,A,L,B) = F[l,j] * unit_gram(x1/lam_l, x2/lam_j): ONE
    kernel launch over the inputs scaled per output and stacked, (L*A, M)
    against (L*B, M), with F applied outside. A training gram (x1 is x2)
    hands the kernel one stacked tensor, as rbf_gram_kernel does."""
    L = lengthscales.shape[0]
    u = stack_scaled(x1, lengthscales)
    unit = unit_gram(u, u if x2 is x1 else stack_scaled(x2, lengthscales))
    unit = unit.reshape(L, x1.shape[0], L, x2.shape[0])
    return F[:, None, :, None] * unit


def rbf_gram_variant_kernel(x1: torch.Tensor, x2: torch.Tensor, lengthscales: torch.Tensor,
                            variance: torch.Tensor) -> torch.Tensor:
    """Per-member grams (L,A,B) = variance[l] * unit_gram(x1/lam_l, x2/lam_l)
    in ONE kernel launch over the inputs scaled per member and stacked:
    lengthscales (L,M) or (L,1); variance (L,); x1 (A,M) and x2 (B,M) shared
    by the members (one fold's outputs), or (L,A,M) and (L,B,M), one per
    member (the outputs of several folds). A training gram (x1 is x2) hands
    the kernel one stacked tensor."""
    ls = lengthscales[:, None, :]
    u = (x1 / ls).contiguous()
    return variance[:, None, None] * unit_gram(u, u if x2 is x1 else (x2 / ls).contiguous())
