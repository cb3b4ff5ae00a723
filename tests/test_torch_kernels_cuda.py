"""The hand-written unit-gram kernel against its plain version, on a CUDA
device, at the shapes of the port's main path. Skipped where there is no
CUDA device: the kernel has no CPU mode.

On a machine with a card, and without JAX (this file needs none, so the
suite's conftest can be skipped):

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest -o addopts='' -p no:randomly
"""

import math

import pytest
import torch

from romcomma_tpu_torch.ops import gram, gram_kernels

pytestmark = pytest.mark.cuda

SHAPES = [(37, 61, 5), (4096, 4096, 30), (8192, 8192, 30)]

#: Forward: both sides compute |u|^2 + |v|^2 - 2 u.v in float32 from inputs
#: whose squared norms stay below ~10, so the exponent differs by a few float32
#: ulps of 10 (~4e-6) at most, and E = exp(-d/2) <= 1 by half that: 2e-6 is the
#: tolerance of the TPU kernel's own tests (tests/test_pallas.py).
VALUE_TOL = 2e-6
#: Backward: float32 sums over up to 8192 products, in another order on each
#: side; held relative to the largest gradient entry.
GRAD_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the unit-gram kernel has no CPU mode')
    return torch.device('cuda')


def _inputs(A, B, M, on, seed=0):
    """u, v with squared distances of order one, so E spans (0, 1]."""
    g = torch.Generator().manual_seed(seed)
    scale = 1.5 / math.sqrt(M)
    return [(torch.randn(n, M, generator=g) * scale).to(on) for n in (A, B)]


@pytest.mark.parametrize('A, B, M', SHAPES)
def test_kernel_matches_plain(cuda, A, B, M):
    u, v = _inputs(A, B, M, cuda)
    before = gram_kernels.LAUNCHES
    got = gram_kernels.unit_gram_cuda(u, v)
    torch.cuda.synchronize()
    assert gram_kernels.LAUNCHES == before + 1
    want = gram_kernels.unit_gram_plain(u, v)
    assert got.shape == (A, B) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=VALUE_TOL, atol=VALUE_TOL)


@pytest.mark.parametrize('A, B, M', SHAPES)
def test_backward_matches_plain(cuda, A, B, M):
    u, v = _inputs(A, B, M, cuda, seed=1)
    gbar = torch.randn(A, B, generator=torch.Generator().manual_seed(2)).to(cuda)
    grads = []
    for fn in (gram_kernels.unit_gram, gram_kernels.unit_gram_plain):
        uu, vv = u.clone().requires_grad_(True), v.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(torch.sum(fn(uu, vv) * gbar), (uu, vv)))
    for got, want in zip(*grads):
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=0.0, atol=GRAD_RTOL * scale)


def test_dispatch_sends_only_float32_cuda_to_the_kernel(cuda):
    x = torch.randn(50, 7, generator=torch.Generator().manual_seed(3)).to(cuda)
    ls, s2 = torch.full((2, 7), 1.5, device=cuda), torch.tensor([1.0, 2.0], device=cuda)
    before = gram_kernels.LAUNCHES
    got = gram.rbf_gram_variant(x, x, ls, s2)
    assert gram_kernels.LAUNCHES == before + 2
    want = gram.rbf_gram_variant(x.double(), x.double(), ls.double(), s2.double())
    assert gram_kernels.LAUNCHES == before + 2
    torch.testing.assert_close(got.double(), want, rtol=VALUE_TOL, atol=VALUE_TOL)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.randn(8, 3, device=cuda)
    with pytest.raises(TypeError):
        gram_kernels.unit_gram_cuda(x.double(), x.double())
    with pytest.raises(ValueError):
        gram_kernels.unit_gram_cuda(x.T, x.T)
    with pytest.raises(ValueError):
        gram_kernels.unit_gram_cuda(x, x.cpu())
    with pytest.raises(ValueError):
        gram_kernels.unit_gram_cuda(x, torch.randn(8, 4, device=cuda))
