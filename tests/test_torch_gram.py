"""The port's unit-gram op and ARD-RBF grams against romcomma_tpu's.

On the CPU the port's autograd.Function runs its plain forward and its
analytic backward; the JAX side runs the Pallas kernel in interpret mode, as
tests/test_pallas.py does. Inputs are made with numpy from a seed and handed
to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romcomma_tpu.ops import gram as jax_gram
from romcomma_tpu.ops import pallas_kernels
from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.ops import gram, gram_kernels


@pytest.fixture(scope='module', autouse=True)
def _on_the_cpu():
    """The port computes on the CPU here because the tests ask for it: it
    raises where there is no CUDA device and nothing was asked for."""
    with pinned_device(torch.device('cpu')):
        yield


torch.set_num_threads(1)

#: Tolerances of tests/test_pallas.py: float32 values, and float32 gradients.
VALUE_TOL = 2e-6
GRAD_TOL = 5e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_kernels, '_INTERPRET', True)
    yield


def _rand(shape, seed, low=None, high=None):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape) if low is None else rng.uniform(low, high, size=shape)
    return a.astype(np.float32)


@pytest.mark.parametrize('A, B, M', [(37, 61, 5), (70, 33, 30), (19, 130, 40)])
def test_unit_gram_matches_pallas(A, B, M):
    u, v = _rand((A, M), 1), _rand((B, M), 2)
    want = np.asarray(pallas_kernels.unit_gram(jnp.asarray(u), jnp.asarray(v)))
    got = gram_kernels.unit_gram(torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=VALUE_TOL, atol=VALUE_TOL)
    plain = gram_kernels.unit_gram_plain(torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(plain.numpy(), want, rtol=VALUE_TOL, atol=VALUE_TOL)


def test_rbf_grams_match_pallas():
    x1, x2 = _rand((50, 7), 3), _rand((30, 7), 4)
    ls, s2 = _rand((7,), 5, 0.5, 2.0), np.float32(1.7)
    want = np.asarray(pallas_kernels.rbf_gram_pallas(jnp.asarray(x1), jnp.asarray(x2),
                                                     jnp.asarray(ls), jnp.asarray(s2)))
    args = (*map(torch.from_numpy, (x1, x2, ls)), torch.tensor(s2))
    for fn in (gram_kernels.rbf_gram_kernel, gram.rbf_gram):
        np.testing.assert_allclose(fn(*args).numpy(), want, rtol=VALUE_TOL, atol=VALUE_TOL)
    # The variant grams, through each package's dispatch (Pallas vs plain on the CPU).
    lsL, s2L = _rand((3, 7), 6, 0.5, 2.0), _rand((3,), 7, 0.5, 2.0)
    want = np.asarray(jax_gram.rbf_gram_variant(*map(jnp.asarray, (x1, x2, lsL, s2L))))
    for fn in (gram.rbf_gram_variant, gram_kernels.rbf_gram_variant_kernel):
        got = fn(*map(torch.from_numpy, (x1, x2, lsL, s2L)))
        np.testing.assert_allclose(got.numpy(), want, rtol=VALUE_TOL, atol=VALUE_TOL)


def test_rbf_gram_gradients_match_pallas():
    x1, x2 = _rand((20, 4), 6), _rand((25, 4), 7)
    ls, s2 = np.array([0.8, 1.1, 1.4, 0.6], np.float32), np.float32(2.3)

    def loss_pallas(x1, x2, ls, s2):
        return jnp.sum(jnp.sin(pallas_kernels.rbf_gram_pallas(x1, x2, ls, s2)))

    want = jax.grad(loss_pallas, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x1, x2, ls, s2)))
    args = [torch.tensor(a, requires_grad=True) for a in (x1, x2, ls, s2)]
    loss = torch.sum(torch.sin(gram_kernels.rbf_gram_kernel(*args)))
    got = torch.autograd.grad(loss, args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_f64_rbf_gram_matches_jnp_path():
    rng = np.random.default_rng(8)
    x1, x2 = rng.normal(size=(23, 5)), rng.normal(size=(17, 5))
    ls, s2 = rng.uniform(0.5, 2.0, 5), 1.3
    want = np.asarray(jax_gram.rbf_gram(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls),
                                        jnp.asarray(s2)))
    got = gram.rbf_gram(*map(torch.tensor, (x1, x2, ls)), torch.tensor(s2, dtype=torch.float64))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_cpu_tensors_take_the_plain_path():
    x = torch.from_numpy(_rand((9, 2), 12))
    before = gram_kernels.LAUNCHES
    out = gram.rbf_gram(x, x, torch.ones(2), torch.tensor(1.0))
    gram_kernels.unit_gram(x, x)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(torch.diagonal(out).numpy(), 1.0, rtol=1e-6)
    assert gram_kernels.LAUNCHES == before
    assert not gram._use_kernel(x, x)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, ties away from 0."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's 3xTF32 cross term a.b: hi.hi in one float32 accumulator and
    hi.lo + lo.hi in another (products and sums in float64 here: the split's
    own error, without the tensor cores' accumulation), added in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    big = (ah.double() @ bh.double().T).float()
    small = (ah.double() @ bl.double().T + al.double() @ bh.double().T).float()
    return big + small


def _split_unit_gram(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """E as the kernel forms it: squared norms from the same split cross term
    (each row against itself), the exponent in one float32 rounding (fma)."""
    uu, vv = torch.diagonal(_split_cross(u, u)), torch.diagonal(_split_cross(v, v))
    sqd = ((uu[:, None] + vv[None, :]).double() - 2.0 * _split_cross(u, v).double()).float()
    return torch.exp(-0.5 * torch.clamp(sqd, min=0.0).double())


def _split_cases(case: str, rng: np.random.Generator):
    """u, v at the kernel tests' scale, or at main-path magnitudes: x/ls with
    x standard normal (the normalized inputs), ls in [0.5, 5], M = 30."""
    if case == 'test scale':
        return [rng.normal(size=(n, 30)) * 1.5 / np.sqrt(30) for n in (300, 200)]
    ls = rng.uniform(0.5, 5.0, 30)
    x = rng.normal(size=(300, 30))
    other = {'main, u is v': x, 'main, two operands': rng.normal(size=(200, 30)),
             'main, near pairs': x + 1e-2 * rng.normal(size=x.shape)}[case]
    return [x / ls, other / ls]


@pytest.mark.parametrize('case', ['test scale', 'main, two operands', 'main, u is v',
                                  'main, near pairs'])
def test_split_cross_term_holds_float32_accuracy(case):
    """The kernel's 3xTF32 cross term with matching norms, emulated: E stays
    within 2e-6 of the float64 E, or, where the plain float32 version itself
    errs by more (near pairs at main-path magnitudes, whose |u|^2 reach ~120),
    no further from it than that version."""
    u, v = (torch.tensor(a, dtype=torch.float32) for a in _split_cases(case, np.random.default_rng(9)))
    exact = gram_kernels.unit_gram_plain(u.double(), v.double())
    split = (_split_unit_gram(u, v) - exact).abs().max().item()
    plain = (gram_kernels.unit_gram_plain(u, v).double() - exact).abs().max().item()
    assert split <= max(VALUE_TOL, plain), (split, plain)
    if case == 'main, u is v':
        assert torch.all(torch.diagonal(_split_unit_gram(u, u)) == 1.0)


def test_scratch_matches_the_kernels_packed_layout():
    """Per operand: hi and lo (2 x 128 x 32 floats) per 128-row block and
    32-column chunk, then one norm per padded row."""
    assert gram_kernels.scratch_floats(8192, 30) == 64 * (8192 + 128)
    assert gram_kernels.scratch_floats(4097, 30) == 33 * (8192 + 128)
    assert gram_kernels.scratch_floats(37, 70) == 3 * 8192 + 128


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match='CUDA'):
        gram_kernels.unit_gram_cuda(x, x)
