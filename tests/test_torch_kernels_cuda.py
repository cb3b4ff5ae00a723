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

from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.ops import gram, gram_kernels

pytestmark = pytest.mark.cuda

#: Ragged tiles, unaligned B (masked stores), M > 32 (several chunks), and the
#: main path's shapes (TMA stores).
SHAPES = [(37, 61, 5), (150, 150, 7), (4097, 4095, 30), (513, 1000, 70), (4096, 4096, 30),
          (8192, 8192, 30)]

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
    with pinned_device(torch.device('cuda')):
        yield torch.device('cuda')


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


@pytest.mark.parametrize('A, M', [(150, 7), (1000, 70), (4096, 30), (8192, 30), (10240, 30),
                                  (20000, 30)])
def test_one_operand(cuda, A, M):
    """A training gram hands the kernel one tensor (u is v): it is packed once,
    the diagonal is exactly 1, and autograd sums both input gradients. 10240
    and 20000 rows are the large route's shapes (ragged: masked stores)."""
    u, _ = _inputs(A, 1, M, cuda, seed=4)
    before = gram_kernels.LAUNCHES
    got = gram_kernels.unit_gram_cuda(u, u)
    torch.cuda.synchronize()
    assert gram_kernels.LAUNCHES == before + 1
    torch.testing.assert_close(got, gram_kernels.unit_gram_plain(u, u), rtol=VALUE_TOL,
                               atol=VALUE_TOL)
    assert torch.all(torch.diagonal(got) == 1.0)
    gbar = torch.randn(A, A, generator=torch.Generator().manual_seed(5)).to(cuda)
    grads = []
    for fn in (gram_kernels.unit_gram, gram_kernels.unit_gram_plain):
        uu = u.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(torch.sum(fn(uu, uu) * gbar), uu)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=0.0,
                               atol=GRAD_RTOL * grads[1].abs().max().item())


def test_calls_on_two_streams_and_of_changing_size(cuda):
    """Each stream keeps its own packed scratch, grown as calls need, and each
    output gets a store descriptor of its own: calls that alternate streams,
    shapes and live outputs all stay right."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    inputs = [_inputs(A, B, M, cuda, seed=A) for A, B, M in
              [(256, 512, 30), (4096, 4096, 30), (256, 512, 30), (300, 128, 70)]]
    torch.cuda.synchronize()
    outs = []
    for i, (u, v) in enumerate(inputs * 2):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(gram_kernels.unit_gram_cuda(u, v))
    torch.cuda.synchronize()
    for (u, v), got in zip(inputs * 2, outs):
        torch.testing.assert_close(got, gram_kernels.unit_gram_plain(u, v), rtol=VALUE_TOL,
                                   atol=VALUE_TOL)


def test_dispatch_sends_only_float32_cuda_to_the_kernel(cuda):
    """A float32 variant gram is one batched launch over its outputs; a
    float64 one takes the plain path and launches nothing."""
    x = torch.randn(50, 7, generator=torch.Generator().manual_seed(3)).to(cuda)
    ls, s2 = torch.full((2, 7), 1.5, device=cuda), torch.tensor([1.0, 2.0], device=cuda)
    before, batched = gram_kernels.LAUNCHES, gram_kernels.BATCHED_LAUNCHES
    got = gram.rbf_gram_variant(x, x, ls, s2)
    assert (gram_kernels.LAUNCHES, gram_kernels.BATCHED_LAUNCHES) == (before + 1, batched + 1)
    want = gram.rbf_gram_variant(x.double(), x.double(), ls.double(), s2.double())
    assert gram_kernels.LAUNCHES == before + 1
    torch.testing.assert_close(got.double(), want, rtol=VALUE_TOL, atol=VALUE_TOL)


#: (n, A, B, M, u is v): the main path's batches (two 4096-row folds x 3
#: outputs; phase 8b's two 5120-row folds x 3; one fold's 3 outputs at 8192),
#: ragged two-operand batches (masked and TMA stores, several M chunks), a
#: batch of one, and large batch counts: csv_script's 20 folds x 3 outputs
#: (at 3800 rows, ragged) and benchmark_script's 2 folds x 9 outputs (M=19).
BATCHES = [(6, 4096, 4096, 30, True), (6, 5120, 5120, 30, True), (3, 8192, 8192, 30, True),
           (3, 4097, 1000, 70, False), (2, 37, 61, 5, False), (4, 150, 150, 7, True),
           (1, 300, 200, 30, False), (60, 3800, 3800, 30, True), (18, 1000, 1000, 19, True)]


def _batch(n, A, B, M, shared, on, seed=0):
    g = torch.Generator().manual_seed(seed)
    scale = 1.5 / math.sqrt(M)
    u = (torch.randn(n, A, M, generator=g) * scale).to(on)
    return u, u if shared else (torch.randn(n, B, M, generator=g) * scale).to(on)


@pytest.mark.parametrize('n, A, B, M, shared', BATCHES)
def test_batched_launch_matches_plain_and_single_launches(cuda, n, A, B, M, shared):
    """One launch for a batch: each member against the plain version, and
    bit for bit against its own single launch (the same tiles, the same
    arithmetic)."""
    u, v = _batch(n, A, B, M, shared, cuda)
    before = gram_kernels.LAUNCHES
    got = gram_kernels.unit_gram_cuda(u, v)
    torch.cuda.synchronize()
    assert gram_kernels.LAUNCHES == before + 1
    assert got.shape == (n, A, B) and torch.isfinite(got).all()
    torch.testing.assert_close(got, gram_kernels.unit_gram_plain(u, v), rtol=VALUE_TOL,
                               atol=VALUE_TOL)
    for i in range(n):
        single = gram_kernels.unit_gram_cuda(u[i], u[i] if shared else v[i])
        assert torch.equal(got[i], single), i
    if shared:
        assert torch.all(torch.diagonal(got, dim1=-2, dim2=-1) == 1.0)


def test_batched_backward_matches_plain(cuda):
    u, v = _batch(3, 513, 1000, 70, False, cuda, seed=1)
    gbar = torch.randn(3, 513, 1000, generator=torch.Generator().manual_seed(2)).to(cuda)
    grads = []
    for fn in (gram_kernels.unit_gram, gram_kernels.unit_gram_plain):
        uu, vv = u.clone().requires_grad_(True), v.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(torch.sum(fn(uu, vv) * gbar), (uu, vv)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0.0, atol=GRAD_RTOL * want.abs().max().item())


def test_batch_past_32_bit_offsets(cuda):
    """n * A * B above 2^31: the last member's output starts past any 32-bit
    offset, and is still right."""
    n, A, M = 9, 16384, 30
    u, _ = _batch(n, A, A, M, True, cuda, seed=6)
    assert n * A * A > 2 ** 31
    got = gram_kernels.unit_gram_cuda(u, u)
    torch.cuda.synchronize()
    for i in (0, n - 1):
        torch.testing.assert_close(got[i], gram_kernels.unit_gram_plain(u[i], u[i]),
                                   rtol=VALUE_TOL, atol=VALUE_TOL)


def test_variant_gram_of_per_member_inputs(cuda):
    """rbf_gram_variant over members with inputs of their own (the outputs of
    several folds), one launch, against the float64 plain path."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(4, 300, 7, generator=g).to(cuda)
    ls = (0.8 + torch.rand(4, 7, generator=g)).to(cuda)
    s2 = (0.5 + torch.rand(4, generator=g)).to(cuda)
    before = gram_kernels.LAUNCHES
    got = gram.rbf_gram_variant(x, x, ls, s2)
    assert gram_kernels.LAUNCHES == before + 1
    want = gram.rbf_gram_variant(x.double(), x.double(), ls.double(), s2.double())
    # s2 < 1.5 scales E's error; the float32 x / ls rounds on the kernel's side only.
    torch.testing.assert_close(got.double(), want, rtol=VALUE_TOL, atol=2 * VALUE_TOL)


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


def _covariant_inputs(L, A, B, M, on, seed):
    """x1 (A,M), x2 (B,M), lengthscales (L,M) and a unit-diagonal F (L,L),
    scaled so the stacked squared distances stay of order one."""
    g = torch.Generator().manual_seed(seed)
    x1, x2 = (torch.randn(n, M, generator=g) / math.sqrt(M) for n in (A, B))
    ls = 0.7 + 0.6 * torch.rand(L, M, generator=g)
    F = torch.full((L, L), 0.3) + 0.7 * torch.eye(L)
    return [t.to(on) for t in (x1, x2, ls, F)]


def _covariant_plain(x1, x2, ls, F):
    L, A, B = ls.shape[0], x1.shape[0], x2.shape[0]
    unit = gram_kernels.unit_gram_plain(gram_kernels.stack_scaled(x1, ls),
                                        gram_kernels.stack_scaled(x2, ls))
    return F[:, None, :, None] * unit.reshape(L, A, L, B)


@pytest.mark.parametrize('L, A, B, M', [(3, 2048, 1536, 30), (3, 1000, None, 30), (2, 37, 61, 5)])
def test_covariant_gram_matches_plain(cuda, L, A, B, M):
    """The covariant gram's one launch over the stacked operands (one operand
    when x1 is x2), forward and backward in x1, x2, lengthscales and F,
    against the plain version: F entries <= 1, so the value tolerance holds."""
    x1, x2, ls, F = _covariant_inputs(L, A, B or A, M, cuda, seed=A)
    if B is None:
        x2 = x1
    before = gram_kernels.LAUNCHES
    got = gram.rbf_gram_covariant(x1, x2, ls, F)
    torch.cuda.synchronize()
    assert gram_kernels.LAUNCHES == before + 1 and got.shape == (L, A, L, x2.shape[0])
    torch.testing.assert_close(got, _covariant_plain(x1, x2, ls, F), rtol=VALUE_TOL,
                               atol=VALUE_TOL)
    gbar = torch.randn(got.shape, generator=torch.Generator().manual_seed(7)).to(cuda)
    grads = []
    for fn in (gram_kernels.rbf_gram_covariant_kernel, _covariant_plain):
        inputs = [t.clone().requires_grad_(True) for t in (x1, ls, F)]
        xx2 = inputs[0] if B is None else x2.clone().requires_grad_(True)
        leaves = inputs if B is None else inputs + [xx2]
        grads.append(torch.autograd.grad(torch.sum(fn(inputs[0], xx2, *inputs[1:]) * gbar), leaves))
    for got_grad, want in zip(*grads):
        torch.testing.assert_close(got_grad, want, rtol=0.0,
                                   atol=GRAD_RTOL * want.abs().max().item())


def test_host_route_value_and_grad_matches_float64_plain(cuda):
    """The lengthscale-frozen objective in float32 (unit gram from the
    kernel, CovariantUpperLML's analytic backward) against autograd through
    lml_covariant in float64 (plain gram) at L*N = 3000. The value is held to the first-order
    bound of a float32 LML, 10 LN eps32 (max F_ll / min noise_ll + 1); the
    gradients to 1e-2 of the largest entry, about cond(K) eps32 here
    (cond(K) ~ LN max F_ll / min noise_ll ~ 3e4)."""
    import numpy as np
    from romcomma_tpu_torch.models import gp, params
    L, N, M = 3, 1000, 30
    rng = np.random.default_rng(8)
    X = rng.uniform(size=(N, M))
    Y = np.stack([np.sin(3 * X[:, l]) + X[:, l + 1] for l in range(L)], axis=1)
    F, noise = 0.2 + 0.8 * np.eye(L), 0.1 * np.eye(L) + 0.01
    values = (F, np.full((L, M), 2.0), noise)
    mask = params.covariant_mask(kernel_covariance=True)
    results = []
    for dtype, route in ((torch.float32, 'upper'), (torch.float64, 'autograd')):
        raw = {name: t.to(dtype) for name, t in params.covariant_init(*values, on=cuda).items()}
        x, y = (torch.tensor(a, dtype=dtype, device=cuda) for a in (X, Y))
        before = gram_kernels.LAUNCHES
        objective, merge = gp._covariant_objective(raw, mask, x, y)
        assert gram_kernels.LAUNCHES == before + (dtype == torch.float32)
        if route == 'autograd':
            objective = lambda p: -gp.lml_covariant(merge(p), x, y)
        p = {name: t.clone().requires_grad_(True) for name, t in raw.items()}
        value = objective(p)
        names = [n for n in params.COVARIANT_FIELDS if n != 'raw_lengthscales']
        results.append((value.double(), [g.double() for g in
                                         torch.autograd.grad(value, [p[n] for n in names])]))
    (value32, grads32), (value64, grads64) = results
    bound = 10 * L * N * 1.1920929e-07 * (F.diagonal().max() / noise.diagonal().min() + 1)
    assert abs(value32.item() - value64.item()) <= bound
    for got, want in zip(grads32, grads64):
        torch.testing.assert_close(got, want, rtol=0.0, atol=1e-2 * want.abs().max().item())


def _distributed_tables(X, Y, Xs, hypers, on):
    """DistributedGP's float64 LML, gradient, posterior alpha, predictions at
    Xs, and first-order and total S and T (non-partial), from the same
    inputs on `on`, on the host."""
    import numpy as np
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    dgp = DistributedGP(len(X), mesh=on, dtype=np.float64, engine='upper')
    x, y = dgp.stage(X, Y)
    p = [torch.tensor(h, dtype=torch.float64, device=on, requires_grad=True) for h in hypers]
    value = dgp.lml(*p, x, y)
    tables = {'lml': value, 'grad': torch.cat([g.reshape(-1) for g in
                                               torch.autograd.grad(value, p)])}
    tables['alpha'] = dgp.posterior_alpha(*hypers, x, y)[0]
    tables['mean'], tables['var'] = dgp.predict(*hypers, x, y, Xs)
    indices = dgp.sobol_indices(*hypers, x, y, X, kind=('first_order', 'total'), error=True,
                                is_T_partial=False)
    tables = {key: value.detach().cpu().numpy() for key, value in tables.items()}
    for key in ('S', 'T'):
        tables[key] = np.array([[by_m[m] for m in sorted(by_m)]
                                for by_m in indices[key].values()])
    return tables


def test_distributed_gp_matches_cpu(cuda):
    """DistributedGP at N=1024, M=10 in float64 on the card against the CPU,
    from the same inputs: every table within 1e-8 of its largest entry (two
    float64 Choleskys of a K of cond ~1e5 differ by ~cond eps64), and T
    squared, the root of a cancelling quadform, within 10 times the CPU's
    largest response to one-ulp moves of the hyperparameters."""
    import numpy as np
    from romcomma_tpu_torch import north_star
    X, Y = north_star.problem(1024, 10)
    rng = np.random.default_rng(11)
    Xs, hypers = rng.standard_normal((64, 10)), (rng.uniform(1.5, 4.0, 10), 1.0, 0.01)
    card, cpu = (_distributed_tables(X, Y, Xs, hypers, on) for on in (cuda, 'cpu'))

    def distance(key, got, want):
        got, want = (got * got, want * want) if key == 'T' else (got, want)
        return float(np.abs(got - want).max()) / float(np.abs(want).max())

    spread = max(distance('T', _distributed_tables(X, Y, Xs, tuple(
        np.nextafter(h, np.where(np.random.default_rng(draw).random(np.shape(h)) < 0.5,
                                 -np.inf, np.inf)) for h in hypers), 'cpu')['T'], cpu['T'])
        for draw in range(3))
    for key, want in cpu.items():
        assert np.isfinite(card[key]).all(), key
        assert distance(key, card[key], want) <= (10 * spread if key == 'T' else 1e-8), key


def test_distributed_gp_float32_lml_through_the_kernel(cuda):
    """ExactLML in float32 (one unit-gram launch per value) against float64
    at N=2048, M=30: the value within the first-order bound of a float32
    LML, 10 N eps32 (s2 / noise + 1); the gradient within 1e-2 of its largest
    entry, about cond(K) eps32 here (cond(K) ~ N s2 / noise ~ 2e4)."""
    import numpy as np
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    from romcomma_tpu_torch import north_star
    X, Y = north_star.problem(2048, 30)
    hypers, results = (np.full(30, 3.0), 1.0, 0.1), []
    for dtype in (np.float32, np.float64):
        dgp = DistributedGP(2048, mesh=cuda, dtype=dtype, engine='upper')
        x, y = dgp.stage(X, Y)
        p = [torch.tensor(h, dtype=x.dtype, device=cuda, requires_grad=True) for h in hypers]
        before = gram_kernels.LAUNCHES
        value = dgp.lml(*p, x, y)
        assert gram_kernels.LAUNCHES == before + (dtype == np.float32)
        results.append((value.double(), [g.double() for g in torch.autograd.grad(value, p)]))
    (value32, grads32), (value64, grads64) = results
    assert abs(value32.item() - value64.item()) <= 10 * 2048 * 1.1920929e-07 * (1.0 / 0.1 + 1)
    for got, want in zip(grads32, grads64):
        torch.testing.assert_close(got, want, rtol=0.0, atol=1e-2 * want.abs().max().item())



def test_ring_tile_in_float64_is_float32_strips_of_the_kernel(cuda):
    """A float32 ring tile kept in float64 (the one-device engines' gram,
    MeshLML): one launch per TILE_STRIP_ROWS rows, a clamped tail included,
    each strip the bits of its own float32 launch, widened."""
    from romcomma_tpu_torch.parallel.distributed import TILE_STRIP_ROWS, ring_tile
    n = 2 * TILE_STRIP_ROWS + 300
    u, _ = _inputs(n, 1, 30, cuda, seed=3)
    ls, s2 = torch.full((30,), 0.7, device=cuda), torch.tensor(2.5, device=cuda)
    before = gram_kernels.LAUNCHES
    got = ring_tile(u, u, ls, s2, torch.float64)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and got.shape == (n, n)
    assert gram_kernels.LAUNCHES == before + 3
    for r0 in range(0, n, TILE_STRIP_ROWS):
        strip = gram.rbf_gram(u[r0:r0 + TILE_STRIP_ROWS], u, ls, s2)
        assert torch.equal(got[r0:r0 + TILE_STRIP_ROWS], strip.double()), r0


def test_covariant_mesh_float32_value_and_grad_at_one_rank(cuda):
    """DistributedCovariantGP over an NCCL group of this process alone (world
    size 1) at L N = 3 x 2048, M = 30, F and the noise covariance
    non-diagonal: one float32 value and (F, noise_cov) gradient, whose ring
    tile and three pair tiles launch the kernel, against CovariantUpperLML:
    each part within chip_smoke.py's COVARIANT_MESH_F32_MULTIPLES of
    CovariantUpperLML float32's own distance from float64, as phase 13c
    holds it."""
    import sys
    from pathlib import Path

    import numpy as np
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from romcomma_tpu_torch.models import gp
    from romcomma_tpu_torch.parallel.covariant_mesh import DistributedCovariantGP
    from romcomma_tpu_torch.parallel.distributed import make_n_mesh
    rng = np.random.default_rng(5)
    X = rng.uniform(0, 1, (2048, 30))
    Y = np.column_stack([np.sin(3 * X[:, 0]) + X[:, 1], X[:, 2] ** 2, X[:, 0] * X[:, 3]])
    Y = Y + 0.05 * rng.standard_normal(Y.shape)
    ls = np.full((3, 30), 3.0)
    F = np.array([[1.0, 0.5, 0.2], [0.5, 0.9, 0.3], [0.2, 0.3, 0.8]])
    noise = np.array([[0.01, 0.002, 0.0], [0.002, 0.012, 0.001], [0.0, 0.001, 0.011]])
    readings = {}
    for dtype in (torch.float32, torch.float64):
        x, y, ls_t, F_t, noise_t = (torch.as_tensor(a, dtype=dtype, device=cuda)
                                    for a in (X, Y, ls, F, noise))
        readings[dtype] = chip_smoke._covariant_value_and_grads(
            torch, gp.covariant_upper_lml(x, ls_t, y), F_t, noise_t)
    x, y, ls_t, F_t, noise_t = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
                                for a in (X, Y, ls, F, noise))
    with chip_smoke.nccl_group(torch):
        dgp = DistributedCovariantGP(2048, 3, make_n_mesh(), dtype=np.float32)
        lml = dgp.lml_fn(dgp.stage(x, y, ls_t))
        before = gram_kernels.LAUNCHES
        got = chip_smoke._covariant_value_and_grads(torch, lml, F_t, noise_t)
        assert gram_kernels.LAUNCHES == before + 4
    reference = chip_smoke._apart(readings[torch.float32], readings[torch.float64])
    apart = chip_smoke._apart(got, readings[torch.float64])
    assert all(np.isfinite(a) and a <= m * r for a, m, r in zip(
        apart, chip_smoke.COVARIANT_MESH_F32_MULTIPLES, reference)), (apart, reference)
