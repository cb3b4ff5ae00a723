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
#: main path's shapes (TMA stores), the streaming gradient's two among them:
#: a pair tile and a strip's gram rows at Npad = 50176.
SHAPES = [(37, 61, 5), (150, 150, 7), (4097, 4095, 30), (513, 1000, 70), (4096, 4096, 30),
          (8192, 8192, 30), (2048, 2048, 30), (2048, 50176, 30)]

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
    """DistributedGP's 'upper' LML (the streaming route) in float32 (one
    unit-gram launch per value) against float64
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



def test_upper_streaming_route_on_the_card(cuda):
    """engine='upper' in float32 at N=5000, M=30 (Npad 5120: three strips,
    the last clamped): one gram launch in the forward, which leaves V alone
    of (Npad, Npad) size held, then one launch per pair tile (6) or 'vvt'
    strip (3); against float64
    ExactLML, as test_distributed_gp_float32_lml_through_the_kernel holds
    ExactLML float32: the value within 10 N eps32 (s2 / noise + 1), each
    gradient part within 1e-2 of its largest entry (cond(K) eps32 here); the
    pair tiles against the 'vvt' strips within the same."""
    import numpy as np
    from romcomma_tpu_torch import north_star
    from romcomma_tpu_torch.models.gp import ExactLML
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    X, Y = north_star.problem(5000, 30)
    hypers = (np.full(30, 2.0), 1.0, 0.05)
    V, slack = 5120 ** 2 * 4, 4 * 5120 * 2048 * 4
    readings = {}
    for dtype, route in ((np.float32, 'pairs'), (np.float32, 'vvt'), (np.float64, 'exact')):
        dgp = DistributedGP(5000, mesh=cuda, dtype=dtype, engine='upper')
        dgp.GRAD_PAIR_TILES = route == 'pairs'
        x, y = dgp.stage(X, Y)
        p = [torch.tensor(h, dtype=x.dtype, device=cuda, requires_grad=True) for h in hypers]
        torch.cuda.synchronize()
        held, before = torch.cuda.memory_allocated(), gram_kernels.LAUNCHES
        value = ExactLML.apply(*p, x, y) if route == 'exact' else dgp.lml(*p, x, y)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated() - held
        forward = gram_kernels.LAUNCHES - before
        grads = torch.autograd.grad(value, p)
        torch.cuda.synchronize()
        launches = gram_kernels.LAUNCHES - before
        readings[route] = [value.detach().double()] + [g.double() for g in grads]
        if route != 'exact':
            assert forward == 1 and launches == 1 + (6 if route == 'pairs' else 3)
            assert V <= after <= V + slack, after
    want = readings['exact']
    assert abs(readings['pairs'][0] - want[0]).item() <= 10 * 5000 * 1.1920929e-07 * (
        1.0 / 0.05 + 1)
    for got, ref in ((readings['pairs'], want), (readings['vvt'], want),
                     (readings['pairs'], readings['vvt'])):
        for g, w in zip(got[1:], ref[1:]):
            torch.testing.assert_close(g, w, rtol=0.0, atol=1e-2 * w.abs().max().item())


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
    tile and three pair tiles launch the kernel, against CovariantUpperLML's
    float64: each part within chip_smoke.py's COVARIANT_MESH_F32_MULTIPLES of
    the all-float32 one-device LML's own distance from float64
    (chip_smoke.covariant_float32_value_and_grads), as phase 13c holds it."""
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
    x, y, ls_t, F_t, noise_t = (torch.as_tensor(a, dtype=torch.float64, device=cuda)
                                for a in (X, Y, ls, F, noise))
    readings[torch.float64] = chip_smoke._covariant_value_and_grads(
        torch, gp.covariant_upper_lml(x, ls_t, y), F_t, noise_t)
    x, y, ls_t, F_t, noise_t = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
                                for a in (X, Y, ls, F, noise))
    readings[torch.float32] = chip_smoke.covariant_float32_value_and_grads(
        torch, x, y, ls_t, F_t, noise_t)
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


# --------------------------------------------------------------------------- #
# The fused W/T sweep (gsa/sweep_kernel.py) against the plain _run_chunk
# --------------------------------------------------------------------------- #

#: Every sweep mode of _run_chunk (prefix-last only, forward with 'single',
#: 'suffix' alone, the single-sweep mode, full prefix columns and a second
#: reverse sweep), as error_scan_folds' ``need``.
SWEEP_NEEDS = [{}, {'single': True}, {'suffix': True}, {'single': True, 'suffix': True},
               {'single': True, 'prefix': True, 'suffix': True}]
SWEEP_NEED_IDS = ['prefix-last', 'single', 'suffix', 'single-sweep', 'full']
#: Rows: not a multiple of the kernel's row or column tile.
SWEEP_N, SWEEP_M = 1000, 5


def _sweep_calibrators(L, is_T_partial, n_cals, N=SWEEP_N, M=SWEEP_M):
    """n_cals float64 ClosedSobolWithError of one shape on the current
    device, each from its own inputs, posterior factors from the port's
    float64 plain path."""
    import numpy as np
    from romcomma_tpu_torch.gsa import calibrators
    from romcomma_tpu_torch.models import gp, params
    cals = []
    for seed in range(n_cals):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(N, M))
        y = np.stack([np.sin(x[:, 0]) + x[:, 1], x[:, 2] ** 2, x[:, 0] * x[:, 3]], -1)[:, :L]
        y = y + 0.05 * rng.standard_normal((N, L))
        raw = params.variant_init(np.full(L, 1.0), np.full((L, M), 1.2 + 0.3 * seed),
                                  np.full(L, 0.05))
        xt, yt = (torch.tensor(a, dtype=torch.float64, device=raw['raw_noise'].device)
                  for a in (x, y))
        K_cho, K_inv_Y = gp.posterior_factors_variant(raw, xt, yt)
        c = params.variant_constrain(raw)
        cals.append(calibrators.ClosedSobolWithError.from_arrays(
            F=c['variance'][None, :], K_cho=K_cho, K_inv_Y=K_inv_Y, Lambda=c['lengthscales'],
            X=xt, is_F_diagonal=True, L=L, M=M, N=N, is_T_partial=is_T_partial))
    return cals


@pytest.mark.parametrize('n_cals', [1, 3])
@pytest.mark.parametrize('need', SWEEP_NEEDS, ids=SWEEP_NEED_IDS)
@pytest.mark.parametrize('is_T_partial', [True, False], ids=['T-partial', 'T-full'])
@pytest.mark.parametrize('L', [1, 3])
def test_sweep_kernel_matches_the_plain_chunk(cuda, L, is_T_partial, need, n_cals):
    """The fused chunk against _run_chunk on the card, in float64: every
    member's quads and every psi column within 1e-12 of its scale (the same
    sum of the terms' absolute values; the two differ only in the order of
    their additions), on the whole columns, a first chunk and a short last
    one, for one calibrator and three at once; one launch a pass and plane
    kind, and a rerun bit for bit."""
    import torch_sweep_support as support
    from romcomma_tpu_torch.gsa import sweep_kernel
    cals = _sweep_calibrators(L, is_T_partial, n_cals)
    passes = 2 if need.get('prefix') else 1
    for q in (slice(0, SWEEP_N), slice(0, 384), slice(768, 1152)):
        before = sweep_kernel.LAUNCHES
        got, want, scale = support.chunks_of(cals, need, q)
        torch.cuda.synchronize()
        assert sweep_kernel.LAUNCHES == before + 2 * passes
        support.assert_within_scale(got, want, scale)
    again = support.chunks_of(cals, need, q)[0]
    for kind in got:
        for x, y in zip(got[kind][0] + (got[kind][1],), again[kind][0] + (again[kind][1],)):
            assert torch.equal(x, y), kind


def test_sweep_kernel_refuses_what_it_does_not_take(cuda):
    """A float32 CUDA sweep raises at the route and at the wrapper: the
    kernel takes float64 only, and nothing falls back."""
    from romcomma_tpu_torch.gsa import sweep_kernel
    with pytest.raises(TypeError):
        sweep_kernel.route(cuda, torch.float32)
    planes = {name: torch.zeros(1, 1, 2, 8, device=cuda) for name in ('A', 'Q')}
    planes['W'] = torch.zeros(1, 1, 8, device=cuda)
    with pytest.raises(TypeError):
        sweep_kernel.sweep(planes, 0, 8, [(False, None, None, True)])


def test_sobol_indices_with_errors_launch_the_sweep_kernel(cuda):
    """A pass of DistributedGP.sobol_indices(..., error=True) on the card
    runs its W/T sweep on the fused kernel (the launch count rises), and its
    'gsa.wt_sweep' span carries a launch a plane kind: the single-sweep
    mode's one pass over one chunk."""
    import numpy as np
    from romcomma_tpu_torch.base import tracing
    from romcomma_tpu_torch.gsa import sweep_kernel
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    rng = np.random.default_rng(3)
    X = rng.standard_normal((1536, 10))
    Y = np.sin(X[:, :1]) + 0.5 * X[:, 1:2] ** 2 + 0.1 * rng.standard_normal((1536, 1))
    dgp = DistributedGP(len(X), mesh=cuda, dtype=np.float64, engine='upper')
    x, y = dgp.stage(X, Y)
    before = sweep_kernel.LAUNCHES
    mode = tracing.mode('on')
    tracing.reset()
    try:
        out = dgp.sobol_indices(np.full(10, 2.0), 1.0, 0.05, x, y, X,
                                kind=('first_order', 'total'), error=True)
        stages = [s for s in tracing.spans() if s['name'] == 'gsa.wt_sweep']
    finally:
        tracing.mode(mode)
        tracing.reset()
    assert sweep_kernel.LAUNCHES >= before + 2
    assert stages and all(s['attrs']['launches'] == 2 for s in stages)
    assert all(np.isfinite(v) for part in ('S', 'T') for kind in out[part].values()
               for v in kind.values())


def _spd_factor(n, dtype, seed=0):
    """The lower factor (CPU, dtype) of A A^T / 64 + I, A (n, 64): condition ~50."""
    A = torch.randn(n, 64, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    K = A @ A.T / 64 + torch.eye(n, dtype=torch.float64)
    return torch.linalg.cholesky(K).to(dtype)


@pytest.mark.parametrize('layout', ['row-major', 'column-major'])
@pytest.mark.parametrize('dtype, rtol', [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=['float64', 'float32'])
def test_in_place_inverse_matches_the_cpu(cuda, dtype, rtol, layout):
    """cho_inverse_lower_ on the card (potri's algorithm in the factor's
    buffer: a recursive triangular inverse on cuBLAS's trmm, then X^T X by
    row panels) at LN = 3000, past BLOCK, against the CPU's cholesky_inverse of the same factor, over
    the lower triangle, relative to K^-1's largest entry: float64 to 1e-12,
    float32 to 1e-5 (a few float32 ulps at condition ~50). The factor is
    row-major, as CovariantUpperLML's is, or column-major, as
    torch.linalg.cholesky leaves it."""
    from romcomma_tpu_torch.ops import linalg
    chol = _spd_factor(3000, dtype)
    want = torch.cholesky_inverse(chol.double()).tril_()
    chol = chol.contiguous() if layout == 'row-major' else chol.mT.contiguous().mT
    before = linalg.IN_PLACE_INVERSES
    got = linalg.cho_inverse_lower_(chol.to(cuda))
    torch.cuda.synchronize()
    assert linalg.IN_PLACE_INVERSES == before + 1
    got = got.double().cpu().tril_()
    torch.testing.assert_close(got, want, rtol=0.0, atol=rtol * want.abs().max().item())


def test_in_place_guard_keeps_cholesky_inverse(cuda, monkeypatch):
    """A factor of IN_PLACE_MAX_ELEMENTS (2^31) elements or more keeps
    torch.cholesky_inverse; one just below takes the in-place route. The
    threshold is lowered to 100^2 here, not allocated."""
    from romcomma_tpu_torch.ops import linalg
    monkeypatch.setattr(linalg, 'IN_PLACE_MAX_ELEMENTS', 100 * 100)
    for n, calls in ((100, 0), (99, 1)):
        chol = _spd_factor(n, torch.float64, seed=n)
        want = torch.cholesky_inverse(chol).tril_()
        before = linalg.IN_PLACE_INVERSES
        got = linalg.cho_inverse_lower_(chol.to(cuda)).cpu().tril_()
        assert linalg.IN_PLACE_INVERSES == before + calls
        torch.testing.assert_close(got, want, rtol=0.0, atol=1e-12 * want.abs().max().item())


def test_covariant_backward_in_the_factor_buffer(cuda):
    """CovariantUpperLML's value and gradients on the card at L N = 3 x 1000,
    float64, against the CPU's to 1e-10 relative; the backward forms K^-1
    in place once and allocates less than one more (L N, L N) buffer. A
    first value+grad on the card runs before the measured one: the autograd
    thread's cuBLAS handle and workspace are made once a process."""
    from romcomma_tpu_torch.models import gp
    from romcomma_tpu_torch.ops import linalg
    g = torch.Generator().manual_seed(4)
    L, N, M = 3, 1000, 5
    x, y = torch.rand(N, M, generator=g, dtype=torch.float64), torch.randn(N, L, generator=g,
                                                                          dtype=torch.float64)
    ls = torch.full((L, M), 0.7, dtype=torch.float64)
    F = torch.tensor([[1.0, 0.5, 0.2], [0.5, 0.9, 0.3], [0.2, 0.3, 0.8]], dtype=torch.float64)
    noise = torch.tensor([[0.05, 0.01, 0.0], [0.01, 0.04, 0.01], [0.0, 0.01, 0.06]],
                         dtype=torch.float64)
    readings = []
    for on in (torch.device('cpu'), cuda):
        with pinned_device(on):
            lml = gp.covariant_upper_lml(x.to(on), ls.to(on), y.to(on))
            leaves = [F.to(on).requires_grad_(True), noise.to(on).requires_grad_(True)]
            if on.type == 'cuda':
                torch.autograd.grad(lml(*leaves), leaves)
            value = lml(*leaves)
            if on.type == 'cuda':
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base, calls = torch.cuda.memory_allocated(), linalg.IN_PLACE_INVERSES
            grads = torch.autograd.grad(value, leaves)
            if on.type == 'cuda':
                torch.cuda.synchronize()
                assert linalg.IN_PLACE_INVERSES == calls + 1
                grown = torch.cuda.max_memory_allocated() - base
                assert grown < (L * N) ** 2 * 8, f'the backward allocated {grown} bytes'
            readings.append([value.detach().cpu(), *(gr.cpu() for gr in grads)])
    for got, want in zip(readings[1], readings[0]):
        torch.testing.assert_close(got, want, rtol=0.0, atol=1e-10 * want.abs().max().item())
