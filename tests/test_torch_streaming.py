"""The one-device streaming LML gradient of the large-N route against
romcomma_tpu's, in float64 on the CPU: the 'upper' engine's in-place inverse
with its pair tiles and 'vvt' strips, and the 'cyclic' engine's strips of
K^-1 from identity-column solves past GRADS_MEMORY_BUDGET_BYTES (the
rescue's float64 engine is such a 'cyclic'), each forced as
tests/test_distributed.py forces romcomma_tpu's (the budget 0, strips of 96
rows, GRAD_PAIR_TILES both ways), at N = 150 and 230 with block 32, so that
padding rows are live and the last strip is clamped (each route against
romcomma_tpu's and against the stored gradient); which route each
engine takes at which N and dtype, against romcomma_tpu's rule; what 'upper'
keeps between its forward and backward; and MOGP's large route end to end
on the streaming route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romcomma_tpu.parallel import distributed as jax_dist
from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.parallel import distributed
from romcomma_tpu_torch.parallel.distributed import DistributedGP

torch.set_num_threads(1)


@pytest.fixture(scope='module', autouse=True)
def _on_the_cpu():
    with pinned_device(torch.device('cpu')):
        yield


SIZES, M, BLOCK, STRIP = (150, 230), 4, 32, 96
ROUTES = ('solves', 'vvt', 'pairs')
#: The (N, route) cases held to romcomma_tpu: every route at both sizes.
PARITY = tuple((N, route) for N in SIZES for route in ROUTES)
#: romcomma_tpu's own tolerances for each route (tests/test_distributed.py):
#: the value, and the gradient's (rtol, atol).
VALUE_RTOL = 1e-12
GRAD_TOL = {'solves': (1e-8, 1e-10), 'vvt': (1e-7, 1e-9), 'pairs': (1e-6, 1e-9)}


def _problem(N: int):
    rng = np.random.default_rng(N)
    X = rng.normal(size=(N, M))
    Y = np.sin(X[:, :1]) + 0.05 * rng.standard_normal((N, 1))
    return X, Y, (np.full(M, 1.3), 1.2, 0.04)


def _forced(gp, route: str):
    """gp with romcomma_tpu's knobs set for ``route``: the budget 0 (so a
    one-device 'cyclic' streams), strips of STRIP rows, pair tiles or not."""
    gp.GRADS_MEMORY_BUDGET_BYTES, gp.GRAD_STRIP_COLS = 0, STRIP
    gp.GRAD_PAIR_TILES = route == 'pairs'
    return gp


def _port(N: int, route: str, dtype=np.float64):
    engine = 'cyclic' if route == 'solves' else 'upper'
    return _forced(DistributedGP(N, torch.device('cpu'), block=BLOCK, dtype=dtype,
                                 engine=engine), route)


def _value_and_grads(gp, X, Y, point):
    p = [torch.tensor(v, dtype=gp.dtype, requires_grad=True) for v in point]
    value = gp.lml(*p, *gp.stage(X, Y))
    return [value.item()] + [g.numpy() for g in torch.autograd.grad(value, p)]


@pytest.fixture(scope='module')
def references():
    """romcomma_tpu's one-device DistributedGP._lml value and gradient on
    each streaming route at each size, forced as its own tests force it."""
    out = {}
    for N, route in PARITY:
        X, Y, point = _problem(N)
        gp = _forced(jax_dist.DistributedGP(N, jax_dist.make_n_mesh(1), block=BLOCK,
                                            dtype=np.float64, dense_kernels=route != 'solves'),
                     route)
        gp._lml = gp._build_lml()
        x, y = gp.stage(X, Y)
        value, grads = jax.value_and_grad(lambda q: gp._lml(q[0], q[1], q[2], x, y))(
            tuple(jnp.asarray(v, jnp.float64) for v in point))
        out[N, route] = [float(value)] + [np.asarray(g) for g in grads]
    return out


@pytest.mark.parametrize('N, route', PARITY)
def test_streaming_route_matches_romcomma_tpu(references, N, route):
    """The port's value and gradient on each streaming route against
    romcomma_tpu's on the same route, at its tolerances."""
    gp = _port(N, route)
    Npad = (gp.plan or gp._upper.plan).Npad
    assert gp.grad_route() == route and Npad > N and Npad % STRIP   # padding, a clamped strip
    assert gp.grad_strip() == (STRIP, -(-Npad // STRIP))
    got, want = _value_and_grads(gp, *_problem(N)), references[N, route]
    np.testing.assert_allclose(got[0], want[0], rtol=VALUE_RTOL)
    rtol, atol = GRAD_TOL[route]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize('N', SIZES)
def test_streaming_routes_match_the_stored_gradient_and_each_other(N):
    """The streaming routes against the stored one ('cyclic' within the
    budget: K and K^-1 rebuilt whole), and the pair tiles against the 'vvt'
    strips, at romcomma_tpu's tolerances for each."""
    X, Y, point = _problem(N)
    stored = DistributedGP(N, torch.device('cpu'), block=BLOCK, dtype=np.float64, engine='cyclic')
    assert stored.grad_route() == 'stored'
    readings = {route: _value_and_grads(_port(N, route), X, Y, point) for route in ROUTES}
    want = _value_and_grads(stored, X, Y, point)
    for route, got in readings.items():
        np.testing.assert_allclose(got[0], want[0], rtol=VALUE_RTOL)
        rtol, atol = GRAD_TOL[route]
        for g, w in zip(got[1:], (readings['vvt'] if route == 'pairs' else want)[1:]):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_upper_keeps_only_V_between_forward_and_backward():
    """engine='upper''s LML saves one (Npad, Npad) tensor for its backward,
    in the working dtype (float32 and float64): V = U^-1, the factor
    inverted in place (upper triangular, V V^T K = I on the real rows);
    every other saved tensor is O(Npad M)."""
    from romcomma_tpu_torch.ops.gram import rbf_gram
    N = SIZES[1]
    X, Y, point = _problem(N)
    Npad = -(-N // BLOCK) * BLOCK
    for dtype in (torch.float32, torch.float64):
        gp = _port(N, 'pairs', dtype)
        p = [torch.tensor(v, dtype=dtype, requires_grad=True) for v in point]
        saved = gp.lml(*p, *gp.stage(X, Y)).grad_fn.saved_tensors
        square = [t for t in saved if t.dim() == 2 and t.shape[0] == t.shape[1] == Npad]
        assert len(square) == 1 and square[0].dtype == dtype
        assert all(t.numel() <= Npad * M for t in saved if t is not square[0])
    V = square[0]
    assert torch.equal(V, torch.triu(V))
    x = torch.as_tensor(X)
    K = rbf_gram(x, x, torch.as_tensor(point[0]), torch.tensor(point[1], dtype=torch.float64))
    K.diagonal().add_(point[2])
    torch.testing.assert_close((V @ V.T)[:N, :N] @ K, torch.eye(N, dtype=torch.float64),
                               rtol=0, atol=1e-11)            # cond(K) ~ 1.7e3 here


def _jax_route(gp) -> str:
    """romcomma_tpu's choice of backward, as its ``_build_lml`` makes it."""
    if gp.plan.S == 1 and gp._engine == 'upper':
        return 'pairs' if gp.GRAD_PAIR_TILES else 'vvt'
    if gp._engine == 'cyclic2':
        return 'ring_pairs'
    Npad = gp.plan.Npad
    if gp.plan.S == 1 and 3 * Npad * Npad * gp._itemsize() > gp.GRADS_MEMORY_BUDGET_BYTES:
        return 'solves'
    return 'stored'


#: Rows on both sides of the float32 and float64 budget crossings (Npad >
#: 32768 at N ~ 32 800; > 23170 at N ~ 23 200) and of the engines' thresholds.
ROUTE_N = (10000, 16384, 23040, 23296, 32768, 33024, 50000)


def test_route_choice_matches_romcomma_tpu():
    """Which backward the port takes at which N and dtype, on one device:
    'upper' (forced, and dense_kernels below CYCLIC2_SINGLE_CHIP_MIN_N),
    'cyclic' (as the float64 rescue builds it: no dense_kernels), and
    'cyclic2', against romcomma_tpu's rule on the same constructions, with
    no arrays computed; the strips' policy with it."""
    seen = set()
    for N in ROUTE_N:
        for dtype in (np.float32, np.float64):
            for options in ({'engine': 'upper'}, {'dense_kernels': True}, {}):
                mine = DistributedGP(N, torch.device('cpu'), dtype=dtype, **options)
                theirs = jax_dist.DistributedGP(N, jax_dist.make_n_mesh(1), dtype=dtype,
                                                **options)
                assert mine.engine == theirs._engine, (N, dtype, options)
                assert mine._itemsize() == theirs._itemsize()
                assert mine.grad_route() == _jax_route(theirs), (N, dtype, options)
                assert mine.grad_strip() == tuple(theirs.grad_strip())
                seen.add((mine.engine, mine.grad_route(), np.dtype(dtype).name))
    assert {('cyclic', 'solves', 'float32'), ('cyclic', 'stored', 'float32'),
            ('cyclic', 'solves', 'float64'), ('cyclic', 'stored', 'float64'),
            ('upper', 'pairs', 'float32'), ('cyclic2', 'ring_pairs', 'float32')} <= seen


def test_mogp_large_route_on_the_streaming_route(monkeypatch, tmp_path):
    """MOGP.calibrate through the public surface with romcomma_tpu's
    thresholds forced as its test_mogp_surface_streaming_route forces them
    (the large route at every N, no dense direct descent, a zero memory
    budget, no joint descent): the descent takes the 'upper' engine's pair
    tiles, the tree is written, and the stored LML is the model's own."""
    from romcomma_tpu_torch import user
    from romcomma_tpu_torch.data.storage import Fold
    from romcomma_tpu_torch.models import gp as gpmod
    from romcomma_tpu_torch.models.gpr import MOGP
    for name in ('DENSE_DIRECT_MAX_N', 'GRADS_MEMORY_BUDGET_BYTES', 'MULTI_MEMORY_BUDGET_BYTES'):
        monkeypatch.setattr(DistributedGP, name, 0)
    calls, pairs = [], distributed.grads_streaming_pairs
    monkeypatch.setattr(distributed, 'grads_streaming_pairs',
                        lambda *args: calls.append(args[0].Npad) or pairs(*args))
    noise = user.sample.GaussianNoise.Variance(L=3, magnitude=0.05)
    repo = user.sample.Function(tmp_path, user.sample.DOE.latin_hypercube,
                                user.functions.ISHIGAMI, N=100, M=3, noise_variance=noise,
                                seed=0).repo.into_K_folds(K=1)
    model = MOGP('gpr_stream', Fold(repo, 0), is_read=False, is_covariant=False,
                 is_isotropic=False)
    model.calibrate(large_n_threshold=1, maxiter=40)
    assert calls and set(calls) == {256}                  # 100 rows padded to block 256
    lml = gpmod.lml_variant(model._variant_raw(), model._tensor(model.X),
                            model._tensor(model.Y)).sum().item()
    stored = float(np.asarray(model.likelihood.data.log_marginal.np, dtype=float).sum())
    assert abs(lml - stored) < 1e-4 * max(1.0, abs(lml))
    assert (Fold(repo, 0).folder / 'gpr_stream/kernel/lengthscales.csv').exists()
