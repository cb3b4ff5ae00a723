"""The port's storage layout, the engines on one device and their routing,
on the CPU: romcomma_tpu's plan, stored order and the deferred engine's
permutations and super panels element for element (N not divisible by B S);
the engine DistributedGP picks for every N, ``dense_kernels`` and ``engine``
on one device, and MOGP's large route, against romcomma_tpu's; and the
one-device 'cyclic2' (several super panels, a clamped tail) against
romcomma_tpu's one-device-mesh 'cyclic2' and the port's ExactLML. The
engines over several ranks are held to romcomma_tpu's over spawned ranks in
test_torch_mesh.py."""

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from romcomma_tpu.parallel import cyclic_deferred as jax_cd
from romcomma_tpu.parallel import distributed as jax_dist
from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.parallel import cyclic_deferred as cd
from romcomma_tpu_torch.parallel import distributed as dist
from romcomma_tpu_torch.parallel.distributed import DistributedGP

SIZES = (2, 3, 4)


@pytest.mark.parametrize('S', SIZES)
def test_plan_and_permutations_match_romcomma_tpu(S):
    """The storage layout element for element, with N not divisible by B S."""
    X = np.random.default_rng(S).normal(size=(ranks.N, ranks.M))
    for B in (ranks.B, 64):
        mine, theirs = dist.plan(ranks.N, S, B), jax_dist.plan(ranks.N, S, B)
        assert tuple(mine) == tuple(theirs)
        np.testing.assert_array_equal(mine.dtype_rows_mask, theirs.dtype_rows_mask)
        np.testing.assert_array_equal(dist.to_stored(mine, X), jax_dist.to_stored(theirs, X))
        stored = jax_dist.to_stored(theirs, X)
        np.testing.assert_array_equal(dist.from_stored(mine, stored),
                                      jax_dist.from_stored(theirs, stored))
        for a, b in zip(cd.stored_global_perms(mine), jax_cd.stored_global_perms(theirs)):
            np.testing.assert_array_equal(a, b)
        for target in (S * B, 2 * S * B, 3584):
            assert cd.super_q(mine, target) == jax_cd.super_q(theirs, target)
            q = cd.super_q(mine, target)
            assert cd.super_sizes(mine, q) == list(jax_cd.super_sizes(theirs, q))


@pytest.mark.parametrize('mesh', [['cpu', 'cpu'], ('cpu',) * 4, []],
                         ids=['two-devices', 'four-devices', 'empty'])
def test_plain_sequences_name_make_n_mesh(mesh):
    with pytest.raises(ValueError, match=r"make_n_mesh\(\)"):
        DistributedGP(10, mesh)


@pytest.mark.parametrize('engine', ['cyclic', 'cyclic2'])
def test_mesh_engines_run_on_one_device_as_romcomma_tpus(engine):
    """engine='cyclic' and 'cyclic2' on one device, with no process group,
    run their engine (S = 1, the ring's collectives the identity), as
    romcomma_tpu's do on a one-device mesh; make_n_mesh(2) still needs a
    process group, and engine='upper' is the one-device route."""
    with pinned_device(torch.device('cpu')):
        gp = DistributedGP(10, engine=engine)
        theirs = jax_dist.DistributedGP(10, jax_dist.make_n_mesh(1), engine=engine)
        assert gp.engine == theirs._engine == engine
        assert tuple(gp.plan) == tuple(theirs.plan) and gp._ops.ring.S == 1
        with pytest.raises(ValueError, match='without a process group'):
            dist.make_n_mesh(2)
        assert DistributedGP(10, engine='upper').engine == 'upper' and \
            DistributedGP(10, engine='upper').plan is None


#: romcomma_tpu's one-device 'cyclic2' threshold, lowered on both packages'
#: classes so that N = ROUTING_N[1] is past it at a test's size.
LOW_MIN_N = 200
ROUTING_N = (150, 200, 300)
ROUTING_CASES = [(n, dense, engine) for n in ROUTING_N for dense in (False, True)
                 for engine in (None, 'upper', 'cyclic', 'cyclic2')]


@pytest.fixture
def low_threshold(monkeypatch):
    """CYCLIC2_SINGLE_CHIP_MIN_N lowered to LOW_MIN_N in both packages."""
    monkeypatch.setattr(jax_dist.DistributedGP, 'CYCLIC2_SINGLE_CHIP_MIN_N', LOW_MIN_N)
    monkeypatch.setattr(DistributedGP, 'CYCLIC2_SINGLE_CHIP_MIN_N', LOW_MIN_N)


def test_one_device_routing_matches_romcomma_tpu(low_threshold):
    """Every N (below, at and past the threshold), dense_kernels and engine
    on one device: the port's engine is romcomma_tpu's, and the plans agree."""
    with pinned_device(torch.device('cpu')):
        for N, dense, engine in ROUTING_CASES:
            mine = DistributedGP(N, dense_kernels=dense, engine=engine)
            theirs = jax_dist.DistributedGP(N, jax_dist.make_n_mesh(1), dense_kernels=dense,
                                            engine=engine)
            assert mine.engine == theirs._engine, (N, dense, engine)
            assert mine.plan is None if mine.engine == 'upper' else \
                tuple(mine.plan) == tuple(theirs.plan)


#: The one-device 'cyclic2' problem: N rows at block B, super panels of
#: PANEL_BLOCKS blocks, so ceil(10 / 3) = 4 panels, the last a clamped tail.
VALUE_N, VALUE_M, VALUE_B, PANEL_BLOCKS = 300, 4, 32, 3
#: test_torch_mesh.py's tolerances for the engines' LML and gradient.
LML_RTOL, GRAD = 1e-12, dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(scope='module')
def one_device_cyclic2():
    """The port's and romcomma_tpu's one-device 'cyclic2' LML and gradients
    (float64) at one seeded point, and the port's ExactLML there."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    X = rng.normal(size=(VALUE_N, VALUE_M))
    Y = np.sin(X[:, :1]) + 0.5 * X[:, 1:2] ** 2 + 0.1 * rng.normal(size=(VALUE_N, 1))
    point = (rng.uniform(0.8, 2.0, VALUE_M), 1.3, 0.04)
    super_block = PANEL_BLOCKS * VALUE_B
    out = {}
    with pinned_device(torch.device('cpu')):
        for engine in ('cyclic2', 'upper'):
            gp = DistributedGP(VALUE_N, block=VALUE_B, dtype=np.float64, engine=engine)
            if engine == 'cyclic2':
                gp._ops = cd.DeferredEngine(gp.plan, gp.mesh, super_block)
                out['panels'] = cd.super_sizes(gp.plan, gp._ops.q)
            p = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in point]
            value = gp.lml(*p, *gp.stage(X, Y))
            out[engine] = [value.item()] + [g.numpy() for g in torch.autograd.grad(value, p)]
    theirs = jax_dist.DistributedGP(VALUE_N, jax_dist.make_n_mesh(1), block=VALUE_B,
                                    dtype=np.float64, engine='cyclic2')
    theirs._deferred = jax_cd.DeferredEngine(theirs.plan, theirs.mesh, super_block=super_block,
                                             chol_precision=None, grad_precision=None)
    for name in ('gram', 'chol', 'fwd', 'bwd', 'logdiag', 'inv'):
        setattr(theirs, f'_{name}', getattr(theirs._deferred, name))
    theirs._lml = theirs._build_lml()
    x, y = theirs.stage(X, Y)
    value, grads = jax.value_and_grad(lambda q: theirs.lml(q[0], q[1], q[2], x, y))(
        tuple(jnp.asarray(v, jnp.float64) for v in point))
    out['romcomma_tpu'] = [float(value)] + [np.asarray(g) for g in grads]
    return out


def test_one_device_cyclic2_matches_romcomma_tpu_and_exact_lml(one_device_cyclic2):
    """The one-device 'cyclic2' LML and gradients, over several super panels
    and a clamped tail, against romcomma_tpu's one-device-mesh 'cyclic2' and
    the port's ExactLML ('upper'), at test_torch_mesh.py's tolerances."""
    r = one_device_cyclic2
    assert len(r['panels']) == 4 and r['panels'][-1] < r['panels'][0]
    for reference in ('romcomma_tpu', 'upper'):
        np.testing.assert_allclose(r['cyclic2'][0], r[reference][0], rtol=LML_RTOL)
        for got, want in zip(r['cyclic2'][1:], r[reference][1:]):
            np.testing.assert_allclose(got, want, **GRAD)


@pytest.mark.parametrize('engine', ['cyclic', 'cyclic2'])
def test_float32_engines_factorize_in_float64(engine):
    """A float32 'cyclic' or 'cyclic2' engine on one device builds its signal
    gram in float32 into a float64 buffer, adds the noise there, factorizes
    and reduces in float64 (over several ranks it keeps float32:
    test_torch_mesh.py):
    its LML (a float64 value), dLML/dnoise and dLML/ds2 (float32) are those
    of the float64 factor of that float32 gram, at a point (s2 / noise =
    1e4) where ExactLML's all-float32 dLML/dnoise lies more than 100 times
    as far from them."""
    from romcomma_tpu_torch.ops.gram import rbf_gram
    rng = np.random.default_rng(11)
    X = rng.normal(size=(VALUE_N, VALUE_M))
    Y = np.sin(X[:, :1]) + 0.5 * X[:, 1:2] ** 2 + 0.1 * rng.normal(size=(VALUE_N, 1))
    point = (np.full(VALUE_M, 2.0), 100.0, 0.01)
    readings = {}
    with pinned_device(torch.device('cpu')):
        for name in (engine, 'upper'):
            gp = DistributedGP(VALUE_N, block=VALUE_B, dtype=np.float32, engine=name)
            p = [torch.tensor(v, dtype=torch.float32, requires_grad=True) for v in point]
            value = gp.lml(*p, *gp.stage(X, Y))
            grads = torch.autograd.grad(value, p)
            readings[name] = (value, grads[1].item(), grads[2].item())
        ls, s2, noise = (torch.tensor(v, dtype=torch.float32) for v in point)
        x, y = torch.as_tensor(X, dtype=torch.float32), torch.as_tensor(Y[:, 0], dtype=torch.float64)
        K = rbf_gram(x, x, ls, s2).double()
        K.diagonal().add_(noise.double())
        L = torch.linalg.cholesky(K)
        alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
        lml = (-0.5 * y @ alpha - torch.sum(torch.log(torch.diagonal(L)))
               - 0.5 * VALUE_N * np.log(2.0 * np.pi)).item()
        dnoise = 0.5 * (alpha @ alpha - torch.trace(torch.cholesky_inverse(L))).item()
        ds2 = (0.5 * ((y @ alpha).item() - VALUE_N) - noise.item() * dnoise) / s2.item()
    value, ds2_got, dnoise_got = readings[engine]
    assert value.dtype == torch.float64
    np.testing.assert_allclose(value.item(), lml, rtol=1e-9)
    np.testing.assert_allclose(dnoise_got, dnoise, rtol=1e-5)
    np.testing.assert_allclose(ds2_got, ds2, rtol=1e-5)
    assert abs(readings['upper'][2] - dnoise) > 100 * abs(dnoise_got - dnoise)
