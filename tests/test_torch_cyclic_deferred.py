"""The port's storage layout and the mesh's refusals, on the CPU: romcomma_tpu's
plan, stored order and the deferred engine's permutations and super panels
element for element (N not divisible by B S), and the mesh engines refused
by name without a process group. The engines themselves are held to
romcomma_tpu's over spawned ranks in test_torch_mesh.py."""

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
def test_mesh_engines_without_a_process_group_are_refused_by_name(engine):
    with pinned_device(torch.device('cpu')):
        with pytest.raises(ValueError, match='runs over a mesh'):
            DistributedGP(10, engine=engine)
        with pytest.raises(ValueError, match='without a process group'):
            dist.make_n_mesh(2)
        assert DistributedGP(10, engine='upper').engine is None
