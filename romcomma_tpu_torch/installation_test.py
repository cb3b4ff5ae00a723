"""End-to-end installation test of the port, in the configuration of the
repository's ``installation_test.py``: OAKLEY2004 (L=3 outputs), M=7 inputs,
N=300 samples, K=2 folds, noise 0.04 (determined), variant GPR isotropic then
anisotropic, all three GSA kinds with standard errors (non-partial T), and
the five results Collections.

It computes on the CUDA device, and raises where there is none unless the
caller asks for the CPU::

    from romcomma_tpu_torch import installation_test, user
    with user.contexts.Environment('CPU run', device='CPU'):
        installation_test.run('installation_test')

or from a shell: ``python -m romcomma_tpu_torch.installation_test [root]``.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Tuple

from romcomma_tpu_torch import user

K: int = 2
Ms: Tuple[int, ...] = (7,)
Ns: Tuple[int, ...] = (300,)
DOE = user.sample.DOE.latin_hypercube
FUNCTION_VECTOR = user.functions.OAKLEY2004
NOISE_MAGNITUDES: Tuple[float, ...] = (0.04,)
IS_NOISE_COVARIANT: bool = False
IS_NOISE_VARIANCE_DETERMINED: bool = True
ROTATIONS = {'': None}
IS_GPR_READ = False
IS_GPR_COVARIANT = False
IS_GPR_ISOTROPIC = None
GSA_KINDS: List[user.run.GSA.Kind] = user.run.GSA.ALL_KINDS
IS_GSA_ERROR_CALCULATED: bool = True
IS_GSA_ERROR_PARTIAL: bool = False


def run(root: str | Path) -> List[Path]:
    """Sample, train, test and analyse every configuration under ``root``;
    returns the repositories' folders."""
    folders = []
    with user.contexts.Environment('Test'):
        kind_names = [kind.name.lower() for kind in GSA_KINDS]
        for noise_magnitude in NOISE_MAGNITUDES:
            for M in Ms:
                for N in Ns:
                    noise_variance = user.sample.GaussianNoise.Variance(
                        len(FUNCTION_VECTOR), noise_magnitude, IS_NOISE_COVARIANT,
                        IS_NOISE_VARIANCE_DETERMINED)
                    for rotation in ROTATIONS.values():
                        with user.contexts.Timer(f'M={M}, N={N}, noise={noise_magnitude}',
                                                 is_inline=False):
                            repo = user.sample.Function(
                                root, DOE, FUNCTION_VECTOR, N, M, noise_variance, None,
                                True).repo.into_K_folds(K).rotate_folds(rotation)
                            models = user.run.gpr(name='gpr', repo=repo, is_read=IS_GPR_READ,
                                                  is_covariant=IS_GPR_COVARIANT,
                                                  is_isotropic=IS_GPR_ISOTROPIC,
                                                  ignore_exceptions=False)
                            user.results.Collect(
                                {'test': {'header': [0, 1]},
                                 'test_summary': {'header': [0, 1], 'index_col': 0}},
                                {repo.folder / model: {'model': model} for model in models},
                                False).from_folders(repo.folder / 'gpr', True)
                            user.results.Collect(
                                {'variance': {}, 'log_marginal': {}},
                                {f'{repo.folder / model}/likelihood': {'model': model}
                                 for model in models},
                                False).from_folders((repo.folder / 'gpr') / 'likelihood', True)
                            user.results.Collect(
                                {'variance': {}, 'lengthscales': {}},
                                {f'{repo.folder / model}/kernel': {'model': model}
                                 for model in models},
                                False).from_folders((repo.folder / 'gpr') / 'kernel', True)
                            user.run.gsa('gpr', repo, is_covariant=IS_GPR_COVARIANT,
                                         is_isotropic=False, kinds=GSA_KINDS,
                                         is_error_calculated=IS_GSA_ERROR_CALCULATED,
                                         ignore_exceptions=False,
                                         is_T_partial=IS_GSA_ERROR_PARTIAL)
                            user.results.Collect(
                                {'S': {}, 'V': {}} | ({'T': {}, 'W': {}}
                                                      if IS_GSA_ERROR_CALCULATED else {}),
                                {f'{repo.folder / model}/gsa/{kind_name}':
                                 {'model': model, 'kind': kind_name}
                                 for kind_name in kind_names for model in models},
                                True).from_folders((repo.folder / 'gsa'), True)
                            folders.append(repo.folder)
    return folders


if __name__ == '__main__':
    print(f'Repositories: {run(Path(sys.argv[1] if len(sys.argv) > 1 else "installation_test"))}')
