"""User-CSV workflow CLI: CSV -> Repository -> k-fold -> GPR -> GSA -> Collect.
Counterpart of the repository's ``csv_script.py``, with the same flags,
constants, ``run`` signature and tree (reference csv_script.py:37-160).

It computes on the CUDA device. A Python caller asks for the CPU by pinning
it around ``run``, with ``user.contexts.Environment(device='CPU')`` or
``base.definitions.pinned_device(torch.device('cpu'))``; without a card and
without that, ``run`` raises. From a shell, on the card:

    python -m romcomma_tpu_torch.csv_script -r -a <data.csv> <root>

``-G/--GPU`` is accepted, as the original script accepts it, and changes
nothing: the card is already the default.
"""

from __future__ import annotations

import argparse
import os
import tarfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from romcomma_tpu_torch import data, user

K: int = 20
INPUT_AXIS_PERMUTATIONS: Dict[str, Optional[List[int]]] = {'': None}
IS_GPR_READ: Optional[bool] = False
IS_GPR_COVARIANT: Optional[bool] = False
IS_GPR_ISOTROPIC: Optional[bool] = False
GSA_KINDS: List[user.run.GSA.Kind] = user.run.GSA.ALL_KINDS
IS_GSA_ERROR_CALCULATED: bool = True
IS_GSA_ERROR_PARTIAL: bool = False


def run(root: str | Path, csv: str | Path, gpr: bool = False, gsa: bool = False,
        ignore_exceptions: bool = True, use_gpu: bool = False, k: Optional[int] = None,
        normalization: Optional[str] = None, unnormalized: bool = False,
        likelihood_variance: Optional[float] = None, rbf_variance: Optional[float] = None,
        rbf_lengthscale: Optional[float] = None,
        coregional_variance: Optional[float] = None) -> Path:
    root = Path(root)
    with user.contexts.Environment('Test'):
        KIND_NAMES = [kind.name.lower() for kind in GSA_KINDS]
        gprs, gsas = {}, {}
        k = K if k is None else k
        kernel_parameters = None
        if rbf_variance is not None or rbf_lengthscale is not None:
            kernel_parameters = {}
            if rbf_variance is not None:
                kernel_parameters['variance'] = np.atleast_2d(rbf_variance)
            if rbf_lengthscale is not None:
                kernel_parameters['lengthscales'] = np.atleast_2d(rbf_lengthscale)
        for ext, permutation in INPUT_AXIS_PERMUTATIONS.items():
            repo_folder = (root if len(INPUT_AXIS_PERMUTATIONS) == 1
                           else (root / root.name).with_suffix(root.suffix + ext))
            with user.contexts.Timer(f'ext={ext}', is_inline=False):
                if gpr:
                    repo = (data.storage.Repository.from_csv(repo_folder, csv)
                            .into_K_folds(k, normalization=normalization,
                                          is_normalization_applicable=not unnormalized)
                            .rotate_folds(user.sample.permute_axes(permutation)))
                    models = user.run.gpr(name='gpr', repo=repo, is_read=IS_GPR_READ,
                                          is_covariant=IS_GPR_COVARIANT,
                                          is_isotropic=IS_GPR_ISOTROPIC,
                                          ignore_exceptions=ignore_exceptions,
                                          kernel_parameters=kernel_parameters,
                                          likelihood_variance=likelihood_variance)
                else:
                    repo = data.storage.Repository(repo_folder)
                    models = [path.name for path in repo.folder.glob('gpr.*')]
                user.results.Collect({'test': {'header': [0, 1]}, 'test_summary': {'header': [0, 1]}},
                                     {repo.folder / model: {'model': model} for model in models},
                                     True).from_folders(repo.folder / 'gpr', True)
                user.results.Collect({'variance': {}, 'log_marginal': {}},
                                     {f'{repo.folder / model}/likelihood': {'model': model} for model in models},
                                     True).from_folders((repo.folder / 'gpr') / 'likelihood', True)
                user.results.Collect({'variance': {}, 'lengthscales': {}},
                                     {f'{repo.folder / model}/kernel': {'model': model} for model in models},
                                     True).from_folders((repo.folder / 'gpr') / 'kernel', True)
                gprs |= {f'{repo.folder}/gpr': {'ext': ext}}
                if gsa:
                    user.run.gsa('gpr', repo, is_covariant=IS_GPR_COVARIANT, is_isotropic=False,
                                 kinds=GSA_KINDS, is_error_calculated=IS_GSA_ERROR_CALCULATED,
                                 ignore_exceptions=ignore_exceptions, is_T_partial=IS_GSA_ERROR_PARTIAL)
                user.results.Collect({'S': {}, 'V': {}} | ({'T': {}, 'W': {}} if IS_GSA_ERROR_CALCULATED else {}),
                                     {f'{repo.folder / model}/gsa/{kind_name}': {'model': model, 'kind': kind_name}
                                      for kind_name in KIND_NAMES for model in models},
                                     True).from_folders((repo.folder / 'gsa'), True)
                gsas |= {f'{repo.folder}/gsa': {'ext': ext}}
    user.results.Collect({'test_summary': {'header': [0, 1]}}, gprs, True).from_folders(root / 'gpr', False)
    user.results.Collect({'variance': {}, 'log_marginal': {}},
                         {key + '/likelihood': value for key, value in gprs.items()},
                         True).from_folders((root / 'gpr') / 'likelihood', False)
    user.results.Collect({'variance': {}, 'lengthscales': {}},
                         {key + '/kernel': value for key, value in gprs.items()},
                         True).from_folders((root / 'gpr') / 'kernel', False)
    user.results.Collect({'S': {}, 'V': {}, 'T': {}, 'W': {}}, gsas, True).from_folders((root / 'gsa'), False)
    return root


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='A program to run GPR and GSA on user csv data.')
    parser.add_argument('-r', '--gpr', action='store_true', help='Flag to run Gaussian process regression.')
    parser.add_argument('-a', '--gsa', action='store_true', help='Flag to run global sensitivity analysis.')
    parser.add_argument('-i', '--ignore', action='store_true', help='Flag to ignore exceptions.')
    parser.add_argument('-u', '--unnormalized', action='store_true', help='Flag to use unnormalized data.')
    parser.add_argument('-G', '--GPU', action='store_true', help='Accepted for parity with csv_script.py; changes nothing, the card is already the default.')
    parser.add_argument('-l', '--likelihood_variance', help='Initial guess for likelihood variance.', type=float)
    parser.add_argument('-s', '--rbf_lengthscale', help='Initial guess for rbf lengthscale.', type=float)
    parser.add_argument('-v', '--rbf_variance', help='Initial guess for the rbf variance.', type=float)
    parser.add_argument('-c', '--coregional_variance', help='Initial guess for coregional variance.', type=float)
    parser.add_argument('-K', '--folds', help='K, the number of folds for K-fold validation.', type=int)
    parser.add_argument('-k', '--proper', action='store_true', help='Flag to suppress improper fold.')
    parser.add_argument('-t', '--tar', help='Outputs a .tar.gz file to path.', type=str)
    parser.add_argument('-n', '--normalization', help='A csv file to use for normalization.', type=str)
    parser.add_argument('csv', help='The path of the csv containing the data to be analysed.', type=Path)
    parser.add_argument('root', help='The path of the root folder to house all data repositories.', type=Path)
    args = parser.parse_args(argv)
    k = None if args.folds is None else (-args.folds if args.proper else args.folds)
    print(f'Root path is {run(args.root, args.csv, args.gpr, args.gsa, args.ignore, args.GPU, k, args.normalization, args.unnormalized, args.likelihood_variance, args.rbf_variance, args.rbf_lengthscale, args.coregional_variance)}.')
    if args.tar:
        tar = Path(args.tar)
        tar.parents[0].mkdir(parents=True, exist_ok=True)
        with tarfile.open(tar, 'w:gz') as tarf:
            for item in os.listdir(args.root):
                tarf.add(Path(args.root, item), arcname=item)


if __name__ == '__main__':
    main()
