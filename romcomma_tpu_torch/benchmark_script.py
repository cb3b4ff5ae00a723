"""Parameter-sweep benchmark CLI: M x N x noise grid over the ALL function
vector (L=9 outputs). Counterpart of the repository's ``benchmark_script.py``,
with the same grid, flags, sweep-cell round robin, tree and collections
(reference benchmark_script.py:33-162).

It computes on the CUDA device; a Python caller asks for the CPU by pinning
it around ``run`` (``user.contexts.Environment(device='CPU')``). From a
shell, on the card, one sweep cell of the M=19 grid:

    python -m romcomma_tpu_torch.benchmark_script -f -r -s -M 19 \\
        --num-processes 940 --process-id 325 <root>

``-G/--GPU`` is accepted and changes nothing: the card is already the default.
"""

from __future__ import annotations

import argparse
import os
import tarfile
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from romcomma_tpu_torch import user
from romcomma_tpu_torch.base.definitions import in_process_group, solo

K: int = -2
Ms: Tuple[int, ...] = (7, 9, 11, 13, 15, 17, 19)
Ns: Tuple[int, ...] = (60, 100, 140, 180, 220, 260, 300, 340, 380, 420, 460, 520, 580, 640,
                       720, 800, 880, 960, 1050, 1150, 1260, 1380, 1510, 1650, 1800, 1960,
                       2130, 2210, 2400, 2600, 2820, 3060, 3320, 3600, 3900, 4220, 4560,
                       4920, 5420, 5860, 6340, 6860, 7420, 8000, 8600, 9200, 9840)
DOE = user.sample.DOE.latin_hypercube
FUNCTION_VECTOR = user.functions.ALL
NOISE_MAGNITUDES: Tuple[float, ...] = (0.0025, 0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.2,
                                       0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.2, 1.5,
                                       2.0, 5.0)
IS_NOISE_VARIANCE_DETERMINED: bool = True
ROTATIONS: Dict[str, Optional[np.ndarray]] = {'': None}
IS_GPR_READ: Optional[bool] = None
IS_GPR_ISOTROPIC: Optional[bool] = False
GSA_KINDS: List[user.run.GSA.Kind] = user.run.GSA.ALL_KINDS
IS_GSA_ERROR_CALCULATED: bool = True


def process_identity() -> Tuple[int, int]:
    """(process_id, num_processes) of this process in a sweep shared by
    several: ``parallel.multihost.process_identity`` (ROMCOMMA_PROCESS_ID /
    ROMCOMMA_NUM_PROCESSES set per task by the launcher, then the process
    group's rank and size, else (0, 1))."""
    from romcomma_tpu_torch.parallel import multihost
    return multihost.process_identity()


def _in_cell_order(table: Dict[str, tuple], gathered: bool) -> Dict[str, dict]:
    """{folder: columns} of ``table`` ({folder: (cell, columns)}) in the
    order of the cells. ``gathered``: of every rank's table, once each rank
    has run its own cells."""
    parts = [table]
    if gathered:
        import torch.distributed as dist
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, table)
    rows = sorted(((cell, folder, columns) for part in parts
                   for folder, (cell, columns) in part.items()), key=lambda row: row[0])
    return {folder: columns for _, folder, columns in rows}


def run(args: argparse.Namespace, root: str | Path) -> Path:
    """Sample, train and analyse this process's cells of the sweep under
    root, then collect every cell's tables at root (args: parse_args')."""
    root = Path(root)
    # Sweep-cell distribution across processes: identity from
    # --process-id/--num-processes, else process_identity(). Each process runs
    # its round-robin share of (noise, M, N, rotation) cells; results persist
    # to the shared tree and collect as usual. -K and -M come from args where
    # given, else from the module's K and Ms. Where the cells are shared out,
    # each process runs and writes its own alone (solo()): under a process
    # group its ranks hold different cells, so they share no collective until
    # the root collections, which rank 0 writes from every rank's cells.
    pid, nproc = process_identity()
    pid = args.process_id if args.process_id is not None else pid
    nproc = args.num_processes if args.num_processes is not None else nproc
    k = args.folds or K
    ms = (args.input_dim,) if args.input_dim else Ms
    cell = -1
    with user.contexts.Environment('Test'), solo() if nproc > 1 else nullcontext():
        KIND_NAMES = [kind.name.lower() for kind in GSA_KINDS]
        gprs, gsas = {}, {}                 # folder: (cell, its columns at root)
        for noise_magnitude in NOISE_MAGNITUDES:
            for M in ms:
                for N in Ns:
                    cell += 1
                    if cell % nproc != pid:
                        continue
                    noise_variance = user.sample.GaussianNoise.Variance(
                        len(FUNCTION_VECTOR), noise_magnitude, args.is_noise_covariant,
                        IS_NOISE_VARIANCE_DETERMINED)
                    for rotation_name, rotation in ROTATIONS.items():
                        ext = rotation_name + f'.{args.ext}' if args.ext else ''
                        ext = ext if ext else None
                        with user.contexts.Timer(f'M={M}, N={N}, noise={noise_magnitude}, ext={ext}',
                                                 is_inline=False):
                            if args.function:
                                repo = user.sample.Function(root, DOE, FUNCTION_VECTOR, N, M,
                                                            noise_variance, ext,
                                                            True).repo.into_K_folds(k).rotate_folds(rotation)
                            else:
                                repo = user.sample.Function(root, DOE, FUNCTION_VECTOR, N, M,
                                                            noise_variance, ext, False).repo
                            if args.gpr:
                                models = user.run.gpr(name='gpr', repo=repo, is_read=IS_GPR_READ,
                                                      is_covariant=args.is_gpr_covariant,
                                                      is_isotropic=IS_GPR_ISOTROPIC,
                                                      ignore_exceptions=args.ignore,
                                                      likelihood_variance=args.likelihood_variance)
                            else:
                                models = [path.name for path in repo.folder.glob('gpr.*')]
                            user.results.Collect({'test': {'header': [0, 1]}, 'test_summary': {'header': [0, 1]}},
                                                 {repo.folder / model: {'model': model} for model in models},
                                                 args.ignore).from_folders(repo.folder / 'gpr', True)
                            user.results.Collect({'variance': {}, 'log_marginal': {}},
                                                 {f'{repo.folder / model}/likelihood': {'model': model} for model in models},
                                                 args.ignore).from_folders((repo.folder / 'gpr') / 'likelihood', True)
                            user.results.Collect({'variance': {}, 'lengthscales': {}},
                                                 {f'{repo.folder / model}/kernel': {'model': model} for model in models},
                                                 args.ignore).from_folders((repo.folder / 'gpr') / 'kernel', True)
                            gprs |= {f'{repo.folder}/gpr': (cell, {
                                'M': M, 'noise magnitude': noise_magnitude,
                                'IS_NOISE_COVARIANT': args.is_noise_covariant,
                                'IS_NOISE_VARIANCE_DETERMINED': IS_NOISE_VARIANCE_DETERMINED,
                                'ext': ext})}
                            if args.gsa:
                                user.run.gsa('gpr', repo, is_covariant=args.is_gpr_covariant,
                                             is_isotropic=False, kinds=GSA_KINDS,
                                             is_error_calculated=IS_GSA_ERROR_CALCULATED,
                                             ignore_exceptions=args.ignore,
                                             is_T_partial=args.is_T_partial)
                            user.results.Collect({'S': {}, 'V': {}} | ({'T': {}, 'W': {}} if IS_GSA_ERROR_CALCULATED else {}),
                                                 {f'{repo.folder / model}/gsa/{kind_name}': {'model': model, 'kind': kind_name}
                                                  for kind_name in KIND_NAMES for model in models},
                                                 True).from_folders((repo.folder / 'gsa'), True)
                            gsas |= {f'{repo.folder}/gsa': (cell, {
                                'M': M, 'noise magnitude': noise_magnitude,
                                'IS_NOISE_COVARIANT': args.is_noise_covariant,
                                'IS_NOISE_VARIANCE_DETERMINED': IS_NOISE_VARIANCE_DETERMINED,
                                'ext': ext})}
    gathered = nproc > 1 and in_process_group()
    gprs, gsas = _in_cell_order(gprs, gathered), _in_cell_order(gsas, gathered)
    user.results.Collect({'test_summary': {'header': [0, 1]}}, gprs, True).from_folders(root / 'gpr', True)
    user.results.Collect({'variance': {}, 'log_marginal': {}}, gprs, True).from_folders((root / 'gpr') / 'likelihood', True)
    user.results.Collect({'variance': {}, 'lengthscales': {}}, gprs, True).from_folders((root / 'gpr') / 'kernel', True)
    user.results.Collect({'S': {}, 'V': {}, 'T': {}, 'W': {}}, gsas, True).from_folders((root / 'gsa'), True)
    if args.copy:
        dst = Path(args.copy)
        user.results.copy(root / 'gpr', dst / 'gpr')
        user.results.copy(root / 'gsa', dst / 'gsa')
    return root


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='A program to benchmark GPR and GSA against a (vector) test function.')
    parser.add_argument('-f', '--function', action='store_true', help='Flag to sample the test function to generate test data.')
    parser.add_argument('-r', '--gpr', action='store_true', help='Flag to run Gaussian process regression.')
    parser.add_argument('-s', '--gsa', action='store_true', help='Flag to run global sensitivity analysis.')
    parser.add_argument('-i', '--ignore', action='store_true', help='Flag to ignore exceptions.')
    parser.add_argument('-G', '--GPU', action='store_true', help='Accepted for parity with benchmark_script.py; changes nothing.')
    parser.add_argument('-K', '--folds', help='The number of k-folds (negative to omit improper fold). Defaults to -2.', type=int)
    parser.add_argument('-M', '--input_dim', help='The input dimension M.', type=int)
    parser.add_argument('-c', '--is_noise_covariant', action='store_true', help='Whether noise is covariant across outputs.')
    parser.add_argument('-C', '--is_gpr_covariant', action='store_true', help='Whether GPR (likelihood) is covariant across outputs.')
    parser.add_argument('-l', '--likelihood_variance', help='Initial guess for likelihood variance.', type=float)
    parser.add_argument('-p', '--is_T_partial', action='store_true', help='Whether GSA error T is partial.')
    parser.add_argument('-e', '--ext', help='The extension appended to each Store name.', type=str)
    parser.add_argument('-t', '--tar', help='Outputs a .tar.gz file to path.', type=str)
    parser.add_argument('-y', '--copy', help='Copies collected results to path.', type=str)
    parser.add_argument('--process-id', help='This process\'s index for sweep-cell distribution '
                        '(defaults to ROMCOMMA_PROCESS_ID, else 0).', type=int, default=None)
    parser.add_argument('--num-processes', help='Total processes sharing the sweep '
                        '(defaults to ROMCOMMA_NUM_PROCESSES, else 1).', type=int, default=None)
    parser.add_argument('root', help='The path of the root folder to house all data repositories.', type=str)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Path:
    args = parse_args(argv)
    root = Path(args.root)
    print(f'Root path is {run(args, root)}')
    if args.tar:
        tar_path = Path(args.tar)
        tar_path.parents[0].mkdir(parents=True, exist_ok=True)
        with tarfile.open(tar_path, 'w:gz') as tar:
            for item in os.listdir(args.root):
                tar.add(Path(args.root, item), arcname=item)
    return root


if __name__ == '__main__':
    main()
