"""The port's persistence layer writes the trees that tests/test_golden_tree.py
checks, byte for byte, and the trees romcomma_tpu writes for the workloads the
golden tree does not cover."""

import random
import sys
from pathlib import Path

import torch

from romcomma_tpu.data import storage as jax_storage
from romcomma_tpu_torch.data import storage

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / 'golden'
sys.path.insert(0, str(GOLDEN))
import workload  # noqa: E402
import workload_model  # noqa: E402


class _PortAdapter:
    """workload_model's adapter for the port. The GSA writer is not ported yet,
    so write_sobol writes nothing and the golden tree's gsa/ files are left out
    of the comparison."""

    @staticmethod
    def open_fold(folder, k):
        return storage.Fold(storage.Repository(folder), k)

    @staticmethod
    def make_mogp(name, fold, is_covariant):
        from romcomma_tpu_torch.models.gpr import MOGP
        return MOGP(name, fold, is_read=False, is_covariant=is_covariant, is_isotropic=False)

    @staticmethod
    def write_sobol(gp, kind_name, m, results):
        pass


def _files(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob('*') if p.is_file())


def _assert_same_bytes(want_root: Path, got_root: Path, files):
    assert _files(got_root) == files
    mismatched = [str(f) for f in files
                  if (want_root / f).read_bytes() != (got_root / f).read_bytes()]
    assert mismatched == []


def test_reference_golden_bytes(tmp_path):
    workload.run(storage, tmp_path)
    workload_model.run(_PortAdapter, tmp_path)
    reference = GOLDEN / 'reference_tree'
    _assert_same_bytes(reference, tmp_path,
                       [f for f in _files(reference) if 'gsa' not in f.parts])


def _drive(storage_module, root: Path, csv: Path):
    """PCA from a csv, a cumulative X_rotation and inputs at the edges of
    the uniform range (the 1e-12 margin before the normal ppf)."""
    random.seed(5)
    storage_module.Repository.from_csv(root / 'pca', csv, PCA=True)
    df = workload.input_df()
    df.iloc[0, :workload.M] = df.iloc[:, :workload.M].min() - 1.0
    df.iloc[1, :workload.M] = df.iloc[:, :workload.M].max() + 1.0
    repo = storage_module.Repository.from_df(root / 'rotated', df).into_K_folds(2)
    repo.rotate_folds(workload.rotation())
    repo.rotate_folds(workload.rotation().T @ workload.rotation().T)


def test_trees_match_romcomma_tpu(tmp_path):
    csv = tmp_path / 'origin.csv'
    workload.input_df().to_csv(csv)
    _drive(jax_storage, tmp_path / 'jax', csv)
    _drive(storage, tmp_path / 'port', csv)
    _assert_same_bytes(tmp_path / 'jax', tmp_path / 'port', _files(tmp_path / 'jax'))
