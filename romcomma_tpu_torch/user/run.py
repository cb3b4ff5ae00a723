"""Workflow orchestration: run.gpr / run.gsa / run.rom (reference: romcomma/user/run.py).
Counterpart of ``romcomma_tpu/user/run.py``.

Reproduces the reference's recursion and tri-state expansion exactly:
  - ``is_covariant=None`` runs variant then covariant; ``is_isotropic=None``
    runs isotropic then anisotropic (run.py:69-78).
  - ``is_read=None`` warm-starts each model from its nearest trained ancestor
    in the independence/isotropy hierarchy by copying the model folder
    (``<name>.v.i`` -> ``<name>.v.a`` -> ``<name>.c.a``, run.py:79-88) before
    broadcasting parameters up.
  - results are Collect-ed across folds with provenance columns.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from romcomma_tpu_torch.base.classes import Data
from romcomma_tpu_torch.data.storage import Repository, Fold
from romcomma_tpu_torch.gsa.calibrators import COVARIANT_ERRORS_UNSUPPORTED, marginalize_all_kinds
from romcomma_tpu_torch.gsa.models import GSA, Sobol
from romcomma_tpu_torch.models.gpr import MOGP
from romcomma_tpu_torch.user import contexts, results


def _model_passes(is_covariant: Optional[bool], is_isotropic: Optional[bool]) -> List[tuple]:
    """Expand the tri-state model-type flags (``None`` = run both settings)
    into the ordered ``(is_covariant, is_isotropic)`` pass list.

    In a full expansion (both flags ``None``) the variant chain runs
    isotropic then anisotropic, and the covariant pass runs anisotropic
    only — it warm-starts from the trained variant anisotropic model
    (reference run.py:69-78 semantics)."""
    passes = []
    for covariant in ([False, True] if is_covariant is None else [is_covariant]):
        if is_isotropic is not None:
            isotropies = [is_isotropic]
        elif covariant and is_covariant is None:
            isotropies = [False]
        else:
            isotropies = [True, False]
        passes += [(covariant, isotropic) for isotropic in isotropies]
    return passes


def _model_name(name: str, is_covariant: bool, is_isotropic: bool) -> str:
    return f"{name}.{'c' if is_covariant else 'v'}.{'i' if is_isotropic else 'a'}"


def _resolve_warm_start(name: str, fold: Fold, full_name: str, is_covariant: bool) -> bool:
    """Resolve ``is_read=None`` for one model pass: reuse the trained folder
    when present, otherwise seed it by copying the nearest trained ancestor in
    the model hierarchy — a covariant model prefers its variant twin, any
    anisotropic model falls back to its isotropic sibling (reference
    run.py:79-88). Returns the concrete ``is_read`` (False = no ancestor
    found, train from scratch)."""
    if (fold.folder / full_name).exists():
        return True
    ancestors = [name + '.v' + full_name[-2:]] if is_covariant else []
    ancestors.append(full_name[:-2] + '.i')
    for ancestor in ancestors:
        if (fold.folder / ancestor).exists():
            Data.copy(src_folder=fold.folder / ancestor, dst_folder=fold.folder / full_name)
            return True
    return False


def gpr(name: str, repo: Repository, is_read: Optional[bool], is_covariant: Optional[bool],
        is_isotropic: Optional[bool], ignore_exceptions: bool = False,
        kernel_parameters: Optional[Dict] = None, likelihood_variance=None,
        is_calibrated: bool = True, is_tested: bool = True,
        fold_parallel: Optional[bool] = None, **kwargs) -> List[str]:
    """Undertake GPR on a Fold, or across every Fold in a Repository.
    Returns the list of model names constructed (reference run.py:35-102).

    ``fold_parallel`` is accepted for compatibility with romcomma_tpu's
    signature. The folds always run in the sequential per-fold loop here, which
    gives the results the fold-batched descent is held to."""
    if not isinstance(repo, Fold):
        names = []
        for k in repo.folds:
            names = gpr(name, Fold(repo, k), is_read, is_covariant, is_isotropic,
                        ignore_exceptions, kernel_parameters, likelihood_variance,
                        is_calibrated, is_tested, **kwargs)
        if is_tested:
            results.Collect({'test': {'header': [0, 1]}, 'test_summary': {'header': [0, 1], 'index_col': 0}},
                            {n: {} for n in names}, ignore_exceptions).from_folds(repo, True)
        results.Collect({'variance': {}, 'log_marginal': {}},
                        {f'{n}/likelihood': {} for n in names}, ignore_exceptions).from_folds(repo, True)
        results.Collect({'variance': {}, 'lengthscales': {}},
                        {f'{n}/kernel': {} for n in names}, ignore_exceptions).from_folds(repo, True)
        return names
    names = []
    for pass_index, (covariant, isotropic) in enumerate(_model_passes(is_covariant, is_isotropic)):
        full_name = _model_name(name, covariant, isotropic)
        # Only the first pass honours the caller's is_read; later passes
        # warm-start from the model trained by an earlier pass.
        read = is_read if pass_index == 0 else None
        if read is None:
            read = _resolve_warm_start(name, repo, full_name, covariant)
        with contexts.Timer(f'fold.{repo.meta["k"]} {full_name} GPR'):
            try:
                gp = (MOGP(full_name, repo, read, covariant, isotropic) if read else
                      MOGP(full_name, repo, read, covariant, isotropic,
                           kernel_parameters, likelihood_variance))
                if is_calibrated:
                    gp.calibrate(**kwargs)
                if is_tested:
                    gp.test()
            except Exception:
                if not ignore_exceptions:
                    raise
        names.append(full_name)
    return names


def gsa(name: str, repo: Repository, is_covariant: Optional[bool], is_isotropic: Optional[bool],
        kinds: 'GSA.Kind | Sequence[GSA.Kind]' = None, m: int = -1,
        ignore_exceptions: bool = False, is_error_calculated: bool = False,
        fold_parallel: Optional[bool] = None, **kwargs) -> List[Path]:
    """Undertake GSA on a Fold, or recursively across the Folds in a Repository
    (reference run.py:105-158). Returns the GSA folders of the last fold,
    relative to the fold's folder.

    ``fold_parallel`` is accepted for compatibility with romcomma_tpu's
    signature. The folds always run in the sequential per-fold loop here.

    Standard errors of a covariant model are not computed, as romcomma_tpu
    cannot compute them either (``calibrators.COVARIANT_ERRORS_UNSUPPORTED``).
    Asked for with ``is_covariant=True``, they raise NotImplementedError before
    any work starts, unless ``ignore_exceptions``. With ``is_covariant=None``
    the variant passes run, and the covariant pass raises, or is skipped under
    ``ignore_exceptions``, as in romcomma_tpu."""
    if is_error_calculated and is_covariant is True and not ignore_exceptions:
        raise NotImplementedError(COVARIANT_ERRORS_UNSUPPORTED)
    kinds = GSA.ALL_KINDS if kinds is None else kinds
    kinds = (kinds,) if isinstance(kinds, GSA.Kind) else kinds
    if not isinstance(repo, Fold):
        names = []
        for k in repo.folds:
            names = gsa(name, Fold(repo, k), is_covariant, is_isotropic, kinds, m,
                        ignore_exceptions, is_error_calculated, **kwargs)
        results.Collect({'S': {}, 'V': {}} | ({'T': {}, 'W': {}} if is_error_calculated else {}),
                        {str(n): {} for n in names}, ignore_exceptions).from_folds(repo, True)
        for n in names:
            shutil.copyfile(repo.fold_folder(repo.folds.start) / 'meta.json',
                            repo.folder / n / 'meta.json')
        return names
    names = []
    for covariant, isotropic in _model_passes(is_covariant, is_isotropic):
        full_name = _model_name(name, covariant, isotropic)
        with contexts.Timer(f'fold.{repo.meta["k"]} {full_name} GSA'):
            try:
                gp = MOGP(full_name, repo, is_read=True, is_covariant=covariant,
                          is_isotropic=isotropic)
                sobols = [Sobol(gp, kind, m, is_error_calculated, **kwargs) for kind in kinds]
                # One pass covers every kind (shared calibrator precompute);
                # each Sobol then post-processes and saves its share.
                kind_slices = {s.kind.name: tuple(s._m_dataset) for s in sobols}
                by_kind, extras = marginalize_all_kinds(gp, kind_slices, is_error_calculated,
                                                        **sobols[0].meta)
                for s in sobols:
                    folder = s.calibrate(precomputed=(by_kind[s.kind.name], extras))['folder']
                    names.append(Path(folder).relative_to(repo.folder))
            except Exception:
                if not ignore_exceptions:
                    raise
    return names


def rom(name: str, repo: Repository, m: int = 1, **kwargs) -> List[Dict]:
    """Undertake ROM (iterative input-basis rotation) across the Folds of a
    Repository: rom.run_rom, as romcomma_tpu's run.rom (run.py:228-233). The
    reference has no working equivalent (its ROM is dormant, rom/old.py)."""
    from romcomma_tpu_torch.rom import run_rom
    return run_rom(name, repo, m=m, **kwargs)
