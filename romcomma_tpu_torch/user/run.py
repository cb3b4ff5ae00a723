"""Workflow orchestration: run.gpr (reference: romcomma/user/run.py).
Counterpart of the GPR half of ``romcomma_tpu/user/run.py``.

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

from typing import Dict, List, Optional

from romcomma_tpu_torch.base.classes import Data
from romcomma_tpu_torch.data.storage import Repository, Fold
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
