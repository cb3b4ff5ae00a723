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
  - ``fold_parallel`` batches the equal-shape folds of a repository, as
    romcomma_tpu's run does: their descents run in lockstep through one
    batched LML, their GSA through one stacked pass.
"""

from __future__ import annotations

import shutil
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from romcomma_tpu_torch.base.classes import Data
from romcomma_tpu_torch.base.definitions import write_once
from romcomma_tpu_torch.data.storage import Repository, Fold
from romcomma_tpu_torch.gsa.calibrators import (COVARIANT_ERRORS_UNSUPPORTED,
                                                marginalize_all_kinds, marginalize_all_kinds_folds)
from romcomma_tpu_torch.gsa.models import GSA, Sobol
from romcomma_tpu_torch.models import gp as gp_module
from romcomma_tpu_torch.models.gpr import MOGP
from romcomma_tpu_torch.models.params import variant_constrain, variant_mask
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


def _gpr_fold_batched(name: str, repo: Repository, is_read: Optional[bool],
                      is_covariant: Optional[bool], is_isotropic: Optional[bool],
                      kernel_parameters: Optional[Dict], likelihood_variance,
                      is_tested: bool, **kwargs) -> Optional[List[str]]:
    """Calibrate each non-covariant model pass of EVERY equal-shape fold
    together: their K*L descents in lockstep, each evaluation one batched LML
    (models.gp.calibrate_variant_folds; romcomma_tpu's run.py:71-156 runs
    them as one vmapped descent). Each descent is the one the per-fold loop
    makes. Parameters, meta and LML are written back per fold through the
    standard persistence path.

    Folds are grouped by (N, M, L, maxiter, gtol, options); the improper
    fold (its N differs), any fold alone in its group and folds of N >=
    the large-N threshold run through MOGP.calibrate in place. Returns the
    constructed model names, or ``None`` when the workload is ineligible
    (covariant passes, fewer than two folds, or no group of two folds): the
    caller then runs the sequential per-fold loop."""
    passes = _model_passes(is_covariant, is_isotropic)
    if any(covariant for covariant, _ in passes) or len(list(repo.folds)) < 2:
        return None
    names: List[str] = []
    for pass_index, (covariant, isotropic) in enumerate(passes):
        full_name = _model_name(name, covariant, isotropic)
        gps, metas, kopts, lopts = [], [], [], []
        for k in repo.folds:
            fold = Fold(repo, k)
            read = is_read if pass_index == 0 else None
            if read is None:
                read = _resolve_warm_start(name, fold, full_name, covariant)
            gp_k = (MOGP(full_name, fold, read, covariant, isotropic) if read else
                    MOGP(full_name, fold, read, covariant, isotropic,
                         kernel_parameters, likelihood_variance))
            meta, ko, lo = gp_k._calibration_options(**{key: (dict(v) if isinstance(v, dict) else v)
                                                        for key, v in kwargs.items()})
            gps.append(gp_k)
            metas.append(meta)
            kopts.append(ko)
            lopts.append(lo)
        groups: Dict[tuple, List[int]] = {}
        for i, (g, m, ko, lo) in enumerate(zip(gps, metas, kopts, lopts)):
            large = g.N >= int(m.get('large_n_threshold', g.LARGE_N_THRESHOLD))
            key = ('large', i) if large else (
                g.N, g.M, g.L, int(m.get('maxiter', 5000)), float(m.get('gtol', 1e-16)),
                str(ko), str(lo))
            groups.setdefault(key, []).append(i)
        if pass_index == 0 and not any(len(v) > 1 for v in groups.values()):
            return None          # nothing to batch: the sequential loop instead
        for key, idxs in groups.items():
            if len(idxs) < 2:
                i = idxs[0]
                with contexts.Timer(f'fold.{gps[i].fold.meta["k"]} {full_name} GPR'):
                    gps[i].calibrate(**kwargs)
                    if is_tested:
                        gps[i].test()
                continue
            maxiter, gtol = key[3], key[4]
            i0 = idxs[0]
            mask = variant_mask(kernel_variance=kopts[i0]['variance'],
                                lengthscales=kopts[i0]['lengthscales']['variant'],
                                noise=lopts[i0]['variance'])
            raws = [gps[i]._variant_raw() for i in idxs]
            raws = {leaf: torch.stack([raw[leaf] for raw in raws]) for leaf in raws[0]}
            # Each fold's X keeps its column-major layout (pandas gives it so
            # and MOGP.calibrate trains on it), so that each descent rounds,
            # and steps, as the per-fold loop's does.
            xs = torch.stack([gps[i]._tensor(gps[i].X).mT for i in idxs]).mT
            ys = torch.stack([gps[i]._tensor(gps[i].Y) for i in idxs])
            with contexts.Timer(f'fold-batched x{len(idxs)} {full_name} GPR'):
                raw_opt, lml, iterations, _ = gp_module.calibrate_variant_folds(
                    raws, mask, xs, ys, maxiter=maxiter, gtol=gtol)
                for j, i in enumerate(idxs):
                    # Constrained fold by fold, as MOGP.calibrate does: an
                    # elementwise CPU kernel may round a longer tensor's tail
                    # otherwise, and the written parameters are the loop's.
                    with torch.no_grad():
                        c = {leaf: value.cpu().numpy() for leaf, value in variant_constrain(
                            {leaf: value[j] for leaf, value in raw_opt.items()}).items()}
                    gps[i]._finish_variant_calibration(c, lml[j].numpy(), iterations[j].numpy(),
                                                       metas[i], kopts[i], lopts[i],
                                                       recompute_lml=True)
                    if is_tested:
                        gps[i].test()
        names.append(full_name)
    return names


def gpr(name: str, repo: Repository, is_read: Optional[bool], is_covariant: Optional[bool],
        is_isotropic: Optional[bool], ignore_exceptions: bool = False,
        kernel_parameters: Optional[Dict] = None, likelihood_variance=None,
        is_calibrated: bool = True, is_tested: bool = True,
        fold_parallel: Optional[bool] = None, **kwargs) -> List[str]:
    """Undertake GPR on a Fold, or across every Fold in a Repository.
    Returns the list of model names constructed (reference run.py:35-102).

    ``fold_parallel`` (repository-level only): calibrate the equal-shape
    folds' models together (:func:`_gpr_fold_batched`) instead of in the
    per-fold loop. ``None`` (default) does so when eligible and falls back to
    the sequential loop, with a RuntimeWarning naming the exception, if the
    batched path fails; ``True`` raises instead; ``False`` runs the
    sequential loop. KeyboardInterrupt and SystemExit always pass through."""
    if not isinstance(repo, Fold):
        names_opt: Optional[List[str]] = None
        if fold_parallel is not False and is_calibrated:
            try:
                names_opt = _gpr_fold_batched(name, repo, is_read, is_covariant, is_isotropic,
                                              kernel_parameters, likelihood_variance, is_tested,
                                              **kwargs)
            except Exception as error:
                if fold_parallel:       # explicitly requested: surface it
                    raise
                # Auto mode: fall back sequentially, but never silently: a
                # genuine calibration bug or a failed launch must leave a trace.
                warnings.warn(f'fold-parallel GPR failed ({type(error).__name__}: '
                              f'{error}); falling back to the sequential fold loop.',
                              RuntimeWarning, stacklevel=2)
        if names_opt is not None:
            names = names_opt
        else:
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


def _gsa_fold_batched(name: str, repo: Repository, is_covariant: Optional[bool],
                      is_isotropic: Optional[bool], kinds, m: int,
                      is_error_calculated: bool, **kwargs) -> Optional[List[Path]]:
    """Run every equal-shape fold's GSA (all model passes, all kinds) through
    one stacked pass per pass and group (calibrators.marginalize_all_kinds_folds;
    romcomma_tpu's run.py:236-294). Odd-shaped folds (the improper fold) run
    through the single-fold call in place. Returns the result paths of the
    last fold, or ``None`` when the workload is ineligible (fewer than two
    folds, or standard errors asked of a covariant pass, which the
    sequential loop refuses as it always has); eligibility is decided before
    any Sobol is built, since building one creates its folders on disk."""
    fold_ks = list(repo.folds)
    passes = _model_passes(is_covariant, is_isotropic)
    if len(fold_ks) < 2 or (is_error_calculated and any(c for c, _ in passes)):
        return None
    names_by_fold: Dict[int, List[Path]] = {}
    for covariant, isotropic in passes:
        full_name = _model_name(name, covariant, isotropic)
        per_fold = []
        for k in fold_ks:
            fold = Fold(repo, k)
            gp = MOGP(full_name, fold, is_read=True, is_covariant=covariant,
                      is_isotropic=isotropic)
            per_fold.append((fold, gp, [Sobol(gp, kind, m, is_error_calculated, **kwargs)
                                        for kind in kinds]))
        groups: Dict[tuple, List[int]] = {}
        for i, (_, gp, _) in enumerate(per_fold):
            groups.setdefault((gp.N, gp.M, gp.L), []).append(i)
        for idxs in groups.values():
            batch = [per_fold[i] for i in idxs]
            kind_slices = {s.kind.name: tuple(s._m_dataset) for s in batch[0][2]}
            meta = batch[0][2][0].meta
            if len(idxs) >= 2:
                with contexts.Timer(f'fold-batched x{len(idxs)} {full_name} GSA'):
                    outs = marginalize_all_kinds_folds([gp for _, gp, _ in batch], kind_slices,
                                                       is_error_calculated, **meta)
            else:
                with contexts.Timer(f'fold.{batch[0][0].meta["k"]} {full_name} GSA'):
                    outs = [marginalize_all_kinds(batch[0][1], kind_slices,
                                                  is_error_calculated, **meta)]
            for i, (fold, gp, sobols), (by_kind, extras) in zip(idxs, batch, outs):
                fold_names = names_by_fold.setdefault(i, [])
                for s in sobols:
                    folder = s.calibrate(precomputed=(by_kind[s.kind.name], extras))['folder']
                    fold_names.append(Path(folder).relative_to(fold.folder))
    # As the sequential loop does: the LAST fold's names.
    return names_by_fold[len(fold_ks) - 1]


def gsa(name: str, repo: Repository, is_covariant: Optional[bool], is_isotropic: Optional[bool],
        kinds: 'GSA.Kind | Sequence[GSA.Kind]' = None, m: int = -1,
        ignore_exceptions: bool = False, is_error_calculated: bool = False,
        fold_parallel: Optional[bool] = None, **kwargs) -> List[Path]:
    """Undertake GSA on a Fold, or recursively across the Folds in a Repository
    (reference run.py:105-158). Returns the GSA folders of the last fold,
    relative to the fold's folder.

    ``fold_parallel`` (repository-level only): run the equal-shape folds'
    GSA together (:func:`_gsa_fold_batched`) instead of in the per-fold loop,
    with the tri-state of :func:`gpr`: ``None`` when eligible, warning and
    falling back on failure; ``True`` raising; ``False`` sequential.

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
        names_opt: Optional[List[Path]] = None
        if fold_parallel is not False:
            try:
                names_opt = _gsa_fold_batched(name, repo, is_covariant, is_isotropic, kinds, m,
                                              is_error_calculated, **kwargs)
            except Exception as error:
                if fold_parallel:       # explicitly requested: surface it
                    raise
                warnings.warn(f'fold-parallel GSA failed ({type(error).__name__}: '
                              f'{error}); falling back to the sequential fold loop.',
                              RuntimeWarning, stacklevel=2)
        if names_opt is not None:
            names = names_opt
        else:
            names = []
            for k in repo.folds:
                names = gsa(name, Fold(repo, k), is_covariant, is_isotropic, kinds, m,
                            ignore_exceptions, is_error_calculated, **kwargs)
        results.Collect({'S': {}, 'V': {}} | ({'T': {}, 'W': {}} if is_error_calculated else {}),
                        {str(n): {} for n in names}, ignore_exceptions).from_folds(repo, True)
        for n in names:
            write_once(shutil.copyfile, repo.fold_folder(repo.folds.start) / 'meta.json',
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
