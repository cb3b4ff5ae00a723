"""ROM: Reduced Order Modelling via iterative input-basis rotation.
Counterpart of ``romcomma_tpu/rom/rom.py`` (the reference's intent:
romcomma/rom/old.py:59-74, 200-214).

An alternating loop that

  1. calibrates the GP in the current (rotated) input basis,
  2. chooses a rotation: the eigenbasis of C = E[grad f grad f^T] of the
     posterior mean under the N(0, I) input measure (``'active_subspace'``,
     from ``MOGP.predict_gradient`` on a Gauss sample), or the Theta that
     maximizes the leading closed Sobol' index S[u_{1:m}] (``'sobol'``,
     ``ClosedSobolWithRotation.optimize_theta``),
  3. rotates the Fold's inputs onto it through the cumulative
     ``Fold.X_rotation``, and
  4. calibrates again, until the leading closed index S[0:m] settles.

The normalized inputs are N(0, 1) i.i.d., so the input measure is rotation
invariant and the Sobol' indices of the rotated model stay well defined.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from romcomma_tpu_torch.base.classes import dump_json
from romcomma_tpu_torch.base.definitions import write_once
from romcomma_tpu_torch.data.storage import Fold, Repository
from romcomma_tpu_torch.gsa.calibrators import ClosedSobol, ClosedSobolWithRotation
from romcomma_tpu_torch.gsa.models import GSA, Sobol
from romcomma_tpu_torch.models.gpr import MOGP


class ROM:
    """Iterative input-basis rotation for dimension reduction.

    meta['rotation_method'] chooses the rotation objective:

    - ``'active_subspace'`` (default): the eigenbasis of the posterior-mean
      gradient outer product C = E[grad f grad f^T].
    - ``'sobol'``: the reference's designed objective (rom/old.py:59-74,
      200-214), Theta maximizing the leading closed Sobol' index S[u_{1:m}]
      by gradient ascent through the differentiable rotated-basis index.

    ``seconds`` adds up the host time of each stage of ``calibrate`` (the
    GP calibrations, the rotations, the leading-index scores, the final GSA)
    and ``theta_timings`` holds each 'sobol' rotation's
    ``ClosedSobolWithRotation.last_theta_timings``; neither is persisted."""

    META: Dict[str, Any] = {'iterations': 4, 'm': 1, 'sample_size': 1024,
                            'tolerance': 1e-3, 'rotation_method': 'active_subspace'}

    def __init__(self, name: str, fold: Fold, gp_name: str = 'gpr.v.a',
                 is_covariant: bool = False, is_isotropic: bool = False,
                 **kwargs: Any):
        self.name = name
        self.fold = fold
        self.gp_name = gp_name
        self.is_covariant = is_covariant
        self.is_isotropic = is_isotropic
        self.meta = dict(self.META) | kwargs
        self.folder = fold.folder / name
        self.folder.mkdir(mode=0o777, parents=True, exist_ok=True)
        self.history: List[Dict[str, Any]] = []
        self.seconds: Dict[str, float] = {}
        self.theta_timings: List[Dict[str, float]] = []

    def _timed(self, stage: str, fn, *args, **kwargs):
        """fn(*args, **kwargs), its host seconds added to ``seconds[stage]``.
        Each stage ends on a host read of its result, so the clock sees the
        device's work."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.seconds[stage] = self.seconds.get(stage, 0.0) + time.perf_counter() - t0
        return out

    def _gp(self, is_read: bool) -> MOGP:
        return MOGP(self.gp_name, self.fold, is_read, self.is_covariant, self.is_isotropic)

    #: Test points per predict_gradient call of the active-subspace estimate.
    GRADIENT_BATCH: int = 256

    def _active_subspace_rotation(self, gp: MOGP, sample_size: int, rng) -> np.ndarray:
        """Eigenbasis of C = E[grad f grad f^T], gradients from the GP."""
        Z = rng.standard_normal((sample_size, gp.M))
        C = np.zeros((gp.M, gp.M))
        for start in range(0, sample_size, self.GRADIENT_BATCH):
            g_mean, _ = gp.predict_gradient(Z[start:start + self.GRADIENT_BATCH])  # (o,L,M)
            C += np.einsum('olM, olm -> Mm', g_mean, g_mean)
        C /= sample_size
        eigenvalues, eigenvectors = np.linalg.eigh(C)
        order = eigenvalues.argsort()[::-1]
        rotation = eigenvectors[:, order].T          # rows = new basis vectors
        # Deterministic signs: each row's largest-magnitude entry positive.
        signs = np.sign(rotation[np.arange(gp.M), np.abs(rotation).argmax(axis=1)])
        rotation = rotation * signs[:, None]
        if np.linalg.det(rotation) < 0:
            rotation[-1] *= -1.0
        return rotation

    def _sobol_rotation(self, gp: MOGP, m: int, meta: Dict[str, Any]) -> np.ndarray:
        """Theta maximizing the leading closed Sobol' index S[u_{1:m}], the
        reference's designed ROM objective (ClosedSobolWithRotation.optimize_theta)."""
        cal = ClosedSobolWithRotation(gp)
        theta, _ = cal.optimize_theta(
            Mu=m, maxiter=int(meta.get('theta_maxiter', 200)),
            n_starts=int(meta.get('theta_starts', 4)),
            seed=int(meta.get('seed', 0)))
        self.theta_timings.append(cal.last_theta_timings)
        return theta

    def _leading_closed_sobol(self, gp: MOGP, m: int) -> float:
        """The ROM score: ``semi_norm(S[0:m])`` over the (L,L) closed Sobol'
        index matrix, the reference's dormant ``Sobol.SemiNorm`` objective
        (rom/old.py:136-138), chosen by ``meta['semi_norm']``:

        - ``'mean_diagonal'`` (default): mean of the per-output indices.
        - ``'trace'``: sum of the per-output indices.
        - ``'frobenius'``: Frobenius norm of the full (L,L) matrix.
        - ``{'element': [l, j]}``: a single matrix element.
        - ``{'weights': [[...]]}``: ``sum(W * S)`` for an (L,L) weight matrix W.
        """
        S = ClosedSobol(gp).marginalize((0, m))['S'].cpu().numpy()
        return float(self._semi_norm(S, self.meta.get('semi_norm', 'mean_diagonal')))

    @staticmethod
    def _semi_norm(S: np.ndarray, spec) -> float:
        if isinstance(spec, dict):
            if 'element' in spec:
                l, j = spec['element']
                return float(S[int(l), int(j)])
            if 'weights' in spec:
                W = np.asarray(spec['weights'], dtype=S.dtype)
                return float(np.sum(W * S))
            raise ValueError(f'Unknown semi_norm spec {spec!r}')
        if spec == 'mean_diagonal':
            return float(np.mean(np.diagonal(S)))
        if spec == 'trace':
            return float(np.trace(S))
        if spec == 'frobenius':
            return float(np.linalg.norm(S))
        raise ValueError(f'Unknown semi_norm spec {spec!r}')

    #: meta['gp_initializer'] strategies, the reference's dormant
    #: GP_Initializer enum (rom/old.py:31-38, 158-172). 'warm' (the default)
    #: warm-starts from the last trained parameters; the others choose a
    #: parameter SOURCE ('current' = latest trained, 'original' = the
    #: iteration-0 optimum) and rotate its lengthscales into the new basis,
    #: optionally with the reference's guessed-lengthscale factor
    #: 0.5*M/(M - arange(M)) (old.py:161-163). 'rbf' (old.py:150-157)
    #: calibrates a throwaway ISOTROPIC model on the rotated fold and
    #: broadcasts its lengthscale to a full (L,M) ARD start for the main GP.
    GP_INITIALIZERS = ('warm', 'current', 'original',
                       'current_with_original_kernel',
                       'original_with_current_kernel',
                       'current_with_guessed_lengthscales',
                       'original_with_guessed_lengthscales',
                       'rbf')

    @staticmethod
    def _snapshot_params(gp: MOGP) -> Dict[str, np.ndarray]:
        return {'lengthscales': np.array(gp.kernel.data.lengthscales.np, dtype=float),
                'variance': np.array(gp.kernel.data.variance.np, dtype=float),
                'noise': np.array(gp.likelihood.data.variance.np, dtype=float)}

    @staticmethod
    def _rotate_lengthscales(ls: np.ndarray, rotation: np.ndarray,
                             guessed: bool = False) -> np.ndarray:
        """Lengthscales re-expressed in the rotated basis Theta: per output
        row, ls_new[m] = sum_k Theta[m,k] ls[k] (reference einsum
        'MK, JK -> M', old.py:161-167), made positive by abs and a floor (the
        positive-transform parameterization cannot hold the reference's
        possible negatives). ``guessed`` applies the reference's factor
        0.5*M/(M - m). Isotropic (L,1) lengthscales are rotation invariant and
        returned unchanged."""
        ls = np.asarray(ls, dtype=float)
        if ls.shape[-1] == 1:
            return ls
        M = ls.shape[-1]
        out = np.abs(ls @ np.asarray(rotation, dtype=float).T)
        if guessed:
            out = out * (0.5 * M / (M - np.arange(M, dtype=float)))
        return np.maximum(out, 1e-6)

    def _rbf_initializer(self, gp: MOGP, opt_kwargs: Dict[str, Any]):
        """The reference's 7th GP_Initializer (old.py:150-157): calibrate an
        isotropic sibling ``<gp_name>.rbf`` on the (rotated) fold, then seed
        the main GP with its optimum, the single lengthscale broadcast to a
        full (L, M) ARD matrix (the reference's ``kernel.make_ard(M)``)."""
        iso = MOGP(self.gp_name + '.rbf', self.fold, False, self.is_covariant, True)
        iso.calibrate(**opt_kwargs)
        params = self._snapshot_params(iso)
        ls = np.broadcast_to(params['lengthscales'].reshape(-1, 1), (gp.L, gp.M)).copy()
        gp.kernel.data.replace(lengthscales=ls, variance=params['variance'])
        gp.likelihood.data.replace(variance=params['noise'])

    def _apply_gp_initializer(self, gp: MOGP, rotation: np.ndarray,
                              strategy: str, original: Dict[str, np.ndarray],
                              opt_kwargs: Optional[Dict[str, Any]] = None):
        if strategy not in self.GP_INITIALIZERS:
            raise ValueError(f"Unknown gp_initializer {strategy!r}; "
                             f"choose from {self.GP_INITIALIZERS}")
        if strategy == 'rbf':
            return self._rbf_initializer(gp, opt_kwargs or {})
        current = self._snapshot_params(gp)
        params = original if strategy.startswith('original') else current
        ls_src = params['lengthscales']
        if strategy == 'current_with_original_kernel':
            ls_src = original['lengthscales']
        elif strategy == 'original_with_current_kernel':
            ls_src = current['lengthscales']
        ls = self._rotate_lengthscales(
            ls_src, rotation, guessed=strategy.endswith('guessed_lengthscales'))
        gp.kernel.data.replace(lengthscales=ls, variance=params['variance'])
        gp.likelihood.data.replace(variance=params['noise'])

    def calibrate(self, **kwargs) -> Dict[str, Any]:
        """Run the alternating rotation loop; persist the history in
        ``meta.json``, the rotation R the fold's inputs went through in
        ``rotation.csv`` (the inputs are now X_0 @ R.T, with X_0 those before
        the run) and the final closed Sobol' indices in the rotated basis."""
        meta = self.meta = self.meta | kwargs
        m, iterations = int(meta['m']), int(meta['iterations'])
        tolerance = float(meta['tolerance'])
        rng = np.random.default_rng(meta.get('seed', 0))
        opt_kwargs = {k: meta[k] for k in ('maxiter', 'gtol') if k in meta}
        gp = self._gp(is_read=False)
        self._timed('calibrate', gp.calibrate, **opt_kwargs)
        score = self._timed('score', self._leading_closed_sobol, gp, m)
        self.history.append({'iteration': 0, 'S_m': score})
        original = self._snapshot_params(gp)   # the GP_Initializer 'original'
        applied = self.fold.X_rotation         # the inputs are now X_0 @ applied.T
        method = str(meta.get('rotation_method', 'active_subspace'))
        initializer = str(meta.get('gp_initializer', 'warm'))
        for it in range(1, iterations + 1):
            if method == 'sobol':
                rotation = self._timed('rotation', self._sobol_rotation, gp, m, meta)
            else:
                rotation = self._timed('rotation', self._active_subspace_rotation, gp,
                                       int(meta['sample_size']), rng)
            self.fold.X_rotation = rotation
            applied = rotation @ applied
            gp = self._gp(is_read=True)       # warm start from previous params
            if initializer != 'warm':
                self._timed('calibrate', self._apply_gp_initializer, gp, rotation, initializer,
                            original, opt_kwargs)
            self._timed('calibrate', gp.calibrate, **opt_kwargs)
            new_score = self._timed('score', self._leading_closed_sobol, gp, m)
            self.history.append({'iteration': it, 'S_m': new_score})
            if abs(new_score - score) < tolerance:
                score = new_score
                break
            score = new_score
        # The final GSA runs in the rotated basis: the rotation is persisted
        # into the fold and the GP retrained over the rotated inputs, so the
        # axis-aligned GSA, standard errors included, applies there as is.
        self._timed('gsa', Sobol(gp, GSA.Kind.CLOSED,
                                 is_error_calculated=bool(meta.get('is_error_calculated', False)),
                                 is_T_partial=bool(meta.get('is_T_partial', True))).calibrate)
        meta['history'] = self.history
        meta['S_m'] = score
        write_once(dump_json, self.folder / 'meta.json', meta, default=str)
        # rotation.csv holds the rotation the inputs went through, R_k ... R_1.
        # Fold.X_rotation composes old @ new, as romcomma_tpu's storage does,
        # which differs once two rotations of the run do not commute.
        write_once(np.savetxt, self.folder / 'rotation.csv', applied, delimiter=',')
        return meta

    def reduce(self, Mu: int) -> Path:
        """Truncate to the leading Mu rotated inputs: write a reduced data.csv
        (X[:, :Mu], Y) in the ROM's folder (reference intent rom/old.py:230-237)."""
        df = self.fold.data.df
        reduced = df.iloc[:, :Mu].join(df.iloc[:, self.fold.M:])
        out = self.folder / f'reduced.{Mu}.csv'
        write_once(reduced.to_csv, out)
        return out


def run_rom(name: str, repo: Repository, m: int = 1, **kwargs) -> List[Dict[str, Any]]:
    """Run ROM across all folds of a Repository."""
    return [ROM(name, Fold(repo, k), m=m, **kwargs).calibrate() for k in repo.folds]
