"""Persistent Gaussian Process models: Likelihood, GPR, MOGP.

Counterpart of ``romcomma_tpu/models/gpr.py`` and of the reference's
``romcomma/gpr/models.py``: the same folder layout (``fold.k/<name>/`` with
``kernel/``, ``likelihood/``, ``kernel.csv`` type tag, ``test.csv``,
``test_summary.csv``) and the same META/meta.json option flow. Calibration is
L independent scipy L-BFGS-B descents on a torch LML (models.gp).

This port covers the variant MOGP below ``MOGP.LARGE_N_THRESHOLD`` rows. A
covariant model can be constructed and persisted, but not calibrated or
predicted yet.
"""

from __future__ import annotations

from abc import abstractmethod
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from romcomma_tpu_torch.base.classes import Data, Model
from romcomma_tpu_torch.base.definitions import (FLOAT, LIKELIHOOD_VARIANCE_FLOOR, TORCH_FLOAT,
                                                 device)
from romcomma_tpu_torch.data.storage import Fold, Frame
from romcomma_tpu_torch.models import gp
from romcomma_tpu_torch.models.kernels import Kernel, RBF
from romcomma_tpu_torch.models.params import variant_constrain, variant_init, variant_mask

_COVARIANT_LATER = ('the covariant MOGP is not ported to romcomma_tpu_torch yet; it waits '
                    'for the covariant slice of the port')


class Likelihood(Model):
    """Persistent likelihood: (L,L)|(1,L) noise variance + recorded
    log_marginal output (reference gpr/models.py:35-84)."""

    class Data(Data):
        FIELDS = {'variance': np.atleast_2d(0.02), 'log_marginal': np.atleast_2d(1.0)}

    META: Dict[str, Any] = {'variance': True, 'covariance': True}

    VARIANCE_FLOOR: float = LIKELIHOOD_VARIANCE_FLOOR

    def __init__(self, parent: 'GPR', read_data: bool = False, **kwargs):
        super().__init__(parent.folder / 'likelihood', read_data, **kwargs)
        self._parent = parent

    @property
    def is_covariant(self) -> bool:
        return self._data.variance.df.shape[0] > 1

    def calibrate(self, **kwargs) -> Dict[str, Any]:
        """Resolve trainability flags only (reference gpr/models.py:71-80)."""
        return dict(self.META) | kwargs


class GPR(Model):
    """Persistent GP regression model (reference gpr/models.py:88-321)."""

    class Data(Data):
        FIELDS = {'kernel': np.atleast_2d(None)}

    META: Dict[str, Any] = {}

    KERNEL_FOLDER_NAME: str = 'kernel'

    def __init__(self, name: str, fold: Fold, is_read: Optional[bool], is_covariant: bool,
                 is_isotropic: bool, kernel_parameters: Optional[Dict] = None,
                 likelihood_variance=None, mean_function=None):
        """``mean_function`` (reference MOMeanFunction, default Zero) composes
        functionally: the GP fits the residuals Y - mean(X) and predictions
        add mean(x) back (models/means.py)."""
        self._fold = fold
        self._X = fold.X.to_numpy(dtype=FLOAT(), copy=True)
        self._Y = fold.Y.to_numpy(dtype=FLOAT(), copy=True)
        self._mean_function = mean_function
        if mean_function is not None:
            self._Y = self._Y - mean_function(torch.as_tensor(self._X)).numpy()
        self._N, self._M, self._L = fold.N, fold.M, fold.L
        super().__init__(fold.folder / name, bool(is_read))
        self._likelihood = (Likelihood(self, bool(is_read)) if likelihood_variance is None
                            else Likelihood(self, bool(is_read), variance=likelihood_variance))
        if is_read and kernel_parameters is None:
            kernel_type = Kernel.TypeFromIdentifier(str(self._data.kernel.np[0, 0]))
            self._kernel = kernel_type(self._folder / self.KERNEL_FOLDER_NAME, True)
        else:
            kernel_parameters = kernel_parameters or {}
            self._kernel = RBF(self._folder / self.KERNEL_FOLDER_NAME, bool(is_read),
                               **kernel_parameters)
            self._data.replace(kernel=np.atleast_2d(RBF.TYPE_IDENTIFIER()))
        self.broadcast_parameters(is_covariant, is_isotropic)

    # -- structure ----------------------------------------------------------- #

    @property
    def fold(self) -> Fold:
        return self._fold

    @property
    def kernel(self) -> Kernel:
        return self._kernel

    @property
    def likelihood(self) -> Likelihood:
        return self._likelihood

    @property
    def L(self) -> int:
        return self._L

    @property
    def M(self) -> int:
        return self._M

    @property
    def N(self) -> int:
        return self._N

    @property
    def X(self) -> np.ndarray:
        return self._X

    @property
    def Y(self) -> np.ndarray:
        return self._Y

    @property
    def test_csv(self) -> Path:
        return self._folder / 'test.csv'

    @property
    def test_summary_csv(self) -> Path:
        return self._folder / 'test_summary.csv'

    def broadcast_parameters(self, is_covariant: bool, is_isotropic: bool) -> 'GPR':
        """Grow parameters to the requested covariance/anisotropy
        (reference gpr/models.py:274-288). The constructor calls this
        unconditionally, as the reference does (gpr/models.py:321)."""
        self._posterior_cache = None
        target_shape = (self._L, self._L) if is_covariant else (1, self._L)
        self._likelihood.data.variance.broadcast_value(target_shape=target_shape, is_diagonal=True)
        self._kernel.broadcast_parameters(variance_shape=target_shape,
                                          M=1 if is_isotropic else self._M)
        return self

    # -- parameters ------------------------------------------------------------ #

    @property
    def is_covariant(self) -> bool:
        return self._likelihood.is_covariant

    def _variant_raw(self):
        if self.is_covariant:
            raise NotImplementedError(_COVARIANT_LATER)
        return variant_init(self._kernel.data.variance.np[0],
                            self._kernel.data.lengthscales.np,
                            self._likelihood.data.variance.np[0])

    @staticmethod
    def _tensor(a: np.ndarray, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """a on the compute device, at ``dtype`` (default: the working dtype)."""
        return torch.as_tensor(np.asarray(a), dtype=dtype or TORCH_FLOAT(), device=device())

    # -- compute ------------------------------------------------------------- #

    @abstractmethod
    def calibrate(self, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError

    #: test points per predict chunk: bounds the O(N o) work of one chunk so
    #: large test sets stream through in fixed memory.
    PREDICT_CHUNK: int = 4096

    def predict(self, x: np.ndarray, y_instead_of_f: bool = True,
                exact_sd: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior (mean (o,L), std (o,L)) at x (reference gpr/models.py:375-384),
        from the cached float64 posterior factors, in chunks of test points.

        ``exact_sd`` (default): in the float32 fast mode, predict in float64
        against the float64 factors. At high condition numbers the float32
        triangular solve loses up to a few percent of SD, which flips Z^2 > 4
        outlier classifications in test(). Pass exact_sd=False for throughput
        when only the mean matters: the gram then runs in the working dtype."""
        if self.is_covariant:
            raise NotImplementedError(_COVARIANT_LATER)
        K_cho, K_inv_Y = self.posterior_factors
        dt = torch.float64 if exact_sd else None
        raw = {name: value.to(dt or value.dtype) for name, value in self._variant_raw().items()}
        X, xs_all = self._tensor(self._X, dt), self._tensor(x, dt)
        means, variances = [], []
        with torch.no_grad():
            for start in range(0, xs_all.shape[0], self.PREDICT_CHUNK):
                mean, var = gp.predict_variant_from_factors(
                    raw, K_cho, K_inv_Y, X, xs_all[start:start + self.PREDICT_CHUNK],
                    y_instead_of_f)
                means.append(mean)
                variances.append(var)
        mean = torch.cat(means).cpu().numpy()
        var = torch.cat(variances).cpu().numpy()
        if self._mean_function is not None:
            mean = mean + self._mean_function(torch.as_tensor(np.asarray(x), dtype=torch.float64)).numpy()
        return np.atleast_2d(mean), np.atleast_2d(np.sqrt(var))

    def predict_f(self, x: np.ndarray, full_cov: bool = False,
                  full_output_cov: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Latent prediction p(f*|Y) with the reference's full-covariance
        shape semantics (gpf/models.py:84-111), including the
        ``full_cov => full_output_cov`` rule. Returns (mean (n,L), var):

            full_cov=False, full_output_cov=False -> var (n,L)
            full_cov=False, full_output_cov=True  -> var (n,L,L)
            full_cov=True                         -> var (n,n,L,L)

        The independent outputs embed their per-output covariances on the
        (L,L) diagonal."""
        if self.is_covariant:
            raise NotImplementedError(_COVARIANT_LATER)
        xs = self._tensor(x)
        with torch.no_grad():
            mean, var = gp.predict_variant_full(self._variant_raw(), self._tensor(self._X),
                                                self._tensor(self._Y), xs,
                                                full_cov=bool(full_cov),
                                                full_output_cov=bool(full_output_cov))
        mean, var = mean.cpu().numpy(), var.cpu().numpy()
        if self._mean_function is not None:
            mean = mean + self._mean_function(xs.cpu()).numpy()
        return mean, var

    @property
    def posterior_factors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K_cho, K_inv_Y) from one float64 Cholesky on the compute device.
        Cached per instance; the cache is invalidated whenever the
        parameters change (calibrate / broadcast)."""
        if self.is_covariant:
            raise NotImplementedError(_COVARIANT_LATER)
        if self._posterior_cache is None:
            with torch.no_grad():
                self._posterior_cache = gp.posterior_factors_variant(
                    self._variant_raw(), self._tensor(self._X), self._tensor(self._Y))
        return self._posterior_cache

    @property
    def K_cho(self) -> torch.Tensor:
        """(L,N,N) Cholesky of the noisy gram (reference gpr/models.py:427-439)."""
        return self.posterior_factors[0]

    @property
    def K_inv_Y(self) -> torch.Tensor:
        """(L,1,N) == ChoSolve(K_cho, Y) (reference gpr/models.py:441-444)."""
        return self.posterior_factors[1]

    def predict_df(self, x: np.ndarray, y_instead_of_f: bool = True,
                   is_normalized: bool = True) -> pd.DataFrame:
        """(X, Mean, SD) prediction frame, optionally denormalized
        (reference gpr/models.py:202-222)."""
        X_heading = self._fold.meta['data']['X_heading']
        Y_heading = self._fold.meta['data']['Y_heading']
        prediction = self.predict(x, y_instead_of_f)
        result = pd.DataFrame(np.concatenate([x, prediction[0]], axis=1),
                              columns=self._fold.test_data.df.columns)
        predictive_std = result.loc[:, [Y_heading]].copy()
        predictive_std.iloc[:] = prediction[1]
        if not is_normalized:
            result = self._fold.normalization.undo_from(result)
            predictive_std = self._fold.normalization.unscale_Y(predictive_std)
        result = result.rename(columns={Y_heading: 'Mean'}, level=0)
        predictive_std = predictive_std.rename(columns={Y_heading: 'SD'}, level=0)
        return result.join([predictive_std])

    def test(self) -> Frame:
        """Write test.csv (per-sample Mean/SD/Abs Error/Z Score/Outlier) and
        test_summary.csv (RMSE/mean-SD/outlier-rate), reference gpr/models.py:235-272."""
        result = Frame(self.test_csv, self._fold.test_data.df)
        Y_heading = self._fold.meta['data']['Y_heading']
        y_frame = result.df.loc[:, [Y_heading]]
        y_true = y_frame.to_numpy(dtype=float, copy=False)
        mean, std = (np.asarray(a, dtype=float) for a in self.predict(self._fold.test_x.values))
        z_score = (y_true - mean) / std
        is_outlier = z_score ** 2 > 4.0

        def stat(heading: str, values: np.ndarray) -> pd.DataFrame:
            frame = y_frame.copy().rename(columns={Y_heading: heading}, level=0)
            frame.iloc[:] = values
            return frame

        per_sample = [stat('Mean', mean), stat('SD', std),
                      stat('Abs Error', np.abs(y_true - mean)), stat('Z Score', z_score)]
        outliers = pd.DataFrame(
            is_outlier, index=result.df.index,
            columns=y_frame.rename(columns={Y_heading: 'Outlier'}, level=0).columns)
        outliers = outliers.join(pd.DataFrame(
            np.column_stack((is_outlier.any(axis=1), is_outlier.all(axis=1))),
            index=outliers.index,
            columns=pd.MultiIndex.from_tuples([('Outlier', 'Any Output'), ('Outlier', 'All Outputs')])))
        result.df = result.df.join(per_sample + [outliers])
        result.write()

        def summary_row(frame: pd.DataFrame) -> pd.DataFrame:
            return pd.DataFrame(frame.sum(axis=0) / frame.count(axis=0)).transpose()

        rmse = summary_row(per_sample[2].rename(columns={'Abs Error': 'RMSE'}, level=0) ** 2) ** 0.5
        summary = rmse.join([summary_row(per_sample[1]), summary_row(outliers)])
        Frame(self.test_summary_csv, summary)
        return result


class MOGP(GPR):
    """The concrete multi-output GP (reference gpr/models.py:324-463)."""

    META: Dict[str, Any] = {'maxiter': 5000, 'gtol': 1e-16}

    #: N at/above which the JAX package switches variant calibration to its
    #: blocked distributed engine. That route is not ported yet.
    LARGE_N_THRESHOLD: int = 10000

    def _calibration_options(self, **kwargs):
        """Resolve META -> meta.json -> kwargs (reference gpr/models.py:354-357)."""
        meta = self.read_meta() if self._meta_json.exists() else dict(self.META)
        kernel_options = self._kernel.calibrate(**(meta.pop('kernel', {}) | kwargs.pop('kernel', {})))
        likelihood_options = self._likelihood.calibrate(**(meta.pop('likelihood', {}) | kwargs.pop('likelihood', {})))
        meta.update(kwargs)
        meta.pop('result', None)
        return meta, kernel_options, likelihood_options

    def _finish_variant_calibration(self, c, iterations, meta, kernel_options,
                                    likelihood_options) -> Dict[str, Any]:
        """Write optimized variant parameters back to the CSV frames + meta.

        The persisted log-marginal is evaluated afresh from the *written* CSV
        parameters, so disk state is exactly self-consistent: reloading the
        model and recomputing its LML reproduces ``log_marginal.csv``."""
        self._posterior_cache = None
        self._kernel.data.replace(variance=c['variance'][None, :],
                                  lengthscales=c['lengthscales'])
        self._likelihood.data.replace(variance=c['noise'][None, :])
        with torch.no_grad():
            lml = gp.lml_variant(self._variant_raw(), self._tensor(self._X),
                                 self._tensor(self._Y)).cpu().numpy()
        self._likelihood.data.replace(log_marginal=lml[None, :])
        result = (f'Converged in {np.asarray(iterations).tolist()} L-BFGS iterations, '
                  f'lml={lml.tolist()}')
        meta.update({'result': result, 'kernel': kernel_options,
                     'likelihood': likelihood_options})
        self.write_meta(meta)
        return meta

    def calibrate(self, method: str = 'L-BFGS-B', **kwargs) -> Dict[str, Any]:
        """Maximize the LML; write optimized parameters back to the
        kernel/likelihood CSV frames (reference gpr/models.py:345-373)."""
        if self.is_covariant:
            raise NotImplementedError(_COVARIANT_LATER)
        self._posterior_cache = None
        meta, kernel_options, likelihood_options = self._calibration_options(**kwargs)
        threshold = int(meta.get('large_n_threshold', self.LARGE_N_THRESHOLD))
        if self._N >= threshold:
            raise NotImplementedError(
                f'N={self._N} >= {threshold}: the large-N variant route (DistributedGP) is not '
                'ported to romcomma_tpu_torch yet; it waits for the large-N slice of the port')
        mask = variant_mask(kernel_variance=kernel_options['variance'],
                            lengthscales=kernel_options['lengthscales']['variant'],
                            noise=likelihood_options['variance'])
        raw_opt, _, iterations = gp.calibrate_variant(
            self._variant_raw(), mask, self._tensor(self._X), self._tensor(self._Y),
            maxiter=int(meta.get('maxiter', 5000)), gtol=float(meta.get('gtol', 1e-16)))
        with torch.no_grad():
            c = {name: value.cpu().numpy() for name, value in variant_constrain(raw_opt).items()}
        return self._finish_variant_calibration(c, iterations, meta, kernel_options,
                                                likelihood_options)
