"""Persistent Gaussian Process models: Likelihood, GPR, MOGP.

Counterpart of ``romcomma_tpu/models/gpr.py`` and of the reference's
``romcomma/gpr/models.py``: the same folder layout (``fold.k/<name>/`` with
``kernel/``, ``likelihood/``, ``kernel.csv`` type tag, ``test.csv``,
``test_summary.csv``) and the same META/meta.json option flow. Calibration is
L independent scipy L-BFGS-B descents on a torch LML (models.gp) for the
variant MOGP, one for the covariant MOGP.

At ``MOGP.LARGE_N_THRESHOLD`` rows and more, the variant MOGP trains through
the large-N route, ``parallel.distributed.DistributedGP``, as romcomma_tpu's
does. The covariant MOGP takes one descent on this device or, under a
process group of several ranks at L*N >= the threshold with the
lengthscales frozen, over their mesh (``parallel.covariant_mesh``), as
romcomma_tpu's does.
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
from romcomma_tpu_torch.models.likelihoods import MOGaussian
from romcomma_tpu_torch.models.params import (covariant_constrain, covariant_init,
                                              covariant_mask, variant_constrain, variant_init,
                                              variant_mask)
from romcomma_tpu_torch.ops.gram import rbf_gram_covariant, rbf_gram_variant
from romcomma_tpu_torch.ops.linalg import tri_solve


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

    def mo_gaussian(self, **kwargs) -> MOGaussian:
        """The math-layer MOGaussian over this model's stored noise variance
        (reference gpr/models.py:59: ``mf.likelihoods.MOGaussian(...)``).
        A variant (1, L) frame becomes the diagonal (L, L) covariance; kwargs
        go to MOGaussian (n_quad, dtype, on)."""
        v = self._data.variance.df.to_numpy(copy=True)
        return MOGaussian(np.diag(v[0]) if v.shape[0] == 1 else v, **kwargs)


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
        (reference gpr/models.py:274-288).

        Reference-parity quirk: the constructor calls this unconditionally
        (reference gpr/models.py:321), and ``broadcast_value(is_diagonal=
        True)`` zeroes the off-diagonals of square targets, so RELOADING a
        covariant model diagonalizes a trained non-diagonal noise covariance,
        as the reference and romcomma_tpu do. The persisted log_marginal of a
        covariant model reflects the full noise covariance it was trained
        with, not the diagonalized reload."""
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
        return variant_init(self._kernel.data.variance.np[0],
                            self._kernel.data.lengthscales.np,
                            self._likelihood.data.variance.np[0])

    def _covariant_raw(self):
        return covariant_init(self._kernel.data.variance.np,
                              self._kernel.data.lengthscales.np,
                              self._likelihood.data.variance.np)

    def _raw(self):
        return self._covariant_raw() if self.is_covariant else self._variant_raw()

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
        when only the mean matters: the gram then runs in the working dtype.
        A covariant model predicts the same way, from its (LN,LN) factor, on
        the compute device (romcomma_tpu moves its float32-mode covariant
        predict to the host CPU instead)."""
        K_cho, K_inv_Y = self.posterior_factors
        dt = torch.float64 if exact_sd else None
        raw = {name: value.to(dt or value.dtype) for name, value in self._raw().items()}
        from_factors = (gp.predict_covariant_from_factors if self.is_covariant else
                        gp.predict_variant_from_factors)
        X, xs_all = self._tensor(self._X, dt), self._tensor(x, dt)
        means, variances = [], []
        with torch.no_grad():
            for start in range(0, xs_all.shape[0], self.PREDICT_CHUNK):
                mean, var = from_factors(raw, K_cho, K_inv_Y, X,
                                         xs_all[start:start + self.PREDICT_CHUNK], y_instead_of_f)
                means.append(mean)
                variances.append(var)
        mean = torch.cat(means).cpu().numpy()
        var = torch.cat(variances).cpu().numpy()
        if self._mean_function is not None:
            mean = mean + self._mean_function(torch.as_tensor(np.asarray(x), dtype=torch.float64)).numpy()
        return np.atleast_2d(mean), np.atleast_2d(np.sqrt(var))

    def predict_gradient(self, x: np.ndarray, y_instead_of_f: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Gradient-GP prediction dy/dx (reference gpr/models.py:386-415,
        romcomma_tpu gpr.py:626-673): mean (o,L,M) and covariance, variant
        (o,o,L,M,M) | covariant (o,L,o,L,M,M), from the analytic RBF derivative
        d k(X,x)/dx = k(X,x) (X - x)/lam^2 (covariant: (X/lam_L - x/lam_l)/lam_l).

        Computed in float64 against the float64 posterior factors whatever the
        working dtype, as predict(exact_sd=True) is, so its grams take the
        plain path. Test points go through in chunks of PREDICT_CHUNK // M,
        which bounds the (L, N, chunk, M) derivative; the covariance block of
        two chunks solves the second chunk again. ``y_instead_of_f`` is
        romcomma_tpu's signature: neither package reads it."""
        K_cho, K_inv_Y = self.posterior_factors
        f64 = torch.float64
        raw = {name: value.to(f64) for name, value in self._raw().items()}
        X, xs = self._tensor(self._X, f64), self._tensor(x, f64)
        o, L, M, N = xs.shape[0], self._L, self._M, self._N
        if self.is_covariant:
            c = covariant_constrain(raw)
            lam = torch.broadcast_to(c['lengthscales'], (L, M))

            def derivative(xc):                                            # (L,N,l,c,M)
                KXx = rbf_gram_covariant(X, xc, c['lengthscales'], c['F'])  # (L,N,l,c)
                u = X[None, :, None, None, :] / lam[:, None, None, None, :]
                v = xc[None, None, None, :, :] / lam[None, None, :, None, :]
                return KXx[..., None] * (u - v) / lam[None, None, :, None, :]

            def solve(d):
                return tri_solve(K_cho, d.reshape(L * N, -1)).reshape(d.shape)

            mean_of = 'LNloM, LiN -> olM'
            cross = 'LNlOM, LNlom -> OLolMm'
            var = torch.zeros((o, L, o, L, M, M), dtype=f64, device=X.device)

            def block(I, J):
                return var[I, :, J]

            kxx = rbf_gram_covariant(xs, xs, c['lengthscales'], c['F'])    # (L,o,l,o)
            ddxxkxx = torch.einsum('LM, lM, LOlo -> OLolM', 1 / lam, 1 / lam, kxx)
        else:
            c = variant_constrain(raw)
            lam = torch.broadcast_to(c['lengthscales'], (L, M))

            def derivative(xc):                                            # (L,N,c,M)
                KXx = rbf_gram_variant(X, xc, c['lengthscales'], c['variance'])   # (L,N,c)
                diff = (X[None, :, None, :] - xc[None, None, :, :]) / (lam ** 2)[:, None, None, :]
                return KXx[..., None] * diff

            def solve(d):
                return tri_solve(K_cho, d.reshape(L, N, -1)).reshape(d.shape)

            mean_of = 'lNoM, liN -> olM'
            cross = 'LNOM, LNom -> OoLMm'
            var = torch.zeros((o, o, L, M, M), dtype=f64, device=X.device)

            def block(I, J):
                return var[I, J]

            kxx = rbf_gram_variant(xs, xs, c['lengthscales'], c['variance'])    # (L,o,o)
            ddxxkxx = torch.einsum('LM, LM, LOo -> OoLM', 1 / lam, 1 / lam, kxx)
        chunk = max(1, self.PREDICT_CHUNK // M)
        chunks = [slice(start, start + chunk) for start in range(0, o, chunk)]
        means = []
        with torch.no_grad():
            for i, I in enumerate(chunks):
                d = derivative(xs[I])
                means.append(torch.einsum(mean_of, d, K_inv_Y))
                A_I = solve(d)
                del d
                block(I, I).copy_(-torch.einsum(cross, A_I, A_I))
                for J in chunks[i + 1:]:
                    A_J = solve(derivative(xs[J]))
                    block(I, J).copy_(-torch.einsum(cross, A_I, A_J))
                    block(J, I).copy_(-torch.einsum(cross, A_J, A_I))
            torch.diagonal(var, dim1=-2, dim2=-1).add_(ddxxkxx)
        mean = torch.cat(means).cpu().numpy()
        if self._mean_function is not None and hasattr(self._mean_function, 'gradient'):
            mean = mean + self._mean_function.gradient(
                torch.as_tensor(np.asarray(x), dtype=f64)).numpy()
        return mean, var.cpu().numpy()

    def predict_f(self, x: np.ndarray, full_cov: bool = False,
                  full_output_cov: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Latent prediction p(f*|Y) with the reference's full-covariance
        shape semantics (gpf/models.py:84-111), including the
        ``full_cov => full_output_cov`` rule. Returns (mean (n,L), var):

            full_cov=False, full_output_cov=False -> var (n,L)
            full_cov=False, full_output_cov=True  -> var (n,L,L)
            full_cov=True                         -> var (n,n,L,L)

        A variant model embeds its per-output covariances on the (L,L)
        diagonal."""
        xs = self._tensor(x)
        full = gp.predict_covariant_full if self.is_covariant else gp.predict_variant_full
        with torch.no_grad():
            mean, var = full(self._raw(), self._tensor(self._X), self._tensor(self._Y), xs,
                             full_cov=bool(full_cov), full_output_cov=bool(full_output_cov))
        mean, var = mean.cpu().numpy(), var.cpu().numpy()
        if self._mean_function is not None:
            mean = mean + self._mean_function(xs.cpu()).numpy()
        return mean, var

    @property
    def posterior_factors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K_cho, K_inv_Y) from one float64 Cholesky on the compute device.
        Cached per instance; the cache is invalidated whenever the
        parameters change (calibrate / broadcast)."""
        if self._posterior_cache is None:
            factors = (gp.posterior_factors_covariant if self.is_covariant else
                       gp.posterior_factors_variant)
            with torch.no_grad():
                self._posterior_cache = factors(self._raw(), self._tensor(self._X),
                                                self._tensor(self._Y))
        return self._posterior_cache

    @property
    def K_cho(self) -> torch.Tensor:
        """(L,N,N) variant | (LN,LN) covariant Cholesky of the noisy gram
        (reference gpr/models.py:427-439)."""
        return self.posterior_factors[0]

    @property
    def K_inv_Y(self) -> torch.Tensor:
        """(L,1,N) == ChoSolve(K_cho, Y) (reference gpr/models.py:441-444)."""
        return self.posterior_factors[1]

    def check_K_inv_Y(self, x: np.ndarray) -> np.ndarray:
        """Numerical self-test: the RMS over x of predict(x) - k(x,X) K^-1 Y,
        per output (reference gpr/models.py:446-463). The gram is built in the
        working dtype (through the unit-gram kernel on a float32 CUDA device)
        and contracted against the float64 K^-1 Y."""
        predicted = torch.as_tensor(self.predict(x)[0], device=device())
        kiy = self.K_inv_Y
        xs = self._tensor(x)
        with torch.no_grad():
            if self.is_covariant:
                c = covariant_constrain(self._covariant_raw())
                kern = rbf_gram_covariant(xs, self._tensor(self._X), c['lengthscales'],
                                          c['F'])                                # (L,o,L,N)
                result = torch.einsum('loLN, LiN -> ol', kern.to(kiy.dtype), kiy)
            else:
                c = variant_constrain(self._variant_raw())
                kern = rbf_gram_variant(xs, self._tensor(self._X), c['lengthscales'],
                                        c['variance'])                           # (L,o,N)
                result = torch.einsum('loN, liN -> ol', kern.to(kiy.dtype), kiy)
        if self._mean_function is not None:
            result = result + self._mean_function(xs.cpu()).to(result)
        result = result - predicted
        return torch.sqrt(torch.sum(result * result, dim=0) / result.shape[0]).cpu().numpy()

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

    #: N at/above which variant calibration takes the large-N route,
    #: parallel.distributed.DistributedGP (romcomma_tpu's threshold).
    #: Overridable per model via meta['large_n_threshold'].
    LARGE_N_THRESHOLD: int = 10000

    def _calibration_options(self, **kwargs):
        """Resolve META -> meta.json -> kwargs (reference gpr/models.py:354-357)."""
        meta = self.read_meta() if self._meta_json.exists() else dict(self.META)
        kernel_options = self._kernel.calibrate(**(meta.pop('kernel', {}) | kwargs.pop('kernel', {})))
        likelihood_options = self._likelihood.calibrate(**(meta.pop('likelihood', {}) | kwargs.pop('likelihood', {})))
        meta.update(kwargs)
        meta.pop('result', None)
        return meta, kernel_options, likelihood_options

    def _finish_variant_calibration(self, c, lml, iterations, meta, kernel_options,
                                    likelihood_options,
                                    recompute_lml: bool = False) -> Dict[str, Any]:
        """Write optimized variant parameters and the LML ``lml`` (L,) back
        to the CSV frames + meta.

        With ``recompute_lml`` the persisted log-marginal is evaluated afresh
        from the *written* CSV parameters, so disk state is exactly
        self-consistent: reloading the model and recomputing its LML
        reproduces ``log_marginal.csv``. The large-N route keeps the
        optimizer's own LML, as romcomma_tpu's does."""
        self._posterior_cache = None
        self._kernel.data.replace(variance=c['variance'][None, :],
                                  lengthscales=c['lengthscales'])
        self._likelihood.data.replace(variance=c['noise'][None, :])
        lml = np.asarray(lml, dtype=np.float64)
        if recompute_lml:
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

    def _calibrate_covariant(self, meta, kernel_options, likelihood_options) -> Dict[str, Any]:
        """One covariant descent (romcomma_tpu gpr.py:496-520). romcomma_tpu's
        L*N threshold between its fused on-device descent and its host-paced
        one guards a TPU compiler limit, and on one rank both of the port's
        descents are the same eager scipy loop; the threshold is passed on as
        ``large``, since on several ranks a large descent with the
        lengthscales frozen takes the covariant mesh
        (``gp.calibrate_covariant``). The persisted log-marginal is evaluated
        afresh from the written CSV parameters (see
        _finish_variant_calibration); meta's result also records scipy's
        reason for stopping."""
        mask = covariant_mask(kernel_variance=kernel_options['variance'],
                              kernel_covariance=kernel_options['covariance'],
                              lengthscales=bool(kernel_options['lengthscales']['covariant']),
                              noise_variance=likelihood_options['variance'],
                              noise_covariance=likelihood_options['covariance'])
        X, Y = self._tensor(self._X), self._tensor(self._Y)
        large = self._L * self._N >= int(meta.get('large_n_threshold', self.LARGE_N_THRESHOLD))
        raw_opt, _, iterations, stop = gp.calibrate_covariant(
            self._covariant_raw(), mask, X, Y, maxiter=int(meta.get('maxiter', 5000)),
            gtol=float(meta.get('gtol', 1e-16)), large=large)
        with torch.no_grad():
            c = {name: value.cpu().numpy() for name, value in covariant_constrain(raw_opt).items()}
        self._kernel.data.replace(variance=c['F'], lengthscales=c['lengthscales'])
        self._likelihood.data.replace(variance=c['noise_cov'])
        with torch.no_grad():
            lml = float(gp.lml_covariant(self._covariant_raw(), X, Y))
        self._likelihood.data.replace(log_marginal=np.atleast_2d(lml))
        meta.update({'result': f'Converged in {int(iterations)} L-BFGS iterations, lml={lml} '
                               f'(scipy: {stop})',
                     'kernel': kernel_options, 'likelihood': likelihood_options})
        self.write_meta(meta)
        return meta

    def calibrate(self, method: str = 'L-BFGS-B', **kwargs) -> Dict[str, Any]:
        """Maximize the LML; write optimized parameters back to the
        kernel/likelihood CSV frames (reference gpr/models.py:345-373)."""
        self._posterior_cache = None
        meta, kernel_options, likelihood_options = self._calibration_options(**kwargs)
        if self.is_covariant:
            return self._calibrate_covariant(meta, kernel_options, likelihood_options)
        maxiter, gtol = int(meta.get('maxiter', 5000)), float(meta.get('gtol', 1e-16))
        mask = variant_mask(kernel_variance=kernel_options['variance'],
                            lengthscales=kernel_options['lengthscales']['variant'],
                            noise=likelihood_options['variance'])
        large = self._N >= int(meta.get('large_n_threshold', self.LARGE_N_THRESHOLD))
        if large:
            c, lml, iterations = self._calibrate_variant_large(
                maxiter, gtol, block=int(meta.get('distributed_block', 256)), mask=mask)
        else:
            raw_opt, lml, iterations = gp.calibrate_variant(
                self._variant_raw(), mask, self._tensor(self._X), self._tensor(self._Y),
                maxiter=maxiter, gtol=gtol)
            with torch.no_grad():
                c = {name: value.cpu().numpy()
                     for name, value in variant_constrain(raw_opt).items()}
        return self._finish_variant_calibration(c, lml, iterations, meta, kernel_options,
                                                likelihood_options, recompute_lml=not large)

    def _calibrate_variant_large(self, maxiter: int, gtol: float, block: int = 256,
                                 mask: Optional[Dict[str, float]] = None):
        """The large-N route (romcomma_tpu gpr.py:551-624): per-output or
        joint descents through parallel.distributed.DistributedGP on
        ``make_n_mesh()`` with ``dense_kernels=True``, as romcomma_tpu builds
        it (under a process group of several ranks, the 'cyclic2' engine over
        them, every rank in lockstep; on one device 'cyclic2' from
        ``DistributedGP.CYCLIC2_SINGLE_CHIP_MIN_N`` rows, 'upper' below), from the
        kernel's variance, its lengthscales broadcast to (L, M) and the
        likelihood's variance. The joint descent runs when L > 1 and
        ``fits_multi(L)``. A descent that ends on a non-finite LML in the
        working dtype is rerun on a float64 engine with at most 4 line-search
        steps per iteration; one still non-finite raises FloatingPointError.
        ``mask`` (a variant_mask dict) freezes hyperparameter groups as the
        small route does. Returns (constrained parameters, lml (L,),
        iterations per output)."""
        from romcomma_tpu_torch.parallel.distributed import DistributedGP, make_n_mesh
        mask3 = ((mask['raw_lengthscales'], mask['raw_variance'], mask['raw_noise'])
                 if mask is not None else (1.0, 1.0, 1.0))
        mesh = make_n_mesh()
        dgp = DistributedGP(self._N, mesh, block=block, dense_kernels=True)
        variance = np.asarray(self._kernel.data.variance.np[0], dtype=FLOAT())
        lengthscales = np.broadcast_to(np.asarray(self._kernel.data.lengthscales.np, dtype=FLOAT()),
                                       (self._L, self._M))
        noise = np.asarray(self._likelihood.data.variance.np[0], dtype=FLOAT())
        joint = self._L > 1 and dgp.fits_multi(self._L)
        if joint:
            (ls_b, s2_b, noise_b), lml_b, iterations_b = dgp.calibrate_multi(
                self._X, self._Y, lengthscales, variance, noise, maxiter=maxiter, gtol=gtol,
                mask=mask3)
        dgp64, results = None, []
        for l in range(self._L):
            start = (lengthscales[l], variance[l], noise[l])
            result = (((ls_b[l], s2_b[l], noise_b[l]), lml_b[l], iterations_b) if joint else
                      dgp.calibrate(self._X, self._Y[:, l:l + 1], *start, maxiter=maxiter,
                                    gtol=gtol, mask=mask3))
            if not np.isfinite(float(result[1])):
                # Smooth RBF grams have exponentially decaying spectra: at this
                # N the working dtype's rounding can swamp the small pivots
                # whatever the start. Rerun the whole descent in float64.
                if dgp64 is None:
                    # romcomma_tpu's rescue engine (gpr.py:607): without
                    # dense_kernels, so on one device 'cyclic', whose descent
                    # is the dense direct one up to DENSE_DIRECT_MAX_N rows.
                    dgp64 = DistributedGP(self._N, mesh, block=block, dtype=np.float64)
                result = dgp64.calibrate(
                    self._X.astype(np.float64), self._Y[:, l:l + 1].astype(np.float64), *start,
                    maxiter=maxiter, gtol=gtol, mask=mask3, max_linesearch_steps=4)
            if not np.isfinite(float(result[1])):
                raise FloatingPointError(
                    f'Large-N calibration of output {l} produced a non-finite '
                    f'LML (N={self._N}) even at float64.')
            results.append(result)

        def stacked(i: int) -> np.ndarray:
            return np.stack([r[0][i].detach().to('cpu', torch.float64).numpy() for r in results])

        c = {'lengthscales': stacked(0), 'variance': stacked(1), 'noise': stacked(2)}
        return c, np.array([float(r[1]) for r in results]), [int(r[2]) for r in results]
