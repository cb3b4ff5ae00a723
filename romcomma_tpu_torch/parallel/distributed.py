"""Dense single-output GP on one device: the engine of the large-N variant route.

Counterpart of ``romcomma_tpu/parallel/distributed.py::DistributedGP``
(:346-1980) on one device. romcomma_tpu shards every (N, N) object of the exact
GP over a mesh and, on one TPU, runs blocked factorizations, streamed
gradients, a mixed-precision posterior refinement ladder and host-paced
dispatch, each to fit a 16 GB chip and its compiler. On one card with native
float64 and 80 GB, the same results come from cuSOLVER and cuBLAS directly:

  - ``lml``: ``models.gp.ExactLML``, the exact log marginal likelihood with
    the analytic backward of romcomma_tpu's custom VJP, which the small
    route's ``gp.lml_single`` evaluates too. Its gram goes through
    ``ops.gram.rbf_gram``, so a float32 gram on a CUDA device is one launch
    of the hand-written unit-gram kernel, and the backward forms K^-1 once
    (``cholesky_inverse``) instead of differentiating through the Cholesky.
  - ``posterior_alpha``, ``predict``, ``make_psi_solver``: one float64
    Cholesky of the noisy gram, in the original row order. romcomma_tpu's
    factor ladder and iterative refinement repair a float32 factor; a
    float64 factor has nothing left to repair.
  - ``sobol_indices``: per output, one ``ClosedSobol`` (or
    ``ClosedSobolWithError``) calibrator from the float64 posterior, with
    every slice of every kind in one factorized interval pass: romcomma_tpu's
    route on the CPU below ``PSI_SOLVER_MIN_N``.
  - ``calibrate``, ``calibrate_multi``: scipy L-BFGS-B over the eager
    value and gradient, in the working dtype.

Rows stay in their original order with no padding: the stored-order
permutation and block padding of romcomma_tpu (``plan``, ``to_stored``,
``from_stored``) lay rows out across devices, and there is one device here.
A mesh of more than one device is refused by name; romcomma_tpu's arguments
that select its TPU engines and refinement (``dense_kernels``, ``engine``,
``refine``) are not taken.

Hyperparameters enter constrained, as in romcomma_tpu: ls (M,), or (L, M)
for several outputs; s2 and noise scalars, or (L,).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from romcomma_tpu_torch.base.definitions import FLOAT, device as compute_device, pinned_device
from romcomma_tpu_torch.models.gp import ExactLML
from romcomma_tpu_torch.models.params import NOISE_LOWER_BOUND
from romcomma_tpu_torch.ops import lbfgs
from romcomma_tpu_torch.ops.gram import rbf_gram
from romcomma_tpu_torch.ops.linalg import cho_solve, cholesky, tri_solve
from romcomma_tpu_torch.ops.transforms import positive, positive_inverse

#: Why a multi-device engine, or a TPU tier of the GSA, is refused.
MULTI_DEVICE_LATER = ('the multi-device engines of romcomma_tpu (the ring gram, the '
                      'block-cyclic and deferred factorizations: parallel/cyclic_deferred.py, '
                      'covariant_mesh.py, gsa/mesh.py) are not ported to romcomma_tpu_torch; '
                      'DistributedGP runs on one device')
TPU_TIERS = ('select reduced-precision or host-routed tiers of romcomma_tpu on the TPU; '
             'romcomma_tpu_torch computes the GSA in float64 on its device and has none')

#: Every slice of each GSA kind, for M input dims (romcomma_tpu's families).
FAMILIES: Dict[str, Callable[[int], list]] = {
    'first_order': lambda M: [(m, m + 1) for m in range(M)],
    'closed': lambda M: [(0, m + 1) for m in range(M)],
    'total': lambda M: [(m + 1, M) for m in range(M)]}


def _one_device(mesh) -> torch.device:
    """The device of a one-device ``mesh``: None (the compute device), a
    device, or a sequence holding one device."""
    if mesh is None:
        return compute_device()
    if isinstance(mesh, (torch.device, str)):
        return torch.device(mesh)
    devices = list(mesh)
    if len(devices) != 1:
        raise ValueError(f'DistributedGP got a mesh of {len(devices)} devices: '
                         f'{MULTI_DEVICE_LATER}.')
    return torch.device(devices[0])


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


class DistributedGP:
    """Exact single-output ARD-RBF GP on one device: LML (analytic
    backward), calibration, posterior solves and Sobol' indices, with
    romcomma_tpu's ``DistributedGP`` interface."""

    #: Bytes of the joint descent's gradient working set, 3 L (Npad, Npad)
    #: buffers, up to which calibrate_multi batches all outputs; romcomma_tpu's
    #: budget, so both packages take the joint descent at the same N.
    MULTI_MEMORY_BUDGET_BYTES: int = 12 * 2 ** 30

    def __init__(self, N: int, mesh=None, block: int = 256, dtype=None):
        """``dtype``: the working dtype of staged arrays and so of the whole
        engine; None takes FLOAT(). np.float64 forces a float64 engine (the
        large route's rescue relies on it). ``mesh`` is None (the compute
        device), a device, or a sequence of one device. ``block`` only sets
        the padded row count of ``fits_multi``'s rule."""
        self.device = _one_device(mesh)
        self.N, self.block = int(N), int(block)
        self.dtype = _torch_dtype(FLOAT() if dtype is None else dtype)
        self._stage_token = 0
        self._staged = None
        self._alpha_cache = None
        self.last_gsa_timings: Dict[str, float] = {}

    # -- staging ------------------------------------------------------------ #

    def _as_working(self, a) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.detach().to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.array(a), dtype=self.dtype, device=self.device)

    def _device_arrays(self, X, Y) -> Tuple[torch.Tensor, torch.Tensor]:
        x_dev = self._as_working(X)
        if x_dev.shape[0] != self.N:
            raise ValueError(f'DistributedGP of N={self.N} rows got X of shape '
                             f'{tuple(x_dev.shape)}.')
        return x_dev, self._as_working(Y).reshape(self.N, -1)

    def stage(self, X, Y) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host X (N, M) and Y (N,) | (N, L) as tensors on the device, in the
        working dtype and the original row order. Each call takes a new stage
        token, which keys the posterior cache of ``sobol_indices``: a staged
        pair is recognised by identity while this engine holds it."""
        x_dev, y_dev = self._device_arrays(X, Y)
        self._stage_token += 1
        self._staged = (self._stage_token, x_dev, y_dev)
        return x_dev, y_dev

    def _stage_token_of(self, x_dev, y_dev) -> Optional[int]:
        if self._staged is not None and x_dev is self._staged[1] and y_dev is self._staged[2]:
            return self._staged[0]
        return None

    @staticmethod
    def _cast(x_dev: torch.Tensor, *values) -> Tuple[torch.Tensor, ...]:
        """Hyperparameters as tensors of x_dev's dtype on its device; a tensor
        keeps its autograd graph."""
        return tuple(v.to(device=x_dev.device, dtype=x_dev.dtype) if torch.is_tensor(v) else
                     torch.as_tensor(np.array(v, dtype=np.float64), dtype=x_dev.dtype,
                                     device=x_dev.device) for v in values)

    # -- LML ------------------------------------------------------------------ #

    def lml(self, ls, s2, noise, x_dev: torch.Tensor, y_dev: torch.Tensor) -> torch.Tensor:
        """The exact LML of one output (scalar), differentiable in ls, s2 and
        noise, in x_dev's dtype; -inf where the factorization breaks down."""
        ls, s2, noise = self._cast(x_dev, ls, s2, noise)
        return ExactLML.apply(ls, s2, noise, x_dev, y_dev)

    # -- posterior ------------------------------------------------------------ #

    def _factor64(self, ls, s2, noise, x_dev: torch.Tensor) -> torch.Tensor:
        """The float64 Cholesky factor of the noisy gram at x_dev's rows."""
        x64 = x_dev.to(torch.float64)
        ls, s2, noise = self._cast(x64, ls, s2, noise)
        K = rbf_gram(x64, x64, ls.detach(), s2.detach())
        K.diagonal().add_(noise.detach())
        return cholesky(K)

    def posterior_alpha(self, ls, s2, noise, x_dev: torch.Tensor, y_dev: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(alpha = K^-1 y (N, R) for y_dev (N,) | (N, R), its float64
        Cholesky factor (N, N)), both float64 in the original row order.
        romcomma_tpu's ``refine`` rounds repair a float32 or bf16x3 factor
        against float64 residuals; a float64 factor leaves nothing to
        refine, so there is no such argument."""
        with torch.no_grad():
            chol = self._factor64(ls, s2, noise, x_dev)
            return cho_solve(chol, y_dev.reshape(self.N, -1).to(torch.float64)), chol

    def predict(self, ls, s2, noise, x_dev: torch.Tensor, y_dev: torch.Tensor, Xs
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean (o,) and variance max(s2 - |L^-1 Ks|^2, 0) + noise
        (o,) at test points Xs (o, M), float64. Ks is built in the working
        dtype (through the unit-gram kernel for a float32 CUDA engine), the
        rest from the float64 posterior."""
        with torch.no_grad():
            alpha, chol = self.posterior_alpha(ls, s2, noise, x_dev, y_dev)
            ls_w, s2_w = self._cast(x_dev, ls, s2)
            Ks = rbf_gram(x_dev, self._cast(x_dev, Xs)[0], ls_w, s2_w).to(torch.float64)
            s2_64, noise_64 = self._cast(alpha, s2, noise)
            A = tri_solve(chol, Ks)
            return ((Ks.T @ alpha)[:, 0],
                    torch.clamp(s2_64 - torch.sum(A * A, dim=0), min=0.0) + noise_64)

    def make_psi_solver(self, ls, s2, noise, x_dev: torch.Tensor,
                        factor: Optional[torch.Tensor] = None
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
        """A function applying K^-1 along the last axis of a float64
        (..., N) array (numpy or tensor) in the original row order, returning
        a float64 tensor on this engine's device. It reuses ``factor``, the
        float64 factor of this gram (posterior_alpha's second return), when
        one is given."""
        with torch.no_grad():
            chol = self._factor64(ls, s2, noise, x_dev) if factor is None else factor

        def solver(f) -> torch.Tensor:
            f = torch.as_tensor(f, dtype=torch.float64).to(chol.device)
            with torch.no_grad():
                return cho_solve(chol, f.reshape(-1, self.N).T).T.reshape(f.shape)

        return solver

    # -- Sobol' indices -------------------------------------------------------- #

    def sobol_indices(self, ls, s2, noise, x_dev: torch.Tensor, y_dev: torch.Tensor, X,
                      kind='first_order', n_chunk: Optional[int] = None, gsa_dtype=None,
                      error: bool = False, is_T_partial: bool = True,
                      intervals_mixed=None, error_solver: str = 'auto'):
        """Closed-form Sobol' indices of the trained GP (romcomma_tpu's
        ``sobol_indices``), in float64 on this engine's device.

        ``kind``: one of 'first_order', 'closed', 'total' -> {m: S_m}; or a
        tuple of kinds -> {kind: {m: S_m}}, every slice of every kind in one
        factorized pass. 'total' is 1 - S of the complement's slice. With
        ``error`` -> {'S': that structure, 'T': its standard errors, the same
        shape}; ``is_T_partial`` picks the reference's partial or total T.
        ``ls`` (L, M) with s2 and noise (L,) and y_dev (N, L) -> a list, one
        structure per output. ``X`` is the float64 input the calibrator sees
        (the host data). ``n_chunk`` sets the calibrator's chunk.

        romcomma_tpu's TPU tiers are refused: ``gsa_dtype`` other than None or
        float64, ``intervals_mixed`` other than None or False, and
        ``error_solver='device'`` (its float32 psi solver). ``error_solver``
        'auto' and 'host' both take the float64 factor, as romcomma_tpu's host
        route does. Sets ``last_gsa_timings`` (seconds) with romcomma_tpu's
        keys."""
        if gsa_dtype is not None and np.dtype(gsa_dtype) != np.float64:
            raise ValueError(f'sobol_indices gsa_dtype={np.dtype(gsa_dtype).name}: reduced GSA '
                             f'planes {TPU_TIERS}.')
        if intervals_mixed not in (None, False):
            raise ValueError(f'sobol_indices intervals_mixed={intervals_mixed!r}: the exp tiers '
                             f'{TPU_TIERS}.')
        if error_solver not in ('auto', 'host'):
            raise ValueError(f'sobol_indices error_solver={error_solver!r}: the device psi '
                             f'solver and its refinement {TPU_TIERS}.')
        t0 = time.perf_counter()
        ls_arr = ls.detach().cpu().numpy() if torch.is_tensor(ls) else np.asarray(ls)
        args_fetch = time.perf_counter() - t0
        options = dict(kind=kind, n_chunk=n_chunk, error=error, is_T_partial=is_T_partial)
        if ls_arr.ndim == 1:
            return self._sobol_indices_one(ls_arr, s2, noise, x_dev, y_dev, X,
                                           args_fetch=args_fetch, **options)
        outputs = ls_arr.shape[0]
        s2_arr, noise_arr = (np.reshape(v.detach().cpu().numpy() if torch.is_tensor(v) else v,
                                        outputs) for v in (s2, noise))
        results, timings = [], {}
        for l in range(outputs):
            results.append(self._sobol_indices_one(ls_arr[l], s2_arr[l], noise_arr[l], x_dev,
                                                   y_dev[:, l:l + 1], X, args_fetch=args_fetch,
                                                   **options))
            for key in ('posterior_s', 'intervals_s', 'k_cho_s', 'total_s'):
                timings[key] = timings.get(key, 0.0) + self.last_gsa_timings.get(key, 0.0)
        self.last_gsa_timings = ({k: timings[k] for k in ('posterior_s', 'intervals_s')}
                                 | {'args_fetch_s': args_fetch, 'outputs': outputs}
                                 | ({'k_cho_s': timings['k_cho_s'], 'total_s': timings['total_s']}
                                    if error else {}))
        return results

    def _sobol_indices_one(self, ls: np.ndarray, s2, noise, x_dev: torch.Tensor,
                           y_dev: torch.Tensor, X, kind, n_chunk, error: bool,
                           is_T_partial: bool, args_fetch: float):
        """One output's indices (see sobol_indices). Without ``error`` the
        posterior alpha is cached per stage token and hyperparameters, so
        repeated analytics of one trained model on one staged pair solve once."""
        t_start = time.perf_counter()
        from romcomma_tpu_torch.gsa.calibrators import (ClosedSobol, ClosedSobolWithError,
                                                        _synchronize)
        t_import = time.perf_counter() - t_start
        kinds = (kind,) if isinstance(kind, str) else tuple(kind)
        s2, noise = (float(v) for v in (s2, noise))
        t0 = time.perf_counter()
        token = self._stage_token_of(x_dev, y_dev)
        key = (ls.tobytes(), s2, noise, token)
        if not error and token is not None and self._alpha_cache is not None \
                and self._alpha_cache[0] == key:
            alpha = self._alpha_cache[1]
        else:
            alpha, chol = self.posterior_alpha(ls, s2, noise, x_dev, y_dev)
            if not error:
                del chol
                self._alpha_cache = (key, alpha) if token is not None else None
        _synchronize(alpha)
        t_posterior = time.perf_counter() - t0
        N, M = self.N, ls.shape[-1]
        meta = {} if n_chunk is None else {'n_chunk': n_chunk}
        t0 = time.perf_counter()
        if error:
            K_cho = chol[None]
            meta['is_T_partial'] = bool(is_T_partial)
        else:
            K_cho = torch.zeros((1, 1, 1), dtype=torch.float64, device=self.device)
        t_kcho = time.perf_counter() - t0
        t0 = time.perf_counter()
        with pinned_device(self.device):
            cal = (ClosedSobolWithError if error else ClosedSobol).from_arrays(
                F=np.asarray([[s2]]), K_cho=K_cho, K_inv_Y=alpha.T.reshape(1, 1, N),
                Lambda=ls[None, :], X=X, is_F_diagonal=True, L=1, M=M, N=N, **meta)
            _synchronize(cal.V[0])
            t_setup = time.perf_counter() - t0
            t0 = time.perf_counter()
            flat = [(0, M)] + [s for k in kinds for s in FAMILIES[k](M)]
            out = cal.marginalize_intervals(tuple(flat))
            V_all = out['V'][0, 0].cpu().numpy()
        t_intervals = time.perf_counter() - t0
        sweep = getattr(cal, 'last_interval_timings', None) or {
            f'v_{k}': v for k, v in cal.last_v_sweep_timings.items()}
        self.last_gsa_timings = {'posterior_s': t_posterior, 'setup_s': t_setup,
                                 'intervals_s': t_intervals, 'import_s': t_import,
                                 'args_fetch_s': args_fetch,
                                 'total_s': time.perf_counter() - t_start}
        self.last_gsa_timings.update({f'iv_{k}': v for k, v in sweep.items()})
        S_out = self._kinds_from_V(V_all, kinds, M, kind)
        if not error:
            return S_out
        self.last_gsa_timings['k_cho_s'] = t_kcho
        t0 = time.perf_counter()
        T_all = out['T'][0, 0][1:].cpu().numpy()
        self.last_gsa_timings['t_assembly_s'] = time.perf_counter() - t0
        T_by_kind = {k: {m: float(T_all[i * M + m]) for m in range(M)}
                     for i, k in enumerate(kinds)}
        return {'S': S_out, 'T': T_by_kind[kind] if isinstance(kind, str) else T_by_kind}

    @staticmethod
    def _kinds_from_V(V_col: np.ndarray, kinds: tuple, M: int, kind):
        """{kind: {m: S}} from one output's V column [V0, kinds[0] slices (M),
        kinds[1] slices (M), ...]; 'total' applies the reference's S_M minus
        S of the complement (romcomma_tpu's ``_kinds_from_V``)."""
        S_all = V_col[1:] / float(V_col[0])
        by_kind = {k: {m: (1.0 - float(v) if k == 'total' else float(v))
                       for m, v in enumerate(S_all[i * M:(i + 1) * M])}
                   for i, k in enumerate(kinds)}
        return by_kind[kind] if isinstance(kind, str) else by_kind

    # -- calibration ----------------------------------------------------------- #

    def _raw0(self, x_dev, ls0, s2_0, noise0, outputs: Optional[int] = None
              ) -> Dict[str, torch.Tensor]:
        """Raw (unconstrained) starting parameters in the working dtype; with
        ``outputs``, ls0 broadcast to (L, M) and s2_0, noise0 to (L,)."""
        ls0, s2_0, noise0 = self._cast(x_dev, ls0, s2_0, noise0)
        if outputs is not None:
            ls0 = torch.broadcast_to(ls0, (outputs, x_dev.shape[1]))
            s2_0, noise0 = s2_0.reshape(outputs), noise0.reshape(outputs)
        return {'ls': positive_inverse(ls0, 0.0), 's2': positive_inverse(s2_0, 0.0),
                'noise': positive_inverse(noise0, NOISE_LOWER_BOUND)}

    @staticmethod
    def _merge(raw0: Dict[str, torch.Tensor], mask: Sequence[float]):
        """The mask (ls, s2, noise) of 0/1 floats as romcomma_tpu merges it:
        frozen groups stay at raw0 through fv + m (rv - fv); all ones is the
        identity."""
        weights = dict(zip(('ls', 's2', 'noise'), (float(m) for m in mask)))
        if all(w == 1.0 for w in weights.values()):
            return lambda raw: raw
        return lambda raw: {name: raw0[name] + weights[name] * (raw[name] - raw0[name])
                            for name in raw}

    @staticmethod
    def _constrain(raw: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return (positive(raw['ls'], 0.0), positive(raw['s2'], 0.0),
                positive(raw['noise'], NOISE_LOWER_BOUND))

    def calibrate(self, X, Y, ls0, s2_0, noise0, maxiter: int = 5000, gtol: float = 1e-16,
                  max_linesearch_steps: Optional[int] = None,
                  mask: tuple = (1.0, 1.0, 1.0)):
        """L-BFGS-B maximization of one output's LML (Y (N,) or (N, 1)): one
        scipy descent over the eager value and gradient, romcomma_tpu's
        single-device production branch. ``mask`` = (lengthscales, signal
        variance, noise) trainability as 0/1 floats. Returns ((ls, s2, noise),
        lml, iterations), lml being the optimizer's own final value (-inf
        where the factorization breaks down there)."""
        x_dev, y_dev = self._device_arrays(X, Y)
        raw0 = self._raw0(x_dev, ls0, s2_0, noise0)
        merge = self._merge(raw0, mask)

        def objective(raw):
            return -self.lml(*self._constrain(merge(raw)), x_dev, y_dev[:, :1])

        res = lbfgs.minimize(objective, raw0, maxiter=maxiter, gtol=gtol,
                             max_linesearch_steps=max_linesearch_steps)
        with torch.no_grad():
            return self._constrain(merge(res.params)), -res.value, res.iterations

    def fits_multi(self, L: int) -> bool:
        """Whether romcomma_tpu's joint L-output descent fits its memory rule,
        3 L Npad^2 itemsize <= MULTI_MEMORY_BUDGET_BYTES, Npad being N padded
        to a multiple of ``block`` as romcomma_tpu pads it."""
        padded = -(-self.N // self.block) * self.block
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return 3 * L * padded ** 2 * itemsize <= self.MULTI_MEMORY_BUDGET_BYTES

    def calibrate_multi(self, X, Y, ls0, s2_0, noise0, maxiter: int = 5000,
                        gtol: float = 1e-16, max_linesearch_steps: Optional[int] = None,
                        mask: tuple = (1.0, 1.0, 1.0)):
        """One joint L-BFGS-B descent of L independent outputs sharing X: the
        objective is the sum of the per-output LMLs, evaluated one output
        after another. romcomma_tpu runs this descent with optax's L-BFGS; the
        port runs scipy's, as its small route does. ``ls0`` (L, M) or (M,),
        ``s2_0`` and ``noise0`` (L,), ``Y`` (N, L). Returns ((ls (L, M),
        s2 (L,), noise (L,)), lml (L,), iterations), the LMLs evaluated afresh
        at the optimum."""
        x_dev, y_dev = self._device_arrays(X, Y)
        outputs = y_dev.shape[1]
        raw0 = self._raw0(x_dev, ls0, s2_0, noise0, outputs)
        merge = self._merge(raw0, mask)

        def lmls(raw) -> torch.Tensor:
            ls, s2, noise = self._constrain(merge(raw))
            return torch.stack([self.lml(ls[l], s2[l], noise[l], x_dev, y_dev[:, l])
                                for l in range(outputs)])

        res = lbfgs.minimize(lambda raw: -torch.sum(lmls(raw)), raw0, maxiter=maxiter,
                             gtol=gtol, max_linesearch_steps=max_linesearch_steps)
        with torch.no_grad():
            return self._constrain(merge(res.params)), lmls(res.params), res.iterations
