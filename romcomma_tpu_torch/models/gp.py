"""Functional multi-output GP core: log marginal likelihood, calibration,
prediction and posterior factors, as plain functions on tensors.

Counterpart of ``romcomma_tpu/models/gp.py``, with its two code paths:

  - variant: L independent ARD-RBF GPs. Where the JAX package vmaps over the
    output axis, the grams and factorizations here carry the L axis as a
    batch dimension, and the L calibrations are independent L-BFGS-B descents
    run one after the other (the reference's per-GP scipy optimizations,
    gpr/models.py:359-361). ``calibrate_variant_folds`` runs the K*L descents
    of K equal-shape folds in lockstep instead, each evaluation of them all
    one batched ``ExactLML`` (romcomma_tpu vmaps its descent over the folds).
  - covariant: one (LN,LN) system with full (L,L) signal and noise
    covariances (reference math: gpf/models.py:73-82, gpf/likelihoods.py:64-67).

Shapes follow the reference conventions, so the GSA layer consumes
``K_cho`` (L,N,N) | (LN,LN) and ``K_inv_Y`` (L,1,N) unchanged
(gpr/models.py:427-444).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from romcomma_tpu_torch.models.params import (CovariantParams, VariantParams,
                                              covariant_constrain, variant_constrain,
                                              variant_select)
from romcomma_tpu_torch.ops import lbfgs
from romcomma_tpu_torch.ops.gram import (rbf_gram, rbf_gram_covariant, rbf_gram_covariant_unit,
                                         rbf_gram_variant)
from romcomma_tpu_torch.ops.linalg import add_diag, cho_solve, cholesky, mvn_logpdf, tri_solve


def _lml_forward(K: torch.Tensor, y: torch.Tensor, N: int):
    """(value, chol, alpha) of one output from its noisy gram K (N, N)."""
    chol = cholesky(K)
    z = tri_solve(chol, y.reshape(N, 1))
    value = (-0.5 * torch.sum(z * z) - torch.sum(torch.log(torch.diagonal(chol)))
             - 0.5 * N * math.log(2.0 * math.pi))
    value = torch.where(torch.isfinite(value), value, -torch.inf)
    return value, chol, tri_solve(chol, z, trans=True)


def _lml_backward(ls, s2, noise, x, K, chol, alpha):
    """(dls, ds2, dnoise) of one output's LML: ExactLML's analytic backward."""
    W = torch.cholesky_inverse(chol).neg_().addr_(alpha[:, 0], alpha[:, 0])   # 2 Bbar
    W_diagonal = W.diagonal().clone()
    dnoise = 0.5 * torch.sum(W_diagonal)
    W.mul_(K).diagonal().sub_(noise * W_diagonal)                            # 2 Bbar * Knn
    ds2 = 0.5 * torch.sum(W) / s2
    xx = x * x
    term = xx.T @ torch.sum(W, dim=1) + xx.T @ torch.sum(W, dim=0) - 2.0 * torch.sum(
        x * (W @ x), dim=0)
    dls = (0.5 * term / torch.broadcast_to(ls, (x.shape[1],)) ** 3).sum_to_size(ls.shape)
    return dls, ds2.reshape(s2.shape), dnoise.reshape(noise.shape)


class ExactLML(torch.autograd.Function):
    """lml(ls, s2, noise) of one output's ARD-RBF GP, or of each of a batch of
    independent ones, with the analytic backward of romcomma_tpu's
    ``DistributedGP._build_lml`` custom VJP:

        dLML/dK = Bbar = (alpha alpha^T - K^-1) / 2,
        dLML/ds2 = sum(Bbar * Knn) / s2,    dLML/dnoise = tr(Bbar),
        dLML/dls_m = sum_ab (Bbar * Knn)_ab (x_am - x_bm)^2 / ls_m^3,

    with Knn the signal gram, the last from row and column sums and one
    (N, N) @ (N, M) product, so no (N, N, M) tensor is built. The backward
    forms K^-1 with ``cholesky_inverse`` and holds three (N, N) buffers per
    output: the noisy gram, its factor and K^-1. Both variant routes evaluate
    their LML here: ``lml_single`` (the small route), ``DistributedGP.lml``
    (the large route) and ``calibrate_variant_folds`` (a fold group).

    Forward inputs, one GP: ls (M,) or broadcastable to it, s2 and noise
    scalars, x (N, M), y (N,) or (N, 1). A batch of B: ls (B, M) or (B, 1), s2
    and noise (B,), x (B, N, M), y (B, N); the value is (B,). All of one
    dtype on one device. A batch's gram is one launch of the unit-gram kernel
    (a float32 CUDA build); each member is then factorized and differentiated
    on its own, as one GP is: torch's batched Cholesky and inverse (MAGMA)
    are slower on the card at these orders than one matrix at a time (PERF.md,
    PR 8), and each member's arithmetic is the single GP's: a member whose x
    has the layout the GP's own x has rounds as it does alone, so a descent
    takes the same steps alone and in a batch. The value is -inf where the
    factorization breaks down, member by member, so a minimizer of -lml backs
    off, as romcomma_tpu's does; the other members stay finite."""

    @staticmethod
    def forward(ctx, ls, s2, noise, x, y):
        ctx.batched = x.dim() == 3
        N = x.shape[-2]
        if not ctx.batched:
            K = rbf_gram(x, x, ls, s2)
            K.diagonal().add_(noise)
            value, chol, alpha = _lml_forward(K, y, N)
            ctx.save_for_backward(ls, s2, noise, x, K, chol, alpha)
            return value
        K = rbf_gram_variant(x, x, torch.broadcast_to(ls, (x.shape[0], x.shape[2])), s2)
        K.diagonal(dim1=-2, dim2=-1).add_(noise[:, None])
        values, chols, alphas = zip(*(_lml_forward(K[b], y[b], N) for b in range(x.shape[0])))
        ctx.save_for_backward(ls, s2, noise, x, K, *chols, *alphas)
        return torch.stack(values)

    @staticmethod
    def backward(ctx, gbar):
        ls, s2, noise, x, K, *factors = ctx.saved_tensors
        if not ctx.batched:
            return (*(gbar * g for g in _lml_backward(ls, s2, noise, x, K, *factors)),
                    None, None)
        B = x.shape[0]
        grads = [_lml_backward(ls[b], s2[b], noise[b], x[b], K[b], factors[b], factors[B + b])
                 for b in range(B)]
        return (*(gbar.reshape((B,) + (1,) * (g[0].dim())) * torch.stack(g)
                  for g in zip(*grads)), None, None)


def lml_single(raw: VariantParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """LML of ONE output's GP through ExactLML. raw leaves are unbatched:
    raw_variance scalar, raw_lengthscales (M,) or (1,), raw_noise scalar.
    y: (N,). -inf where the factorization breaks down."""
    c = variant_constrain(raw)
    return ExactLML.apply(c['lengthscales'], c['variance'], c['noise'], x, y)


def lml_variant(raw: VariantParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-output LML vector (L,). raw batched over L; y: (N,L)."""
    return torch.stack([lml_single(variant_select(raw, l), x, y[:, l])
                        for l in range(y.shape[1])])


def _merge(p: Dict[str, torch.Tensor], frozen: Dict[str, torch.Tensor],
           mask: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """eff = frozen + mask * (p - frozen): frozen leaves never move."""
    return {name: frozen[name] + mask[name] * (p[name] - frozen[name]) for name in p}


def calibrate_variant(raw: VariantParams, mask: Dict[str, float], x: torch.Tensor,
                      y: torch.Tensor, maxiter: int = 5000, gtol: float = 1e-16,
                      ftol: float = lbfgs.SCIPY_FTOL
                      ) -> Tuple[VariantParams, torch.Tensor, torch.Tensor]:
    """L independent L-BFGS-B maximizations of the per-output LML.

    mask values are 0/1 floats switching trainability per the reference META
    system. x/y are cast to the params' working dtype, which sets the compute
    precision (float32 fast path or float64 verification). Returns
    (raw_opt (batched over L), lml (L,), iterations (L,))."""
    wd = raw['raw_variance'].dtype
    x, y = x.to(wd), y.to(wd)
    results = []
    for l in range(y.shape[1]):
        frozen = {name: value.detach() for name, value in variant_select(raw, l).items()}
        y_l = y[:, l]

        def objective(p: VariantParams) -> torch.Tensor:
            value = -lml_single(_merge(p, frozen, mask), x, y_l)
            # +inf (not NaN) on factorization breakdown; lbfgs.minimize then
            # reports it to scipy as a large value so the line search backs off.
            return torch.where(torch.isfinite(value), value, torch.inf)

        res = lbfgs.minimize(objective, frozen, maxiter=maxiter, gtol=gtol, ftol=ftol)
        results.append((_merge(res.params, frozen, mask), -res.value, res.iterations))
    raw_opt = {name: torch.stack([eff[name] for eff, _, _ in results]) for name in raw}
    lml = torch.tensor([value for _, value, _ in results], dtype=torch.float64)
    iterations = torch.tensor([its for _, _, its in results])
    return raw_opt, lml, iterations


def calibrate_variant_folds(raws: VariantParams, mask: Dict[str, float], xs: torch.Tensor,
                            ys: torch.Tensor, maxiter: int = 5000, gtol: float = 1e-16,
                            ftol: float = lbfgs.SCIPY_FTOL
                            ) -> Tuple[VariantParams, torch.Tensor, torch.Tensor, List[List[str]]]:
    """K equal-shape folds calibrated together: the K*L descents that
    ``calibrate_variant`` makes fold by fold, in lockstep
    (``lbfgs.minimize_lockstep``), each evaluation of the live ones ONE
    batched ``ExactLML``, whose gram is one kernel launch (romcomma_tpu vmaps
    the same descents, ``gp.py:106-118``). raws leaves stacked on a leading
    fold axis, (K, L[, M]); xs (K,N,M); ys (K,N,L). Returns (raw_opt (K,L,...),
    lml (K,L), iterations (K,L), scipy's stop reasons [K][L])."""
    wd = raws['raw_variance'].dtype
    xs, ys = xs.to(wd), ys.to(wd)
    K, L = ys.shape[0], ys.shape[2]
    frozen = {name: value.detach().flatten(0, 1) for name, value in raws.items()}   # (K*L, ...)
    outputs = torch.movedim(ys, 2, 1).flatten(0, 1)                                 # (K*L, N)
    starts = [{name: value[i] for name, value in frozen.items()} for i in range(K * L)]

    def objective(members: List[int], p: VariantParams) -> torch.Tensor:
        # The parameters are constrained member by member: a CPU elementwise
        # kernel may round the tail of a longer tensor otherwise than a
        # member's own, and the descents are held to the sequential loop's.
        c = [variant_constrain(_merge({name: value[r] for name, value in p.items()}, starts[i],
                                      mask)) for r, i in enumerate(members)]
        c = {name: torch.stack([c_r[name] for c_r in c]) for name in c[0]}
        index = torch.tensor(members, device=xs.device)
        value = -ExactLML.apply(c['lengthscales'], c['variance'], c['noise'],
                                xs[index // L], outputs[index])
        return torch.where(torch.isfinite(value), value, torch.inf)

    results = lbfgs.minimize_lockstep(objective, starts, maxiter=maxiter, gtol=gtol, ftol=ftol)
    raw_opt = {name: torch.stack([_merge(res.params, start, mask)[name]
                                  for res, start in zip(results, starts)]).unflatten(0, (K, L))
               for name in raws}
    lml = torch.tensor([-res.value for res in results], dtype=torch.float64).reshape(K, L)
    iterations = torch.tensor([res.iterations for res in results]).reshape(K, L)
    stops = [[results[k * L + l].message for l in range(L)] for k in range(K)]
    return raw_opt, lml, iterations, stops


def predict_variant(raw: VariantParams, x: torch.Tensor, y: torch.Tensor, xs: torch.Tensor,
                    y_instead_of_f: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean/variance at xs. Returns (mean (o,L), var (o,L))."""
    c = variant_constrain(raw)
    K = rbf_gram_variant(x, x, c['lengthscales'], c['variance'])        # (L,N,N)
    chol = cholesky(add_diag(K, c['noise'][:, None]))
    Ks = rbf_gram_variant(x, xs, c['lengthscales'], c['variance'])      # (L,N,o)
    A = tri_solve(chol, Ks)                                             # (L,N,o)
    alpha = tri_solve(chol, y.T[..., None])                             # (L,N,1)
    mean = torch.einsum('lno,lni->ol', A, alpha)
    # Clamp at zero against f32 cancellation (predictive var is >= 0 exactly).
    var_f = torch.clamp(c['variance'][None, :] - torch.einsum('lno,lno->ol', A, A), min=0.0)
    var = var_f + c['noise'][None, :] if y_instead_of_f else var_f
    return mean, var


def predict_variant_from_factors(raw: VariantParams, K_cho: torch.Tensor,
                                 K_inv_Y: torch.Tensor, x: torch.Tensor, xs: torch.Tensor,
                                 y_instead_of_f: bool = True
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean/variance at xs reusing a cached factorization: only
    O(N o) work per call. The variance solve runs in the working dtype."""
    c = variant_constrain(raw)
    Ks = rbf_gram_variant(x, xs, c['lengthscales'], c['variance'])      # (L,N,o)
    mean = torch.einsum('lno,lin->ol', Ks.to(K_inv_Y.dtype), K_inv_Y)
    A = tri_solve(K_cho.to(Ks.dtype), Ks)                               # (L,N,o)
    var_f = torch.clamp(c['variance'][None, :] - torch.einsum('lno,lno->ol', A, A), min=0.0)
    var = var_f + c['noise'][None, :] if y_instead_of_f else var_f
    return mean, var.to(mean.dtype)


def predict_variant_full(raw: VariantParams, x: torch.Tensor, y: torch.Tensor,
                         xs: torch.Tensor, full_cov: bool = False,
                         full_output_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent prediction p(f*|Y) with the reference's full-covariance shape
    contract (gpf/models.py:84-111): the L independent GPs have zero
    cross-output covariance, so the (L,L) blocks are diagonal embeddings of
    the per-output posterior covariances. Returns (mean (n,L), var) with var
    (n,L); (n,L,L) if full_output_cov; (n,n,L,L) if full_cov."""
    full_output_cov = True if full_cov else full_output_cov
    c = variant_constrain(raw)
    L = y.shape[1]
    K = rbf_gram_variant(x, x, c['lengthscales'], c['variance'])
    chol = cholesky(add_diag(K, c['noise'][:, None]))
    Ks = rbf_gram_variant(x, xs, c['lengthscales'], c['variance'])      # (L,N,n)
    A = tri_solve(chol, Ks)
    alpha = tri_solve(chol, y.T[..., None])                             # (L,N,1)
    mean = torch.einsum('lno,lni->ol', A, alpha)                        # (n,L)
    Knn = rbf_gram_variant(xs, xs, c['lengthscales'], c['variance'])    # (L,n,n)
    f_var = Knn - torch.einsum('lna,lnb->lab', A, A)                    # (L,n,n)
    eye_L = torch.eye(L, dtype=x.dtype, device=x.device)
    if full_cov:
        return mean, torch.einsum('lab,lj->abjl', f_var, eye_L)
    diag = torch.diagonal(f_var, dim1=-2, dim2=-1)                      # (L,n)
    if full_output_cov:
        return mean, torch.einsum('ln,lj->njl', diag, eye_L)            # (n,L,L)
    return mean, diag.T                                                 # (n,L)


def posterior_factors_variant(raw: VariantParams, x: torch.Tensor, y: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K_cho (L,N,N), K_inv_Y (L,1,N)): the GSA inputs (gpr/models.py:427-444).

    ALWAYS computed and returned in float64, on the device of x: a float32
    Cholesky breaks down once cond(K) ~ N s2 / noise crosses 1/eps_f32, and
    the GSA contractions downstream cancel catastrophically unless their
    inputs carry float64 precision."""
    c = variant_constrain({name: value.to(torch.float64) for name, value in raw.items()})
    x64, y64 = x.to(torch.float64), y.to(torch.float64)
    K = rbf_gram_variant(x64, x64, c['lengthscales'], c['variance'])
    chol = cholesky(add_diag(K, c['noise'][:, None]))
    k_inv_y = cho_solve(chol, y64.T[..., None])                         # (L,N,1)
    return chol, k_inv_y.mT                                             # (L,1,N)


# --------------------------------------------------------------------------- #
# Covariant path: one (LN,LN) system.
# --------------------------------------------------------------------------- #

def _add_noise(K4: torch.Tensor, noise_cov: torch.Tensor) -> torch.Tensor:
    """(LN,LN) noisy gram K + Sigma kron I_N (gpf/likelihoods.py:64-67) from a
    fresh (L,N,L,N) gram K4: Sigma is added in place on the (L,L,N) diagonal
    of the blocks, so neither an (N,N) identity nor an (LN,LN) index is ever
    built."""
    L, N = K4.shape[:2]
    K4.diagonal(dim1=1, dim2=3).add_(noise_cov[:, :, None])
    return K4.reshape(L * N, L * N)


def _assemble(unit4: torch.Tensor, F: torch.Tensor, noise_cov: torch.Tensor) -> torch.Tensor:
    """(LN,LN) noisy gram from the unit gram (L,N,L,N): one product with F."""
    return _add_noise(F[:, None, :, None] * unit4, noise_cov)


def _covariant_noisy_K(c: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(LN,LN) noisy gram of constrained covariant params c at inputs x."""
    return _add_noise(rbf_gram_covariant(x, x, c['lengthscales'], c['F']), c['noise_cov'])


def lml_covariant(raw: CovariantParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """LML of the covariant MOGP. y: (N,L), stacked to (LN,1) output-major
    exactly like the reference (gpf/models.py:130)."""
    chol = cholesky(_covariant_noisy_K(covariant_constrain(raw), x))
    yy = y.T.reshape(-1, 1)
    return torch.sum(mvn_logpdf(yy, torch.zeros_like(yy), chol))


class CovariantUpperLML(torch.autograd.Function):
    """lml(F, noise_cov) of the ls-frozen covariant MOGP over a fixed unit
    gram, with the analytic backward of romcomma_tpu's custom-VJP
    ``covariant_upper_lml``:

        dLML/dF[i,j]  = 1/2 sum(W_blk(i,j) * unit_blk(i,j)),
        dLML/dnz[i,j] = 1/2 tr(W_blk(i,j)),       W = alpha alpha^T - K^-1,

    so the backward neither rebuilds the gram nor differentiates through the
    Cholesky. The gradients are per-entry partials of F and noise_cov as free
    (L,L) matrices; covariant_constrain's SPD parameterization outside
    symmetrizes them through ordinary autograd.

    Forward inputs: F, noise_cov (L,L); unit4 (L,N,L,N), the unit gram; yy
    (LN,1), the outputs stacked output-major. A factorization that breaks
    down gives lml = -inf (through ops.linalg.cholesky's NaN), so a
    minimizer of -lml sees +inf and backs off."""

    @staticmethod
    def forward(ctx, F, noise_cov, unit4, yy):
        chol = cholesky(_assemble(unit4, F, noise_cov))
        z = tri_solve(chol, yy)
        value = (-0.5 * torch.sum(z * z) - torch.sum(torch.log(torch.diagonal(chol)))
                 - 0.5 * yy.shape[0] * math.log(2.0 * math.pi))
        value = torch.where(torch.isfinite(value), value, -torch.inf)
        alpha = tri_solve(chol, z, trans=True)                          # K^-1 yy
        ctx.save_for_backward(chol, alpha, unit4)
        return value

    @staticmethod
    def backward(ctx, gbar):
        chol, alpha, unit4 = ctx.saved_tensors
        L, N = unit4.shape[:2]
        W = torch.cholesky_inverse(chol).neg_().addr_(alpha[:, 0], alpha[:, 0])
        W4 = W.view(L, N, L, N)
        dnoise = 0.5 * W4.diagonal(dim1=1, dim2=3).sum(-1)
        dF = 0.5 * W4.mul_(unit4).sum(dim=(1, 3))
        return gbar * dF, gbar * dnoise, None, None


def covariant_upper_lml(x: torch.Tensor, lengthscales: torch.Tensor, y: torch.Tensor
                        ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """lml(F, noise_cov) of the ls-frozen covariant MOGP at inputs x (N,M),
    outputs y (N,L) and fixed lengthscales (L,M), through CovariantUpperLML:
    romcomma_tpu's ``covariant_upper_lml``. The unit gram is built once, here,
    through the unit-gram kernel on a float32 CUDA device; each call then
    costs one Cholesky forward and one cholesky_inverse backward."""
    with torch.no_grad():
        unit4 = rbf_gram_covariant_unit(x, lengthscales.detach())
    yy = y.T.reshape(-1, 1)
    return lambda F, noise_cov: CovariantUpperLML.apply(F, noise_cov, unit4, yy)


def _covariant_objective(raw: CovariantParams, mask: Dict[str, float], x: torch.Tensor,
                         y: torch.Tensor):
    """Masked negative-LML objective for covariant calibration, and its merge.

    With the lengthscales frozen by the mask (the reference's default
    covariant configuration, gpr/kernels.py:54-57) each evaluation is
    CovariantUpperLML over a unit gram built once, before the descent: the
    reference's K_unit_variance cache (gpf/kernels.py:74-104), so only the
    O((LN)^3) factorization and its analytic backward remain per evaluation.
    With them trainable each evaluation rebuilds the gram, and autograd runs
    through the Cholesky and the unit gram's backward."""
    frozen = {name: value.detach() for name, value in raw.items()}
    ls_frozen = not mask['raw_lengthscales']
    if ls_frozen:
        lml = covariant_upper_lml(x, covariant_constrain(frozen)['lengthscales'], y)

    def merge(p: CovariantParams) -> CovariantParams:
        return _merge(p, frozen, mask)

    def objective(p: CovariantParams) -> torch.Tensor:
        if ls_frozen:
            c = covariant_constrain(merge(p))
            return -lml(c['F'], c['noise_cov'])
        return -lml_covariant(merge(p), x, y)

    return objective, merge


def calibrate_covariant(raw: CovariantParams, mask: Dict[str, float], x: torch.Tensor,
                        y: torch.Tensor, maxiter: int = 5000, gtol: float = 1e-16,
                        ftol: float = lbfgs.SCIPY_FTOL, large: bool = False
                        ) -> Tuple[CovariantParams, float, int, str]:
    """One L-BFGS-B maximization of the covariant LML over _covariant_objective.
    x/y are cast to the params' working dtype. Returns (raw_opt, lml,
    iterations, stop), stop being scipy's reason for stopping.

    ``large`` is romcomma_tpu's choice of its host-paced calibrator
    (``MOGP``: L*N >= meta['large_n_threshold']). Where it holds with the
    lengthscales frozen, under a process group of several ranks, from L*N =
    ``covariant_mesh.COVARIANT_MESH_MIN_LN``, the descent runs over the
    ranks' mesh (``DistributedCovariantGP``, every rank in lockstep), as
    romcomma_tpu's ``calibrate_covariant_host`` takes its covariant mesh.
    Otherwise it runs on this rank's device, on any number of ranks."""
    from romcomma_tpu_torch.base.definitions import group_size
    wd = raw['raw_kernel_chol_diag'].dtype
    x, y = x.to(wd), y.to(wd)
    if large and not mask['raw_lengthscales'] and group_size() > 1:
        from romcomma_tpu_torch.parallel import covariant_mesh
        if x.shape[0] * y.shape[1] >= covariant_mesh.COVARIANT_MESH_MIN_LN:
            mesh_gp = covariant_mesh.DistributedCovariantGP(x.shape[0], y.shape[1], dtype=wd)
            return mesh_gp.calibrate(x, y, raw, mask, maxiter, gtol, ftol)
    objective, merge = _covariant_objective(raw, mask, x, y)
    res = lbfgs.minimize(objective, {name: value.detach() for name, value in raw.items()},
                         maxiter=maxiter, gtol=gtol, ftol=ftol)
    return merge(res.params), -res.value, res.iterations, res.message


def predict_covariant(raw: CovariantParams, x: torch.Tensor, y: torch.Tensor, xs: torch.Tensor,
                      y_instead_of_f: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean/variance at xs for the covariant MOGP: (mean (o,L),
    var (o,L)), the diagonal (over both output and sample) of the full
    predictive covariance (gpf/models.py:84-111 with full_cov =
    full_output_cov = False), in the dtype of the params."""
    K_cho, K_inv_Y = _covariant_factors(raw, x, y)
    return predict_covariant_from_factors(raw, K_cho, K_inv_Y, x, xs, y_instead_of_f)


def predict_covariant_from_factors(raw: CovariantParams, K_cho: torch.Tensor,
                                   K_inv_Y: torch.Tensor, x: torch.Tensor, xs: torch.Tensor,
                                   y_instead_of_f: bool = True
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """predict_covariant reusing a cached factorization (K_cho (LN,LN),
    K_inv_Y (L,1,N)): only O(LN Lo) work per call. The variance solve runs in
    the working dtype."""
    c = covariant_constrain(raw)
    L = c['lengthscales'].shape[0]
    N, o = x.shape[0], xs.shape[0]
    Kmn = rbf_gram_covariant(x, xs, c['lengthscales'], c['F']).reshape(L * N, L * o)
    mean = (Kmn.to(K_inv_Y.dtype).T @ K_inv_Y.reshape(L * N, 1)).reshape(L, o).T
    A = tri_solve(K_cho.to(Kmn.dtype), Kmn)                             # (LN,Lo)
    var_f = torch.clamp((torch.diagonal(c['F'])[:, None] - torch.sum(A * A, dim=0).reshape(L, o)).T,
                        min=0.0)
    var = var_f + torch.diagonal(c['noise_cov'])[None, :] if y_instead_of_f else var_f
    return mean, var.to(mean.dtype)


def predict_covariant_full(raw: CovariantParams, x: torch.Tensor, y: torch.Tensor,
                           xs: torch.Tensor, full_cov: bool = False,
                           full_output_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent prediction p(f*|Y) for the covariant MOGP with the reference's
    predict_f shape contract (gpf/models.py:84-111), including the
    ``full_cov => full_output_cov`` rule. Returns (mean (n,L), var) with var
    (n,L); (n,L,L) if full_output_cov; (n,n,L,L) if full_cov. No noise."""
    full_output_cov = True if full_cov else full_output_cov
    c = covariant_constrain(raw)
    L = c['lengthscales'].shape[0]
    N, n = x.shape[0], xs.shape[0]
    chol = cholesky(_covariant_noisy_K(c, x))
    Kmn = rbf_gram_covariant(x, xs, c['lengthscales'], c['F']).reshape(L * N, L * n)
    A = tri_solve(chol, Kmn)                                            # (LN,Ln)
    alpha = tri_solve(chol, y.T.reshape(-1, 1))                         # (LN,1)
    mean = (A.T @ alpha).reshape(L, n).T                                # (n,L)
    Knn = rbf_gram_covariant(xs, xs, c['lengthscales'], c['F'])         # (L,n,L,n)
    f_var = Knn - (A.T @ A).reshape(L, n, L, n)
    if full_output_cov:
        f_var = torch.permute(f_var, (0, 2, 1, 3))                      # (L,L,n,n)
    else:
        f_var = torch.diagonal(f_var, dim1=0, dim2=2)                   # (n,n,L)
        f_var = torch.permute(f_var, (2, 0, 1))                         # (L,n,n)
    if not full_cov:
        f_var = torch.diagonal(f_var, dim1=-2, dim2=-1)
    return mean, torch.permute(f_var, tuple(reversed(range(f_var.dim()))))


def _covariant_factors(raw: CovariantParams, x: torch.Tensor, y: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K_cho (LN,LN), K_inv_Y (L,1,N)) in the dtype of raw, x and y."""
    L, N = y.shape[1], x.shape[0]
    chol = cholesky(_covariant_noisy_K(covariant_constrain(raw), x))
    return chol, cho_solve(chol, y.T.reshape(-1, 1)).reshape(L, N)[:, None, :]


def posterior_factors_covariant(raw: CovariantParams, x: torch.Tensor, y: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K_cho (LN,LN), K_inv_Y (L,1,N)) per gpr/models.py:427-444, ALWAYS in
    float64 on the device of x, as the variant path's."""
    return _covariant_factors({name: value.to(torch.float64) for name, value in raw.items()},
                              x.to(torch.float64), y.to(torch.float64))
