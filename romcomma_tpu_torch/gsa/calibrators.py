"""Closed-form Sobol' index calibrators.

Counterpart of ``romcomma_tpu/gsa/calibrators.py`` and of the reference's
``romcomma/gsa/calibrators.py``: the conditional-variance integrals of the GP
posterior evaluate to products and ratios of Gaussian pdfs contracted through
einsum chains.

Math summary (diagonal signal variance F, the supported error path):
  g0[l,n]   = F_l * prod_m (lam2_l+1)^-1/2 * exp(-x_n^2/(2(lam2_l+1))): the
              kernel expectation E_z k_l(z, x_n) under z ~ N(0, I)
  g0KY      = g0 * K^-1 Y, centred
  G, Phi    = (lam2_l+1)^-1 x_n, (lam2_l+1)^-1
  V_m       = g0KY . H_m . g0KY  with H_m a ratio of Gaussians over the
              slice [m0:m1] of input axes              (reference _V)
  S_m       = V_m / V_M
with first-order/closed/total selected by the slice (gsa/models.py).

Everything runs in float64 on ``definitions.device()``, whatever the training
dtype: the quadforms cancel N^2 large alternating terms. The JAX package's
TPU devices (emulated-float64 tiers, routing to the host CPU below an N,
host-paced dispatch, a retry on the CPU) have no counterpart here, and the
meta keys that selected them are refused (``TPU_ONLY_META``).
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from romcomma_tpu_torch.base import tracing
from romcomma_tpu_torch.base.definitions import device
from romcomma_tpu_torch.gsa import sweep_kernel
from romcomma_tpu_torch.gsa.base import (Calibrator, Gaussian, diag_det, mean, rms, sos,
                                         sym_check)
from romcomma_tpu_torch.ops.linalg import tri_solve

#: meta keys of the JAX package's TPU tiers and routes; none has a meaning on
#: the card, and each is refused by name rather than dropped.
TPU_ONLY_META = ('intervals_mixed', 'intervals_acc_f64', 'fast_V', 'defer_V', 'host_paced',
                 'gsa_on_cpu', 'pack_device', 'psi_solver', 'psi_solver_factory')

#: romcomma_tpu cannot compute standard errors of a covariant model either: its
#: error sweep solves the psi factors, N rows per output, against the (LN, LN)
#: covariant K_cho and raises there (romcomma_tpu/gsa/factorized_errors.py:693-703,
#: ``_psi_solve``: "Incompatible shapes for arguments to triangular_solve"); the
#: port's _psi_solve would fail the same way, so it is refused before any work.
COVARIANT_ERRORS_UNSUPPORTED = (
    'standard errors (is_error_calculated=True) of a covariant MOGP are not computed: '
    'romcomma_tpu cannot compute them either, since its error sweep solves the N-row psi '
    'factors against the (LN, LN) covariant K_cho and fails there '
    '(romcomma_tpu/gsa/factorized_errors.py:693-703, _psi_solve). Run the covariant GSA '
    'with is_error_calculated=False.')


def _f64(a) -> torch.Tensor:
    """a as a float64 tensor on the compute device."""
    if torch.is_tensor(a):
        return a.to(device=device(), dtype=torch.float64)
    return torch.tensor(np.asarray(a), dtype=torch.float64, device=device())


def _set_diag(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    torch.diagonal(x, dim1=-2, dim2=-1).copy_(d)
    return x


def _diag_part(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1)


def _synchronize(t: torch.Tensor):
    """Wait for the card, so a host clock read next times the work."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class ClosedSobol(Calibrator):
    """Closed Sobol' indices from a trained GP posterior
    (reference calibrators.py:31-143)."""

    META: Dict[str, Any] = {}

    def __init__(self, gp, **kwargs: Any):
        meta = dict(self.META) | kwargs
        is_F_diagonal = meta.pop('is_F_diagonal', None)
        if is_F_diagonal is None:
            is_F_diagonal = _is_F_diagonal(gp)
        arrays = self.gather_arrays(gp)
        self._setup(is_F_diagonal=is_F_diagonal, L=gp.L, M=gp.M, N=gp.N, meta=meta, **arrays)

    @staticmethod
    def gather_arrays(gp, need_K_cho: bool = True) -> Dict[str, torch.Tensor]:
        """The calibrator's inputs, all float64 on the compute device, whatever
        the training dtype (ROMCOMMA_X64=0 trains in float32; the posterior
        factors are float64 either way).

        ``need_K_cho=False`` (the plain no-error calibrator): the factor is
        consumed only by the error path's psi solves, and its copy is the one
        O(N^2) array of the gather. A (1,1,1) placeholder keeps the no-error
        pass O(N M)-sized."""
        K_cho, K_inv_Y = gp.posterior_factors
        return {'F': _f64(gp.kernel.data.variance.np),
                'K_cho': _f64(K_cho) if need_K_cho else torch.zeros(
                    (1, 1, 1), dtype=torch.float64, device=device()),
                'K_inv_Y': _f64(K_inv_Y),
                'Lambda': _f64(gp.kernel.data.lengthscales.np),
                'X': _f64(gp.X)}

    @classmethod
    def from_arrays(cls, F, K_cho, K_inv_Y, Lambda, X, *, is_F_diagonal: bool,
                    L: int, M: int, N: int, **meta) -> 'ClosedSobol':
        """Construct (and pre-calibrate) from raw arrays (numpy or torch),
        which move to the compute device as float64."""
        self = cls.__new__(cls)
        meta = dict(cls.META) | meta
        meta.pop('is_F_diagonal', None)
        self._setup(F=F, K_cho=K_cho, K_inv_Y=K_inv_Y, Lambda=Lambda, X=X,
                    is_F_diagonal=is_F_diagonal, L=L, M=M, N=N, meta=meta)
        return self

    def _setup(self, F, K_cho, K_inv_Y, Lambda, X, is_F_diagonal: bool,
               L: int, M: int, N: int, meta: Dict[str, Any]):
        refused = [key for key in TPU_ONLY_META if key in meta]
        if refused:
            raise ValueError(f'GSA meta {refused} select TPU tiers or routes of romcomma_tpu; '
                             'romcomma_tpu_torch computes in float64 on its device and has none.')
        F, K_cho, K_inv_Y, Lambda, X = (_f64(a) for a in (F, K_cho, K_inv_Y, Lambda, X))
        self.meta = meta
        self.L, self.M, self.N = L, M, N
        self.Ms = (0, self.M)
        self.F, self.K_cho, self.K_inv_Y = F, K_cho, K_inv_Y
        self.is_F_diagonal = is_F_diagonal
        if self.is_F_diagonal:
            self.F = self.F if self.F.shape[0] == 1 else _diag_part(self.F)
            self.F = self.F.reshape(self.L, 1)
        else:
            self.K_inv_Y = torch.permute(self.K_inv_Y, (1, 0, 2))
        self.Lambda = torch.broadcast_to(Lambda, (self.L, self.M))
        self.Lambda2 = self._Lambda2()
        self.X = X
        self._calibrate()

    def _Lambda2(self) -> Dict[int, Tuple[torch.Tensor, ...]]:
        """Powers of <Lambda^2 + J> for J in {0,1,2} (calibrators.py:99-109)."""
        if self.is_F_diagonal:
            result = torch.einsum('lM, lM -> lM', self.Lambda, self.Lambda)[:, None, :]
        else:
            result = torch.einsum('lM, LM -> lLM', self.Lambda, self.Lambda)
        result = tuple(result + j for j in range(3))
        return {1: result, -1: tuple(value ** (-1) for value in result)}

    def _V(self, G: torch.Tensor, Phi: torch.Tensor) -> torch.Tensor:
        """Conditional variance (L,L) for the current marginalization slice
        (reference calibrators.py:60-80), over the jJn axis in chunks when
        the O(L^4 N^2) H tensor would exceed the memory budget."""
        return self._V_chunked(G, Phi, self._auto_n_chunk() or G.shape[2])

    #: bytes of H-tensor buffer above which _V switches to chunked evaluation.
    V_MEMORY_BUDGET_BYTES: int = 2 ** 30

    def _auto_n_chunk(self) -> 'int | None':
        """Chunk size for the jJn axis, or None to evaluate in one piece.
        Settable explicitly via meta['n_chunk']; 0 forces unchunked.

        The budget counts the trailing M axis: evaluated eagerly, the
        Gaussian exponent materializes an O(L^4 N^2 M) difference tensor
        before its M-reduction."""
        explicit = self.meta.get('n_chunk', None)
        if explicit is not None:
            return int(explicit) if explicit else None
        lb = self.g0KY.shape[0] * self.g0KY.shape[1]        # l*L bunch size
        budget = self.V_MEMORY_BUDGET_BYTES // self.X.element_size()
        h_elements = (lb * self.N) ** 2 * (self.M + 1)
        if h_elements <= budget:
            return None
        return max(128, int(budget) // (lb * lb * self.N * (self.M + 1)))

    def _V_chunked(self, G: torch.Tensor, Phi: torch.Tensor, chunk: int) -> torch.Tensor:
        """_V over the jJn axis in chunks of ``chunk``, so peak memory is
        O(L^4 N chunk) instead of O(L^4 N^2)."""
        Gamma = 1 - Phi
        Psi = Gamma[:, :, None, None, :] + Gamma[None, None, ...]
        Psi = Psi - torch.einsum('lLM, jJM -> lLjJM', Gamma, Gamma)
        PsiPhi = torch.einsum('lLjJM, lLM -> lLjJM', Psi, Phi)
        phi_div = Gaussian(mean=G, variance=Phi, is_variance_diagonal=True,
                           LBunch=2).expand_dims([-1, -2, -3])
        ordinate = G[..., None, None, None, :]
        V = torch.zeros((G.shape[0], G.shape[0]), dtype=G.dtype, device=G.device)
        for start in range(0, G.shape[2], chunk):
            G_c = G[:, :, start:start + chunk]
            g_c = self.g0KY[:, :, start:start + chunk]
            PhiG = torch.unsqueeze(torch.einsum('lLM, jJcM -> lLjJcM', Phi, G_c), 2)
            H = Gaussian(mean=PhiG, variance=PsiPhi, ordinate=ordinate,
                         is_variance_diagonal=True, LBunch=2)
            H = H / phi_div
            V = V + torch.einsum('lLN, lLNjJc, jJc -> lj', self.g0KY, H.pdf, g_c)
        return V

    def _calibrate(self):
        """Pre-compute everything independent of the marginalization slice
        (reference calibrators.py:82-97)."""
        pre_factor = torch.sqrt(diag_det(self.Lambda2[1][0] * self.Lambda2[-1][1])) * self.F
        self.g0 = torch.exp(Gaussian(mean=self.X[None, None, ...], variance=self.Lambda2[1][1],
                                     is_variance_diagonal=True, LBunch=2).exponent)
        self.g0 = self.g0 * pre_factor[..., None]
        self.g0KY = self.g0 * self.K_inv_Y
        self.g0KY = self.g0KY - (torch.einsum('lLN -> l', self.g0KY)[..., None, None]
                                 / float(np.prod(self.g0KY.shape[1:])))
        self.G = torch.einsum('lLM, NM -> lLNM', self.Lambda2[-1][1], self.X)
        self.Phi = self.Lambda2[-1][1]
        self.V = {0: self._V(self.G, self.Phi)}
        self.V |= {1: _diag_part(self.V[0])}
        V = torch.sqrt(self.V[1])
        self.V |= {2: torch.einsum('l, i -> li', V, V)}
        self.S = self.V[0] / self.V[2]
        if self.meta.get('debug', False):
            # Opt-in diagnostics (meta['debug']=True): the reference's debug
            # reductions applied to the calibration invariants. V is an (L,L)
            # Gram of conditional variances and must be symmetric; the
            # residual is the asymmetry of the einsum contraction order.
            self.debug = {
                'V_sym': sym_check(self.V[0], (1, 0)),
                'V_sym_relative': sym_check(self.V[0], (1, 0)) / sos(self.V[0]),
                'S_rms': rms(self.S),
                'g0KY_mean': mean(self.g0KY),
                'g0KY_rms': rms(self.g0KY),
            }

    #: padding value for masked dims in width-padded slices: contributes
    #: exponent 0 and cho_diag ratio sqrt(2g-g^2)->1 with g=1-PAD_PHI.
    PAD_PHI: float = 1e-20

    def _padded_slice(self, m: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Slice [m0:m1] of (G, Phi), zero/PAD_PHI-padded back to width M.
        Padded dims are exactly neutral in the Gaussian-ratio algebra: G=0
        gives zero exponent, Phi=PAD_PHI a unit determinant-ratio factor."""
        pad = self.M - (m[1] - m[0])
        G = torch.nn.functional.pad(self.G[..., m[0]:m[1]], (0, pad))
        Phi = torch.nn.functional.pad(self.Phi[..., m[0]:m[1]], (0, pad), value=self.PAD_PHI)
        return G, Phi

    def marginalize(self, m: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        """Sobol' V and S of the slice [m[0]:m[1]] (calibrators.py:49-58)."""
        G, Phi = self._padded_slice(m)
        result = {'V': self._V(G, Phi)}
        result['S'] = result['V'] / self.V[2]
        return result

    # -- factorized all-interval evaluation ----------------------------------- #
    #
    # The Gaussian-ratio pdf of an interval slice has DIAGONAL variance over
    # input dims, so it factorizes exactly per dim m:
    #   pdf_[a:b)(p,q) = prod_{m in [a,b)} exp(e_m(p,q)) / d_m
    #   e_m(p,q) = -(G_pm - Phi_m G_qm)^2/(2 PsiPhi_m) + G_pm^2/(2 Phi_m)
    #   d_m      = sqrt(PsiPhi_m / Phi_m)
    # Exponents are additive over m, so ONE prefix/suffix pass over dims
    # yields every canonical slice family at once: FIRST_ORDER needs e_m,
    # CLOSED needs E_{<=m} (prefix), TOTAL needs E_{>=m} (suffix), at
    # O(N^2 M) for ALL slices of ALL kinds instead of O(N^2 M) per slice.

    @staticmethod
    def _classify_interval(m: Tuple[int, int], M: int) -> Tuple[str, int]:
        a, b = int(m[0]), int(m[1])
        if a == b:
            return ('empty', 0)
        if b == a + 1:
            return ('single', a)
        if a == 0:
            return ('prefix', b)
        if b == M:
            return ('suffix', a)
        return ('general', 0)

    @staticmethod
    def _interval_specs(slices: 'Tuple[Tuple[int, int], ...]', M: int):
        """(specs, need) of the factorized pass, with the FULL (0, M) slice
        served by whichever cumulative sweep already runs: it is both
        families' end state (E_{<=M} == E_{>=0}), so when no PROPER prefix
        (0, b<M) is requested it reclassifies to ('suffix', 0) and the
        forward sweep is skipped."""
        specs = [ClosedSobol._classify_interval(m, M) for m in slices]
        proper_prefix = any(k == 'prefix' and idx < M for k, idx in specs)
        if not proper_prefix:
            specs = [('suffix', 0) if (k == 'prefix' and idx == M) else (k, idx)
                     for k, idx in specs]
        need = {k: any(s[0] == k for s in specs) for k in ('single', 'prefix', 'suffix')}
        return specs, need

    def _intervals_chunk(self) -> int:
        """Column-chunk size for the factorized pass: ~5 live
        (l,L,N,j,J,chunk) planes per step."""
        explicit = self.meta.get('n_chunk', None)
        if explicit is not None:
            # Same convention as _auto_n_chunk: 0 means the whole N as one chunk.
            return int(explicit) if explicit else self.N
        lb = self.g0KY.shape[0] * self.g0KY.shape[1]
        budget = self.V_MEMORY_BUDGET_BYTES // self.X.element_size()
        return int(min(self.N, max(128, budget // (lb * lb * self.N * 5))))

    def _intervals_pack(self) -> Dict[str, torch.Tensor]:
        """The per-dim tensors of the factorized interval pass."""
        g = self.g0KY                                              # (l,L,N)
        Gamma = 1 - self.Phi
        Psi = (Gamma[:, :, None, None, :] + Gamma[None, None, :, :, :]
               - torch.einsum('lLM, jJM -> lLjJM', Gamma, Gamma))
        PsiPhi = torch.einsum('lLjJM, lLM -> lLjJM', Psi, self.Phi)  # (l,L,j,J,M)
        d = torch.sqrt(PsiPhi / self.Phi[:, :, None, None, :])        # per-dim det
        return {'g': g,
                'Gp_m': torch.movedim(self.G, -1, 0),                # (M,l,L,N)
                'Phi_m': torch.movedim(self.Phi, -1, 0),             # (M,l,L)
                'PsiPhi_m': torch.movedim(PsiPhi, -1, 0),            # (M,l,L,j,J)
                'inv_single': 1.0 / d,
                'inv_prefix': 1.0 / torch.cumprod(d, dim=-1),        # 1/D_{<=m+1}
                'inv_suffix': 1.0 / torch.flip(torch.cumprod(torch.flip(d, (-1,)), dim=-1),
                                               (-1,))}

    def _intervals_finalize(self, pack, acc, specs, slices) -> list:
        """V columns (list aligned with ``slices``) from accumulated chunk
        quadforms, with the per-slice inverse determinants applied."""
        qf_s, qf_p, qf_f = acc
        V_single = torch.einsum('mlLjJ, lLjJm -> mlj', qf_s, pack['inv_single'])
        V_prefix = torch.einsum('mlLjJ, lLjJm -> mlj', qf_p, pack['inv_prefix'])
        V_suffix = torch.einsum('mlLjJ, lLjJm -> mlj', qf_f, pack['inv_suffix'])
        s_sum = torch.einsum('lLN -> l', pack['g'])
        V_empty = torch.einsum('l, j -> lj', s_sum, s_sum)
        columns = []
        for (kindname, idx), m in zip(specs, slices):
            if kindname == 'single':
                columns.append(V_single[idx])
            elif kindname == 'prefix':
                columns.append(V_prefix[idx - 1])
            elif kindname == 'suffix':
                columns.append(V_suffix[idx])
            elif kindname == 'empty':
                columns.append(V_empty)
            else:                                   # exotic: per-slice fallback
                columns.append(self.marginalize(m)['V'])
        return columns

    def marginalize_intervals(self, slices: 'Tuple[Tuple[int, int], ...]'
                              ) -> Dict[str, torch.Tensor]:
        """V and S for MANY interval slices in one O(N^2 M) factorized pass.

        Every slice any GSA kind produces (gsa/models.py) is a single dim, a
        prefix, a suffix, or empty; exotic intervals fall back to
        :meth:`marginalize`. Returns {'V','S'} with the slice axis LAST,
        ordered as ``slices``."""
        (V,) = _intervals_pass([self], slices)
        return {'V': V, 'S': V / self.V[2][..., None]}


def _intervals_pass(cals: 'List[ClosedSobol]', slices: 'Tuple[Tuple[int, int], ...]'
                    ) -> 'List[torch.Tensor]':
    """The factorized V pass of one calibrator, or of several of one shape
    and meta together: each chunk step then runs once for them all,
    ``torch.func.vmap`` giving it a leading calibrator axis (romcomma_tpu
    vmaps its whole GSA over the folds, ``calibrators.py:1506-1522``). The
    automatic chunk shrinks by the number of calibrators, so the device holds
    the planes of one (``marginalize_intervals_stacked``'s rule, ``:760-766``);
    an explicit meta['n_chunk'] is kept. Returns each calibrator's V (slice
    axis last). The pass is the span 'gsa.v_pass' (``base.tracing``), with
    its ``chunks``."""
    cal = cals[0]
    specs, need = cal._interval_specs(slices, cal.M)
    l, L, N, M = cal.G.shape
    chunk = cal._intervals_chunk()
    if len(cals) > 1 and cal.meta.get('n_chunk', None) is None:
        chunk = max(64, chunk // len(cals))
    with tracing.span('gsa.v_pass', on=cal.G.device, chunks=-(-N // chunk)):
        packs = [c._intervals_pack() for c in cals]
        zero = torch.zeros((len(cals), M, l, L, l, L), dtype=cal.G.dtype, device=cal.G.device)
        if len(cals) == 1:
            pack, G, g, acc = packs[0], cal.G, cal.g0KY, (zero[0],) * 3

            def step(pack, acc, Gq_c, gq_c):
                return _intervals_step(need, pack, acc, Gq_c, gq_c)
        else:
            pack = {key: torch.stack([p[key] for p in packs]) for key in packs[0]}
            G, g = torch.stack([c.G for c in cals]), torch.stack([c.g0KY for c in cals])
            acc = (zero,) * 3
            step = torch.func.vmap(lambda *args: _intervals_step(need, *args))
        mesh = getattr(cal, 'gsa_mesh', None)
        if mesh is not None:
            # The chunks spread over the mesh's ranks (gsa/mesh.py), as romcomma_tpu's do.
            from romcomma_tpu_torch.gsa.mesh import intervals_sweep
            acc = intervals_sweep(mesh, range(0, N, chunk), lambda acc, start: step(
                pack, acc, G[..., start:start + chunk, :], g[..., start:start + chunk]), acc)
        else:
            for start in range(0, N, chunk):
                acc = step(pack, acc, G[..., start:start + chunk, :], g[..., start:start + chunk])
        Vs = []
        for i, (c, p) in enumerate(zip(cals, packs)):
            acc_i = acc if len(cals) == 1 else tuple(a[i] for a in acc)
            Vs.append(torch.stack(c._intervals_finalize(p, acc_i, specs, slices), dim=-1))
    return Vs


def _intervals_step(need: Dict[str, bool], pack: Dict[str, torch.Tensor], acc, Gq_c, gq_c):
    """One q chunk of the factorized interval pass: the per-dim exponent
    planes, their forward (prefix) and reverse (suffix) accumulations, and
    the g0KY-weighted quadforms of their exps, added to ``acc`` =
    (single, prefix, suffix) quadforms (M,l,L,l,L). ``Gq_c`` (j,J,c,M) and
    ``gq_c`` (j,J,c) are the chunk's columns of G and g0KY."""
    g = pack['g']                                                   # (l,L,N)
    M = pack['Gp_m'].shape[0]
    Gq_cm = torch.movedim(Gq_c, -1, 0)                              # (M,j,J,c)

    def e_step(m):
        """Per-dim exponent plane (l,L,j,J,N,c)."""
        Gp1, Phi1, PsiPhi1 = pack['Gp_m'][m], pack['Phi_m'][m], pack['PsiPhi_m'][m]
        bq = Phi1[:, :, None, None, None] * Gq_cm[m][None, None]       # (l,L,j,J,c)
        diff = Gp1[:, :, None, None, :, None] - bq[:, :, :, :, None, :]
        e = -0.5 * diff * diff / PsiPhi1[:, :, :, :, None, None]
        return e + 0.5 * (Gp1 * Gp1 / Phi1[..., None])[:, :, None, None, :, None]

    def qf(E):
        """Quadform of exp(E) over (N, c): a matrix-vector product on the
        plane's trailing (N, c) axes, which torch.einsum would first copy."""
        col = (g[:, :, None, None, None, :] @ torch.exp(E))[..., 0, :]      # (l,L,j,J,c)
        return torch.einsum('lLjJc, jJc -> lLjJ', col, gq_c)

    acc_s, acc_p, acc_f = acc
    # The single-dim quadform rides whichever cumulative sweep already runs
    # (its plane e_m is the same either way); only when neither family is
    # requested does it get a pass of its own.
    single_on_bwd = need['suffix']
    if need['prefix'] or (need['single'] and not single_on_bwd):
        E, ys_s, ys_p = 0.0, [], []
        for m in range(M):
            e = e_step(m)
            if need['single'] and not single_on_bwd:
                ys_s.append(qf(e))
            if need['prefix']:
                E = E + e
                ys_p.append(qf(E))
        if ys_p:
            acc_p = acc_p + torch.stack(ys_p)
        if ys_s:
            acc_s = acc_s + torch.stack(ys_s)
    if need['suffix']:
        E, ys_s, ys_f = 0.0, [None] * M, [None] * M
        for m in reversed(range(M)):                # emitted in dim order
            e = e_step(m)
            E = E + e
            if need['single']:
                ys_s[m] = qf(e)
            ys_f[m] = qf(E)
        acc_f = acc_f + torch.stack(ys_f)
        if need['single']:
            acc_s = acc_s + torch.stack(ys_s)
    return acc_s, acc_p, acc_f


class ClosedSobolWithError(ClosedSobol):
    """Closed Sobol' indices with standard errors
    (reference calibrators.py:146-402)."""

    META: Dict[str, Any] = {'is_T_partial': True}

    class RankEquation(NamedTuple):
        l: str
        i: str
        j: str
        k: str

    class RankEquations(NamedTuple):
        DIAGONAL: Any
        MIXED: Any

    RANK_EQUATIONS = RankEquations(
        DIAGONAL=(RankEquation(l='j', i='k', j='l', k='i'),
                  RankEquation(l='k', i='j', j='i', k='l')),
        MIXED=(RankEquation(l='k', i='k', j='j', k='i'),))

    def _equateRanks(self, liLNjkJM: torch.Tensor, rank_eq: 'RankEquation') -> torch.Tensor:
        """Diagonalize/sum tensor ranks per rank_eq (calibrators.py:172-191).
        The reference's reshape-merge of the last two axes (TF's rank-6 einsum
        limit) is kept verbatim since the axis bookkeeping depends on it."""
        shape = list(liLNjkJM.shape)
        eqRanks_j = 'j' if shape[4] == 1 else rank_eq.j
        eqRanks_k = 'k' if shape[5] == 1 else rank_eq.k
        t = liLNjkJM.reshape(shape[:-2] + [-1])
        if rank_eq in self.RANK_EQUATIONS.MIXED:
            result = torch.einsum('iiLNjkS -> LNjiS', t)
        else:
            result = torch.einsum(f'liLN{eqRanks_j}{eqRanks_k}S -> LN{rank_eq.j}{rank_eq.k}S', t)
        result = result.reshape(list(result.shape[:-1]) + shape[-2:])
        return (torch.einsum('LNjjJM -> LNjJM', result)[..., None, :, :]
                if rank_eq.j == 'i' else result)

    def _equatedRanksGaussian(self, mean: torch.Tensor, variance: torch.Tensor,
                              ordinate: torch.Tensor, rank_eqs) -> List[Gaussian]:
        """(calibrators.py:193-212)"""
        result = []
        N_axis = 3
        for rank_eq in rank_eqs:
            eq_ranks_variance = self._equateRanks(torch.unsqueeze(variance, N_axis),
                                                  rank_eq)[..., None, :]
            eq_ranks_mean = self._equateRanks(mean, rank_eq)[..., None, :]
            shape = (tuple(eq_ranks_mean.shape[:-2]) + tuple(ordinate.shape[-2:])
                     if ordinate.dim() > 2 else None)
            eq_ranks_mean = (eq_ranks_mean if shape is None
                             else torch.broadcast_to(eq_ranks_mean, shape)) - ordinate
            result += [Gaussian(mean=eq_ranks_mean, variance=eq_ranks_variance,
                                is_variance_diagonal=True, LBunch=10000)]
        return result

    def _omega_mean_variance(self, mp, G: torch.Tensor, Phi: torch.Tensor,
                             Upsilon: torch.Tensor):
        """Omega-family mean/variance tensors (reference calibrators.py:
        214-242), elementwise in the trailing M axis, before rank-equating.
        Sliced to ``mp`` when it is not the full interval."""
        Gamma = 1 - Phi
        Gamma_inv = 1 / Gamma
        Pi = 1 + Phi + torch.einsum('ikM, ikM, ikM -> ikM', Phi, Gamma_inv, Phi)
        Pi = 1 / Pi
        B = torch.einsum('jJM, jJM -> jJM', Gamma, Phi)[None, :, None, ...]
        B = B + torch.einsum('jJM, ikM, jJM -> ijkJM', Phi, Pi, Phi)
        Gamma_reshape = Gamma[:, None, :, None, :]
        C = Gamma_reshape / (1 - torch.einsum('lLM, ikM -> liLkM', Phi, Upsilon))
        C = torch.einsum('ikM, liLkM -> liLkM', (1 - Upsilon), C)
        Omega = torch.einsum('ikM, ikM, ikM -> ikM', Pi, Phi, Gamma_inv)
        Omega = torch.einsum('jJM, ikM -> ijkJM', Phi, Omega)
        mean = torch.einsum('ijkJM, liLkM, lLM, lLNM -> liLNjkJM', Omega, C, Gamma_inv, G)
        variance = (B[None, :, None, ...]
                    + torch.einsum('ijkJM, liLkM, ijkJM -> liLjkJM', Omega, C, Omega))
        if mp is not self.Ms:
            variance = variance[..., mp[0]:mp[1]]
            mean = mean[..., mp[0]:mp[1]]
        return mean, variance

    def _OmegaGaussian(self, mp, G: torch.Tensor, Phi: torch.Tensor, Upsilon: torch.Tensor,
                       rank_eqs) -> List[Gaussian]:
        """The Omega integral family (calibrators.py:214-242)."""
        mean, variance = self._omega_mean_variance(mp, G, Phi, Upsilon)
        if mp is not self.Ms:
            G = G[..., mp[0]:mp[1]]
        return self._equatedRanksGaussian(mean, variance, G[:, None, ...], rank_eqs)

    def _upsilon_mean_variance(self, G: torch.Tensor, Phi: torch.Tensor,
                               Upsilon: torch.Tensor):
        """Upsilon-family mean/variance tensors (reference calibrators.py:
        244-257), elementwise in the trailing M axis, before rank-equating."""
        Upsilon_cho = torch.sqrt(Upsilon)
        mean = torch.einsum('ikM, lLNM -> liLNkM', Upsilon_cho, G)[..., None, :, None, :]
        variance = 1 - torch.einsum('ikM, lLM, ikM -> liLkM', Upsilon_cho, Phi,
                                    Upsilon_cho)[..., None, :, None, :]
        return mean, variance

    def _UpsilonGaussian(self, G: torch.Tensor, Phi: torch.Tensor, Upsilon: torch.Tensor,
                         rank_eqs) -> List[Gaussian]:
        """The Upsilon integral family (calibrators.py:244-257)."""
        mean, variance = self._upsilon_mean_variance(G, Phi, Upsilon)
        return self._equatedRanksGaussian(mean, variance,
                                          torch.zeros((), dtype=G.dtype, device=G.device),
                                          rank_eqs)

    def _mu_phi_mu(self, GGaussian: Gaussian, UpsilonGaussians: List[Gaussian],
                   OmegaGaussians: List[Gaussian], rank_eqs) -> torch.Tensor:
        """E_m E_mp (mu[m] phi[m][mp] mu[mp])  (calibrators.py:259-288)."""
        GGaussian = GGaussian.expand_dims([2])
        mu_phi_mu = 0.0
        for i, rank_eq in enumerate(rank_eqs):
            OmegaGaussians[i] = OmegaGaussians[i] / GGaussian
            OmegaGaussians[i].exponent = (OmegaGaussians[i].exponent
                                          + UpsilonGaussians[i].exponent)
            if UpsilonGaussians[i].cho_diag.shape[-1] == GGaussian.cho_diag.shape[-1]:
                OmegaGaussians[i].cho_diag = (OmegaGaussians[i].cho_diag
                                              * UpsilonGaussians[i].cho_diag)
            else:
                OmegaGaussians[i].cho_diag = (diag_det(OmegaGaussians[i].cho_diag)
                                              * diag_det(UpsilonGaussians[i].cho_diag))[..., None]
            if rank_eq in self.RANK_EQUATIONS.MIXED:
                result = torch.einsum('kLN, LNjkJn, jJn -> jk', self.g0KY,
                                      OmegaGaussians[i].pdf, self.g0KY)
                mu_phi_mu = mu_phi_mu + torch.einsum('k, jk -> jk',
                                                     self.mu_phi_mu['pre-factor'], result)
                mu_phi_mu = _set_diag(mu_phi_mu, 2 * _diag_part(mu_phi_mu))
            elif rank_eq.l == 'k' and rank_eq.i == 'j':
                result = torch.einsum('jLN, LNjkJn, jJn -> j', self.g0KY,
                                      OmegaGaussians[i].pdf, self.g0KY)
                mu_phi_mu = mu_phi_mu + torch.diag(torch.einsum(
                    'j, j -> j', self.mu_phi_mu['pre-factor'], result))
            else:
                result = torch.einsum('jLN, LNjkJn, jJn -> jk', self.g0KY,
                                      OmegaGaussians[i].pdf, self.g0KY)
                mu_phi_mu = mu_phi_mu + torch.einsum('k, jk -> jk',
                                                     self.mu_phi_mu['pre-factor'], result)
        return mu_phi_mu

    def _psi_ratio(self, G: torch.Tensor, Phi: torch.Tensor, GGaussian: Gaussian) -> Gaussian:
        """The psi Gaussian RATIO of a slice: the pdf whose contraction
        (:meth:`_psi_contract`) yields the psi factor."""
        D = Phi[..., None, None, :] - torch.einsum('lLM, iIM, lLM -> lLiIM', Phi, Phi, Phi)
        mean = torch.einsum('lLM, iInM -> lLiInM', Phi, G)
        mean = mean[:, :, None, ...] - G[..., None, None, None, :]
        gaussian = Gaussian(mean=mean, variance=D, is_variance_diagonal=True, LBunch=2)
        return gaussian / GGaussian.expand_dims([-1, -2, -3])

    def _psi_factor(self, G: torch.Tensor, Phi: torch.Tensor, GGaussian: Gaussian
                    ) -> torch.Tensor:
        """The psi factor of E_m E_mp (mu psi mu) (calibrators.py:290-309)."""
        return self._psi_contract(self._psi_ratio(G, Phi, GGaussian))

    def _psi_contract(self, gaussian: Gaussian) -> torch.Tensor:
        """Contract the psi Gaussian ratio with g0KY/g0 and solve vs K_cho."""
        factor = torch.einsum('lLN, iIn, lLNiIn -> liIn', self.g0KY, self.g0, gaussian.pdf)
        if self.K_cho.dim() == 2 and factor.shape[-2] == 1:
            inner = torch.einsum('liIN -> lNi', factor)
            factor = torch.einsum('lNiI -> liIN', torch.diag_embed(inner))
        factor = factor.reshape(list(factor.shape[:-2]) + [-1, 1])
        return torch.squeeze(tri_solve(self.K_cho, factor), -1)

    def _mu_psi_mu(self, psi_factor: torch.Tensor, rank_eqs) -> torch.Tensor:
        """(calibrators.py:311-322)"""
        first_psi_factor = (self.psi_factor if rank_eqs is self.RANK_EQUATIONS.MIXED
                            else psi_factor)
        first_ein = 'liS' if rank_eqs is self.RANK_EQUATIONS.DIAGONAL else 'iiS'
        result = torch.einsum(f'{first_ein}, liS -> li', first_psi_factor, psi_factor)
        return _set_diag(result, 2 * _diag_part(result))

    def _W(self, mu_phi_mu: torch.Tensor, mu_psi_mu: torch.Tensor) -> torch.Tensor:
        W = mu_phi_mu - mu_psi_mu
        return W + W.T

    def _T(self, Wmm: torch.Tensor, WMm: torch.Tensor = None, Vm: torch.Tensor = None
           ) -> torch.Tensor:
        if self.meta['is_T_partial']:
            return torch.sqrt(torch.abs(Wmm) / self.V[4])
        return self._T_from(Wmm, self.Q, WMm, Vm)

    def _T_from(self, Wmm: torch.Tensor, Q: torch.Tensor, WMm: torch.Tensor,
                Vm: torch.Tensor) -> torch.Tensor:
        """Non-partial T with ``Q`` passed explicitly (the factorized engine
        computes Q itself before the full-interval cache exists)."""
        Qs = Wmm - 2 * Vm * WMm / self.V[1] + Vm * Vm * Q
        return torch.sqrt(torch.abs(Qs) / self.V[4])

    def _families(self, m: Tuple[int, int]):
        """The error-integral families of slice ``m``: (GGaussian, psi ratio,
        Upsilon Gaussians per rank family, Omega Gaussians per rank family,
        rank families). The per-slice path, for general slices; canonical
        intervals go through the factorized sweep (gsa/factorized_errors.py)."""
        G, Phi, Upsilon = tuple(tensor[..., m[0]:m[1]]
                                for tensor in (self.G, self.Phi, self.Upsilon))
        GGaussian = Gaussian(G, Phi, is_variance_diagonal=True, LBunch=2)
        psi_ratio = self._psi_ratio(G, Phi, GGaussian)
        families = ((self.RANK_EQUATIONS.DIAGONAL,) if self.meta['is_T_partial']
                    else tuple(self.RANK_EQUATIONS))
        ups = tuple(self._UpsilonGaussian(G, Phi, Upsilon, req) for req in families)
        oms = tuple(self._OmegaGaussian(m, self.G, self.Phi, self.Upsilon, req)
                    for req in families)
        return GGaussian, psi_ratio, ups, oms, families

    def _error_results(self, bundle, Vm: torch.Tensor) -> Dict[str, torch.Tensor]:
        """W and T from a family bundle (the tail of reference
        calibrators.py:348-373). ``Vm`` is used only when is_T_partial is
        False (the V-dependent T correction)."""
        GGaussian, psi_ratio, ups_fams, oms_fams, families = bundle
        psi_factor = self._psi_contract(psi_ratio)
        Ws = [self._W(self._mu_phi_mu(GGaussian, list(ups), [copy.copy(o) for o in oms], req),
                      self._mu_psi_mu(psi_factor, req))
              for ups, oms, req in zip(ups_fams, oms_fams, families)]
        if self.meta['is_T_partial']:
            return {'W': Ws[0], 'T': self._T(Ws[0])}
        Wmm, WMm = Ws                              # (DIAGONAL, MIXED) order
        return {'W': Wmm, 'T': self._T(Wmm, WMm, Vm)}

    def marginalize(self, m: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        """V, S, W and T of the slice [m[0]:m[1]], slice by slice
        (calibrators.py:348-373): O(N^2 M) tensors of every family at once,
        the oracle of the factorized sweep and the path of general slices."""
        result = super().marginalize(m)
        result |= self._error_results(self._families(m), result['V'])
        return result

    def marginalize_intervals(self, slices: 'Tuple[Tuple[int, int], ...]'
                              ) -> Dict[str, torch.Tensor]:
        """Factorized all-interval pass INCLUDING standard errors.

        V/S come from the parent's O(N^2 M) pass. The W/T error integrals
        factorize the same way and are computed by the chunked sweep in
        :mod:`romcomma_tpu_torch.gsa.factorized_errors`. A set of slices with
        a general one falls back to per-slice evaluation (:meth:`marginalize`),
        as romcomma_tpu's does (calibrators.py:1039-1046). The V pass and
        the W/T sweep are the spans 'gsa.v_pass' and 'gsa.wt_sweep'
        (``base.tracing``)."""
        return marginalize_intervals_folds([self], slices)[0]

    def _calibrate(self):
        """(calibrators.py:375-402). The full-interval error integrals
        (psi_factor, W, Q, T) are computed lazily on first access by the
        factorized sweep (gsa/factorized_errors.py)."""
        super()._calibrate()
        if not self.is_F_diagonal:
            raise NotImplementedError('If the MOGP kernel covariance is not diagonal, '
                                      'the Sobol error calculation is unstable.')
        self.Upsilon = self.Lambda2[-1][2]
        self.V |= {4: torch.einsum('li, li -> li', self.V[2], self.V[2])}
        self.mu_phi_mu = {'pre-factor': torch.reshape(
            torch.sqrt(torch.prod(self.Lambda2[1][0] * self.Lambda2[-1][2], dim=-1)) * self.F,
            [-1])}
        self._full_error_cache = None

    def _full_error(self) -> Dict[str, Any]:
        if self._full_error_cache is None:
            from romcomma_tpu_torch.gsa import factorized_errors
            self._full_error_cache = factorized_errors.full_interval(self)
        return self._full_error_cache

    @property
    def psi_factor(self) -> torch.Tensor:
        return self._full_error()['psi_factor']

    @property
    def W(self):
        w = self._full_error()['W']
        return (w['DIAGONAL'] if self.meta['is_T_partial']
                else self.RankEquations(DIAGONAL=w['DIAGONAL'], MIXED=w['MIXED']))

    @property
    def Q(self) -> torch.Tensor:
        return self._full_error()['Q']

    @property
    def T(self) -> torch.Tensor:
        return self._full_error()['T']


class ClosedSobolWithRotation(ClosedSobol):
    """Closed Sobol' indices under an input-basis rotation u = Theta x: the
    ROM hook (reference calibrators.py:405-423; romcomma_tpu calibrators.py:
    1528-1683).

    With orthonormal rows P = Theta[:Mu] and x ~ N(0, I), the rotated closed
    index V[u_{1:Mu}] = Cov_u(E[f_l | Px], E[f_j | Px]) closes over the RBF
    posterior mean: conditioning gives x | Px=u ~ N(P^T u, Sigma_c), Sigma_c =
    I - P^T P; with B_l = (Lambda_l^2 + Sigma_c)^-1 and C_lj = P^T (P (B_l +
    B_j) P^T + I)^-1 P,

        E_u[g^l_n g^j_n'] ~ exp(-q_l(x_n)/2 - q_j(x_n')/2 + x_n^T B_l C_lj B_j x_n'),

    so all N^2 pair integrals of an output pair are one (N, M+2) @ (M+2, N)
    matmul and an elementwise exp, differentiable in Theta through autograd.
    :meth:`optimize_theta` ascends the mean leading index over SO(M) through
    a Cayley parameterization.

    V and S only: the ROM persists Theta into the fold and retrains, after
    which :class:`ClosedSobolWithError` gives standard errors in the rotated
    basis as in any other (``ROM.calibrate(is_error_calculated=True)``)."""

    def V_rotated(self, P: torch.Tensor) -> torch.Tensor:
        """The (L, L) conditional-variance matrix of the rotated slice
        u_{1:Mu} = P x (P: (Mu, M), orthonormal rows), float64 and
        differentiable in P. At P = I[:Mu] it equals ``marginalize((0, Mu))['V']``:
        the centred ``g0KY`` weights contracted through the Gaussian pdf ratio
        H = E_u[g^l_n g^j_n'] / (g0_ln g0_jn'), in full-matrix algebra."""
        if not self.is_F_diagonal:
            raise NotImplementedError('Rotated Sobol indices require a diagonal kernel '
                                      'covariance F.')
        X = self.X                                              # (N, M)
        P = P.to(X)
        Lam2 = self.Lambda ** 2                                 # (L, M)
        g = self.g0KY[:, 0, :]                                  # (L, N) centred
        L, M, Mu = self.L, self.M, P.shape[0]
        I_M = torch.eye(M, dtype=X.dtype, device=X.device)
        I_Mu = torch.eye(Mu, dtype=X.dtype, device=X.device)
        ones = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
        Sig_c = I_M - P.T @ P
        B, logc1, lc0, q0 = [], [], [], []
        for l in range(L):
            cho = torch.linalg.cholesky(torch.diag(Lam2[l]) + Sig_c)
            B.append(torch.cholesky_inverse(cho))
            logc1.append(0.5 * torch.sum(torch.log(Lam2[l]))
                         - torch.sum(torch.log(torch.diagonal(cho))))
            # The g0 divisor's log-constant and per-point exponent (the
            # unconditional integral, Sigma_c -> I).
            lc0.append(0.5 * torch.sum(torch.log(Lam2[l] / (Lam2[l] + 1.0))))
            q0.append(torch.sum(X * X / (Lam2[l] + 1.0), dim=-1))          # (N,)
        rows = []
        for l in range(L):
            cols = []
            for j in range(L):
                cho_m = torch.linalg.cholesky(P @ (B[l] + B[j]) @ P.T + I_Mu)
                C = P.T @ torch.cholesky_inverse(cho_m) @ P               # (M, M)
                q_l = torch.sum((X @ (B[l] - B[l] @ C @ B[l])) * X, dim=-1)
                q_j = torch.sum((X @ (B[j] - B[j] @ C @ B[j])) * X, dim=-1)
                constant = (logc1[l] + logc1[j] - lc0[l] - lc0[j]
                            - torch.sum(torch.log(torch.diagonal(cho_m))))
                # log H = X B_l C B_j X^T + a_n + b_n', the per-point terms
                # riding the same matmul as two extra columns.
                a = -0.5 * (q_l - q0[l]) + constant
                b = -0.5 * (q_j - q0[j])
                left = torch.cat([X @ (B[l] @ C @ B[j]), a[:, None], ones], dim=1)
                right = torch.cat([X, ones, b[:, None]], dim=1)
                cols.append(g[l] @ torch.exp(left @ right.T) @ g[j])
            rows.append(torch.stack(cols))
        return torch.stack(rows)

    def S_rotated(self, P: torch.Tensor) -> torch.Tensor:
        """Closed Sobol' index matrix of the rotated slice, normalized by the
        total variance as :meth:`ClosedSobol.marginalize` is."""
        return self.V_rotated(P) / self.V[2]

    @staticmethod
    def _cayley(A_flat: torch.Tensor, M: int) -> torch.Tensor:
        """Theta in SO(M) from M(M-1)/2 free parameters by the Cayley
        transform Theta = (I + A)^-1 (I - A), A skew-symmetric: one native
        float64 solve."""
        idx = torch.tril_indices(M, M, -1, device=A_flat.device)
        A = torch.zeros((M, M), dtype=A_flat.dtype, device=A_flat.device).index_put(
            (idx[0], idx[1]), A_flat)
        A = A - A.T
        I = torch.eye(M, dtype=A_flat.dtype, device=A_flat.device)
        return torch.linalg.solve(I + A, I - A)

    def optimize_theta(self, Mu: int, maxiter: int = 200, n_starts: int = 4, seed: int = 0,
                       scale: float = 0.5) -> Tuple[np.ndarray, float]:
        """Ascend the mean (over outputs) leading closed index S[u_{1:Mu}] over
        Theta in SO(M), from the identity and n_starts - 1 random Cayley
        generators, each by scipy's L-BFGS-B (romcomma_tpu runs optax's L-BFGS
        here, so the two may stop at different points). Returns (Theta (M, M),
        best S). Records the objective's value+grad count and seconds in
        ``last_theta_timings``."""
        from romcomma_tpu_torch.ops import lbfgs
        M = self.M
        n_free = (M * (M - 1)) // 2
        evaluations = [0]

        def objective(p):
            evaluations[0] += 1
            P = self._cayley(p['A'], M)[:Mu]
            return -torch.mean(torch.diagonal(self.S_rotated(P)))

        rng = np.random.default_rng(seed)
        starts = [np.zeros(n_free)]
        starts += [rng.normal(scale=scale, size=n_free) for _ in range(max(0, n_starts - 1))]
        best = None
        t0 = time.perf_counter()
        for x0 in starts:
            res = lbfgs.minimize(objective, {'A': torch.as_tensor(x0, dtype=self.X.dtype,
                                                                  device=self.X.device)},
                                 maxiter=maxiter)
            if best is None or res.value < best.value:
                best = res
        self.last_theta_timings = {'evaluations': evaluations[0],
                                   'seconds': time.perf_counter() - t0}
        with torch.no_grad():
            theta = self._cayley(best.params['A'], M).cpu().numpy()
        # Deterministic signs (each row's largest-magnitude entry positive) keep
        # the persisted rotation reproducible; row sign flips leave S invariant.
        signs = np.sign(theta[np.arange(M), np.abs(theta).argmax(axis=1)])
        theta = theta * signs[:, None]
        if np.linalg.det(theta) < 0:
            theta[-1] *= -1.0
        return theta, -float(best.value)


def _is_F_diagonal(gp) -> bool:
    """F-diagonality, read from the GP's meta.json kernel options
    (reference calibrators.py:129-132)."""
    gp_options = gp.read_meta() if gp._meta_json.exists() else dict(gp.META)
    return not gp_options.pop('kernel', {}).pop('covariance', False)


def marginalize_intervals_folds(cals: 'List[ClosedSobol]', slices: 'Tuple[Tuple[int, int], ...]'
                                ) -> 'List[Dict[str, torch.Tensor]]':
    """``marginalize_intervals`` of several calibrators of one class, shape
    and meta (the equal-shape folds of a repository) together: the V pass and
    the W/T sweep each run their chunk steps once for them all (see
    :func:`_intervals_pass`), the psi solves each against its own K_cho.
    Returns one result per calibrator, as its own ``marginalize_intervals``
    would. A set of slices with a general one goes slice by slice,
    calibrator by calibrator."""
    from romcomma_tpu_torch.gsa import factorized_errors
    slices = tuple(slices)
    cal = cals[0]
    specs = [cal._classify_interval(m, cal.M) for m in slices]
    if any(k == 'general' for k, _ in specs):
        results = []
        for c in cals:
            if isinstance(c, ClosedSobolWithError):
                # romcomma_tpu falls back to the per-slice path for every
                # slice of a set with a general one (calibrators.py:1039-1046).
                outs = [c.marginalize(m) for m in slices]
                results.append({key: torch.stack([out[key] for out in outs], dim=-1)
                                for key in outs[0]})
            else:
                results.append(ClosedSobol.marginalize_intervals(c, slices))
        return results
    return _marginalize_canonical(cals, slices, specs, factorized_errors.intervals_folds)


def _marginalize_canonical(cals, slices, specs, intervals) -> 'List[Dict[str, torch.Tensor]]':
    """The stacked pass of :func:`marginalize_intervals_folds` over canonical
    ``slices`` (classified as ``specs``): one V pass, then, for calibrators
    with errors, one W/T sweep by ``intervals`` (``factorized_errors``'
    ``intervals_folds`` or ``intervals_stacked``), the span 'gsa.wt_sweep'
    with the fused kernel's ``launches`` inside it."""
    Vs = _intervals_pass(cals, slices)
    errors = [{} for _ in cals]
    if isinstance(cals[0], ClosedSobolWithError):
        with tracing.span('gsa.wt_sweep', on=cals[0].G.device) as record:
            launches = sweep_kernel.LAUNCHES
            errors = intervals(cals, slices, specs, Vs)
            if record is not None:
                record['attrs']['launches'] = sweep_kernel.LAUNCHES - launches
    return [{'V': V, 'S': V / c.V[2][..., None]} | error
            for c, V, error in zip(cals, Vs, errors)]


def _stacked_specs(cals, slices) -> list:
    """The classified ``slices`` of an output-stacked pass, which takes only
    canonical slices and calibrators of one shape and dtype (romcomma_tpu's
    rules, ``calibrators.py:748-758``)."""
    first = cals[0]
    specs = [first._classify_interval(m, first.M) for m in slices]
    if any(k == 'general' for k, _ in specs):
        raise ValueError(f'stacked interval passes support only canonical interval slices; got '
                         f'{tuple(slices)}.')
    for c in cals:
        if c.G.shape != first.G.shape or c.G.dtype != first.G.dtype or type(c) is not type(first):
            raise ValueError('stacked outputs must share their class, (l, L, N, M) and dtype.')
    return specs


def marginalize_intervals_stacked(cals: 'List[ClosedSobol]', slices: 'Tuple[Tuple[int, int], ...]'
                                  ) -> 'List[Dict[str, torch.Tensor]]':
    """ONE factorized interval pass for several independent single-output
    calibrators sharing X, the outputs of one large-route model (romcomma_tpu's,
    ``calibrators.py:732``): each q chunk's step runs once for them all, as
    the folds' pass does (:func:`_intervals_pass`, whose automatic chunk
    shrinks by their number). Canonical slices only. Returns one {'V'} per
    calibrator (slice axis last), what each one's ``marginalize_intervals``
    gives up to the order of additions."""
    slices = tuple(slices)
    _stacked_specs(cals, slices)
    return [{'V': V} for V in _intervals_pass(cals, slices)]


def marginalize_intervals_error_stacked(cals: 'List[ClosedSobolWithError]',
                                        slices: 'Tuple[Tuple[int, int], ...]'
                                        ) -> 'List[Dict[str, torch.Tensor]]':
    """Multi-output ``ClosedSobolWithError.marginalize_intervals``
    (romcomma_tpu's, ``calibrators.py:1168``): ONE stacked V pass and ONE
    stacked W/T sweep (``factorized_errors.intervals_stacked``) for
    independent single-output calibrators sharing X, each output's psi
    factors then solved against its own K_cho or half solver. Canonical
    slices only. Returns one {'V', 'S', 'W', 'T'} per calibrator."""
    from romcomma_tpu_torch.gsa import factorized_errors
    slices = tuple(slices)
    return _marginalize_canonical(cals, slices, _stacked_specs(cals, slices),
                                  factorized_errors.intervals_stacked)


def marginalize_all(gp, slices: Tuple[Tuple[int, int], ...], is_error_calculated: bool, **meta):
    """Run a whole GSA kind: calibrator construction plus every m-slice
    marginalization. See :func:`marginalize_all_kinds`, of which this is the
    single-kind case. Returns (results, extras)."""
    by_kind, extras = marginalize_all_kinds(gp, {'_only': tuple(slices)},
                                            is_error_calculated, **meta)
    return by_kind['_only'], extras


def marginalize_all_kinds(gp, kind_slices: 'Dict[str, Tuple[Tuple[int, int], ...]]',
                          is_error_calculated: bool, **meta):
    """Run EVERY requested GSA kind of one fold's GP: one calibrator
    precompute plus one factorized pass over all m-slices of all kinds, on
    ``definitions.device()`` and nowhere else.

    Returns ({kind: results}, extras): results[key] has the slice axis last;
    extras = {'V0','S'[,'T']}, the quantities Sobol._post_calibrate needs.
    """
    return marginalize_all_kinds_folds([gp], kind_slices, is_error_calculated, **meta)[0]


def marginalize_all_kinds_folds(gps, kind_slices: 'Dict[str, Tuple[Tuple[int, int], ...]]',
                                is_error_calculated: bool, **meta) -> list:
    """:func:`marginalize_all_kinds` of the GPs of several equal-shape (N, M,
    L) folds at once: one calibrator each, and one pass over all slices of
    all kinds for them all (:func:`marginalize_intervals_folds`), the port of
    romcomma_tpu's vmapped ``marginalize_all_kinds_folds``
    (calibrators.py:1465-1525). F's diagonality is the first GP's, as there.
    Returns one (by_kind, extras) per GP, in the single-fold function's
    structure."""
    if is_error_calculated and any(gp.is_covariant for gp in gps):
        raise NotImplementedError(COVARIANT_ERRORS_UNSUPPORTED)
    cls = ClosedSobolWithError if is_error_calculated else ClosedSobol
    meta = {k: v for k, v in meta.items() if k not in ('folder', 'm', 'M')}
    is_F_diagonal = meta.pop('is_F_diagonal', None)
    if is_F_diagonal is None:
        is_F_diagonal = _is_F_diagonal(gps[0])
    cals = [cls.from_arrays(is_F_diagonal=is_F_diagonal, L=gp.L, M=gp.M, N=gp.N, **meta,
                            **ClosedSobol.gather_arrays(gp, need_K_cho=is_error_calculated))
            for gp in gps]
    flat = [s for slices in kind_slices.values() for s in slices]
    results = []
    for cal, out in zip(cals, marginalize_intervals_folds(cals, tuple(flat))):
        by_kind, start = {}, 0
        for kind, slices in kind_slices.items():
            stop = start + len(slices)
            by_kind[kind] = {k: v[..., start:stop] for k, v in out.items()}
            start = stop
        extras = {'V0': cal.V[0], 'S': cal.S}
        if is_error_calculated and not cal.meta['is_T_partial']:
            extras['T'] = cal.T
        results.append((by_kind, extras))
    return results
