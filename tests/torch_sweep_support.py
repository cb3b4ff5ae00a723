"""What the W/T sweep kernel's tests share (no JAX here, so the card's test
file can import it): the plain chunk and the kernel chunk of the same
calibrators, each output's scale, and the kernel's launch contract emulated
in plain torch for the CPU."""

import torch

from romcomma_tpu_torch.gsa import factorized_errors

#: A fused chunk sum and a plain one differ only in the order of their
#: additions: each is held within this share of its scale, the same sum of
#: the terms' absolute values (the plain sum's rounding is ~log2(n) eps of
#: it, the kernel's sequential adds over row tiles ~(N / 32) eps).
SCALE_RTOL = 1e-12


def _abs_weights(C):
    """A prep whose row and column weights are their absolute values: its
    chunk sums are the sums of the absolute values of the terms."""
    out = dict(C, g=C['g'].abs(), g0q=C['g0q'].abs(), gw={k: v.abs() for k, v in C['gw'].items()})
    if 'gw_prefix_last' in C:
        out['gw_prefix_last'] = C['gw_prefix_last'].abs()
    return out


def chunks_of(cals, need, q: slice):
    """(kernel chunk, plain chunk, scale) of the calibrators ``cals`` for
    ``need``, columns ``q``: the first through ``_pack`` and
    ``_run_chunk_kernel`` (a calibrator axis first), the others
    ``_run_chunk`` stacked over the calibrators."""
    kinds = tuple(k for k in factorized_errors.KINDS if need.get(k) or k == 'prefix')
    prefix_full = bool(need.get('prefix'))
    layout = factorized_errors._member_layout(cals[0])
    Cs = [factorized_errors._prep(c, kinds, prefix_full) for c in cals]
    K = factorized_errors._pack(Cs, layout, kinds, prefix_full)
    got = factorized_errors._run_chunk_kernel(K, layout, kinds, prefix_full, q)

    def plain(preps):
        return factorized_errors._stack([factorized_errors._run_chunk(C, layout, kinds,
                                                                      prefix_full, q)
                                         for C in preps])
    return got, plain(Cs), plain([_abs_weights(C) for C in Cs])


def plain_chunk(cals, need) -> int:
    """The plain sweep's automatic chunk for the calibrators ``cals`` swept
    together: ``_chunk_size``'s rule on the CPU, wherever they are."""
    cal = cals[0]
    n_members = len(factorized_errors._member_layout(cal))
    L = cal.G.shape[0]
    per_col = cal.N * L * L * 3 * (n_members + 1)
    chunk = int(min(cal.N, max(64, cal.V_MEMORY_BUDGET_BYTES // cal.X.element_size() // per_col)))
    return max(64, chunk // len(cals)) if len(cals) > 1 else chunk


def shares(got, want, scale):
    """(part, worst |got - want| over its scale) of every leaf of ``want``,
    inf where ``got`` is not finite; raises where kinds or shapes differ."""
    if got.keys() != want.keys():
        raise ValueError(f'kinds {sorted(got)} against {sorted(want)}')
    for kind in want:
        pairs = list(zip(got[kind][0], want[kind][0], scale[kind][0]))
        pairs.append((got[kind][1], want[kind][1], scale[kind][1]))
        for i, (g, w, s) in enumerate(pairs):
            part = f'{kind} ' + (f'member {i} quads' if i < len(pairs) - 1 else 'psi columns')
            if g.shape != w.shape:
                raise ValueError(f'{part}: shape {tuple(g.shape)} against {tuple(w.shape)}')
            worst = (float(((g - w).abs() / s.clamp_min(torch.finfo(s.dtype).tiny)).max())
                     if torch.isfinite(g).all() else float('inf'))
            yield part, worst


def assert_within_scale(got, want, scale, rtol=SCALE_RTOL):
    """Every leaf of ``got`` within ``rtol`` of its scale of ``want``; the
    same kinds and shapes."""
    for part, worst in shares(got, want, scale):
        assert worst <= rtol, f'{part}: {worst:.3g} of its scale'


def emulated_sweep(planes, col0, ncols, passes, psi_L=0):
    """``sweep_kernel.sweep`` in plain torch, one row group, with the
    kernel's own flat offsets: its launch contract on the CPU."""
    A, Q, W = planes['A'], planes['Q'], planes['W']
    B, P, M, N = A.shape
    KU = W.shape[1] if psi_L else (planes['U'].shape[1] if 'U' in planes else 0)
    NQ = Q.shape[-1]
    flat = {key: value.reshape(-1) for key, value in planes.items()}
    flat.setdefault('WL', flat['W'])
    last = any(p[3] for p in passes)
    out, out_last = (torch.zeros(n, dtype=A.dtype)
                     for n in (B * KU * M * P * ncols, B * P * ncols))
    rows, cols = torch.arange(N), torch.arange(ncols)
    for bp in range(B * P):
        b, p = divmod(bp, P)
        out_base, a_row, q_row = (b * KU * M * P + p) * ncols, bp * M * N, bp * M * NQ + col0
        if psi_L:
            l = p // psi_L
            u_base, w_base, w_step = 0, (b * KU * M * psi_L + l) * N, psi_L * N
            ul_row, wl_row = 0, (b * psi_L + l) * N
        else:
            u_base, w_base, w_step = (b * KU * P + p) * M * N, bp * N, 0
            ul_row, wl_row = bp * N, bp * N

        def emit(X, u_row, w_row, target, at, u_key='U', w_key='W'):
            x = -X if psi_L else flat[u_key][u_row + rows][:, None] - X
            target[at + cols] += torch.sum(torch.exp(x) * flat[w_key][w_row + rows][:, None], 0)

        for reverse, single, acc, emit_last in passes:
            E = torch.zeros((N, ncols), dtype=A.dtype)
            for step in range(M):
                m = M - 1 - step if reverse else step
                d = (flat['A'][a_row + m * N + rows][:, None]
                     - flat['Q'][q_row + m * NQ + cols][None, :])
                e = d * d
                E = E + e
                for X, k in ((e, single), (E, acc)):
                    if k is not None:
                        emit(X, u_base + (k * P * M + m) * N, w_base + (k * M + m) * w_step,
                             out, out_base + (k * M + m) * P * ncols)
            if emit_last:
                emit(E, ul_row, wl_row, out_last, bp * ncols, 'UL', 'WL')
    return (out.reshape(B, KU, M, P, ncols),
            out_last.reshape(B, P, ncols) if last else None)
