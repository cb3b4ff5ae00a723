"""Factorized standard-error (W/T) pass for ClosedSobolWithError.

Counterpart of ``romcomma_tpu/gsa/factorized_errors.py``: computes the
Sobol' standard-error integrals of EVERY canonical interval slice (single
dim / prefix / suffix / empty) in one chunked sweep over input dims, the
same shape as ``ClosedSobol.marginalize_intervals``'s V pass.

Math (quantities defined in reference romcomma/gsa/calibrators.py:146-402):

Every error-family Gaussian (psi, the Upsilon and Omega families per rank
equation, and the G-divisor Gaussian) has diagonal variance over input dims
with *slice-independent per-dim parameters*, and its per-dim exponent has the
separable form

    e_m(p, q) = -(a_m[p-axes] - b_m[q-axes])^2 / (2 v_m[batch-axes])

with a batch-only Cholesky diagonal. Exponents are therefore additive over
dims and sqrt-determinants multiplicative, so a forward sweep over dims
yields every prefix slice (CLOSED kind), a reverse sweep every suffix
(TOTAL), and the per-dim plane itself every single-dim slice (FIRST_ORDER),
at O(N^2 M) total cost instead of O(N^2 M) *per slice*. The Upsilon
(p-side-only) and G-divisor exponents carry no (p, q) cross term, so their
cumulative sums, and all determinant products, are precomputed outside the
sweep as O(N M) arrays and folded in at emission time.

Because ``g0KY`` is centred (sums to zero per output), the empty-slice error
integrals vanish identically: W = 0, T = 0.

Only the diagonal-F case exists here: ``ClosedSobolWithError._calibrate``
rejects non-diagonal F (matching the reference's instability note). The
sweep runs on one device in float64. On the CPU a chunk is ``_run_chunk``,
the sweeps over dims as Python loops of torch ops; on a CUDA device it is
the fused kernel of :mod:`romcomma_tpu_torch.gsa.sweep_kernel`, whose planes
never leave the chip (``_run_chunk`` stays its oracle). Several calibrators
of one shape (the equal-shape folds of a repository, a model's outputs)
sweep together: on the CPU ``torch.func.vmap`` gives each chunk step a
leading calibrator axis, on a card the kernel takes that axis itself, so one
step runs once for them all, as romcomma_tpu vmaps its whole GSA over the
folds; each keeps its own psi solve against its own K_cho.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from romcomma_tpu_torch.gsa import sweep_kernel
from romcomma_tpu_torch.gsa.calibrators import _diag_part, _set_diag
from romcomma_tpu_torch.ops.linalg import tri_solve


def _cums(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-dim ('single'), forward-cumulative ('prefix') and
    reverse-cumulative ('suffix') views along the leading M axis."""
    return {'single': x, 'prefix': torch.cumsum(x, dim=0),
            'suffix': torch.flip(torch.cumsum(torch.flip(x, (0,)), dim=0), (0,))}


KINDS = ('single', 'prefix', 'suffix')


# --------------------------------------------------------------------------- #
# Per-dim family parameters (compact axes; asserts the diagonal-F layout)
# --------------------------------------------------------------------------- #

def _families_of(cal):
    return ((('DIAGONAL', cal.RANK_EQUATIONS.DIAGONAL),)
            if cal.meta['is_T_partial']
            else (('DIAGONAL', cal.RANK_EQUATIONS.DIAGONAL),
                  ('MIXED', cal.RANK_EQUATIONS.MIXED)))


def _member_layout(cal) -> List[Dict[str, Any]]:
    """Per-member layout: the ``_mu_phi_mu`` branch of each (family,
    rank-equation) member: p-side index, output spec, MIXED flag."""
    layout: List[Dict[str, Any]] = []
    for fam_name, rank_eqs in _families_of(cal):
        for rank_eq in rank_eqs:
            mixed = rank_eq in cal.RANK_EQUATIONS.MIXED
            diag_add = (not mixed) and rank_eq.l == 'k' and rank_eq.i == 'j'
            layout.append({'family': fam_name, 'p': 'k' if mixed else 'j',
                           'out': 'j' if diag_add else 'jk', 'mixed': mixed})
    return layout


def _member_arrays(cal) -> List[Dict[str, torch.Tensor]]:
    """Per-member arrays, aligned with :func:`_member_layout`: Omega per-dim
    N-side mean ``a`` (M, j, k, N) and variance ``v`` (M, j, k); the Upsilon
    per-dim (p-side-only) exponent ``e_up`` (M, j, k, N); the combined
    per-dim sqrt-determinant ``d`` (M, j, k) of (Omega / G-divisor) *
    Upsilon."""
    G, Phi, Upsilon = cal.G, cal.Phi, cal.Upsilon
    om_mean, om_var = cal._omega_mean_variance(cal.Ms, G, Phi, Upsilon)
    up_mean, up_var = cal._upsilon_mean_variance(G, Phi, Upsilon)
    dg = torch.sqrt(Phi[:, 0, :])                           # (L, M) G-divisor cho

    def equate(tensor, rank_eq, insert_n_axis: bool):
        t = torch.unsqueeze(tensor, 3) if insert_n_axis else tensor
        return cal._equateRanks(t, rank_eq)[..., None, :]   # (L',N?,j,k,J,1,M)

    def compact(t, with_n: bool):
        assert t.shape[0] == 1 and t.shape[4] == 1 and t.shape[5] == 1, t.shape
        if with_n:
            return torch.permute(t[0, :, :, :, 0, 0, :], (3, 1, 2, 0))
        return torch.movedim(t[0, 0, :, :, 0, 0, :], -1, 0)  # M leading

    arrays: List[Dict[str, torch.Tensor]] = []
    for fam_name, rank_eqs in _families_of(cal):
        for rank_eq in rank_eqs:
            a = compact(equate(om_mean, rank_eq, False), True)     # (M,j,k,N)
            v = compact(equate(om_var, rank_eq, True), False)      # (M,j,k)
            a_u = equate(up_mean, rank_eq, False)
            v_u = equate(up_var, rank_eq, True)
            e_up = compact(-0.5 * (a_u * a_u / v_u), True)          # (M,j,k,N)
            d_u = compact(torch.sqrt(v_u), False)                   # (M,j,k)
            assert a.shape[1] == dg.shape[0], (a.shape, dg.shape)   # j == L
            d = torch.sqrt(v) * d_u / dg.T[:, :, None]              # GG on j
            arrays.append({'a': a, 'v': v, 'e_up': e_up, 'd': d})
    return arrays


def _chunk_size(cal, n_members: int, n_cals: int = 1) -> int:
    """q-axis chunk size for ``n_cals`` calibrators swept together.
    meta['n_chunk'] overrides (0 = unchunked, the V-pass convention). The
    plain sweep holds ~3 live (N, L, L, chunk) planes per member plus the psi
    plane, exp temporaries included, and shrinks by the number of calibrators,
    so the device holds the planes of one. The kernel holds no plane, only
    its partial sums (``sweep_kernel.column_bytes``), so its chunk is every
    column that fits the budget, and on a mesh at most a rank's share."""
    explicit = cal.meta.get('n_chunk', None)
    if explicit is not None:
        return int(explicit) if explicit else cal.N
    L = cal.G.shape[0]
    if sweep_kernel.route(cal.G.device, cal.G.dtype) == 'kernel':
        per_col = sweep_kernel.column_bytes(n_cals, (n_members + 1) * L * L, len(KINDS), cal.M)
        chunk = cal.V_MEMORY_BUDGET_BYTES // per_col // sweep_kernel.BLOCK_COLS
        chunk = max(1, chunk) * sweep_kernel.BLOCK_COLS
        mesh = getattr(cal, 'gsa_mesh', None)
        if mesh is not None:
            chunk = min(chunk, -(-cal.N // mesh.size()))
        return int(min(cal.N, chunk))
    budget = cal.V_MEMORY_BUDGET_BYTES // cal.X.element_size()
    per_col = cal.N * L * L * 3 * (n_members + 1)
    chunk = int(min(cal.N, max(64, budget // max(per_col, 1))))
    return max(64, chunk // n_cals) if n_cals > 1 else chunk


# --------------------------------------------------------------------------- #
# The sweep
# --------------------------------------------------------------------------- #

def _prep(cal, kinds, prefix_full: bool) -> Dict[str, Any]:
    """Every per-dim array the sweeps consume: member params, per-kind
    emission-time weights, cumulative exponents and inverse determinants."""
    M = cal.M
    g = cal.g0KY[:, 0, :]                              # (L, N)
    mem = _member_arrays(cal)
    Gm = torch.movedim(cal.G[:, 0, :, :], -1, 0)       # (M, L, N)
    phi_m = torch.movedim(cal.Phi[:, 0, :], -1, 0)     # (M, L)
    # psi per-dim variance phi_l (1 - phi_l phi_i); G-divisor exponent.
    v_psi = phi_m[:, :, None] * (1.0 - phi_m[:, :, None] * phi_m[:, None, :])
    # Scaled-difference form of every sweep plane: the per-dim exponent
    # -(a - b)^2 / (2 v) is accumulated as a sum of d*d with d = a*s - b*s,
    # s = sqrt(0.5 / v) folded into the means outside the sweep.
    s_psi = torch.sqrt(0.5 / v_psi)                    # (M, L, L)
    eg = _cums(-0.5 * Gm * Gm / phi_m[..., None])      # (M, L, N) per kind
    # Per kind: q-side Omega weights g0KY * exp(-Egg) (the G-divisor
    # division, aligned on j), Upsilon exponent cums, inverse dets.
    gw = {k: g[None] * torch.exp(-eg[k]) for k in kinds}  # (M, L, N)
    eup = {k: [] for k in kinds}
    invd = {k: [] for k in kinds}
    for m in mem:
        dcum = _cums(torch.log(m['d']))
        for k in kinds:
            invd[k].append(torch.exp(-dcum[k]))
        ecum = _cums(m['e_up'])
        m['s'] = torch.sqrt(0.5 / m['v'])                 # (M, j, k)
        m['a_sc'] = m['a'] * m['s'][..., None]            # (M, j, k, N)
        for k in kinds:
            eup[k].append(ecum[k])
    invd_psi = {k: torch.exp(-_cums(torch.log(
        torch.sqrt(v_psi) / torch.sqrt(phi_m)[:, :, None]))[k]) for k in kinds}
    out = {'a_sc': tuple(m['a_sc'] for m in mem),
           's': tuple(m['s'] for m in mem),
           'eup': {k: tuple(eup[k]) for k in kinds},
           'invd': {k: tuple(invd[k]) for k in kinds},
           'invd_psi': invd_psi, 'gw': gw, 'g': g, 'g0q': cal.g0[:, 0, :],
           'Gm': Gm, 'phi_m': phi_m, 's_psi': s_psi}
    # Prefix-last mode keeps only each prefix per-dim array's final
    # (cumulative-over-all-dims) column.
    if not prefix_full:
        out['eup'] = {**out['eup'], 'prefix': tuple(e[M - 1:] for e in out['eup']['prefix'])}
        out['invd'] = {**out['invd'], 'prefix': tuple(d[M - 1:] for d in out['invd']['prefix'])}
        out['invd_psi'] = {**invd_psi, 'prefix': invd_psi['prefix'][M - 1:]}
        out['gw_prefix_last'] = gw['prefix'][M - 1]
    return out


def _run_chunk(C, layout, kinds, prefix_full: bool, q: slice) -> Dict[str, tuple]:
    """All sweeps for the q chunk ``q`` of the columns. Returns
    {kind: ([member quads (Mk, ...)], psi contributions (Mk, l, i, c))} with
    Mk = 1 for 'prefix' in prefix-last mode. Every big plane is laid out
    (j, k, N, c) / (l, i, N, c)."""
    R = len(layout)
    M = C['Gm'].shape[0]
    scan_kinds = tuple(k for k in kinds if k != 'prefix' or prefix_full)
    Gq = C['Gm'][:, :, q]                                # (M, L, c)
    gw_q = {k: C['gw'][k][:, :, q] for k in kinds}       # (M, L, c)
    g0q = C['g0q'][:, q]                                 # (L, c)

    def member_quad(spec_r, Eplane, gq_m):
        """Quadform of exp(Eplane): Eplane (j, k, N, c); the contraction
        covers N and c always, plus k when the member reduces to 'j'. N goes
        by a matrix-vector product on the plane's trailing (N, c) axes,
        which torch.einsum would first copy."""
        g = C['g']                                        # (L, N), aligned on p
        g = g[:, None, None, :] if spec_r['p'] == 'j' else g[None, :, None, :]
        col = (g @ torch.exp(Eplane))[..., 0, :]          # (j, k, c)
        return torch.einsum(f"jkC, jC -> {spec_r['out']}", col, gq_m)

    def member_quads(oms, eup_cols, gq):
        """Per-member quads (tuple of R) from per-member accumulations and eup
        columns (j, k, N). The accumulations are positive quadratic forms:
        the exponent is eup - P."""
        return tuple(member_quad(layout[r], eup_cols[r][..., None] - oms[r], gq)
                     for r in range(R))

    def psi_quad(pw, P_psi):
        """liC psi contribution from the POSITIVE quadratic plane P_psi
        (l,i,N,C): the exponent is ``-P_psi``. Only N is contracted."""
        return (pw[:, None, None, :] @ torch.exp(-P_psi))[..., 0, :] * g0q[None]

    def step(m, carry, emit_kinds, accumulated, ys):
        # Carries are POSITIVE quadratic accumulations (sum of d*d, the
        # exponent is their negation): 3 plane ops per dim per member.
        E_oms, E_psi = carry
        e_oms = []
        for r in range(R):
            d = C['a_sc'][r][m][..., None] - (Gq[m][:, None, None, :]
                                             * C['s'][r][m][..., None, None])
            e_oms.append(d * d)                                 # (j, k, N, c)
        E_oms = tuple(e if E is None else E + e for E, e in zip(E_oms, e_oms))
        sps = C['s_psi'][m]
        bp = (C['phi_m'][m][:, None, None] * Gq[m][None, :, :]) * sps[..., None]
        Gp = C['Gm'][m][:, None, :] * sps[..., None]            # (l, i, N)
        d_psi = Gp[..., None] - bp[:, :, None, :]               # (l, i, N, c)
        e_psi = d_psi * d_psi
        E_psi = e_psi if E_psi is None else E_psi + e_psi
        for k in emit_kinds:
            oms = E_oms if accumulated[k] else e_oms
            psi = E_psi if accumulated[k] else e_psi
            ys[k][m] = (member_quads(oms, [e[m] for e in C['eup'][k]], gw_q[k][m]),
                        psi_quad(C['gw'][k][m], psi))
        return E_oms, E_psi

    def sweep(dims, emit_kinds, accumulated):
        carry = ((None,) * R, None)
        ys = {k: [None] * M for k in emit_kinds}
        for m in dims:
            carry = step(m, carry, emit_kinds, accumulated, ys)
        out = {k: (tuple(torch.stack([y[0][r] for y in ys[k]]) for r in range(R)),
                   torch.stack([y[1] for y in ys[k]])) for k in emit_kinds}
        return carry, out

    def prefix_last(carry, out):
        # The carry after ALL dims IS the full-interval accumulation
        # (forward or reverse: addition order only); one plane exp and
        # contraction replace M of them.
        E_oms, E_psi = carry
        qp = member_quads(E_oms, [e[0] for e in C['eup']['prefix']], gw_q['prefix'][M - 1])
        pp = psi_quad(C['gw_prefix_last'], E_psi)
        return out | {'prefix': (tuple(q[None] for q in qp), pp[None])}

    if 'suffix' in kinds and not prefix_full:
        # Single-sweep mode: 'single' emissions are carry-free, so the
        # reverse (suffix) sweep emits them too, and its final carry is the
        # full-interval accumulation for the prefix-last column.
        emit = tuple(k for k in ('single', 'suffix') if k in scan_kinds)
        carry, out = sweep(reversed(range(M)), emit, {'single': False, 'suffix': True})
        return prefix_last(carry, out)
    fwd_kinds = tuple(k for k in ('single', 'prefix') if k in scan_kinds)
    carry, out = sweep(range(M), fwd_kinds, {'single': False, 'prefix': True})
    if not prefix_full:
        out = prefix_last(carry, out)
    if 'suffix' in kinds:
        _, out_b = sweep(reversed(range(M)), ('suffix',), {'suffix': True})
        out = out | out_b
    return out


def _planes(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-dim (M, j, k, N) arrays, one per plane group -> (sum of j k, M,
    N): one row of N per plane and dim, as the kernel reads them."""
    return torch.cat([torch.movedim(t, 0, 2).reshape(-1, t.shape[0], t.shape[-1])
                      for t in arrays])


def _pack(Cs: Sequence, layout, kinds, prefix_full: bool) -> Dict[str, Any]:
    """The kernel's inputs for the calibrators' preps ``Cs``, with a leading
    calibrator axis: per-plane row-side A and column-side Q exactly as
    ``_run_chunk``'s ``step`` forms them (member r's planes (j, k), k of
    size 1 where it reduces to 'j', then psi's (l, i)), the members'
    exponent offsets U and row weights W (g on the member's p axis), psi's
    row weights (gw per kind), and the prefix-last columns; the members'
    q-side weights and g0 stay with the host."""
    N = Cs[0]['Gm'].shape[2]
    scan = tuple(k for k in kinds if k != 'prefix' or prefix_full)

    def each(f):
        return torch.stack([f(C) for C in Cs])

    def g_on_p(C, spec, a):
        g = C['g'][:, None, :] if spec['p'] == 'j' else C['g'][None, :, :]
        return g.expand(a.shape).reshape(-1, N)

    members = {
        'A': each(lambda C: _planes(C['a_sc'])),
        'Q': each(lambda C: _planes([C['Gm'][:, :, None, :] * s[..., None] for s in C['s']])),
        'W': each(lambda C: torch.cat([g_on_p(C, spec, a[0])
                                       for spec, a in zip(layout, C['a_sc'])]))}
    psi = {
        'A': each(lambda C: _planes([C['Gm'][:, :, None, :] * C['s_psi'][..., None]])),
        'Q': each(lambda C: _planes([(C['phi_m'][:, :, None, None] * C['Gm'][:, None, :, :])
                                     * C['s_psi'][..., None]])),
        'W': each(lambda C: torch.stack([C['gw'][k] for k in scan]) if scan
                  else C['gw']['prefix'][:0])}
    # An offset broadcasts over the plane axes it lacks (MIXED's j), as in
    # _run_chunk's `eup - E`.
    if scan:
        members['U'] = each(lambda C: torch.stack([_planes([
            e.expand(e.shape[:1] + a.shape[1:]) for e, a in zip(C['eup'][k], C['a_sc'])])
            for k in scan]))
    if not prefix_full:
        members['UL'] = each(lambda C: torch.cat([e[-1].expand(a.shape[1:]).reshape(-1, N)
                                                  for e, a in zip(C['eup']['prefix'],
                                                                  C['a_sc'])]))
        psi['WL'] = each(lambda C: C['gw_prefix_last'])
    return {'members': members, 'psi': psi, 'scan': scan,
            'shapes': [tuple(a.shape[1:3]) for a in Cs[0]['a_sc']],
            'gw': {k: each(lambda C: C['gw'][k]) for k in kinds}, 'g0q': each(lambda C: C['g0q'])}


def _run_chunk_kernel(K, layout, kinds, prefix_full: bool, q: slice) -> Dict[str, tuple]:
    """``_run_chunk`` of every calibrator packed in ``K`` (:func:`_pack`) at
    once, on the fused kernel: the same results with a leading calibrator
    axis. The kernel gives each plane's row sums by column; the members'
    q-side weights and the psi columns' g0 are applied here, as
    ``member_quad`` and ``psi_quad`` apply them."""
    scan = K['scan']
    B, _, M, N = K['members']['A'].shape
    L = K['g0q'].shape[1]
    start = min(q.start or 0, N)
    stop = min(N if q.stop is None else q.stop, N)
    cols, c = slice(start, stop), stop - start
    if 'suffix' in kinds and not prefix_full:
        # Single-sweep mode, as in _run_chunk: the reverse sweep emits
        # 'single' and 'suffix', its final carry the prefix-last column.
        passes = [(True, 'single', 'suffix', True)]
    else:
        passes = [(False, 'single', 'prefix' if prefix_full else None, not prefix_full)]
        if 'suffix' in kinds:
            passes.append((True, None, 'suffix', False))
    passes = [(rev, scan.index(s) if s in scan else None, scan.index(a) if a in scan else None,
               last) for rev, s, a, last in passes]
    col_m, last_m = sweep_kernel.sweep(K['members'], start, c, passes)
    col_p, last_p = sweep_kernel.sweep(K['psi'], start, c, passes, psi_L=L)
    g0q = K['g0q'][:, None, None, :, cols]                    # (B, 1, 1, i, c)

    def quads(col, gq):
        """Member columns (B, Mk, planes, c) against q-side weights (B, Mk,
        j, c): each member's quads (B, Mk, j[, k])."""
        parts = torch.split(col, [j * k for j, k in K['shapes']], dim=2)
        return tuple(torch.einsum(f"bmjkC, bmjC -> bm{spec['out']}",
                                  part.reshape(part.shape[:2] + shape + part.shape[-1:]), gq)
                     for part, shape, spec in zip(parts, K['shapes'], layout))

    out = {k: (quads(col_m[:, i], K['gw'][k][..., cols]),
               col_p[:, i].reshape(B, M, L, L, c) * g0q) for i, k in enumerate(scan)}
    if not prefix_full:
        out['prefix'] = (quads(last_m[:, None], K['gw']['prefix'][:, M - 1:, :, cols]),
                         last_p.reshape(B, 1, L, L, c) * g0q)
    return out


def _stack(trees: Sequence):
    """Leaf-wise torch.stack of equal nested dicts/tuples of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: _stack([tree[key] for tree in trees]) for key in first}
    if isinstance(first, tuple):
        return tuple(_stack(list(leaves)) for leaves in zip(*trees))
    return torch.stack(list(trees))


def _unstack(tree, i: int):
    """Member i of a tree that _stack made."""
    if isinstance(tree, dict):
        return {key: _unstack(value, i) for key, value in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_unstack(value, i) for value in tree)
    return tree[i]


def error_scan(cal, need: Dict[str, bool]) -> Dict[str, Any]:
    """Run the factorized error sweep of one calibrator: error_scan_folds's."""
    return error_scan_folds([cal], need)[0]


def error_scan_folds(cals: Sequence, need: Dict[str, bool]) -> List[Dict[str, Any]]:
    """Run the factorized error sweep of one calibrator, or of several of one
    shape and meta together (each chunk step batched over them: vmapped on
    the CPU, the kernel's calibrator axis on a card).

    ``need`` flags which kinds to emit ('single'/'suffix'; 'prefix' always
    runs: its (0, M) column is the full-interval psi factor and MIXED-W
    source). Returns per calibrator {'layout', 'quads': {kind: [(M, j[, k])
    per member]}, 'psi': {kind: (M, l, i, N)}} with determinants applied and
    the psi factors K-solved, each against its own K_cho (reference
    calibrators.py:290-322 semantics). The automatic chunk is
    :func:`_chunk_size`'s; an explicit meta['n_chunk'] is kept. A CUDA
    float64 sweep runs on the fused kernel (``sweep_kernel.route``)."""
    cal = cals[0]
    kinds = tuple(k for k in KINDS if need.get(k) or k == 'prefix')
    # Per-dim prefix COLUMNS are consumed only by CLOSED-kind slices; when
    # none are requested, prefix is emitted once, from the final carry.
    prefix_full = bool(need.get('prefix'))
    layout = _member_layout(cal)
    N = cal.N
    chunk = _chunk_size(cal, len(layout), len(cals))
    Cs = [_prep(c, kinds, prefix_full) for c in cals]

    if sweep_kernel.route(cal.G.device, cal.G.dtype) == 'kernel':
        K = _pack(Cs, layout, kinds, prefix_full)

        def step(q: slice):
            out = _run_chunk_kernel(K, layout, kinds, prefix_full, q)
            return out if len(cals) > 1 else _unstack(out, 0)
    elif len(cals) == 1:
        def step(q: slice):
            return _run_chunk(Cs[0], layout, kinds, prefix_full, q)
    else:
        C = _stack(Cs)

        def step(q: slice):
            return torch.func.vmap(lambda C_: _run_chunk(C_, layout, kinds, prefix_full, q))(C)

    mesh = getattr(cal, 'gsa_mesh', None)
    if mesh is not None:
        # The chunks spread over the mesh's ranks (gsa/mesh.py), as romcomma_tpu's do.
        from romcomma_tpu_torch.gsa.mesh import error_sweep
        quads, psi = error_sweep(mesh, N, chunk, step, kinds)
    else:
        quads, psi_parts = None, {k: [] for k in kinds}
        for start in range(0, N, chunk):
            out = step(slice(start, start + chunk))
            quads = ({k: out[k][0] for k in kinds} if quads is None else
                     {k: tuple(q0 + q1 for q0, q1 in zip(quads[k], out[k][0]))
                      for k in kinds})
            for k in kinds:
                psi_parts[k].append(out[k][1])
        psi = {k: torch.cat(psi_parts[k], dim=-1) for k in kinds}

    # Determinants, then the K_cho solve of the psi factors, fold by fold.
    sweeps = []
    for i, (c, C) in enumerate(zip(cals, Cs)):
        quads_i, psi_i = (quads, psi) if len(cals) == 1 else (_unstack(quads, i), _unstack(psi, i))
        invd, invd_psi = C['invd'], C['invd_psi']
        sweeps.append({'layout': layout,
                       'quads': {k: tuple(q * (invd[k][r] if layout[r]['out'] == 'jk'
                                               else invd[k][r][..., 0])
                                          for r, q in enumerate(quads_i[k])) for k in kinds},
                       'psi': {k: _psi_solve(c.meta.get('psi_half_solver', c.K_cho),
                                             psi_i[k] * invd_psi[k][..., None])
                               for k in kinds}})
    return sweeps


def error_scan_stacked(cals: Sequence, need: Dict[str, bool]) -> List[Dict[str, Any]]:
    """ONE factorized error sweep for several independent single-output
    calibrators sharing X, the outputs of one large-route model
    (romcomma_tpu's ``error_scan_stacked``, ``factorized_errors.py:450``):
    each chunk step runs once for them all. Their group sweep is
    :func:`error_scan_folds`, the port's ``_error_scan_group`` (``:462``),
    which the folds' pass runs too; this adds romcomma_tpu's rules for
    outputs: L = 1 each, one (N, M), dtype and T mode. Returns one
    :func:`error_scan` result per calibrator."""
    first = cals[0]
    for c in cals:
        if c.G.shape[0] != 1 or c.G.shape != first.G.shape or c.G.dtype != first.G.dtype:
            raise ValueError('stacked error sweeps take single-output calibrators of one '
                             '(N, M) and dtype.')
        if bool(c.meta['is_T_partial']) != bool(first.meta['is_T_partial']):
            raise ValueError('stacked error sweeps take calibrators of one is_T_partial.')
    return error_scan_folds(cals, need)


def _psi_solve(K_cho, factor: torch.Tensor) -> torch.Tensor:
    """tri_solve(K_cho, factor (M, l, i, N)) with K_cho's batch axis aligned
    with ``i`` (reference _psi_contract), as ONE multi-RHS solve per K_cho[i].
    A callable K_cho is a half solver of its own (a mesh's, whose factor is
    spread over its ranks): the psi factors only meet again in quadforms
    over their last axis."""
    if callable(K_cho):
        return K_cho(factor)
    Mm, l, i, N = factor.shape
    if K_cho.ndim == 2:
        sol = tri_solve(K_cho, factor.reshape(Mm * l * i, N).T)   # (N, R)
        return sol.T.reshape(Mm, l, i, N)
    rhs = torch.permute(factor, (2, 3, 0, 1)).reshape(i, N, Mm * l)
    sol = tri_solve(K_cho, rhs)                                    # batch i
    return torch.permute(sol.reshape(i, N, Mm, l), (2, 3, 0, 1))


# --------------------------------------------------------------------------- #
# Assembly: W (and T) per slice from the sweep outputs
# --------------------------------------------------------------------------- #

def _mu_phi(cal, layout, quads_m) -> Dict[str, torch.Tensor]:
    """mu_phi_mu per family from one slice's member quads: the branch rules
    of the reference's ClosedSobolWithError._mu_phi_mu (calibrators.py:259-288)."""
    pref = cal.mu_phi_mu['pre-factor']
    out: Dict[str, torch.Tensor] = {}
    for spec, quad in zip(layout, quads_m):
        if spec['mixed']:
            mu = torch.einsum('k, jk -> jk', pref, quad)
            mu = _set_diag(mu, 2.0 * _diag_part(mu))
        elif spec['out'] == 'j':
            mu = torch.diag(torch.einsum('j, j -> j', pref, quad))
        else:
            mu = torch.einsum('k, jk -> jk', pref, quad)
        out[spec['family']] = out.get(spec['family'], 0.0) + mu
    return out


def _mu_psi(first: torch.Tensor, second: torch.Tensor, mixed: bool) -> torch.Tensor:
    """mu_psi_mu for one slice (reference calibrators.py:311-322): the
    quadform f1ᵀ K⁻¹ f2 from a pair of K_cho-half-solved factors. ``first``
    is the slice's own factor (DIAGONAL) or the full-interval factor taken
    on its output diagonal (MIXED); ``second`` is the slice's own factor."""
    ein = 'iin, lin -> li' if mixed else 'lin, lin -> li'
    r = torch.einsum(ein, first, second)
    return _set_diag(r, 2.0 * _diag_part(r))


def _w_of(cal, layout, quads_m, psi_m, full_first) -> Dict[str, torch.Tensor]:
    """W per family of one slice from its member quads and its psi factor."""
    out = {}
    for fam, mu in _mu_phi(cal, layout, quads_m).items():
        mixed = fam == 'MIXED'
        out[fam] = cal._W(mu, _mu_psi(full_first if mixed else psi_m, psi_m, mixed))
    return out


def _full_first(sweep) -> torch.Tensor:
    """The MIXED-family first factor: the full-interval (0, M) prefix column
    (the LAST emitted prefix column: index M-1 in a full prefix sweep, 0 in
    prefix-last mode)."""
    return sweep['psi']['prefix'][-1]


def _full_cache(cal, sweep) -> Dict[str, Any]:
    """The full-interval (0, M) error quantities from a sweep's prefix
    column: psi_factor, W per family, and Q/T in non-partial mode."""
    full_W = _w_of(cal, sweep['layout'], [q[-1] for q in sweep['quads']['prefix']],
                   sweep['psi']['prefix'][-1], _full_first(sweep))
    cache = {'psi_factor': sweep['psi']['prefix'][-1], 'W': full_W}
    if not cal.meta['is_T_partial']:
        Q = _diag_part(full_W['MIXED']) / (4.0 * cal.V[1] * cal.V[1])
        cache['Q'] = Q[None, ...] + Q[..., None] + 2.0 * torch.diag(Q)
        cache['T'] = cal._T_from(full_W['DIAGONAL'], cache['Q'], full_W['MIXED'], cal.V[0])
    return cache


def full_interval(cal) -> Dict[str, Any]:
    """Lazy backing of ClosedSobolWithError.psi_factor/W/Q/T."""
    return _full_cache(cal, error_scan(cal, {}))


def intervals(cal, slices, kinds_idx, V_cols):
    """W and T columns for classified canonical slices.

    ``kinds_idx`` = [('single'|'prefix'|'suffix'|'empty', idx)] aligned with
    ``slices``; ``V_cols`` are the V columns of the base pass (slice axis
    last), used by the non-partial T correction. Populates the calibrator's
    full-interval error cache as a side effect.
    """
    need = _need_of(cal, kinds_idx)
    return _assemble(cal, error_scan(cal, need), need, kinds_idx, V_cols)


def intervals_folds(cals: Sequence, slices, kinds_idx, V_cols: Sequence) -> List[Dict]:
    """:func:`intervals` of several calibrators of one shape and meta, their
    sweeps run together; ``V_cols`` holds each one's V columns."""
    need = _need_of(cals[0], kinds_idx)
    return [_assemble(cal, sweep, need, kinds_idx, V)
            for cal, sweep, V in zip(cals, error_scan_folds(cals, need), V_cols)]


def intervals_stacked(cals: Sequence, slices, kinds_idx, V_cols_list: Sequence) -> List[Dict]:
    """Multi-output :func:`intervals` (romcomma_tpu's, ``factorized_errors.py:800``):
    ONE stacked error sweep (:func:`error_scan_stacked`) for independent
    single-output calibrators sharing X, then each output's W/T assembly.
    ``V_cols_list`` holds each one's base-pass V columns, aligned with
    ``slices``. Returns one {'W', 'T'} per calibrator."""
    need = _need_of(cals[0], kinds_idx)
    return [_assemble(cal, sweep, need, kinds_idx, V)
            for cal, sweep, V in zip(cals, error_scan_stacked(cals, need), V_cols_list)]


def _need_of(cal, kinds_idx) -> Dict[str, bool]:
    need = {k: any(s[0] == k for s in kinds_idx) for k in KINDS}
    # A (0, M) full-interval slice classifies as ('prefix', M), but it is
    # served by the prefix-LAST column; per-dim prefix emission is only
    # needed for PROPER closed slices (idx < M).
    need['prefix'] = any(k == 'prefix' and idx < cal.M for k, idx in kinds_idx)
    return need


def _assemble(cal, sweep, need, kinds_idx, V_cols) -> Dict[str, torch.Tensor]:
    """W and T columns of one output from its sweep result; populates the
    calibrator's full-interval error cache as a side effect."""
    cache = _full_cache(cal, sweep)
    cal._full_error_cache = cache
    full_first = _full_first(sweep)
    L_out = cal.g0KY.shape[0]
    zero = torch.zeros((L_out, L_out), dtype=cal.G.dtype, device=cal.G.device)
    W_cols, T_cols = [], []
    for i, (kind, idx) in enumerate(kinds_idx):
        if kind == 'empty':
            W_cols.append(zero)
            T_cols.append(zero)
            continue
        if kind == 'prefix':
            m = idx - 1 if need['prefix'] else 0   # prefix-last: one column
        else:
            m = idx
        Ws = _w_of(cal, sweep['layout'], [q[m] for q in sweep['quads'][kind]],
                   sweep['psi'][kind][m], full_first)
        W_cols.append(Ws['DIAGONAL'])
        if cal.meta['is_T_partial']:
            T_cols.append(cal._T(Ws['DIAGONAL']))
        else:
            T_cols.append(cal._T_from(Ws['DIAGONAL'], cache['Q'], Ws['MIXED'], V_cols[..., i]))
    return {'W': torch.stack(W_cols, dim=-1), 'T': torch.stack(T_cols, dim=-1)}
