"""Free-network datum, scale bars and direct observations at scale (PyTorch
port of `bundle_adjustment_tpu/parallel/freenet.py`).

The dense bordered normal-equation matrix that holds scale-bar rows,
directly observed parameters and the Helmert inner-constraint rows cannot
exist at 100k..1M points.  This module folds all three into the
point-eliminated reduced camera system *exactly*, without breaking the
block-diagonal point elimination, so the kernels (K1-K3) stay as they are:

* **Scale bars** add rank-1 rows u_s over two points.  With
  Hpp' = Hpp + U^T W U, Woodbury gives

      S' = Hxx - Hxp Hpp'^{-1} Hpx = S_base + Z Cap^{-1} Z^T,
      Z = Hxp (Hpp^{-1} U^T),  Cap = W^{-1} + U Hpp^{-1} U^T,

  an exact dense correction of rank S to the implicit Schur matvec.

* **Inner constraints** (rows B over datum-point coordinates, normalised
  per row) enter as KKT multipliers; eliminating the points and then the
  multipliers yields

      (S' + Y Bb^{-1} Y^T) dx = r' + Y Bb^{-1} r_lam,
      Y = Hxp Hpp'^{-1} B^T,  Bb = B Hpp'^{-1} B^T,

  another exact correction of rank d <= 7.  lambda and the point step are
  recovered afterwards; B dx = 0 holds as in a bordered solve.

* **Direct observations** with diagonal weights are added by the
  lineariser into the block-diagonal structures (points -> Hpp / bp, EO ->
  extra_c / bc, IO and distortion -> extra_g / bg) before any elimination;
  a group with a fully populated dispersion over point coordinates joins
  the bars as one generalised row set.

The corrections are computed against the closures of `engine.PointOps`,
whose [P, 3] arguments are indexed by point id in either lane layout.
Plain functions on tensors; device and dtype follow the inputs.  Nothing
here reads a value back to the host: the small inverses are `inv_ex` /
`solve_ex` (no error check, no synchronisation), and the sums over rows
that share a point are taken in a fixed order (`_add_at`), so a step gives
the same bits on every run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..solver import tracing
from .engine import PointOps


class Extras(NamedTuple):
    """Correction data of one linearisation (tensors on the device)."""

    z0_full: torch.Tensor          # [P, 3] Hpp'^{-1} bp_full (stable form)
    rc: torch.Tensor               # corrected reduced rhs (cameras)
    rg: torch.Tensor               # corrected reduced rhs (globals)
    # generalised point-row set (Q = bars + direct-dispersion rows)
    u_idx: torch.Tensor | None     # [Q, 2] int64 point ids per slot
    u_val: torch.Tensor | None     # [Q, 2, 3] row values (+-unit / e_axis)
    v_val: torch.Tensor | None     # [Q, 2, 3] Hpp^{-1}-applied rows
    w_s: torch.Tensor | None       # [R] bar weights (bars only)
    w_sb: torch.Tensor | None      # [Q] misclosures (bars, then direct rows)
    Zc: torch.Tensor | None        # [Q, M, 6]
    Zg: torch.Tensor | None        # [Q, G]
    Cap_inv: torch.Tensor | None   # [Q, Q]
    # inner constraints (d rows)
    Brows: torch.Tensor | None     # [d, P, 3]
    Yc: torch.Tensor | None        # [d, M, 6]
    Yg: torch.Tensor | None        # [d, G]
    Bb_inv: torch.Tensor | None    # [d, d]
    r_lam: torch.Tensor | None     # [d]
    omega0: torch.Tensor = None    # Omega at the linearisation incl. extras
    Cap: torch.Tensor = None       # [Q, Q] (not inverted; wrap_precond)
    Bb: torch.Tensor = None        # [d, d] (not inverted; wrap_precond)
    Wu_inv: torch.Tensor = None    # [Q, Q] W^{-1} = blkdiag(1/w_bar, Sigma)
    # the 2Q slots that name the same point (`_add_at`)
    u_same: torch.Tensor = None    # [2Q, 2Q]
    # [Y; Z] stacked once per step, flattened over (cameras, globals), and
    # blkdiag(Bb^{-1}, Cap^{-1}): what `wrap_matvec` applies
    W: torch.Tensor = None         # [d + Q, 6M + G]
    C: torch.Tensor = None         # [d + Q, d + Q]


def datum_rows_dense(points, datum_mask, defect_flags):
    """Helmert inner-constraint rows as dense [d, P, 3] point-space
    vectors, normalised per row; None without a defect.  The centroid and
    the norms are taken over the datum points only (``datum_mask`` is zero
    for every other point, padded dummy points included)."""
    m = datum_mask.to(points.dtype)
    cnt = torch.sum(m)
    c = [torch.sum(points[:, a] * m) / cnt for a in range(3)]
    x, y, z = ((points[:, a] - c[a]) * m for a in range(3))
    zero = torch.zeros_like(x)

    tx, ty, tz, rx, ry, rz, s = defect_flags
    rows = []
    if tx:
        rows.append(torch.stack([m, zero, zero], dim=1))
    if ty:
        rows.append(torch.stack([zero, m, zero], dim=1))
    if tz:
        rows.append(torch.stack([zero, zero, m], dim=1))
    if rx:
        rows.append(torch.stack([zero, z, -y], dim=1))
    if ry:
        rows.append(torch.stack([-z, zero, x], dim=1))
    if rz:
        rows.append(torch.stack([y, -x, zero], dim=1))
    if s:
        rows.append(torch.stack([x, y, z], dim=1))
    if not rows:
        return None
    B = torch.stack(rows)  # [d, P, 3]
    norms = torch.sqrt(torch.sum(B * B, dim=(1, 2)))
    return B / norms[:, None, None]


def has_rows(a) -> bool:
    """An optional row set (bars, direct group) that is present."""
    return a is not None and a.shape[0] > 0


def _inv(a):
    """Inverse without the error check (and its host synchronisation) of
    `torch.linalg.inv`: a singular block gives non-finite entries."""
    return torch.linalg.inv_ex(a)[0]


def solve_vec(a, v):
    """a^{-1} v for a vector v, likewise without a host read."""
    return torch.linalg.solve_ex(a, v[:, None])[0][:, 0]


def _add_at(z, u_idx, u_same, val):
    """z [P, 3] with val [Q, 2, 3] added at the points u_idx [Q, 2], rows
    that share a point summed.  The sum over sharing slots is a small
    dense product (``u_same`` [2Q, 2Q] marks them), so every slot writes
    its point's whole value: the indexed assignment meets only equal
    values, and the result does not depend on the order of the writes (an
    atomic `index_add_` would)."""
    idx = u_idx.reshape(-1)
    return z.index_put((idx,), z[idx] + u_same @ val.reshape(-1, 3))


def _u_dot(u_idx, u_val, z):
    """(U z) [Q]: each generalised row against the point vectors z [P, 3]."""
    return (torch.sum(u_val[:, 0] * z[u_idx[:, 0]], dim=1)
            + torch.sum(u_val[:, 1] * z[u_idx[:, 1]], dim=1))


def _hxp_rows(ops: PointOps, rows):
    """`ops.hxp` of each of the k point vectors rows [k, P, 3]: ([k, M, 6],
    [k, G]).  One row at a time: batched over k, the per-observation
    temporaries of `hxp` would be k times as large (18 rows of [k, N])."""
    out = [ops.hxp(r) for r in rows]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def prepare_extras(problem, state, bp, rc, rg, ops: PointOps, omega0,
                   sb_misclosure=None, dpg_misclosure=None) -> Extras:
    """Build the exact low-rank corrections for the current linearisation.

    ``problem`` (`rcs.RCSProblem` of tensors) carries sb_a / sb_b /
    sb_length / sb_weight, dpg_idx / dpg_axis / dpg_val / dpg_cov,
    datum_mask_d / defect_flags_d (each or None) and free_point.  ``bp``
    is the base reduced-point rhs [P, 3]; ``rc`` / ``rg`` the base reduced
    rhs; ``omega0`` the base Omega at the linearisation point.
    ``sb_misclosure`` / ``dpg_misclosure``: optional overrides of the bar
    and direct-group misclosures.  The mixed-precision refiner passes
    f64-accurate values: length minus distance, and observed minus
    current, cancel catastrophically in f32 near convergence (the
    coefficients are condition-safe in f32, only the residuals are not).

    Scale bars and fully populated direct-observation groups over point
    coordinates are folded as ONE generalised low-rank row set: each row
    touches at most 2 points (bars: the two ends; direct rows: one point,
    second slot zero), with the weight W = blkdiag(diag(w_bar),
    dpg_cov^{-1}) entering only through Cap = W^{-1} + U Hpp^{-1} U^T: the
    populated dispersion is its own W^{-1} block and is never inverted.
    """
    p = problem
    P = p.num_points
    dtype, dev = bp.dtype, bp.device

    has_bars = has_rows(p.sb_a)
    has_dpg = has_rows(p.dpg_idx)
    flags = p.defect_flags_d
    d = sum(1 for f in flags if f) if flags is not None else 0

    u_idx = u_val = v_val = w_s = w_sb = Zc = Zg = Cap_inv = None
    Cap = Bb = Wu_inv = u_same = None
    Brows = Yc = Yg = Bb_inv = r_lam = None

    rows_idx, rows_val, winv_blocks, mis = [], [], [], []
    if has_bars:
        ia, ib = p.sb_a.long(), p.sb_b.long()
        dvec = state.points[ib] - state.points[ia]
        dist = torch.sqrt(torch.sum(dvec * dvec, dim=1))
        unit = dvec / dist[:, None]
        w_s = p.sb_weight.to(dtype)
        if sb_misclosure is None:
            w_bar = (p.sb_length - dist).to(dtype)
        else:
            w_bar = sb_misclosure.to(dtype)
        rows_idx.append(torch.stack([ia, ib], dim=1))
        rows_val.append(torch.stack([-unit * p.free_point[ia],
                                     unit * p.free_point[ib]], dim=1))
        winv_blocks.append(torch.diag(1.0 / w_s))
        mis.append(w_bar)
        omega0 = omega0 + torch.sum(w_s * w_bar * w_bar)

    if has_dpg:
        pt, ax = p.dpg_idx.long(), p.dpg_axis.long()
        cov = p.dpg_cov.to(dtype)                           # [n, n] = W^{-1}
        e = (torch.nn.functional.one_hot(ax, 3).to(dtype)
             * p.free_point[pt])                            # masked E rows
        if dpg_misclosure is None:
            cur = torch.gather(state.points[pt], 1, ax[:, None])[:, 0]
            w_d = (p.dpg_val - cur).to(dtype)
        else:
            w_d = dpg_misclosure.to(dtype)
        rows_idx.append(torch.stack([pt, pt], dim=1))
        rows_val.append(torch.stack([e, torch.zeros_like(e)], dim=1))
        winv_blocks.append(cov)
        mis.append(w_d)
        omega0 = omega0 + torch.dot(w_d, solve_vec(cov, w_d))

    any_rows = bool(rows_idx)
    if any_rows:
        u_idx = torch.cat(rows_idx)                         # [Q, 2]
        u_val = torch.cat(rows_val)                         # [Q, 2, 3]
        w_sb = torch.cat(mis)                               # [Q]
        Q = u_idx.shape[0]
        Wu_inv = torch.block_diag(*winv_blocks)
        flat = u_idx.reshape(-1)
        u_same = (flat[:, None] == flat[None, :]).to(dtype)  # [2Q, 2Q]

        # V = Hpp^{-1}-applied rows (same sparsity)
        v_val = torch.stack([
            torch.einsum("rab,rb->ra", ops.hinv_at(u_idx[:, 0]), u_val[:, 0]),
            torch.einsum("rab,rb->ra", ops.hinv_at(u_idx[:, 1]), u_val[:, 1]),
        ], dim=1)

        # Cap = W^{-1} + U Hpp^{-1} U^T (rows share points -> slot match)
        dots = torch.einsum("rlc,qmc->rlqm", u_val, v_val)
        gram = torch.sum(dots * u_same.reshape(Q, 2, Q, 2), dim=(1, 3))
        Cap = Wu_inv + gram
        Cap_inv = _inv(Cap)

        # Z = Hxp (Hpp^{-1} U^T): row r holds v_val[r] at its two points
        # (a direct row names one point twice, its second slot zero)
        Vrows = torch.zeros((Q, P, 3), dtype=dtype, device=dev)
        Vrows.index_put_(
            (torch.arange(Q, device=dev)[:, None].expand(Q, 2), u_idx),
            v_val, accumulate=True)
        Zc, Zg = _hxp_rows(ops, Vrows)                      # [Q, M, 6], [Q, G]
        del Vrows

    if d > 0:
        Brows = datum_rows_dense(state.points, p.datum_mask_d, flags)
        Vb = ops.hinv(Brows)                                # [d, P, 3]
        Ybc, Ybg = _hxp_rows(ops, Vb)                       # [d, M, 6], [d, G]
        BB = torch.einsum("kpa,qpa->kq", Brows, Vb)         # B Hpp^{-1} B^T

        if any_rows:
            # Xub[r, k] = U_r Hpp^{-1} B_k^T
            Xub = (torch.einsum("rc,krc->rk", u_val[:, 0],
                                Vb[:, u_idx[:, 0], :])
                   + torch.einsum("rc,krc->rk", u_val[:, 1],
                                  Vb[:, u_idx[:, 1], :]))
            CX = Cap_inv @ Xub                              # [Q, d]
            Yc = Ybc - torch.einsum("rk,rmc->kmc", CX, Zc)
            Yg = Ybg - torch.einsum("rk,rg->kg", CX, Zg)
            Bb = BB - Xub.T @ CX
        else:
            Yc, Yg = Ybc, Ybg
            Bb = BB
        Bb_inv = _inv(Bb)
        del Vb

    # ---- corrected reduced rhs (f32-stable small-rank form) -----------
    # Never materialise bp_full = bp + U^T W w: the weight-amplified
    # endpoint spikes exceed f32 resolution and Hpp^{-1} (norm up to ~1e4
    # for weakly conditioned points) blows the rounding into a point-step
    # error larger than the step.  Instead carry
    # z0_full = Hpp'^{-1} bp_full, exactly:
    #   Hpp'^{-1} U^T W w = V Cap^{-1} w  (Woodbury identity, any SPD W)
    #   z0_full = hinv(bp) + V Cap^{-1} (w - U hinv(bp))
    # Every operand is step-scaled, no cancelling large intermediates.
    z0 = ops.hinv(bp)
    if any_rows:
        coeff = Cap_inv @ (w_sb - _u_dot(u_idx, u_val, z0))
        z0_full = _add_at(z0, u_idx, u_same, v_val * coeff[:, None, None])
        # r' = bc - Hxp z0_full = rc_base - Zc coeff
        rc = rc - torch.einsum("rmc,r->mc", Zc, coeff)
        rg = rg - torch.einsum("rg,r->g", Zg, coeff)
    else:
        z0_full = z0

    if d > 0:
        # r_lam = B Hpp'^{-1} bp_full = B z0_full (stable: z0_full is
        # step-scaled, unlike the r_lam - Y^T x difference it replaces)
        r_lam = torch.einsum("kpa,pa->k", Brows, z0_full)
        br = Bb_inv @ r_lam
        rc = rc + torch.einsum("kmc,k->mc", Yc, br)
        rg = rg + torch.einsum("kg,k->g", Yg, br)

    # [Y; Z] and blkdiag(Bb^{-1}, Cap^{-1}) stacked once per step
    parts = [(Yc, Yg, Bb_inv)] if d > 0 else []
    if any_rows:
        parts.append((Zc, Zg, Cap_inv))
    W = C = None
    if parts:
        W = torch.cat([torch.cat([c.reshape(c.shape[0], -1), g], dim=1)
                       for c, g, _ in parts]).contiguous()
        C = torch.block_diag(*(ci for _, _, ci in parts))

    return Extras(z0_full=z0_full, rc=rc, rg=rg,
                  u_idx=u_idx, u_val=u_val, v_val=v_val, w_s=w_s, w_sb=w_sb,
                  Zc=Zc, Zg=Zg, Cap_inv=Cap_inv,
                  Brows=Brows, Yc=Yc, Yg=Yg, Bb_inv=Bb_inv, r_lam=r_lam,
                  omega0=omega0, Cap=Cap, Bb=Bb, Wu_inv=Wu_inv,
                  u_same=u_same, W=W, C=C)


def _flat(xc, xg):
    return torch.cat([xc.reshape(-1), xg])


def wrap_matvec(base_matvec, ext: Extras):
    """S_tot @ x = S_base @ x + Z Cap^{-1} Z^T x + Y Bb^{-1} Y^T x, the
    two corrections as one pair of small products with the stacked
    ``ext.W`` = [Y; Z]: (W^T (C (W x)))."""
    if ext.W is None:
        return base_matvec
    W, C = ext.W, ext.C

    def matvec(xc, xg):
        oc, og = base_matvec(xc, xg)
        corr = (C @ (W @ _flat(xc, xg))) @ W
        k = oc.numel()
        return oc + corr[:k].reshape(oc.shape), og + corr[k:]

    return matvec


def wrap_precond(apply_M, ext: Extras):
    """Low-rank-corrected preconditioner apply: the exact Woodbury fold of
    the corrections into the base preconditioner.

    The datum and bar corrections W^T C W (W = [Y; Z], C =
    blkdiag(Bb^{-1}, Cap^{-1})) carry the observation weight scale: their
    spectrum can sit orders of magnitude above S's typical eigenvalues,
    and a base preconditioner that ignores them leaves CG with a condition
    number that f32 does not survive (the f32 free-network step error
    exceeded the step itself).  Woodbury restores exactness on the
    correction subspace at the cost of q = d + Q base applies at set-up
    and two [q, 6M + G] products and one [q, q] product per CG iteration:

        (M + W^T C W)^{-1} = M^{-1} - M^{-1} W^T A^{-1} W M^{-1},
        A = C^{-1} + W M^{-1} W^T,  C^{-1} = blkdiag(Bb, Cap).
    """
    if ext.W is None:
        return apply_M
    W = ext.W
    blocks = ([ext.Bb] if ext.Yc is not None else []) \
        + ([ext.Cap] if ext.Zc is not None else [])
    k = ext.rc.numel()
    MW = torch.stack([
        _flat(*apply_M(w[:k].reshape(ext.rc.shape), w[k:])) for w in W])
    A_inv = _inv(torch.block_diag(*blocks) + W @ MW.T)

    def apply_full(rc_, rg_):
        zc, zg = apply_M(rc_, rg_)
        corr = (A_inv @ (W @ _flat(zc, zg))) @ MW
        return zc - corr[:k].reshape(zc.shape), zg - corr[k:]

    return apply_full


def _hinv_rows(ext: Extras, ops: PointOps, y):
    """Hpp'^{-1} y including the Woodbury correction of the generalised
    rows (bars + direct-dispersion rows)."""
    z = ops.hinv(y)
    if ext.Zc is not None:
        s = ext.Cap_inv @ _u_dot(ext.u_idx, ext.u_val, z)
        z = _add_at(z, ext.u_idx, ext.u_same, -ext.v_val * s[:, None, None])
    return z


@tracing.traced("back_substitute")
def back_substitute(problem, ext: Extras, ops: PointOps, xc, xg):
    """Recover (dx_p [P, 3], lambda [d] or None) after the reduced solve.

    The multiplier comes from the UNCONSTRAINED point step, Bb lam =
    B dxp0 with dxp0 = Hpp'^{-1} (bp_full - Hpx x): algebraically equal to
    lam = Bb^{-1} (r_lam - Y^T x) but stable in f32.  r_lam - Y^T x
    differences two large weight-scaled terms and Bb^{-1} amplifies the
    cancellation noise (a point-step error 10x the step itself); B dxp0
    contracts small operands directly.  dxp0 reuses the stable z0_full =
    Hpp'^{-1} bp_full of `prepare_extras`."""
    dxp0 = ext.z0_full - _hinv_rows(ext, ops, ops.hpx(xc, xg))
    if ext.Yc is None:
        return dxp0, None
    lam = ext.Bb_inv @ torch.einsum("kpa,pa->k", ext.Brows, dxp0)
    corr = _hinv_rows(ext, ops, torch.einsum("kpa,k->pa", ext.Brows, lam))
    return dxp0 - corr, lam


def omega_extras(problem, ext: Extras, dxp):
    """The generalised rows' (bars + direct-dispersion rows) share of
    Omega(dx) at the linearisation point: v = w - A dx, Omega += v^T W v
    with W = Wu_inv^{-1}, applied as a [Q] solve."""
    if ext.u_val is None:
        return 0.0
    v = ext.w_sb - _u_dot(ext.u_idx, ext.u_val, dxp)
    return torch.dot(v, solve_vec(ext.Wu_inv, v))
