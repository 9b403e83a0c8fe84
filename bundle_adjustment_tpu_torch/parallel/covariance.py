"""Posterior covariance blocks on demand at scale (PyTorch port of
`bundle_adjustment_tpu/parallel/covariance.py`).

At 1e5..1e6 points the full dispersion Qxx cannot be materialised.  With
the point-eliminated factorisation, selected blocks are recovered exactly:

    Q_cam       = S^{-1}                       (reduced camera system)
    Qpp[p]      = Hpp^{-1}[p] + C_p^T S^{-1} C_p
    Qpp[p, q]   =              C_p^T S^{-1} C_q        (cross-point block)
    C_p         = Hxp[:, p] Hpp^{-1}[p]   in R^{(6M+G) x 3}

C_p has nonzero camera rows only for images observing p; S^{-1} C_p is
computed matrix-free by batched PCG on the implicit reduced system: no S
and no Qxx is formed.

Two engines, picked by the problem's type:
* an `engine.FMProblem` with its `engine.FMBlocks` (the feature-major
  engine, point-major layout): C_p from the V observation lanes of each
  selected point (the compact rows of a multi-camera network included),
  the matvec `engine.schur_matvec` with a leading right-hand-side axis;
* an `rcs.RCSProblem` with its `rcs.Blocks` (the block-layout engine, any
  layout, as the JAX module takes): C_p from each selected point's own
  observations (its segment of the point order), the matvec
  `rcs.schur_matvec`.
The preconditioner rule is one for both (`prepare`): the coupled block
preconditioner (camera blocks, global block, the exact camera-global
blocks; the feature-major engine assembles them in `engine.prepare(...,
couple_global=True)`, the block layout recovers them through G unit
matvecs, `rcs.couple_preconditioner`, as JAX does); only the iteration
counts may differ from JAX's.  The coupled form drops the camera-camera
blocks, and its global Schur complement can be indefinite (camera rigs,
ROADMAP Queue 3), where PCG has no convergence guarantee: `prepare` then
falls back to the positive definite camera and global blocks alone
(block Jacobi).

Every function takes (p, b, Minv) from `prepare` below (damping 0) and runs
in the dtype of its inputs; run it in f64 (the f32 reduced system is
indefinite at 100k points).  Scale bars, an inner-constraint datum or a
populated direct group (``p.has_extras``) raise NotImplementedError: the
reduced system here carries none of them, so its S would be that of
another (on a free network, singular) system.
"""

from __future__ import annotations

import numpy as np
import torch

from . import engine, rcs

#: bytes of [..., N] temporaries one batched matvec may hold (~40 rows per
#: right-hand side); the rhs axis is chunked to stay within it
MATVEC_BYTES = 2.0e9


def _refuse_extras(p) -> None:
    if p.has_extras:
        raise NotImplementedError(
            "covariance blocks on demand have no branch for scale bars, an "
            "inner-constraint datum or a populated direct group")


def _block_layout(p) -> bool:
    """True for an `rcs.RCSProblem` (the block-layout engine), False for
    an `engine.FMProblem`."""
    if isinstance(p, rcs.RCSProblem):
        return True
    if isinstance(p, engine.FMProblem):
        return False
    raise TypeError(f"an engine.FMProblem or rcs.RCSProblem, not {type(p)}")


def prepare(p, state, spec):
    """(blocks, Precond) at damping 0: the linearisation the covariance
    functions read, of the engine of ``p``'s type (`engine.prepare` with
    couple_global, or `rcs.prepare` and `rcs.couple_preconditioner`; both
    set the blocks' extra_c).  The Precond is the coupled one where its
    global Schur complement is positive definite, else block Jacobi."""
    _refuse_extras(p)
    if _block_layout(p):
        b, _rc, _rg, Minv = rcs.prepare(p, state, spec, 0.0)
        Minv = rcs.couple_preconditioner(
            lambda c, g: rcs.schur_matvec(p, b, c, g), Minv, p.num_images,
            b.Jg.shape[2])
    else:
        b, _rc, _rg, Minv = engine.prepare(p, state, spec, 0.0,
                                           couple_global=True)
    return b, rcs.definite_coupling(Minv)


def _global_rows_at(p: engine.FMProblem, b: engine.FMBlocks, lanes):
    """The masked global rows Jg [2G, L] at the lanes ``lanes`` [L] (the
    compact rows materialised at those lanes only)."""
    if b.Jg is not None:
        return torch.stack([r[lanes] for r in b.Jg])
    Gp = len(b.Jg_loc) // 2
    C = p.free_global.shape[0] // Gp
    sel = (b.cam_obs[lanes][None, :] == torch.arange(
        C, device=lanes.device)[:, None]).to(b.Jp[0].dtype)      # [C, L]
    loc = torch.stack([r[lanes] for r in b.Jg_loc]).reshape(2, 1, Gp, -1)
    fg = p.free_global.reshape(1, C, Gp, 1)
    return (loc * sel[None, :, None, :] * fg).reshape(2 * C * Gp, -1)


def _hinv_at(b, ids):
    """The selected points' Hpp^{-1} blocks [k, 3, 3], either engine."""
    if isinstance(b, rcs.Blocks):
        return b.Hpp_inv[ids]
    h = [r[ids] for r in b.Hpp_inv]
    return torch.stack([torch.stack([h[0], h[1], h[2]], dim=1),
                        torch.stack([h[1], h[3], h[4]], dim=1),
                        torch.stack([h[2], h[4], h[5]], dim=1)], dim=1)


def _coupling_columns(p, b, point_ids):
    """C[k] = Hxp[:, p_k] Hpp^{-1}[p_k] for the selected points, dense over
    the reduced axis: returns (Cc [k, M, 6, 3], Cg [k, G, 3])."""
    if _block_layout(p):
        return _coupling_columns_blocks(p, b, point_ids)
    ids = torch.as_tensor(point_ids, device=b.Jp[0].device).long()
    k, V, M = ids.shape[0], p.views, p.num_images
    lanes = engine.point_lanes(p, ids).reshape(-1)                # [k V]

    def at(rows):
        return torch.stack([r[lanes] for r in rows])              # [., kV]

    Jc, PJp = at(b.Jc), at(b.PJp)
    Jg = _global_rows_at(p, b, lanes)
    G = Jg.shape[0] // 2
    # per-observation Hcp = Jc^T P Jp [kV, 6, 3] and Hgp [kV, G, 3]
    Hcp = torch.einsum("en,an->nea", Jc[:6], PJp[:3]) \
        + torch.einsum("en,an->nea", Jc[6:], PJp[3:])
    Hgp = torch.einsum("gn,an->nga", Jg[:G], PJp[:3]) \
        + torch.einsum("gn,an->nga", Jg[G:], PJp[3:])
    # camera rows: Cc[j, m] = sum over point j's views with image m, as a
    # product with the [k, V, M] image one-hot (fixed order, no atomics)
    img = p.obs_image.long()[lanes].reshape(k, V)
    oh = (img[:, :, None] == torch.arange(M, device=ids.device)).to(Hcp.dtype)
    Cc = torch.einsum("kvm,kvea->kmea", oh, Hcp.reshape(k, V, 6, 3))
    Cg = Hgp.reshape(k, V, G, 3).sum(dim=1)
    Hinv = _hinv_at(b, ids)
    Cc = torch.einsum("kmab,kbc->kmac", Cc, Hinv)
    Cg = torch.einsum("kab,kbc->kac", Cg, Hinv)
    return Cc, Cg


def _coupling_columns_blocks(p: rcs.RCSProblem, b: rcs.Blocks, point_ids):
    """`_coupling_columns` on the block layout: each selected point's own
    observations (its segment of the point order, padded to the most
    views among them with masked entries), the camera rows by a product
    with their image one-hot (fixed order, no atomics)."""
    ids = torch.as_tensor(point_ids, device=b.Jp.device).long()
    order, counts = rcs.point_segments(p)
    starts = torch.cumsum(counts, 0) - counts
    n = counts[ids]
    L = max(int(n.max()), 1)
    j = torch.arange(L, device=ids.device)
    live = j[None, :] < n[:, None]                              # [k, L]
    obs = order[torch.where(live, starts[ids][:, None] + j, 0)]
    mask = live.to(b.Jp.dtype)
    Jp, Jc, Jg = (b.PJp[obs], b.Jc[obs], b.Jg[obs])             # [k, L, 2, .]
    Hcp = torch.einsum("klie,klia->klea", Jc, Jp)               # [k, L, 6, 3]
    Hgp = torch.einsum("klig,klia->klga", Jg, Jp)               # [k, L, G, 3]
    oh = (p.obs_image.long()[obs][:, :, None]
          == torch.arange(p.num_images, device=ids.device)).to(mask.dtype)
    Cc = torch.einsum("klm,klea->kmea", oh * mask[:, :, None], Hcp)
    Cg = torch.einsum("kl,klga->kga", mask, Hgp)
    Hinv = _hinv_at(b, ids)
    return (torch.einsum("kmab,kbc->kmac", Cc, Hinv),
            torch.einsum("kab,kbc->kac", Cg, Hinv))


def _matvec(p, b):
    """The implicit S @ x of ``p``'s engine over a leading rhs axis."""
    if _block_layout(p):
        return lambda xc, xg: rcs.schur_matvec(p, b, xc, xg)
    N = b.Jp[0].shape[0]

    def matvec(xc, xg):
        # chunked over the rhs axis: [r, N] temporaries within MATVEC_BYTES
        chunk = max(1, int(MATVEC_BYTES / (40 * N * xc.element_size())))
        outs = [engine.schur_matvec(p, b, xc[i:i + chunk], xg[i:i + chunk])
                for i in range(0, xc.shape[0], chunk)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    return matvec


def _apply_M_multi(Minv: rcs.Precond):
    """Preconditioner apply over a leading rhs axis."""
    if Minv.Scg is not None:
        def apply_M(rc_, rg_):
            u = torch.einsum("mab,rmb->rma", Minv.Minv_c, rc_)
            zg = torch.einsum(
                "gh,rh->rg", Minv.Sghat_inv,
                rg_ - torch.einsum("mag,rma->rg", Minv.Scg, u))
            zc = u - torch.einsum("mag,rg->rma", Minv.W, zg)
            return zc, zg
    else:
        def apply_M(rc_, rg_):
            return (torch.einsum("mab,rmb->rma", Minv.Minv_c, rc_),
                    torch.einsum("gh,rh->rg", Minv.Minv_g, rg_))
    return apply_M


def _pcg_multi(p, b, Rc, Rg, Minv, tol=1e-8, maxiter=400):
    """Batched PCG: solve S X = R for R right-hand sides at once.

    Rc [R, M, 6], Rg [R, G]; each rhs runs its own CG (per-rhs alpha and
    beta) through the engine's implicit matvec over the rhs axis
    (`_matvec`; the feature-major one chunked so that its [r, N]
    temporaries stay within `MATVEC_BYTES`).  ``Minv`` a `rcs.Precond`.
    Stops when every rhs has |r| <= tol (1 + |r0|) or after ``maxiter``
    iterations; one host read per iteration.  Returns (Xc, Xg,
    iterations)."""
    matvec = _matvec(p, b)
    apply_M = _apply_M_multi(Minv)

    def dot(ac, ag, bc, bg):  # per-rhs inner products [R]
        return (ac * bc).sum(dim=(1, 2)) + (ag * bg).sum(dim=1)

    xc = torch.zeros_like(Rc)
    xg = torch.zeros_like(Rg)
    rc, rg = Rc, Rg
    zc, zg = apply_M(rc, rg)
    pc, pg = zc, zg
    rz = dot(rc, rg, zc, zg)
    limit = tol * (1.0 + torch.sqrt(dot(rc, rg, rc, rg)))
    it = 0
    while it < maxiter and bool(
            (torch.sqrt(dot(rc, rg, rc, rg)) > limit).any()):
        qc, qg = matvec(pc, pg)
        denom = dot(pc, pg, qc, qg)
        alpha = torch.where(denom != 0, rz / denom, torch.zeros_like(rz))
        xc = xc + alpha[:, None, None] * pc
        xg = xg + alpha[:, None] * pg
        rc = rc - alpha[:, None, None] * qc
        rg = rg - alpha[:, None] * qg
        zc, zg = apply_M(rc, rg)
        rz_new = dot(rc, rg, zc, zg)
        beta = torch.where(rz != 0, rz_new / rz, torch.zeros_like(rz))
        pc = zc + beta[:, None, None] * pc
        pg = zg + beta[:, None] * pg
        rz = rz_new
        it += 1
    return xc, xg, it


def _solve_columns(p, b, Minv, Cc, Cg, tol, maxiter, stats):
    """X = S^{-1} C for coupling columns Cc [k, M, 6, 3], Cg [k, G, 3]:
    3 rhs per point.  Returns (Xc [k, M, 6, 3], Xg [k, G, 3])."""
    k, M = Cc.shape[:2]
    Rc = Cc.permute(0, 3, 1, 2).reshape(3 * k, M, 6)
    Rg = Cg.permute(0, 2, 1).reshape(3 * k, -1)
    Xc, Xg, it = _pcg_multi(p, b, Rc, Rg, Minv, tol=tol, maxiter=maxiter)
    if stats is not None:
        stats["iterations"] = it
    return (Xc.reshape(k, 3, M, 6).permute(0, 2, 3, 1),
            Xg.reshape(k, 3, -1).permute(0, 2, 1))


def point_covariance_blocks(p, b, Minv: rcs.Precond, point_ids, tol=1e-8,
                            maxiter=400, stats: dict | None = None):
    """Exact 3x3 posterior cofactor blocks of the selected points: returns
    Q [k, 3, 3] (unscaled cofactor; multiply by the a-posteriori variance
    of unit weight for the dispersion).  ``b``, ``Minv``: from `prepare`.
    ``stats``: a dict that receives the PCG iteration count."""
    _refuse_extras(p)
    Cc, Cg = _coupling_columns(p, b, point_ids)
    Xc, Xg = _solve_columns(p, b, Minv, Cc, Cg, tol, maxiter, stats)
    corr = (torch.einsum("kmab,kmac->kbc", Cc, Xc)
            + torch.einsum("kab,kac->kbc", Cg, Xg))
    ids = torch.as_tensor(point_ids, device=Cc.device).long()
    return _hinv_at(b, ids) + corr


def point_pair_covariance_blocks(p, b, Minv: rcs.Precond, pairs, tol=1e-8,
                                 maxiter=400, stats: dict | None = None):
    """Exact 3x3 cross-point posterior cofactor blocks Q[p, q] =
    C_p^T S^{-1} C_q for the given (p, q) pairs [k, 2] (p != q: Hpp is
    block diagonal, so there is no direct term).  Returns [k, 3, 3]."""
    _refuse_extras(p)
    pairs = np.asarray(pairs)
    Cp_c, Cp_g = _coupling_columns(p, b, pairs[:, 0])
    Cq_c, Cq_g = _coupling_columns(p, b, pairs[:, 1])
    Xc, Xg = _solve_columns(p, b, Minv, Cq_c, Cq_g, tol, maxiter, stats)
    return (torch.einsum("kmab,kmac->kbc", Cp_c, Xc)
            + torch.einsum("kab,kac->kbc", Cp_g, Xg))


def camera_covariance_blocks(p, b, Minv: rcs.Precond, image_ids, tol=1e-8,
                             maxiter=400, stats: dict | None = None):
    """Exact 6x6 posterior cofactor blocks of the selected images' EO: the
    rows of S^{-1} at each image's 6 columns, by unit right-hand sides.
    Returns [k, 6, 6]."""
    _refuse_extras(p)
    ids = torch.as_tensor(np.asarray(image_ids),
                          device=b.Jp[0].device).long()
    k, M = ids.shape[0], p.num_images
    Rc = b.Jp[0].new_zeros((k, 6, M, 6))
    i6 = torch.arange(6, device=ids.device)
    Rc[torch.arange(k, device=ids.device)[:, None], i6[None, :],
       ids[:, None], i6[None, :]] = 1.0
    Rc = Rc.reshape(6 * k, M, 6)
    Rg = b.Jp[0].new_zeros((6 * k, p.free_global.shape[0]))
    Xc, _, it = _pcg_multi(p, b, Rc, Rg, Minv, tol=tol, maxiter=maxiter)
    if stats is not None:
        stats["iterations"] = it
    # each image's own 6x6 diagonal block, never the [k, 6, k, 6] product
    return Xc.reshape(k, 6, M, 6)[torch.arange(k, device=ids.device), :,
                                  ids, :]
