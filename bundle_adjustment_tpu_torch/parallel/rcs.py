"""Reduced camera system pieces of the large-scale solver (PyTorch port of
`bundle_adjustment_tpu/parallel/rcs.py`, the subset the feature-major
engine uses): the problem container, the blocked image layout, the
(coupled) block preconditioner, PCG on the implicit Schur complement and
the state update.

Eliminating the points from the bundle normal equations gives the reduced
system over x = (cameras, globals)

    S x = rhs,   S = Hxx - Hxp Hpp^{-1} Hpx,   rhs = bx - Hxp Hpp^{-1} bp

whose product is computed implicitly from per-observation rows
(`engine.schur_matvec`, or the K1 kernel) and solved by PCG.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.problem import ParamState
from ..ops.residuals import image_weight_2x2


class RCSProblem(NamedTuple):
    """Static arrays of the large-scale problem: numpy arrays on the host
    (as `synthetic.build_problem` returns them) or tensors on a device
    (`convert.problem_to_torch`).  Datum: fixed coordinates (free_* masks).
    """

    obs_point: object      # [N] int32
    obs_image: object      # [N] int32
    obs_xy: object         # [N, 2]
    obs_weight: object     # [N, 2, 2] (already includes validity mask)
    r0: object             # [C]
    num_points: int
    num_images: int
    free_point: object     # [P, 3] 1.0 = free, 0.0 = fixed
    free_eo: object        # [M, 6]
    free_global: object    # [G] with G = C * (3 + K)
    # blocked image-reduction layout: permutation into image-sorted order
    # padded per image to a multiple of IMG_BLOCK (pad entries == N)
    img_perm: object = None         # [Nip] int32
    img_block_starts: object = None  # [M+1] int32 (block units)
    # uniform views per point in point-major order (static int)
    point_uniform: int | None = None
    # camera of each image (None: every image on camera 0, C = 1 only)
    cam_of_image: object = None     # [M] int32
    # ---- free-network extensions (parallel/freenet.py) ----
    # scale bars: rank-1 rows over two points, folded into the reduced
    # system by Woodbury
    sb_a: object = None       # [S] int32
    sb_b: object = None       # [S] int32
    sb_length: object = None  # [S]
    sb_weight: object = None  # [S] sigma0^2 / sigma_s^2
    # Helmert inner constraints
    datum_mask_d: object = None          # [P] 1.0 = datum point
    defect_flags_d: tuple | None = None  # 7 bools (tx ty tz rx ry rz s)
    # directly observed parameters with diagonal weights; weight 0 = not
    # observed
    dp_w: object = None    # [P, 3]
    dp_val: object = None  # [P, 3]
    de_w: object = None    # [M, 6]
    de_val: object = None  # [M, 6]
    dg_w: object = None    # [G]
    dg_val: object = None  # [G]
    # directly observed point coordinates with a fully populated
    # dispersion: n coordinates (point, axis) with the cofactor block
    # dpg_cov = Sigma / sigma0^2 = W^{-1}, folded as exact low-rank rows
    dpg_idx: object = None   # [n] int32 point ids
    dpg_axis: object = None  # [n] int32 axis (0/1/2)
    dpg_val: object = None   # [n] observed values
    dpg_cov: object = None   # [n, n]

    @property
    def has_extras(self) -> bool:
        """Scale bars, inner constraints or a populated direct group
        present (the `engine.lm_step_full` route)."""
        return ((self.sb_a is not None and int(self.sb_a.shape[0]) > 0)
                or (self.defect_flags_d is not None
                    and any(self.defect_flags_d))
                or (self.dpg_idx is not None
                    and int(self.dpg_idx.shape[0]) > 0))


#: block size of the image-sorted blocked reduction
IMG_BLOCK = 512


def build_image_block_layout(obs_image, num_images, block=IMG_BLOCK):
    """Host-side: permutation into image-sorted order with per-image padding
    to a multiple of ``block``; returns (img_perm [Nip], img_block_starts
    [M+1] in block units), both int32 numpy."""
    obs_image = np.asarray(obs_image)
    N = obs_image.shape[0]
    order = np.argsort(obs_image, kind="stable")
    counts = np.bincount(obs_image, minlength=num_images)
    padded = ((counts + block - 1) // block) * block
    starts = np.concatenate([[0], np.cumsum(padded)])
    perm = np.full(int(starts[-1]), N, np.int32)
    src = 0
    for m in range(num_images):
        c = int(counts[m])
        perm[starts[m]:starts[m] + c] = order[src:src + c]
        src += c
    return perm, (starts // block).astype(np.int32)


class PointMajor(NamedTuple):
    """The uniform point-major layout of observations given in any order
    (`point_major_layout`): entry e = point * views + view."""

    src: np.ndarray   # [P * V] int64 the observation entry e takes, -1 none
    live: np.ndarray  # [P * V] bool: one of the point's own observations
    views: int        # V

    def gather(self, a, fill):
        """a [N, ...] in the observations' order -> [P * V, ...] in the
        layout's; ``fill`` where a point has no observation at all."""
        a = np.asarray(a)
        seen = (self.src >= 0).reshape((-1,) + (1,) * (a.ndim - 1))
        return np.where(seen, a[np.maximum(self.src, 0)], fill)


def point_major_layout(obs_point, num_points) -> PointMajor:
    """The layout the feature-major engine reads, for observations of
    points ``obs_point`` [N] in any order: V = the most views any point
    has (at least 1), each point's own observations first, in their
    order, then pad entries that repeat its first observation (none for
    a point no image sees).  The callers give pad entries zero weight."""
    obs_point = np.asarray(obs_point, np.int64)
    P = int(num_points)
    counts = np.bincount(obs_point, minlength=P)
    V = max(int(counts.max()) if counts.size else 0, 1)
    order = np.argsort(obs_point, kind="stable")
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    view = np.arange(obs_point.shape[0]) - first[obs_point[order]]
    src = np.full((P, V), -1, np.int64)
    src[obs_point[order], view] = order
    real = src >= 0
    fill = np.where(counts > 0, src[:, 0], -1)
    src = np.where(real, src, fill[:, None]).reshape(-1)
    return PointMajor(src=src, live=real.reshape(-1), views=V)


def rcs_from_problem(bp, device, dtype=torch.float64) -> RCSProblem:
    """The tensor RCSProblem of a compiled dense `models.problem.BundleProblem`
    on ``device``, in the layout the feature-major engine reads: observations
    point-major with a uniform V = the most views any point has, each point's
    own observations first (in their order), then zero-weight pad rows that
    repeat its first observation (image 0 at (0, 0) for a point no image
    sees); and the blocked image layout.  Zero weights null every pad row's
    contribution, so the sums are those of the observations alone.

    Carried over as in the JAX `rcs.rcs_from_problem`: scale bars, the
    inner-constraint datum (``datum_mask_d`` = the problem's datum points,
    its defect flags) and every direct observation: diagonal weights fold
    into dp / de / dg; a group with a fully populated dispersion over point
    coordinates becomes dpg rows.  A populated dispersion over IO / EO /
    distortion parameters raises ValueError, as in the reference."""
    P, M, C = bp.num_points, bp.num_images, bp.num_cameras
    K = bp.spec.num_coefficients

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def flt(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device,
                               dtype=dtype)

    pm = point_major_layout(bp.obs_point, P)
    obs_image = pm.gather(bp.obs_image, 0).astype(np.int32)
    var = flt(pm.gather(bp.obs_var, 1.0))
    w2 = image_weight_2x2(var[:, 0], var[:, 1],
                          flt(pm.gather(bp.obs_rho, 0.0)), bp.sigma2_apriori)
    w2 = w2 * flt(pm.live)[:, None, None]
    img_perm, img_bstarts = build_image_block_layout(obs_image, M)
    V = pm.views

    free_global = np.concatenate(
        [np.concatenate([bp.col_io[c] >= 0, bp.col_dist[c] >= 0])
         for c in range(C)]).astype(np.float64)
    fields = {}
    if bp.num_scale_bars:
        fields.update(sb_a=idx(bp.sb_a), sb_b=idx(bp.sb_b),
                      sb_length=flt(bp.sb_length),
                      sb_weight=flt(bp.sigma2_apriori / bp.sb_var))
    if bp.defect > 0:
        fields.update(datum_mask_d=flt(bp.datum_mask),
                      defect_flags_d=tuple(bool(f) for f in bp.defect_flags))
    if bp.direct_groups:
        fields.update(_direct_fields(bp, C, K, idx, flt))

    return RCSProblem(
        obs_point=idx(np.repeat(np.arange(P), V)), obs_image=idx(obs_image),
        obs_xy=flt(pm.gather(bp.obs_xy, 0.0)), obs_weight=w2, r0=flt(bp.r0),
        num_points=P, num_images=M,
        free_point=flt(bp.col_points >= 0), free_eo=flt(bp.col_eo >= 0),
        free_global=flt(free_global),
        img_perm=idx(img_perm), img_block_starts=idx(img_bstarts),
        point_uniform=V, cam_of_image=idx(bp.cam_of_image), **fields)


def _direct_fields(bp, C, K, idx, flt) -> dict:
    """dp / de / dg (diagonal weights) and dpg (populated point groups) of
    a BundleProblem's direct groups."""
    G = C * (3 + K)
    dp_w, dp_val = np.zeros((bp.num_points, 3)), np.zeros((bp.num_points, 3))
    de_w, de_val = np.zeros((bp.num_images, 6)), np.zeros((bp.num_images, 6))
    dg_w, dg_val = np.zeros(G), np.zeros(G)
    dpg_idx, dpg_axis, dpg_val, dpg_cov = [], [], [], []
    for dg in bp.direct_groups:
        if not dg.diagonal:
            if not (dg.kind == 0).all():
                raise ValueError(
                    "fully populated direct-observation dispersion over "
                    "IO/EO/distortion parameters is the dense solver's "
                    "domain (DirectlyObservedParameterGroup.java:67-92); "
                    "at scale only point-coordinate groups are supported")
            # weight = sigma0^2 Sigma^{-1}; freenet takes W^{-1}
            dpg_idx.append(dg.flat // 3)
            dpg_axis.append(dg.flat % 3)
            dpg_val.append(dg.values)
            dpg_cov.append(np.linalg.inv(dg.weight))
            continue
        for kind, flat, wv, val in zip(dg.kind, dg.flat,
                                       np.diagonal(dg.weight), dg.values):
            if kind == 0:
                dp_w.flat[flat] += wv
                dp_val.flat[flat] = val
            elif kind == 3:
                de_w.flat[flat] += wv
                de_val.flat[flat] = val
            elif kind == 1:  # io: per-camera global slot
                c, k = divmod(int(flat), 3)
                dg_w[c * (3 + K) + k] += wv
                dg_val[c * (3 + K) + k] = val
            else:  # dist
                c, k = divmod(int(flat), K)
                dg_w[c * (3 + K) + 3 + k] += wv
                dg_val[c * (3 + K) + 3 + k] = val
    out = {}
    if dp_w.any():
        out.update(dp_w=flt(dp_w), dp_val=flt(dp_val))
    if de_w.any():
        out.update(de_w=flt(de_w), de_val=flt(de_val))
    if dg_w.any():
        out.update(dg_w=flt(dg_w), dg_val=flt(dg_val))
    if dpg_idx:
        n = sum(len(i) for i in dpg_idx)
        cov = np.zeros((n, n))
        o = 0
        for blk in dpg_cov:
            cov[o:o + blk.shape[0], o:o + blk.shape[0]] = blk
            o += blk.shape[0]
        out.update(dpg_idx=idx(np.concatenate(dpg_idx)),
                   dpg_axis=idx(np.concatenate(dpg_axis)),
                   dpg_val=flt(np.concatenate(dpg_val)), dpg_cov=flt(cov))
    return out


class Precond(NamedTuple):
    """Block preconditioner of the reduced system: exact 6x6 camera blocks
    plus the exact global block.  With ``Scg``/``W``/``Sghat_inv`` set, it
    also carries the exact camera-global blocks and is applied exactly via
    a Schur complement on the small global block:

        u  = D^{-1} rc
        zg = (Sgg - Scg^T D^{-1} Scg)^{-1} (rg - Scg^T u)
        zc = u - (D^{-1} Scg) zg
    """

    Minv_c: torch.Tensor                  # [M, 6, 6]
    Minv_g: torch.Tensor                  # [G, G]
    Scg: torch.Tensor | None = None       # [M, 6, G]
    W: torch.Tensor | None = None         # [M, 6, G]  (= D^{-1} Scg)
    Sghat_inv: torch.Tensor | None = None  # [G, G]


def finish_coupling(Minv: Precond, Scg, Sgg) -> Precond:
    """Complete a coupled `Precond` from the exact Scg [M, 6, G] and Sgg
    [G, G] blocks: W = D^{-1} Scg and the inverse of the global Schur
    complement Sghat = Sgg - Scg^T D^{-1} Scg."""
    W = torch.einsum("mab,mbg->mag", Minv.Minv_c, Scg)
    corr = torch.einsum("mag,mah->gh", Scg, W)
    return Minv._replace(Scg=Scg, W=W,
                         Sghat_inv=torch.linalg.inv_ex(Sgg - corr)[0])


def make_apply_M(Minv: Precond):
    """Preconditioner apply (zc, zg) = M^{-1} (rc, rg) of a `Precond`:
    the exact coupled form when it carries Scg, else block-diagonal.  An
    apply that is already a callable (`freenet.wrap_precond`) passes
    through."""
    if callable(Minv):
        return Minv
    if Minv.Scg is not None:
        def apply_M(rc_, rg_):
            u = torch.einsum("mab,mb->ma", Minv.Minv_c, rc_)
            zg = Minv.Sghat_inv @ (
                rg_ - torch.einsum("mag,ma->g", Minv.Scg, u))
            zc = u - torch.einsum("mag,g->ma", Minv.W, zg)
            return zc, zg
    else:
        def apply_M(rc_, rg_):
            return (torch.einsum("mab,mb->ma", Minv.Minv_c, rc_),
                    Minv.Minv_g @ rg_)
    return apply_M


def pcg(rc, rg, Minv, matvec, tol=1e-10, maxiter=200, stall_limit=None):
    """Preconditioned CG on the implicit reduced system.

    ``matvec(xc, xg) -> (Sc, Sg)`` is the implicit Schur product;
    ``Minv`` a `Precond` or a callable apply (rc, rg) -> (zc, zg).
    Returns the best-residual iterate (long f32 runs can wander past the
    rounding floor) and the iteration count.  ``stall_limit``: stop once
    no iteration in a window of this many improves the best residual by
    >= 10%; default 8 for f32, disabled for f64.  Where no iterate
    lowers |r|_2 below the first residual, the best iterate is the zero
    start.

    The loop runs on the host and reads the residual norm once per
    iteration (one device synchronisation each)."""
    apply_M = make_apply_M(Minv)

    def dot(ac, ag, bc_, bg_):
        return torch.sum(ac * bc_) + torch.sum(ag * bg_)

    if stall_limit is None:
        stall_limit = 8 if rc.dtype == torch.float32 else maxiter + 1
    xc = torch.zeros_like(rc)
    xg = torch.zeros_like(rg)
    bxc, bxg = xc, xg
    zc, zg = apply_M(rc, rg)
    pc, pg = zc, zg
    rz = dot(rc, rg, zc, zg)
    r0norm = float(torch.sqrt(dot(rc, rg, rc, rg)))
    rnorm = best = r0norm
    stall = it = 0
    while it < maxiter and stall < stall_limit and rnorm > tol * (1.0 + r0norm):
        qc, qg = matvec(pc, pg)
        alpha = rz / dot(pc, pg, qc, qg)
        xc = xc + alpha * pc
        xg = xg + alpha * pg
        rc = rc - alpha * qc
        rg = rg - alpha * qg
        zc, zg = apply_M(rc, rg)
        rz_new = dot(rc, rg, zc, zg)
        beta = rz_new / rz
        pc = zc + beta * pc
        pg = zg + beta * pg
        rz = rz_new
        rnorm = float(torch.sqrt(dot(rc, rg, rc, rg)))
        if rnorm < best:
            bxc, bxg = xc, xg
        stall = 0 if rnorm < 0.9 * best else stall + 1
        best = min(best, rnorm)
        it += 1
    return bxc, bxg, it


def apply_step(state: ParamState, dxp, dxc, dxg):
    """x <- x + dx with the global vector split back into (io, dist);
    returns (state, max|dx|) with max|dx| a 0-d tensor."""
    C = state.io.shape[0]
    K = state.dist.shape[1]
    g = dxg.reshape(C, 3 + K)
    mdx = torch.max(torch.stack([dxp.abs().max(), dxc.abs().max(),
                                 dxg.abs().max()]))
    return ParamState(points=state.points + dxp, io=state.io + g[:, :3],
                      dist=state.dist + g[:, 3:], eo=state.eo + dxc), mdx
