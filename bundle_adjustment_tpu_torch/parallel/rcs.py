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


class RCSProblem(NamedTuple):
    """Static arrays of the large-scale problem: numpy arrays on the host
    (as `synthetic.build_problem` returns them) or tensors on a device
    (`convert.problem_to_torch`).  Datum: fixed coordinates (free_* masks).
    """

    obs_point: object      # [N] int32
    obs_image: object      # [N] int32
    obs_xy: object         # [N, 2]
    obs_weight: object     # [N, 2, 2] (already includes validity mask)
    r0: object             # [C] (the port takes C = 1)
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
    the exact coupled form when it carries Scg, else block-diagonal."""
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

    ``matvec(xc, xg) -> (Sc, Sg)`` is the implicit Schur product.
    Returns the best-residual iterate (long f32 runs can wander past the
    rounding floor) and the iteration count.  ``stall_limit``: stop once
    no iteration in a window of this many improves the best residual by
    >= 10%; default 8 for f32, disabled for f64.

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
