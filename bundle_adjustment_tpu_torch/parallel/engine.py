"""Feature-major RCS engine (PyTorch port of
`bundle_adjustment_tpu/parallel/engine.py`, single-camera scale path).

Every per-observation quantity is a feature row of length N.  Reductions:

  per point : uniform point-major reshape [P, V] (or the view-major blocked
              order [P/pb, V, pb]) -> sum over views
  per image : static permutation to image-sorted order (pad row N), 512-row
              block sums, cumsum-diff over block boundaries
  global    : plain row sums / small matrix products

``lm_step(use_kernels=True)`` runs the hand-written CUDA kernels of
`kernels.py` for CUDA tensors (K3 camera gather, K2 fused assembly, K1
Schur matvec); for CPU tensors the same wrappers take their plain
PyTorch versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.problem import ParamState
from . import rcs


class FMProblem(NamedTuple):
    """Feature-major problem tensors (static per adjustment)."""

    obs_image: torch.Tensor   # [N] int32
    obs_x: torch.Tensor       # [N]
    obs_y: torch.Tensor       # [N]
    wxx: torch.Tensor         # [N]  2x2 weight rows (sigma0^2 Sigma^{-1})
    wxy: torch.Tensor         # [N]
    wyy: torch.Tensor         # [N]
    r0: torch.Tensor          # [C]
    num_points: int
    num_images: int
    views: int                # uniform views per point
    free_point: torch.Tensor  # [3, P] rows
    free_eo: torch.Tensor     # [M, 6]
    free_global: torch.Tensor  # [G]
    img_perm: torch.Tensor    # [Nip] int32 (pad entries == N)
    img_block_starts: torch.Tensor  # [M+1] int32 (block units)
    # view-major blocked lane layout (the kernels' layout): lane =
    # i*vm_pb*V + v*vm_pb + p for point i*vm_pb + p; None = point-major
    vm_pb: int | None = None


class FMBlocks(NamedTuple):
    """Linearisation in feature rows.  J*/PJ* are tuples of [N] rows."""

    Jp: tuple        # 6 rows: (i, a) for i in (x,y), a in (X,Y,Z)
    PJp: tuple       # 6 rows
    Jc: tuple        # 12 rows: (i, a) over EO
    PJc: tuple       # 12 rows
    Jg: tuple        # 2G rows: (i, g) over IO+distortion
    PJg: tuple       # 2G rows
    w: tuple         # 2 rows (misclosure)
    Pw: tuple        # 2 rows
    Hpp_inv: tuple   # 6 rows [P]: symmetric 3x3 inverse (00,01,02,11,12,22)
    bp: tuple        # 3 rows [P]
    bc: torch.Tensor | None       # [M, 6]
    bg: torch.Tensor              # [G]
    extra_c: torch.Tensor | None  # [M, 6]
    extra_g: torch.Tensor         # [G]
    omega0: torch.Tensor          # scalar


def fm_problem(p: rcs.RCSProblem) -> FMProblem:
    """Convert a tensor RCSProblem (`convert.problem_to_torch`; uniform
    point-major layout and blocked image layout required)."""
    if p.point_uniform is None:
        raise ValueError("engine requires the uniform point-major layout")
    if p.img_perm is None:
        raise ValueError("engine requires the blocked image layout")
    w = p.obs_weight
    return FMProblem(
        obs_image=p.obs_image,
        obs_x=p.obs_xy[:, 0].contiguous(), obs_y=p.obs_xy[:, 1].contiguous(),
        wxx=w[:, 0, 0].contiguous(), wxy=w[:, 0, 1].contiguous(),
        wyy=w[:, 1, 1].contiguous(),
        r0=p.r0, num_points=p.num_points, num_images=p.num_images,
        views=p.point_uniform,
        free_point=p.free_point.T.contiguous(),
        free_eo=p.free_eo, free_global=p.free_global,
        img_perm=p.img_perm, img_block_starts=p.img_block_starts,
    )


def pad_problem(problem: rcs.RCSProblem, state: ParamState,
                multiple: int = 128):
    """Pad the point count to a multiple of ``multiple`` with zero-weight
    dummy points (tensor RCSProblem).

    Dummy points copy point 0's coordinates (finite geometry, so their
    rows are finite; zero weights null every contribution) and are marked
    fixed, so Hpp gets a unit diagonal and dx stays 0.
    Returns (padded RCSProblem, padded ParamState, P_original)."""
    P = problem.num_points
    V = problem.point_uniform
    if V is None:
        raise ValueError("pad_problem requires the uniform point-major layout")
    P_pad = -(-P // multiple) * multiple
    if P_pad == P:
        return problem, state, P
    extra = P_pad - P
    n_extra = extra * V
    dt = problem.obs_xy.dtype
    dev = problem.obs_xy.device
    i32 = torch.int32
    obs_point = torch.cat([problem.obs_point, torch.repeat_interleave(
        torch.arange(P, P_pad, dtype=i32, device=dev), V)])
    obs_image = torch.cat([problem.obs_image,
                           torch.zeros(n_extra, dtype=i32, device=dev)])
    obs_xy = torch.cat([problem.obs_xy,
                        torch.zeros((n_extra, 2), dtype=dt, device=dev)])
    obs_weight = torch.cat([problem.obs_weight,
                            torch.zeros((n_extra, 2, 2), dtype=dt, device=dev)])
    free_point = torch.cat([problem.free_point,
                            torch.zeros((extra, 3), dtype=dt, device=dev)])
    img_perm, img_bs = rcs.build_image_block_layout(
        obs_image.cpu().numpy(), problem.num_images)
    problem = problem._replace(
        obs_point=obs_point, obs_image=obs_image, obs_xy=obs_xy,
        obs_weight=obs_weight, free_point=free_point, num_points=P_pad,
        img_perm=torch.as_tensor(img_perm, device=dev),
        img_block_starts=torch.as_tensor(img_bs, device=dev))
    state = state._replace(points=torch.cat(
        [state.points, state.points[:1].expand(extra, 3)]))
    return problem, state, P


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _point_sum(p: FMProblem, row):
    """[N] -> [P] over the uniform views (layout-aware)."""
    if p.vm_pb is None:
        return row.reshape(p.num_points, p.views).sum(dim=1)
    nb = p.num_points // p.vm_pb
    return row.reshape(nb, p.views, p.vm_pb).sum(dim=1).reshape(-1)


def _point_expand(p: FMProblem, col):
    """[P] -> [N] broadcast over views (layout-aware)."""
    if p.vm_pb is None:
        return col[:, None].expand(p.num_points, p.views).reshape(-1)
    nb = p.num_points // p.vm_pb
    return col.reshape(nb, 1, p.vm_pb).expand(
        nb, p.views, p.vm_pb).reshape(-1)


def view_major_perm(P: int, V: int, pb: int) -> np.ndarray:
    """perm[new_lane] = point-major index: new order (block, view, p_local)."""
    nblocks = P // pb
    i = np.arange(nblocks)[:, None, None]
    v = np.arange(V)[None, :, None]
    q = np.arange(pb)[None, None, :]
    return ((i * pb + q) * V + v).reshape(-1)


def to_view_major(p: FMProblem, pb: int) -> FMProblem:
    """Re-lay the observation axis into the view-major blocked order the
    kernels consume (see FMProblem.vm_pb).  One-time host cost; all engine
    reductions stay exact (same sums, permuted order).  Requires
    pb | num_points (pad_problem first)."""
    if p.vm_pb is not None:
        if p.vm_pb != pb:
            raise ValueError(f"already view-major with pb={p.vm_pb}")
        return p
    if p.num_points % pb != 0:
        raise ValueError(f"pb={pb} must divide num_points={p.num_points}; "
                         "use pad_problem")
    dev = p.obs_x.device
    perm = view_major_perm(p.num_points, p.views, pb)
    obs_image = p.obs_image.cpu().numpy()[perm]
    img_perm, img_bs = rcs.build_image_block_layout(obs_image, p.num_images)
    perm_t = torch.as_tensor(perm, device=dev)

    def g(a):
        return a[perm_t].contiguous()

    return p._replace(
        obs_image=torch.as_tensor(obs_image, device=dev),
        obs_x=g(p.obs_x), obs_y=g(p.obs_y),
        wxx=g(p.wxx), wxy=g(p.wxy), wyy=g(p.wyy),
        img_perm=torch.as_tensor(img_perm, device=dev),
        img_block_starts=torch.as_tensor(img_bs, device=dev),
        vm_pb=pb,
    )


def _image_sum_stack(p: FMProblem, rows):
    """Per-image sums of F feature rows: returns [M, F].  One row gather
    into image-sorted order + 512-block sums + cumsum-diff (the numerics
    of the reference's blocked image reduction)."""
    x = torch.stack(rows, dim=1)  # [N, F]
    xp = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    xi = xp[p.img_perm.long()]  # [Nip, F]
    nb = xi.shape[0] // rcs.IMG_BLOCK
    bl = xi.reshape(nb, rcs.IMG_BLOCK, -1).sum(dim=1)
    cs = torch.cat([bl.new_zeros((1, bl.shape[1])), torch.cumsum(bl, dim=0)])
    bs = p.img_block_starts.long()
    return cs[bs[1:]] - cs[bs[:-1]]


def _sym3_inverse(m00, m01, m02, m11, m12, m22):
    """Closed-form symmetric 3x3 inverse rows (adjugate / det)."""
    i00 = m11 * m22 - m12 * m12
    i01 = m02 * m12 - m01 * m22
    i02 = m01 * m12 - m02 * m11
    i11 = m00 * m22 - m02 * m02
    i12 = m01 * m02 - m00 * m12
    i22 = m00 * m11 - m01 * m01
    det = m00 * i00 + m01 * i01 + m02 * i02
    inv_det = 1.0 / det
    return (i00 * inv_det, i01 * inv_det, i02 * inv_det,
            i11 * inv_det, i12 * inv_det, i22 * inv_det)


def _hinv_apply(H, a0, a1, a2):
    """(6-row symmetric 3x3) @ [3] rows."""
    h00, h01, h02, h11, h12, h22 = H
    return (h00 * a0 + h01 * a1 + h02 * a2,
            h01 * a0 + h11 * a1 + h12 * a2,
            h02 * a0 + h12 * a1 + h22 * a2)


# ---------------------------------------------------------------------------
# linearisation
# ---------------------------------------------------------------------------

def _gather_rows(p: FMProblem, tbl, ncols, cam_gather=None):
    """tbl [M, c] -> ``ncols`` rows [N] of tbl[obs_image]."""
    if cam_gather is not None:
        rows = cam_gather(tbl)
        return [rows[a] for a in range(ncols)]
    idx = p.obs_image.long()
    return [tbl[:, a][idx] for a in range(ncols)]


def linearize(p: FMProblem, state: ParamState, spec, damping,
              state_lo: ParamState | None = None,
              cam_gather=None) -> FMBlocks:
    """Jacobian rows, misclosures, point blocks and global diagonal at
    ``state`` (single camera).  ``cam_gather``: optional
    fn(tbl [M, c<=8]) -> [8, N] replacing the per-row gathers (the K3
    wrapper, `kernels.make_cam_gather`).  ``state_lo``: low-order part of
    a two-float state (see ops.fm.project_rows)."""
    from ..ops import fm

    if state.io.shape[0] != 1:
        raise NotImplementedError("the port takes single-camera problems")
    pts = state.points
    X = _point_expand(p, pts[:, 0])
    Y = _point_expand(p, pts[:, 1])
    Z = _point_expand(p, pts[:, 2])
    eog = _gather_rows(p, state.eo, 6, cam_gather)

    lo = None
    if state_lo is not None:
        lo = tuple(_point_expand(p, state_lo.points[:, a]) for a in range(3))
        lo = lo + tuple(_gather_rows(p, state_lo.eo[:, :3], 3, cam_gather))

    K = state.dist.shape[1]
    G = 3 + K
    iog = [state.io[0, a].expand_as(X) for a in range(3)]
    cg = [state.dist[0, k].expand_as(X) for k in range(K)]
    r0 = p.r0[0].expand_as(X)

    rows_x, rows_y, pred_x, pred_y = fm.jacobian_rows(
        X, Y, Z, iog[0], iog[1], iog[2],
        eog[0], eog[1], eog[2], eog[3], eog[4], eog[5], cg, spec, r0, lo=lo)
    w0 = p.obs_x - pred_x
    w1 = p.obs_y - pred_y

    # fixed-parameter masks
    fp = [_point_expand(p, p.free_point[a]) for a in range(3)]
    fe = _gather_rows(p, p.free_eo, 6, cam_gather)

    Jp = tuple(rows_x[a] * fp[a] for a in range(3)) \
        + tuple(rows_y[a] * fp[a] for a in range(3))
    Jc = tuple(rows_x[6 + a] * fe[a] for a in range(6)) \
        + tuple(rows_y[6 + a] * fe[a] for a in range(6))

    # global rows [x0 y0 c dist...]; x0 / y0 identity entries in slots 0/1
    one = torch.ones_like(X)
    zero = torch.zeros_like(X)
    gx = [one, zero, rows_x[5]] + [rows_x[12 + k] for k in range(K)]
    gy = [zero, one, rows_y[5]] + [rows_y[12 + k] for k in range(K)]

    # weight application: PJ = W2x2 J (correlated x/y,
    # PartialDerivativeFactory.java:313-319)
    def apply_w(rows):
        n = len(rows) // 2
        return tuple(p.wxx * rows[a] + p.wxy * rows[n + a] for a in range(n)) \
            + tuple(p.wxy * rows[a] + p.wyy * rows[n + a] for a in range(n))

    fg = p.free_global
    Jg = tuple(gx[g] * fg[g] for g in range(G)) \
        + tuple(gy[g] * fg[g] for g in range(G))
    PJg = apply_w(Jg)
    PJp = apply_w(Jp)
    PJc = apply_w(Jc)
    Pw = (p.wxx * w0 + p.wxy * w1, p.wxy * w0 + p.wyy * w1)
    omega0 = torch.sum(w0 * Pw[0] + w1 * Pw[1])

    def hpp(a, b):
        return _point_sum(p, Jp[a] * PJp[b] + Jp[3 + a] * PJp[3 + b])

    m00, m01, m02 = hpp(0, 0), hpp(0, 1), hpp(0, 2)
    m11, m12, m22 = hpp(1, 1), hpp(1, 2), hpp(2, 2)
    fpc = p.free_point
    e0 = damping * m00 + (1.0 - fpc[0])
    e1 = damping * m11 + (1.0 - fpc[1])
    e2 = damping * m22 + (1.0 - fpc[2])
    bp = tuple(_point_sum(p, Jp[a] * Pw[0] + Jp[3 + a] * Pw[1])
               for a in range(3))
    Hpp_inv = _sym3_inverse(m00 + e0, m01, m02, m11 + e1, m12, m22 + e2)

    Hgg_diag = torch.stack([torch.sum(Jg[g] * PJg[g] + Jg[G + g] * PJg[G + g])
                            for g in range(G)])
    bg = torch.stack([torch.sum(Jg[g] * Pw[0] + Jg[G + g] * Pw[1])
                      for g in range(G)])
    extra_g = damping * Hgg_diag + (1.0 - fg)
    return FMBlocks(Jp=Jp, PJp=PJp, Jc=Jc, PJc=PJc, Jg=Jg, PJg=PJg,
                    w=(w0, w1), Pw=Pw, Hpp_inv=Hpp_inv, bp=bp,
                    bc=None, bg=bg, extra_c=None, extra_g=extra_g,
                    omega0=omega0)


# ---------------------------------------------------------------------------
# reduced system
# ---------------------------------------------------------------------------

def _t_rows(p: FMProblem, b: FMBlocks, xc, xg, cam_gather=None):
    """t = P (Jc xc + Jg xg) per observation: 2 rows [N]."""
    xcg = _gather_rows(p, xc, 6, cam_gather)
    G2 = len(b.Jg) // 2
    t = []
    for i in (0, 1):
        acc = 0.0
        for a in range(6):
            acc = acc + b.PJc[i * 6 + a] * xcg[a]
        for g in range(G2):
            acc = acc + b.PJg[i * G2 + g] * xg[g]
        t.append(acc)
    return t


def _point_solve_expand(p: FMProblem, b: FMBlocks, t):
    """z = Hpp^{-1} Jp^T t per point, expanded back to observations."""
    y = [_point_sum(p, b.Jp[a] * t[0] + b.Jp[3 + a] * t[1]) for a in range(3)]
    z = _hinv_apply(b.Hpp_inv, *y)
    return [_point_expand(p, z[a]) for a in range(3)]


def schur_matvec(p: FMProblem, b: FMBlocks, xc, xg):
    """Implicit S @ [xc; xg], feature-major: returns ([M, 6], [G])."""
    t = _t_rows(p, b, xc, xg)
    zo = _point_solve_expand(p, b, t)
    tv = []
    for i in (0, 1):
        u = sum(b.PJp[i * 3 + a] * zo[a] for a in range(3))
        tv.append(t[i] - u)
    qc = [b.Jc[a] * tv[0] + b.Jc[6 + a] * tv[1] for a in range(6)]
    G2 = len(b.Jg) // 2
    og = torch.stack([torch.sum(b.Jg[g] * tv[0] + b.Jg[G2 + g] * tv[1])
                      for g in range(G2)])
    oc = _image_sum_stack(p, qc)
    return oc + b.extra_c * xc, og + b.extra_g * xg


def prepare(p: FMProblem, state: ParamState, spec, damping,
            couple_global: bool = False,
            state_lo: ParamState | None = None):
    """Linearise + build rhs and the (camera, global) block preconditioner.
    Returns (blocks, rc, rg, rcs.Precond)."""
    b = linearize(p, state, spec, damping, state_lo=state_lo)
    return reduce_blocks(p, b, state, damping, couple_global=couple_global)


def reduce_blocks(p: FMProblem, b: FMBlocks, state: ParamState, damping,
                  couple_global: bool = False):
    """`prepare` minus the linearisation: the fused per-image reduction of
    39 (+ 6G with ``couple_global``) feature rows, the global rhs
    correction and the Sgg product pieces, finished by
    `finish_reduction`."""
    G2 = len(b.Jg) // 2

    # z0 = Hpp^{-1} bp expanded; u0 = P Jp z0
    z0o = [_point_expand(p, z) for z in _hinv_apply(b.Hpp_inv, *b.bp)]
    u0 = [sum(b.PJp[i * 3 + a] * z0o[a] for a in range(3)) for i in (0, 1)]

    # Hpg per point [3][G][P] and W = Hpp^{-1} Hpg [G][3][P]
    hpg = [[_point_sum(p, b.Jp[a] * b.PJg[g] + b.Jp[3 + a] * b.PJg[G2 + g])
            for g in range(G2)] for a in range(3)]
    W = [_hinv_apply(b.Hpp_inv, hpg[0][g], hpg[1][g], hpg[2][g])
         for g in range(G2)]

    rows = []
    # bc terms (6)
    rows += [b.Jc[a] * b.Pw[0] + b.Jc[6 + a] * b.Pw[1] for a in range(6)]
    # Hcc diagonal (6)
    rows += [b.Jc[a] * b.PJc[a] + b.Jc[6 + a] * b.PJc[6 + a]
             for a in range(6)]
    # rc correction terms (6)
    rows += [b.Jc[a] * u0[0] + b.Jc[6 + a] * u0[1] for a in range(6)]
    # Scc = Hcc - Hcp Hpp^{-1} Hpc, upper triangle (21), exact per
    # observation: each contributes Hpc_n^T Hppinv[pt] Hpc_n
    hp = [[b.Jp[a] * b.PJc[e] + b.Jp[3 + a] * b.PJc[6 + e] for e in range(6)]
          for a in range(3)]
    H = tuple(_point_expand(p, h) for h in b.Hpp_inv)
    for e in range(6):
        he = _hinv_apply(H, hp[0][e], hp[1][e], hp[2][e])
        for f in range(e, 6):
            jpj = b.Jc[e] * b.PJc[f] + b.Jc[6 + e] * b.PJc[6 + f]
            corr = sum(he[a] * hp[a][f] for a in range(3))
            rows.append(jpj - corr)
    if couple_global:
        # Scg rows (6G): Hcg - Hcp Hpp^{-1} Hpg, exact per observation
        Wobs = [[_point_expand(p, W[g][a]) for a in range(3)]
                for g in range(G2)]
        for e in range(6):
            for g in range(G2):
                hcg = b.Jc[e] * b.PJg[g] + b.Jc[6 + e] * b.PJg[G2 + g]
                corr = sum(hp[a][e] * Wobs[g][a] for a in range(3))
                rows.append(hcg - corr)
    red = _image_sum_stack(p, rows)  # [M, 39 (+ 6G)]

    rg_corr = torch.stack([torch.sum(b.Jg[g] * u0[0] + b.Jg[G2 + g] * u0[1])
                           for g in range(G2)])
    T2 = torch.stack(b.Jg) @ torch.stack(b.PJg).T      # [2G, 2G]
    HpgM = torch.stack([hpg[a][g] for a in range(3) for g in range(G2)])
    WM = torch.stack([W[g][a] for a in range(3) for g in range(G2)])
    T3 = WM @ HpgM.T                                      # [3G, 3G]
    return finish_reduction(p, b, state, damping, red, rg_corr, T2, T3,
                            couple_global)


def finish_reduction(p: FMProblem, b: FMBlocks, state: ParamState, damping,
                     red, rg_corr, T2, T3, couple_global):
    """Shared tail of `prepare`: turn the fused per-image reduction ``red``
    [M, 39 (+ 6G)], the global rhs correction ``rg_corr`` [G] and the Sgg
    pieces ``T2`` [2G, 2G] / ``T3`` [3G, 3G] into (blocks, rc, rg,
    Precond).  Used by the plain reduction above and by the K2 path
    (`kernels.prepare_kernels`).  The inverses do not check for
    singularity (as jnp.linalg.inv; no device sync): a singular block gives
    non-finite entries."""
    G2 = len(b.Jg) // 2
    m_rows = red.shape[0]
    bc = red[:, :6]
    extra_c = damping * red[:, 6:12] + (1.0 - p.free_eo)
    rc = bc - red[:, 12:18]
    tri = red[:, 18:39]
    iu = np.triu_indices(6)
    iu0 = torch.as_tensor(iu[0], device=red.device)
    iu1 = torch.as_tensor(iu[1], device=red.device)
    Scc = red.new_zeros((m_rows, 6, 6))
    Scc[:, iu0, iu1] = tri
    Scc[:, iu1, iu0] = tri
    Scc = Scc + extra_c[:, :, None] * torch.eye(6, dtype=red.dtype,
                                                device=red.device)
    Minv_c = torch.linalg.inv_ex(Scc)[0]
    b = b._replace(bc=bc, extra_c=extra_c)

    rg = b.bg - rg_corr
    Hgg = T2[:G2, :G2] + T2[G2:, G2:] + torch.diag(b.extra_g)
    corr_g = sum(T3[a * G2:(a + 1) * G2, a * G2:(a + 1) * G2]
                 for a in range(3))
    Sgg = Hgg - corr_g
    Minv_g = torch.linalg.inv_ex(Sgg)[0]
    if not couple_global:
        return b, rc, rg, rcs.Precond(Minv_c=Minv_c, Minv_g=Minv_g)
    Scg = red[:, 39:39 + 6 * G2].reshape(m_rows, 6, G2)
    Minv = rcs.finish_coupling(rcs.Precond(Minv_c=Minv_c, Minv_g=Minv_g),
                               Scg, Sgg)
    return b, rc, rg, Minv


def back_substitute_points(p: FMProblem, b: FMBlocks, xc, xg,
                           cam_gather=None):
    """dx_p = Hpp^{-1} (bp - Hpx x): returns [P, 3]."""
    t = _t_rows(p, b, xc, xg, cam_gather)
    y = [_point_sum(p, b.Jp[a] * t[0] + b.Jp[3 + a] * t[1]) for a in range(3)]
    dx = _hinv_apply(b.Hpp_inv, b.bp[0] - y[0], b.bp[1] - y[1],
                     b.bp[2] - y[2])
    return torch.stack(dx, dim=1)


def omega_at(p: FMProblem, b: FMBlocks, dxp, dxc, dxg):
    """Omega(dx) at the linearisation point (getOmega semantics,
    BundleAdjustment.java:472-491)."""
    dxp_o = [_point_expand(p, dxp[:, a]) for a in range(3)]
    dxc_o = _gather_rows(p, dxc, 6)
    G2 = len(b.Jg) // 2
    v = []
    for i in (0, 1):
        jdx = sum(b.Jp[i * 3 + a] * dxp_o[a] for a in range(3))
        jdx = jdx + sum(b.Jc[i * 6 + a] * dxc_o[a] for a in range(6))
        jdx = jdx + sum(b.Jg[i * G2 + g] * dxg[g] for g in range(G2))
        v.append(b.w[i] - jdx)
    pv0 = p.wxx * v[0] + p.wxy * v[1]
    pv1 = p.wxy * v[0] + p.wyy * v[1]
    return torch.sum(v[0] * pv0 + v[1] * pv1)


def lm_step(p: FMProblem, state: ParamState, spec, damping,
            cg_tol=1e-10, cg_maxiter=200, use_kernels=False,
            couple_global=True, state_lo: ParamState | None = None,
            stall_limit=None):
    """One LM inner solve; returns (dxp, dxc, dxg, blocks, cg_iterations).

    ``use_kernels``: run the assembly through K2 (`kernels.prepare_kernels`,
    one fused pass over the packed rows), every CG matvec through K1 and
    the camera gathers of linearise and back-substitution through K3; the
    rows are packed once per step and shared by K2 and K1.  ``p`` must
    then be view-major (`to_view_major`).  The wrappers launch the CUDA
    kernels for CUDA tensors and take their plain versions for CPU
    tensors.  ``couple_global``: precondition with the exact
    camera-global blocks, assembled inside the fused reduction."""
    cgf = None
    if use_kernels:
        from . import kernels

        cgf = kernels.make_cam_gather(p)
        b, rc, rg, Minv, pp = kernels.prepare_kernels(
            p, state, spec, damping, couple_global=couple_global,
            state_lo=state_lo, cam_gather=cgf)
        matvec = kernels.make_matvec(pp, b.extra_c, b.extra_g)
    else:
        b, rc, rg, Minv = prepare(p, state, spec, damping,
                                  couple_global=couple_global,
                                  state_lo=state_lo)

        def matvec(c, g):
            return schur_matvec(p, b, c, g)
    xc, xg, it = rcs.pcg(rc, rg, Minv, matvec, tol=cg_tol,
                         maxiter=cg_maxiter, stall_limit=stall_limit)
    dxp = back_substitute_points(p, b, xc, xg, cam_gather=cgf)
    return dxp, xc, xg, b, it
