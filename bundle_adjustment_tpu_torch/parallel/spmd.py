"""The observation-sharded LM step (port of
`bundle_adjustment_tpu/parallel/spmd.py`) on the feature rows.

Every rank holds a contiguous shard of the point-major observation rows
(lane = point * V + view; a shard may split a point) and the replicated
parameters.  Each rank linearises its rows and forms partial sums; the
collectives combine them:

* per point: the rank's rows are written at their lanes into a zero
  [P V, k] buffer and reshape-summed over the views (no atomics), then
  psum-ed, so Hpp, bp and Hpg are global before Hpp^{-1} is applied;
* per image: the blocked image layout of the rank's own rows, then psum;
* global: plain sums, then psum.

The PCG runs on every rank on the replicated reduced quantities with the
exact camera-block and global-block preconditioners (as the JAX module:
no camera-global coupling, no best-iterate or stall rule), one psum per
point and image sum of each matvec.  Gauss-Newton (no damping), as the
JAX step.  The point-sharded step of the flagship engine is `spmd_fm`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.problem import ParamState
from . import engine, rcs
from .sharding import pad_to_multiple


class ShardedProblem(NamedTuple):
    """This rank's rows of a point-major problem (pad rows: zero weight,
    lanes past P V) and the replicated metadata."""

    lane: torch.Tensor        # [n] int64 global lane of each row
    obs_image: torch.Tensor   # [n] int64
    obs_xy: torch.Tensor      # [n, 2]
    obs_weight: torch.Tensor  # [n, 2, 2]
    img_perm: torch.Tensor    # the rank's blocked image layout
    img_block_starts: torch.Tensor
    r0: torch.Tensor          # [C]
    cam_of_image: torch.Tensor  # [M] int64
    free_point: torch.Tensor  # [P, 3]
    free_eo: torch.Tensor     # [M, 6]
    free_global: torch.Tensor  # [G]
    num_points: int
    num_images: int
    views: int
    rows_padded: int          # N padded to a multiple of the ranks
    offset: int               # lane of the rank's first row


def shard_problem(problem: rcs.RCSProblem, comm) -> ShardedProblem:
    """This rank's contiguous shard of a tensor RCSProblem (uniform
    point-major layout) on ``comm.device``: rows [r Np / D, (r + 1) Np /
    D) of the observations padded to Np, a multiple of the ranks, with
    zero-weight pad rows.  Scale bars, inner constraints and direct
    observations are not taken (ValueError)."""
    if problem.point_uniform is None:
        raise ValueError("shard_problem takes the uniform point-major layout")
    if problem.has_extras or any(getattr(problem, f) is not None for f in (
            "dp_w", "de_w", "dg_w")):
        raise ValueError("the observation-sharded step takes image "
                         "observations only")
    D, r = comm.size, comm.rank
    P, V, M = problem.num_points, problem.point_uniform, problem.num_images
    N = P * V
    Np = pad_to_multiple(N, D)
    n = Np // D
    lo, hi = r * n, min((r + 1) * n, N)
    k = max(hi - lo, 0)
    dev = comm.device
    dt = problem.obs_xy.dtype

    def rows(a, tail):
        a = a[lo:lo + k].to(dev)
        return torch.cat([a, a.new_zeros((n - k,) + tuple(tail))])

    obs_image = rows(problem.obs_image, ()).long()
    perm, starts = rcs.build_image_block_layout(obs_image.cpu().numpy(), M)
    cam = problem.cam_of_image
    cam = torch.zeros(M, dtype=torch.int64) if cam is None else cam.long()
    return ShardedProblem(
        lane=torch.arange(lo, lo + n, device=dev), obs_image=obs_image,
        obs_xy=rows(problem.obs_xy, (2,)),
        obs_weight=rows(problem.obs_weight, (2, 2)),
        img_perm=torch.as_tensor(perm, device=dev),
        img_block_starts=torch.as_tensor(starts, device=dev),
        r0=problem.r0.to(dev), cam_of_image=cam.to(dev),
        free_point=problem.free_point.to(dev, dt),
        free_eo=problem.free_eo.to(dev, dt),
        free_global=problem.free_global.to(dev, dt),
        num_points=P, num_images=M, views=V, rows_padded=Np, offset=lo)


def _point_sum(sp: ShardedProblem, x, comm):
    """[n, k] per-row terms -> [P, k] global per-point sums: the rows at
    their lanes of a zero [Np, k] buffer, summed over the views, psum."""
    buf = x.new_zeros((sp.rows_padded, x.shape[1]))
    buf[sp.offset:sp.offset + x.shape[0]] = x
    P, V = sp.num_points, sp.views
    return comm.psum(buf[:P * V].reshape(P, V, -1).sum(dim=1))


def _image_sum(sp: ShardedProblem, x, comm):
    """[n, k] -> [M, k] global per-image sums."""
    return comm.psum(engine._image_sum_stack(sp, list(x.unbind(1))))


def linearize_rows(sp: ShardedProblem, state: ParamState, spec):
    """(Jp [n, 2, 3], Jc [n, 2, 6], Jg [n, 2, G], w [n, 2]) of the rank's
    rows, fixed parameters masked (a camera's global columns only on its
    images' rows)."""
    from ..ops import fm

    P, V = sp.num_points, sp.views
    pt = torch.clamp(sp.lane // V, max=P - 1)
    img = sp.obs_image
    X, Y, Z = (state.points[pt, a] for a in range(3))
    eo = [state.eo[img, a] for a in range(6)]
    cams = sp.cam_of_image[img]
    C, K = state.io.shape[0], state.dist.shape[1]
    Gp = 3 + K
    rows_x, rows_y, pred_x, pred_y = fm.jacobian_rows(
        X, Y, Z, *(state.io[cams, a] for a in range(3)), *eo,
        [state.dist[cams, k] for k in range(K)], spec, sp.r0[cams])
    w = sp.obs_xy - torch.stack([pred_x, pred_y], dim=1)
    one, zero = torch.ones_like(X), torch.zeros_like(X)

    fp = sp.free_point[pt]
    fe = sp.free_eo[img]
    Jp = torch.stack([torch.stack(rows_x[:3], 1), torch.stack(rows_y[:3], 1)],
                     dim=1) * fp[:, None, :]
    Jc = torch.stack([torch.stack(rows_x[6:12], 1),
                      torch.stack(rows_y[6:12], 1)], dim=1) * fe[:, None, :]
    gx = torch.stack([one, zero, rows_x[5]] + rows_x[12:12 + K], 1)
    gy = torch.stack([zero, one, rows_y[5]] + rows_y[12:12 + K], 1)
    onehot = (cams[:, None] == torch.arange(C, device=cams.device)).to(X.dtype)
    Jg = (torch.stack([gx, gy], dim=1)[:, :, None, :]
          * onehot[:, None, :, None]).reshape(-1, 2, C * Gp) \
        * sp.free_global
    return Jp, Jc, Jg, w


def make_spmd_lm_step(sp: ShardedProblem, spec, comm, cg_tol=1e-8,
                      cg_maxiter=100):
    """The observation-sharded Gauss-Newton step on this rank: returns
    ``step(state) -> (new_state, max_dx, omega0, cg_it)`` with the state
    replicated (the same on every rank in and out; max_dx and omega0 0-d
    tensors, cg_it an int)."""
    P2 = sp.obs_weight
    extra_c = 1.0 - sp.free_eo
    extra_g = 1.0 - sp.free_global
    pt = torch.clamp(sp.lane // sp.views, max=sp.num_points - 1)
    img = sp.obs_image

    def step(state: ParamState):
        Jp, Jc, Jg, w = linearize_rows(sp, state, spec)
        PJp = torch.einsum("nij,nja->nia", P2, Jp)
        PJc = torch.einsum("nij,nja->nia", P2, Jc)
        PJg = torch.einsum("nij,nja->nia", P2, Jg)
        Pw = torch.einsum("nij,nj->ni", P2, w)
        omega0 = comm.psum(torch.sum(w * Pw))
        G = Jg.shape[2]

        # global per-point blocks: Hpp (+ unit rows for fixed coordinates),
        # bp and Hpg in one psum
        hpp = torch.einsum("nia,nib->nab", Jp, PJp).reshape(-1, 9)
        bpo = torch.einsum("nia,ni->na", Jp, Pw)
        hpg = torch.einsum("nia,nig->nag", Jp, PJg).reshape(-1, 3 * G)
        pts = _point_sum(sp, torch.cat([hpp, bpo, hpg], dim=1), comm)
        Hpp = pts[:, :9].reshape(-1, 3, 3) + torch.diag_embed(
            1.0 - sp.free_point)
        Hpp_inv = torch.linalg.inv(Hpp)
        bp = pts[:, 9:12]
        Hpg = pts[:, 12:].reshape(-1, 3, G)
        bc = _image_sum(sp, torch.einsum("nia,ni->na", Jc, Pw), comm)
        bg = comm.psum(torch.einsum("nig,ni->g", Jg, Pw))

        def t_rows(xc, xg):
            return torch.einsum("nia,na->ni", PJc, xc[img]) \
                + torch.einsum("nig,g->ni", PJg, xg)

        def matvec(xc, xg):
            t = t_rows(xc, xg)
            y = _point_sum(sp, torch.einsum("nia,ni->na", Jp, t), comm)
            z = torch.einsum("pab,pb->pa", Hpp_inv, y)
            tv = t - torch.einsum("nia,na->ni", PJp, z[pt])
            oc = _image_sum(sp, torch.einsum("nia,ni->na", Jc, tv), comm)
            og = comm.psum(torch.einsum("nig,ni->g", Jg, tv))
            return oc + extra_c * xc, og + extra_g * xg

        # rhs
        z0 = torch.einsum("pab,pb->pa", Hpp_inv, bp)
        u0 = torch.einsum("nia,na->ni", PJp, z0[pt])
        rc = bc - _image_sum(sp, torch.einsum("nia,ni->na", Jc, u0), comm)
        rg = bg - comm.psum(torch.einsum("nig,ni->g", Jg, u0))

        # exact camera blocks (per-observation Schur correction) and the
        # exact global block
        Hpc = torch.einsum("nia,nib->nab", Jp, PJc)
        corr = torch.einsum("nab,nac,ncd->nbd", Hpc, Hpp_inv[pt], Hpc)
        Scc = _image_sum(sp, (torch.einsum("nia,nib->nab", Jc, PJc)
                              - corr).reshape(-1, 36), comm).reshape(-1, 6, 6)
        Minv_c = torch.linalg.inv(Scc + torch.diag_embed(extra_c))
        Hgg = comm.psum(torch.einsum("nia,nib->ab", Jg, PJg)) \
            + torch.diag(extra_g)
        Sgg = Hgg - torch.einsum("pag,pab,pbh->gh", Hpg, Hpp_inv, Hpg)
        Minv_g = torch.linalg.inv(Sgg)

        def apply_M(rc_, rg_):
            return torch.einsum("mab,mb->ma", Minv_c, rc_), Minv_g @ rg_

        def dot(ac, ag, bc_, bg_):
            return torch.sum(ac * bc_) + torch.sum(ag * bg_)

        xc, xg = torch.zeros_like(rc), torch.zeros_like(rg)
        zc, zg = apply_M(rc, rg)
        pc, pg = zc, zg
        rz = dot(rc, rg, zc, zg)
        r0n = float(torch.sqrt(dot(rc, rg, rc, rg)))
        rn, it = r0n, 0
        while it < cg_maxiter and rn > cg_tol * (1.0 + r0n):
            qc, qg = matvec(pc, pg)
            alpha = rz / dot(pc, pg, qc, qg)
            xc, xg = xc + alpha * pc, xg + alpha * pg
            rc, rg = rc - alpha * qc, rg - alpha * qg
            zc, zg = apply_M(rc, rg)
            rz2 = dot(rc, rg, zc, zg)
            beta = rz2 / rz
            pc, pg = zc + beta * pc, zg + beta * pg
            rz = rz2
            rn = float(torch.sqrt(dot(rc, rg, rc, rg)))
            it += 1

        # back-substitution (a global point sum)
        y = _point_sum(sp, torch.einsum("nia,ni->na", Jp, t_rows(xc, xg)),
                       comm)
        dxp = torch.einsum("pab,pb->pa", Hpp_inv, bp - y)
        new_state, max_dx = rcs.apply_step(state, dxp, xc, xg)
        return new_state, max_dx, omega0, it

    return step
