"""The observation-sharded LM step (port of
`bundle_adjustment_tpu/parallel/spmd.py`) on the block-layout engine.

Every rank holds a contiguous shard of the observation rows in the
problem's own order (file order, or the point-major rows of a uniform
problem; a shard may split a point), padded to a multiple of the ranks
with zero-weight rows at point 0 / image 0 as the JAX module pads them,
and the replicated parameters.  Each rank linearises its rows with
`rcs.linearize` on a local `rcs.RCSProblem` of its rows (its own point
order and blocked image layout), so that `rcs._seg_point` /
`rcs._seg_image` give its [P, k] / [M, k] partial sums in a fixed order,
without atomics; the collectives combine them:

* per point: Hpp, bp and Hpg in one psum, so that they are global before
  Hpp^{-1} is formed (the shard's own Hpp^{-1}, the inverse of a partial
  sum, is not used), and Hpx x in each matvec;
* per image and global: the right-hand side, the camera blocks, Hgg and
  Omega in one psum, and the image and global sums of each matvec in one.

The PCG runs on every rank on the replicated reduced quantities with the
exact camera-block and global-block preconditioners (as the JAX module: no
camera-global coupling, no best-iterate or stall rule), two psums per
matvec.  Gauss-Newton (no damping), as the JAX step.  K3 gathers the EO
rows of the linearisation and the back-substitution where ``use_kernels``
says so (as `solver.solve`'s file route).  The point-sharded step of the
flagship engine is `spmd_fm`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.problem import ParamState
from . import kernels, rcs
from .sharding import pad_to_multiple


class ShardedProblem(NamedTuple):
    """This rank's rows of a problem and where they lie in it."""

    problem: rcs.RCSProblem  # the rows as a file-order problem (pad rows last)
    offset: int              # the problem's row at which the shard starts
    rows: int                # the problem's rows in the shard; then pad rows
    rows_padded: int         # N padded to a multiple of the ranks


def shard_problem(problem: rcs.RCSProblem, comm) -> ShardedProblem:
    """This rank's contiguous shard of a tensor RCSProblem in either layout
    on ``comm.device``: rows [r Np / D, (r + 1) Np / D) of the observations
    in the problem's order, padded to Np, a multiple of the ranks, with
    zero-weight rows at point 0 / image 0; the shard's point order and
    blocked image layout.  Scale bars, inner constraints and direct
    observations are not taken (ValueError)."""
    if problem.has_extras or any(getattr(problem, f) is not None for f in (
            "dp_w", "de_w", "dg_w")):
        raise ValueError("the observation-sharded step takes image "
                         "observations only")
    D, r = comm.size, comm.rank
    P, M = problem.num_points, problem.num_images
    N = int(problem.obs_point.shape[0])
    Np = pad_to_multiple(N, D)
    n = Np // D
    lo = r * n
    k = max(min(lo + n, N) - lo, 0)
    dev = comm.device
    dt = problem.obs_xy.dtype

    def rows(a):
        a = a[lo:lo + k].to(dev)
        return torch.cat([a, a.new_zeros((n - k,) + tuple(a.shape[1:]))])

    obs_point = rows(problem.obs_point).to(torch.int32)
    obs_image = rows(problem.obs_image).to(torch.int32)
    order, counts = rcs.point_order(obs_point.cpu().numpy(), P)
    perm, starts = rcs.build_image_block_layout(obs_image.cpu().numpy(), M)
    cam = problem.cam_of_image
    local = rcs.RCSProblem(
        obs_point=obs_point, obs_image=obs_image,
        obs_xy=rows(problem.obs_xy), obs_weight=rows(problem.obs_weight),
        r0=problem.r0.to(dev), num_points=P, num_images=M,
        free_point=problem.free_point.to(dev, dt),
        free_eo=problem.free_eo.to(dev, dt),
        free_global=problem.free_global.to(dev, dt),
        img_perm=torch.as_tensor(perm, device=dev),
        img_block_starts=torch.as_tensor(starts, device=dev),
        cam_of_image=None if cam is None else cam.to(dev),
        point_order=torch.as_tensor(order, device=dev),
        point_counts=torch.as_tensor(counts, device=dev))
    return ShardedProblem(problem=local, offset=lo, rows=k, rows_padded=Np)


def make_spmd_lm_step(sp: ShardedProblem, spec, comm, cg_tol=1e-8,
                      cg_maxiter=100, use_kernels=None):
    """The observation-sharded Gauss-Newton step on this rank: returns
    ``step(state) -> (new_state, max_dx, omega0, cg_it)`` with the state
    replicated on ``comm.device`` in the problem's dtype (the same on
    every rank in and out; max_dx and omega0 0-d tensors, cg_it an int).
    ``use_kernels``: as `solver.solve`'s on the file order
    (`kernels.runs_kernels`): None runs K3 for f32 CUDA tensors, a bool
    says so, naming K1 or K2 raises ValueError."""
    lp = sp.problem
    x = lp.obs_xy
    cg = kernels.make_cam_gather(lp) \
        if kernels.runs_kernels(lp, use_kernels, x.dtype, x.device) else None
    P, M = lp.num_points, lp.num_images
    extra_c = 1.0 - lp.free_eo
    extra_g = 1.0 - lp.free_global

    def step(state: ParamState):
        b = rcs.linearize(lp, state, spec, 0.0, skip_image_reductions=True,
                          cam_gather=cg)
        G = b.Jg.shape[2]
        Pw = (b.P2 * b.w[:, None, :]).sum(dim=2)

        # per point: Hpp, bp and Hpg, global before Hpp^{-1}
        pts = comm.psum(rcs._seg_point(lp, torch.cat([
            rcs._tt(b.Jp, b.PJp).reshape(-1, 9), rcs._tv(b.Jp, Pw),
            rcs._tt(b.Jp, b.PJg).reshape(-1, 3 * G)], dim=1)))
        Hpp_inv = torch.linalg.inv_ex(
            pts[:, :9].reshape(P, 3, 3)
            + torch.diag_embed(1.0 - lp.free_point))[0]
        bp = pts[:, 9:12]
        Hpg = pts[:, 12:].reshape(P, 3, G)
        b = b._replace(Hpp_inv=Hpp_inv, bp=bp, extra_c=extra_c,
                       extra_g=extra_g)

        # per image and global: rc, the camera blocks of S, rg, Hgg, Omega
        u0 = rcs._mv(b.PJp, rcs._expand_point(lp, rcs._hv(Hpp_inv, bp)))
        img = rcs._seg_image(lp, torch.cat([
            rcs._tv(b.Jc, Pw - u0), rcs._scc_terms(lp, b).reshape(-1, 36)],
            dim=1))
        glob = torch.cat([rcs._tv(b.Jg, Pw - u0).sum(dim=0),
                          (b.Jg.reshape(-1, G).T
                           @ b.PJg.reshape(-1, G)).reshape(-1),
                          b.omega0.reshape(1)])
        red = comm.psum(torch.cat([img.reshape(-1), glob]))
        img, glob = red[:M * 42].reshape(M, 42), red[M * 42:]
        rc, rg, omega0 = img[:, :6], glob[:G], glob[-1]
        Hgg = glob[G:G + G * G].reshape(G, G) + torch.diag(extra_g)
        Sgg = Hgg - Hpg.reshape(-1, G).T @ (Hpp_inv @ Hpg).reshape(-1, G)
        apply_M = rcs.make_apply_M(rcs.Precond(
            Minv_c=torch.linalg.inv_ex(img[:, 6:].reshape(M, 6, 6)
                                       + torch.diag_embed(extra_c))[0],
            Minv_g=torch.linalg.inv_ex(Sgg)[0]))

        def matvec(xc, xg):
            y, t = rcs._hpx(lp, b, xc, xg)
            z = rcs._hv(Hpp_inv, comm.psum(y))
            tv = t - rcs._mv(b.PJp, rcs._expand_point(lp, z))
            o = comm.psum(torch.cat([
                rcs._seg_image(lp, rcs._tv(b.Jc, tv)).reshape(-1),
                rcs._tv(b.Jg, tv).sum(dim=0)]))
            return (o[:M * 6].reshape(M, 6) + extra_c * xc,
                    o[M * 6:] + extra_g * xg)

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
        y = comm.psum(rcs._hpx(lp, b, xc, xg, cg)[0])
        new_state, max_dx = rcs.apply_step(state, rcs._hv(Hpp_inv, bp - y),
                                           xc, xg)
        return new_state, max_dx, omega0, it

    return step
