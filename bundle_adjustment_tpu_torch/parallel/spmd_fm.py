"""The point-sharded LM step of the feature-major engine (port of
`bundle_adjustment_tpu/parallel/spmd_fm.py`).

Every rank owns a contiguous block of P / D whole points with all V views
of each, so the per-point reductions stay rank-local reshapes.  The
per-image reductions run the blocked image layout of the rank's own
observations (`rcs.build_image_block_layout` per shard, padded to one
length across ranks), and one psum combines the [M, F] partials; the
reduced system (cameras + globals) is replicated and the PCG runs on every
rank with one psum pair per matvec.  The same `engine.prepare` /
`schur_matvec` / `rcs.pcg` code runs with ``comm`` set, so one rank and
D ranks differ only in the order of the sums.

``cam_shard`` (tensor-parallel mode): the reduced camera system is also
sharded by image rows.  The fused [M, F] reduction lands by one
psum_scatter (each rank keeps M / D images' rows and their 6x6 blocks),
the PCG vectors are camera-sharded with psum-ed dots, the matvec re-forms
the full [M, 6] vector with one tiled all_gather, and one more all_gather
re-forms xc for the back-substitution.  Needs M a multiple of D
(`pad_for_mesh(images=True)` pads it).

The step runs the plain PyTorch path on each shard, as the JAX module
runs XLA there; the CUDA kernels are not used.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.problem import ParamState
from . import engine, rcs


def pad_for_mesh(problem: rcs.RCSProblem, state: ParamState, comm,
                 images: bool = False):
    """Pad the point count so every rank holds the same number of whole
    points; with ``images`` also pad the image count to a multiple of the
    ranks (fully fixed dummy images) as the ``cam_shard`` step needs.
    Tensor RCSProblem in and out.  Returns (problem, state, P_original).
    (The JAX function's ``multiple``, a Pallas lane block per shard, has
    no use while the sharded step runs the plain path.)"""
    D = comm.size
    problem, state, Pn = engine.pad_problem(problem, state, multiple=D)
    if images:
        problem, state, _ = engine.pad_images(problem, state, D)
    return problem, state, Pn


def shard_arrays(problem: rcs.RCSProblem, state: ParamState, comm):
    """This rank's share of a padded tensor RCSProblem: (the FMProblem of
    its P / D points with its own image layout, its points [P / D, 3], P /
    D), on ``comm.device``.  Every rank builds the layouts of all shards
    (host numpy) to pad its own to their common length."""
    if problem.has_extras:
        raise ValueError("the point-sharded step takes no scale bars, inner "
                         "constraints or populated direct groups")
    D, r = comm.size, comm.rank
    Pn, V, M = problem.num_points, problem.point_uniform, problem.num_images
    if Pn % D != 0:
        raise ValueError("pad the problem first (pad_for_mesh)")
    P_loc = Pn // D
    N_loc = P_loc * V
    obs_image = problem.obs_image.cpu().numpy().reshape(D, N_loc)
    layouts = [rcs.build_image_block_layout(obs_image[s], M)
               for s in range(D)]
    nip = max(pm.shape[0] for pm, _ in layouts)
    nip = -(-nip // rcs.IMG_BLOCK) * rcs.IMG_BLOCK
    perm = np.full(nip, N_loc, np.int32)
    perm[:layouts[r][0].shape[0]] = layouts[r][0]
    dev = comm.device
    rows = slice(r * N_loc, (r + 1) * N_loc)
    pts = slice(r * P_loc, (r + 1) * P_loc)

    def t(a):
        return None if a is None else a.to(dev)

    local = problem._replace(
        obs_point=t(problem.obs_point[rows] - r * P_loc),
        obs_image=t(problem.obs_image[rows]),
        obs_xy=t(problem.obs_xy[rows]), obs_weight=t(problem.obs_weight[rows]),
        r0=t(problem.r0), num_points=P_loc,
        free_point=t(problem.free_point[pts]), free_eo=t(problem.free_eo),
        free_global=t(problem.free_global),
        img_perm=torch.as_tensor(perm, device=dev),
        img_block_starts=torch.as_tensor(layouts[r][1], device=dev),
        cam_of_image=t(problem.cam_of_image),
        dp_w=None if problem.dp_w is None else t(problem.dp_w[pts]),
        dp_val=None if problem.dp_val is None else t(problem.dp_val[pts]),
        de_w=t(problem.de_w), de_val=t(problem.de_val),
        dg_w=t(problem.dg_w), dg_val=t(problem.dg_val))
    return engine.fm_problem(local), state.points[pts].to(dev), P_loc


def make_spmd_fm_lm_step(problem: rcs.RCSProblem, state: ParamState, spec,
                         comm, damping=1e-4, cg_tol=1e-6, cg_maxiter=200,
                         couple_global: bool = True, cam_shard: bool = False,
                         stall_limit=None):
    """The point-sharded LM step on this rank.

    ``problem`` / ``state``: the whole padded problem (`pad_for_mesh`),
    the same on every rank.  Returns (step, args0) where ``step(points,
    io, dist, eo) -> ((points, io, dist, eo), max_dx, omega0, cg_it)``
    takes and returns this rank's points [P / D, 3] and the replicated
    io, dist, eo, so it can be iterated; ``args0`` are those of
    ``state`` on ``comm.device``.  max_dx and omega0 are 0-d tensors with
    the same bits on every rank, cg_it an int.

    ``cam_shard``: the tensor-parallel mode (module docstring); raises
    ValueError unless the image count is a multiple of the ranks."""
    p_loc, points, _ = shard_arrays(problem, state, comm)
    D = comm.size
    if cam_shard and problem.num_images % D != 0:
        raise ValueError(
            f"cam_shard requires the image count ({problem.num_images}) to "
            f"be a multiple of the mesh size ({D})")

    def step(points, io, dist, eo):
        st = ParamState(points=points, io=io, dist=dist, eo=eo)
        b, rc, rg, Minv = engine.prepare(
            p_loc, st, spec, damping, couple_global=couple_global,
            comm=comm, cam_scatter=cam_shard)

        def matvec(c, g):
            return engine.schur_matvec(p_loc, b, c, g, comm=comm,
                                       cam_scatter=cam_shard)

        xc, xg, it = rcs.pcg(rc, rg, Minv, matvec, tol=cg_tol,
                             maxiter=cg_maxiter, stall_limit=stall_limit,
                             comm_cam=comm if cam_shard else None)
        if cam_shard:
            xc = comm.all_gather(xc)
        dxp = engine.back_substitute_points(p_loc, b, xc, xg)
        C, K = io.shape[0], dist.shape[1]
        g = xg.reshape(C, 3 + K)
        new = (points + dxp, io + g[:, :3], dist + g[:, 3:], eo + xc)
        max_dx = torch.maximum(comm.pmax(dxp.abs().max()),
                               torch.maximum(xc.abs().max(), xg.abs().max()))
        return new, max_dx, b.omega0, it

    dev = comm.device
    return step, (points, state.io.to(dev), state.dist.to(dev),
                  state.eo.to(dev))
