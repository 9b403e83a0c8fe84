"""Scenario-batched calibration networks (port of
`bundle_adjustment_tpu/parallel/scenario.py`).

Fleets of independent networks with one static shape (the same rig, target
field and visibility: repeated calibrations) take one LM step together:
S scenarios share the index arrays and differ in observations, weights and
parameter values.  As in the JAX module, the step of each scenario is that
of the block-layout `rcs.lm_step` (block-Jacobi PCG: the exact camera
blocks and the exact global block), in either layout of `rcs.LAYOUTS`: a
file-order fleet runs unpadded.  It is one batched program over a leading
S axis: `torch.func.vmap` over `rcs.prepare`, `rcs.schur_matvec` and
`rcs.back_substitute_points`, and a PCG whose scalars (alpha, beta, the
best iterate, the stop) are per scenario.  A scenario that has met its own
stop is frozen, as a `vmap` of JAX's `while_loop` freezes it: its iterate
and its count stay where they stopped while the others go on.  The loop
reads the [S] stop mask once per iteration.  Elementwise work and the
per-point sums are batched; every other reduction and product runs once
per scenario (`rcs._PerItem`), so each scenario's step is that of
`rcs.lm_step` on its own network bit for bit: a batched sum rounds
otherwise, and near the f64 floor those bits move the CG count by up to
~10 iterations.  No CUDA kernel runs here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..models.problem import ParamState
from . import rcs


class ScenarioBatch(NamedTuple):
    """S problems of one static shape.  ``problem``: the shared tensor
    `rcs.RCSProblem` (its index arrays and layouts; its observations are
    not read); per scenario the observations, their 2x2 weights and the
    parameters, each with a leading S axis."""

    problem: rcs.RCSProblem
    obs_xy: torch.Tensor       # [S, N, 2]
    obs_weight: torch.Tensor   # [S, N, 2, 2]
    states: ParamState         # leading S axis on every block


def make_batch(problem: rcs.RCSProblem, obs_xy_batch, obs_weight_batch,
               states: ParamState) -> ScenarioBatch:
    """A batch on the device of ``problem`` (a tensor `rcs.RCSProblem` in
    either layout; a file-order one carries its point order) in its float
    dtype; the per-scenario arrays may be numpy."""
    dev, dt = problem.obs_xy.device, problem.obs_xy.dtype

    def t(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a))
        return a.to(dev, dt)

    return ScenarioBatch(problem=problem, obs_xy=t(obs_xy_batch),
                         obs_weight=t(obs_weight_batch),
                         states=ParamState(*(t(a) for a in states)))


def _fields(nt) -> dict:
    """The tensor fields of a NamedTuple (vmap returns tensors only)."""
    return {k: v for k, v in nt._asdict().items() if v is not None}


def _rebuild(cls, fields: dict):
    return cls(**{k: fields.get(k) for k in cls._fields})


def _pcg_frozen(rc, rg, apply_M, matvec, tol, maxiter):
    """`rcs.pcg` for S systems at once ([S, M, 6] / [S, G] vectors):
    per-scenario alpha, beta, best iterate, stall count and stop; a
    scenario that stops is frozen.  The stop rule is `rcs.pcg`'s, its
    quantities compared in the residual's dtype as `rcs.pcg` compares them.
    Returns (xc, xg, iterations [S] int64)."""
    def dot_one(a, b, c, d):  # `rcs.pcg`'s, each sum per scenario
        return rcs._per_item(torch.sum, a * c) \
            + rcs._per_item(torch.sum, b * d)

    def dot(ac, ag, bc_, bg_):
        return vmap(dot_one)(ac, ag, bc_, bg_)

    S = rc.shape[0]
    stall_limit = 8 if rc.dtype == torch.float32 else maxiter + 1
    xc, xg = torch.zeros_like(rc), torch.zeros_like(rg)
    bxc, bxg = xc, xg
    zc, zg = apply_M(rc, rg)
    pc, pg = zc, zg
    rz = dot(rc, rg, zc, zg)
    r0 = torch.sqrt(dot(rc, rg, rc, rg))
    rnorm = best = r0
    stall = torch.zeros(S, dtype=torch.int64, device=rc.device)
    it = torch.zeros_like(stall)

    def running():
        return (it < maxiter) & (stall < stall_limit) \
            & (rnorm > tol * (1.0 + r0))

    act = running()
    while bool(act.any()):
        qc, qg = matvec(pc, pg)
        alpha = rz / dot(pc, pg, qc, qg)
        xc_n = xc + alpha[:, None, None] * pc
        xg_n = xg + alpha[:, None] * pg
        rc_n = rc - alpha[:, None, None] * qc
        rg_n = rg - alpha[:, None] * qg
        zc, zg = apply_M(rc_n, rg_n)
        rz_n = dot(rc_n, rg_n, zc, zg)
        beta = rz_n / rz
        pc_n = zc + beta[:, None, None] * pc
        pg_n = zg + beta[:, None] * pg
        rn = torch.sqrt(dot(rc_n, rg_n, rc_n, rg_n))
        a2, a3 = act[:, None], act[:, None, None]
        better = act & (rn < best)
        bxc = torch.where(better[:, None, None], xc_n, bxc)
        bxg = torch.where(better[:, None], xg_n, bxg)
        stall = torch.where(act, torch.where(rn < 0.9 * best, 0, stall + 1),
                            stall)
        best = torch.where(act, torch.minimum(best, rn), best)
        xc, xg = torch.where(a3, xc_n, xc), torch.where(a2, xg_n, xg)
        rc, rg = torch.where(a3, rc_n, rc), torch.where(a2, rg_n, rg)
        pc, pg = torch.where(a3, pc_n, pc), torch.where(a2, pg_n, pg)
        rz = torch.where(act, rz_n, rz)
        rnorm = torch.where(act, rn, rnorm)
        it = it + act.long()
        act = act & running()
    return bxc, bxg, it


def prepare_batch(batch: ScenarioBatch, spec, damping):
    """`rcs.prepare` (block Jacobi, as `rcs.lm_step`) of every scenario,
    vmapped: (blocks, rc [S, M, 6], rg [S, G], preconditioner), blocks and
    preconditioner as dicts of their tensor fields with a leading S
    axis."""
    p = batch.problem

    def prepare_one(xy, w, st):
        b, rc, rg, Minv = rcs.prepare(p._replace(obs_xy=xy, obs_weight=w),
                                      st, spec, damping)
        return _fields(b), rc, rg, _fields(Minv)

    return vmap(prepare_one)(batch.obs_xy, batch.obs_weight, batch.states)


def matvec_batch(p: rcs.RCSProblem, blocks: dict, xc, xg):
    """`rcs.schur_matvec` of every scenario ([S, M, 6], [S, G]), vmapped
    over `prepare_batch`'s blocks."""
    def matvec_one(bd_, c, g):
        return rcs.schur_matvec(p, _rebuild(rcs.Blocks, bd_), c, g)

    return vmap(matvec_one)(blocks, xc, xg)


def scenario_lm_step(batch: ScenarioBatch, spec, damping, cg_tol=1e-8,
                     cg_maxiter=100):
    """One LM iteration for every scenario at once, the step of
    `rcs.lm_step` (its block-Jacobi preconditioner and `rcs.pcg`'s stop
    rule) per scenario.

    Returns (new_states, max_dx [S], omega0 [S], cg_iters [S])."""
    p = batch.problem
    bd, rc, rg, md = prepare_batch(batch, spec, damping)

    def apply_one(md_, c, g):
        return rcs.make_apply_M(_rebuild(rcs.Precond, md_))(c, g)

    xc, xg, it = _pcg_frozen(
        rc, rg, lambda c, g: vmap(apply_one)(md, c, g),
        lambda c, g: matvec_batch(p, bd, c, g), cg_tol, cg_maxiter)

    def finish_one(bd_, st, c, g):
        dxp = rcs.back_substitute_points(p, _rebuild(rcs.Blocks, bd_), c, g)
        return rcs.apply_step(st, dxp, c, g)

    new_states, max_dx = vmap(finish_one)(bd, batch.states, xc, xg)
    return new_states, max_dx, bd["omega0"], it
