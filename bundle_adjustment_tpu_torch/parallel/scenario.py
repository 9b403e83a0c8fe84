"""Scenario-batched calibration networks (port of
`bundle_adjustment_tpu/parallel/scenario.py`).

Fleets of independent networks with one static shape (the same rig, target
field and visibility: repeated calibrations) take one LM step together:
S scenarios share the index arrays and differ in observations, weights and
parameter values.  The step is one batched program over a leading S axis
on the feature-major engine: `torch.func.vmap` over `engine.prepare`,
`engine.schur_matvec` and `engine.back_substitute_points`, and a PCG whose
scalars (alpha, beta, the stop) are per scenario.  A scenario that has met
its own stop is frozen, as a `vmap` of JAX's `while_loop` freezes it: its
iterate and its count stay where they stopped while the others go on.
The loop reads the [S] stop mask once per iteration.

(The JAX module vmaps the block-layout `rcs.lm_step`, which the port does
not have; the feature-major step solves the same normal equations.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..models.problem import ParamState
from . import engine, rcs


class ScenarioBatch(NamedTuple):
    """S problems of one static shape.  ``problem``: the shared
    feature-major problem (its index arrays, layouts and masks; its
    observations are not read); per scenario the observations, their 2x2
    weights and the parameters, each with a leading S axis."""

    problem: engine.FMProblem
    obs_xy: torch.Tensor       # [S, N, 2]
    obs_weight: torch.Tensor   # [S, N, 2, 2]
    states: ParamState         # leading S axis on every block


def make_batch(problem, obs_xy_batch, obs_weight_batch,
               states: ParamState) -> ScenarioBatch:
    """A batch on the device of ``problem`` (a tensor `rcs.RCSProblem`,
    converted by `engine.fm_problem`, or an `engine.FMProblem`) in its
    float dtype; the per-scenario arrays may be numpy."""
    if isinstance(problem, rcs.RCSProblem):
        problem = engine.fm_problem(problem)
    dev, dt = problem.obs_x.device, problem.obs_x.dtype

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
    quantities compared in float64 as `rcs.pcg` compares Python floats.
    Returns (xc, xg, iterations [S] int64)."""
    def dot(ac, ag, bc_, bg_):
        return vmap(lambda a, b, c, d: torch.sum(a * c) + torch.sum(b * d))(
            ac, ag, bc_, bg_)

    S = rc.shape[0]
    stall_limit = 8 if rc.dtype == torch.float32 else maxiter + 1
    xc, xg = torch.zeros_like(rc), torch.zeros_like(rg)
    bxc, bxg = xc, xg
    zc, zg = apply_M(rc, rg)
    pc, pg = zc, zg
    rz = dot(rc, rg, zc, zg)
    r0 = torch.sqrt(dot(rc, rg, rc, rg)).double()
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
        rn = torch.sqrt(dot(rc_n, rg_n, rc_n, rg_n)).double()
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
    """`engine.prepare` (coupled preconditioner, as `engine.lm_step`) of
    every scenario, vmapped: (blocks, rc [S, M, 6], rg [S, G],
    preconditioner), blocks and preconditioner as dicts of their tensor
    fields with a leading S axis."""
    p = batch.problem

    def prepare_one(xy, w, st):
        q = p._replace(obs_x=xy[:, 0], obs_y=xy[:, 1], wxx=w[:, 0, 0],
                       wxy=w[:, 0, 1], wyy=w[:, 1, 1])
        b, rc, rg, Minv = engine.prepare(q, st, spec, damping,
                                         couple_global=True)
        return _fields(b), rc, rg, _fields(Minv)

    return vmap(prepare_one)(batch.obs_xy, batch.obs_weight, batch.states)


def matvec_batch(p: engine.FMProblem, blocks: dict, xc, xg):
    """`engine.schur_matvec` of every scenario ([S, M, 6], [S, G]),
    vmapped over `prepare_batch`'s blocks."""
    def matvec_one(bd_, c, g):
        return engine.schur_matvec(p, _rebuild(engine.FMBlocks, bd_), c, g)

    return vmap(matvec_one)(blocks, xc, xg)


def scenario_lm_step(batch: ScenarioBatch, spec, damping, cg_tol=1e-8,
                     cg_maxiter=100):
    """One LM iteration for every scenario at once, the step of
    `engine.lm_step` (plain path, its default preconditioner and stall
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
        dxp = engine.back_substitute_points(
            p, _rebuild(engine.FMBlocks, bd_), c, g)
        return rcs.apply_step(st, dxp, c, g)

    new_states, max_dx = vmap(finish_one)(bd, batch.states, xc, xg)
    return new_states, max_dx, bd["omega0"], it
