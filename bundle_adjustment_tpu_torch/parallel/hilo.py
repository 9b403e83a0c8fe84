"""Two-float (hi + lo) parameter state: f64-grade convergence in f32.

Port of `bundle_adjustment_tpu/parallel/hilo.py`.  The reference converges
to max|dx| <= sqrt(eps_f64) in double precision
(BundleAdjustment.java:77,332).  In f32 the state quantisation eps*|x|
(~1e-4 at km-scale coordinates) makes smaller updates unrepresentable.
Holding the state as an unevaluated sum x = hi + lo of two f32 tensors
removes that floor:

* updates accumulate error-free via two-sum (Knuth/Moller) into (hi, lo);
* the forward model consumes lo only where |x| is large and differences
  are formed (the projection's X - X0, `ops.fm.project_rows`);
* Jacobians, reductions and the CG solve stay plain f32.

Two-sum is exact only if nothing contracts ``s - a`` and friends into a
fused multiply-add or reassociates them.  Every function here is eager
elementwise PyTorch: each operation is its own kernel with its own rounded
result, so the transform stays exact on the CPU and on the GPU.  Do not
route this module through ``torch.compile`` (or any fuser): a fused kernel
may reorder the operations and lose the low-order part.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.problem import ParamState


class HiLoState(NamedTuple):
    hi: ParamState
    lo: ParamState


def _two_sum(a, b):
    """Error-free transform: a + b = s + e exactly (Knuth two-sum)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def from_f64(state64: ParamState, dtype=torch.float32) -> HiLoState:
    """Split an f64 state into (hi, lo): hi = fl(x), lo = fl(x - hi)."""
    hi = ParamState(*(a.to(dtype) for a in state64))
    lo = ParamState(*((a.double() - h.double()).to(dtype)
                      for a, h in zip(state64, hi)))
    return HiLoState(hi=hi, lo=lo)


def from_f32(state: ParamState) -> HiLoState:
    lo = ParamState(*(torch.zeros_like(a) for a in state))
    return HiLoState(hi=state, lo=lo)


def to_f64(s: HiLoState) -> ParamState:
    return ParamState(*(h.double() + lo.double() for h, lo in zip(s.hi, s.lo)))


def apply_step(s: HiLoState, dxp, dxc, dxg, alpha=1.0) -> tuple:
    """x <- x + alpha dx with error-free (two-sum) accumulation per block.

    Returns (HiLoState, max|dx|), max|dx| a 0-d tensor (the
    rcs.apply_step analogue)."""
    C = s.hi.io.shape[0]
    K = s.hi.dist.shape[1]
    g = (alpha * dxg).reshape(C, 3 + K)
    dio, ddist = g[:, :3], g[:, 3:]

    def upd(hi, lo, dx):
        return _two_sum(hi, lo + dx)

    p_hi, p_lo = upd(s.hi.points, s.lo.points, alpha * dxp)
    e_hi, e_lo = upd(s.hi.eo, s.lo.eo, alpha * dxc)
    i_hi, i_lo = upd(s.hi.io, s.lo.io, dio)
    d_hi, d_lo = upd(s.hi.dist, s.lo.dist, ddist)
    new = HiLoState(hi=ParamState(points=p_hi, io=i_hi, dist=d_hi, eo=e_hi),
                    lo=ParamState(points=p_lo, io=i_lo, dist=d_lo, eo=e_lo))
    max_dx = torch.max(torch.stack([
        (alpha * dxp).abs().max(), (alpha * dxc).abs().max(),
        (alpha * dxg).abs().max()]))
    return new, max_dx
