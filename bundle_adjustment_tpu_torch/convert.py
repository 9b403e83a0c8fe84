"""Host arrays -> the port's tensors on a device.

Takes an RCSProblem-shaped object whose fields are host arrays (the port's
`synthetic.build_problem`, or the JAX package's `bench.build_problem`) and
a ParamState-shaped object, and returns the port's tensor containers on
the given device: index arrays as int32, everything else in ``dtype``.
The tests use it to feed both implementations the same problem.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.problem import ParamState
from .parallel.rcs import RCSProblem

_INDEX_FIELDS = ("obs_point", "obs_image", "img_perm", "img_block_starts")
_FLOAT_FIELDS = ("obs_xy", "obs_weight", "r0", "free_point", "free_eo",
                 "free_global")
# optional fields (None = absent): scale bars, Helmert datum, direct
# observations (see parallel/rcs.RCSProblem)
_OPT_INDEX_FIELDS = ("sb_a", "sb_b", "dpg_idx", "dpg_axis")
_OPT_FLOAT_FIELDS = ("sb_length", "sb_weight", "datum_mask_d", "dp_w",
                     "dp_val", "de_w", "de_val", "dg_w", "dg_val", "dpg_val",
                     "dpg_cov")
# fields of the JAX RCSProblem the port does not take: the dense
# visibility tables of the block-layout engine
_UNSUPPORTED = ("point2obs", "img2obs")


def refuse_unsupported(problem) -> None:
    """Raise NotImplementedError for a problem with more than one camera
    or with the block-layout engine's visibility tables."""
    if tuple(problem.r0.shape) != (1,):
        raise NotImplementedError("the port takes single-camera problems")
    for name in _UNSUPPORTED:
        if getattr(problem, name, None) is not None:
            raise NotImplementedError(
                f"RCSProblem.{name} is not supported by the port yet")


def problem_to_torch(problem, device, dtype=torch.float32) -> RCSProblem:
    """The port's RCSProblem with tensors on ``device``."""
    refuse_unsupported(problem)

    def idx(a):
        return torch.as_tensor(np.array(a, np.int32), device=device)

    def flt(a):
        return torch.as_tensor(np.array(a, np.float64), device=device,
                               dtype=dtype)

    def opt(conv, name):
        a = getattr(problem, name, None)
        return None if a is None else conv(a)

    fields = {n: idx(getattr(problem, n)) for n in _INDEX_FIELDS}
    fields.update({n: flt(getattr(problem, n)) for n in _FLOAT_FIELDS})
    fields.update({n: opt(idx, n) for n in _OPT_INDEX_FIELDS})
    fields.update({n: opt(flt, n) for n in _OPT_FLOAT_FIELDS})
    flags = getattr(problem, "defect_flags_d", None)
    return RCSProblem(num_points=int(problem.num_points),
                      num_images=int(problem.num_images),
                      point_uniform=problem.point_uniform,
                      defect_flags_d=None if flags is None
                      else tuple(bool(f) for f in flags), **fields)


def state_to_torch(state, device, dtype=torch.float32) -> ParamState:
    """The port's ParamState with tensors on ``device``."""
    return ParamState(*(torch.as_tensor(np.array(a, np.float64),
                                        device=device, dtype=dtype)
                        for a in state))
