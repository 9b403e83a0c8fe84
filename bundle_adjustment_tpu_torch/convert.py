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
# fields of the JAX RCSProblem the port's slice does not take yet
_UNSUPPORTED = ("point2obs", "img2obs", "sb_a", "datum_mask_d",
                "defect_flags_d", "dp_w", "de_w", "dg_w", "dpg_idx")


def problem_to_torch(problem, device, dtype=torch.float32) -> RCSProblem:
    """The port's RCSProblem with tensors on ``device``."""
    if np.asarray(problem.r0).shape != (1,):
        raise NotImplementedError("the port takes single-camera problems")
    for name in _UNSUPPORTED:
        val = getattr(problem, name, None)
        if val is not None and not (name == "defect_flags_d"
                                    and not any(val)):
            raise NotImplementedError(
                f"RCSProblem.{name} is not supported by the port yet")

    def idx(a):
        return torch.as_tensor(np.array(a, np.int32), device=device)

    def flt(a):
        return torch.as_tensor(np.array(a, np.float64), device=device,
                               dtype=dtype)

    fields = {n: idx(getattr(problem, n)) for n in _INDEX_FIELDS}
    fields.update({n: flt(getattr(problem, n)) for n in _FLOAT_FIELDS})
    return RCSProblem(num_points=int(problem.num_points),
                      num_images=int(problem.num_images),
                      point_uniform=problem.point_uniform, **fields)


def state_to_torch(state, device, dtype=torch.float32) -> ParamState:
    """The port's ParamState with tensors on ``device``."""
    return ParamState(*(torch.as_tensor(np.array(a, np.float64),
                                        device=device, dtype=dtype)
                        for a in state))
