"""The parity harness of the port's tests, and its own check.

`build_pair` makes one synthetic problem with `bench.build_problem`
(numpy, seeded) and lays it out for the JAX engine and for the port
(`bundle_adjustment_tpu_torch`) on the CPU.  The tests below check that
both sides then hold the same arrays in the same lane order: the layout
code (fm_problem, pad, view-major permutation, blocked image layout) is
integer bookkeeping and must agree exactly."""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.parallel import engine as E
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.parallel import engine as TE
from bundle_adjustment_tpu_torch.parallel import kernels as TK

CPU = torch.device("cpu")


class Pair(NamedTuple):
    fj: object        # JAX view-major FMProblem
    state_j: object   # JAX ParamState
    ft: object        # port view-major FMProblem
    state_t: object   # port ParamState
    spec: object
    problem_j: object  # JAX RCSProblem (padded)


def build_pair(P, M, V, seed, f64=True, pb=128) -> Pair:
    """bench.build_problem -> pad to 128 -> view-major with block ``pb``,
    converted once for each side (same numbers, same lane order)."""
    import bench

    jdt = jnp.float64 if f64 else jnp.float32
    tdt = torch.float64 if f64 else torch.float32
    problem, state, spec = bench.build_problem(P, M, V, jdt, seed=seed)
    problem, state, _ = E.pad_problem(problem, state)
    fj = E.to_view_major(E.fm_problem(problem), pb)
    pt = convert.problem_to_torch(problem, CPU, tdt)
    st = convert.state_to_torch(state, CPU, tdt)
    ft = TE.to_view_major(TE.fm_problem(pt), pb)
    return Pair(fj, state, ft, st, spec, problem)


def packed_to_torch(pp_j, ft) -> TK.PackedFM:
    """The JAX side's packed rows as the port's PackedFM (same layout)."""
    def t(a):
        return torch.as_tensor(np.array(a))

    return TK.PackedFM(
        packed=t(pp_j.packed), obs_img=t(pp_j.obs_img).reshape(-1),
        hppinv=t(pp_j.hppinv), img_perm=ft.img_perm,
        img_block_starts=ft.img_block_starts, num_points=pp_j.num_points,
        views=pp_j.views, num_images=pp_j.num_images, g=pp_j.g,
        f_pad=pp_j.f_pad, pb=pp_j.pb)


def scaled_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def blocks_to_torch(b) -> TE.FMBlocks:
    """A JAX engine.FMBlocks (single camera) as the port's FMBlocks, so
    both sides can run the steps after linearise on identical rows."""
    def t(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(torch.as_tensor(np.array(r)) for r in x)
        return torch.as_tensor(np.array(x))

    return TE.FMBlocks(*(t(getattr(b, f)) for f in TE.FMBlocks._fields))


def inverse_err(inv_a, inv_b) -> float:
    """Inverse blocks [..., k, k]: max over blocks of the relative Frobenius
    difference divided by cond_F(block).  An inverse amplifies a relative
    input difference by up to its condition number, so this ratio is
    bounded by the relative difference of the inputs."""
    a = np.asarray(inv_a, np.float64).reshape((-1,) + np.shape(inv_b)[-2:])
    b = np.asarray(inv_b, np.float64).reshape(a.shape)
    rel = (np.linalg.norm(a - b, axis=(1, 2))
           / np.linalg.norm(b, axis=(1, 2)))
    return float(np.max(rel / np.linalg.cond(b, "fro")))


@pytest.mark.parametrize("P,M,V,pb", [(128, 6, 4, 128), (500, 24, 8, 32)])
def test_layouts_match_jax(P, M, V, pb):
    pr = build_pair(P, M, V, seed=1, pb=pb)
    fj, ft = pr.fj, pr.ft
    assert (ft.num_points, ft.num_images, ft.views, ft.vm_pb) == \
        (fj.num_points, fj.num_images, fj.views, fj.vm_pb)
    for f in ("obs_image", "img_perm", "img_block_starts", "obs_x", "obs_y",
              "wxx", "wxy", "wyy", "free_point", "free_eo", "free_global",
              "r0"):
        np.testing.assert_array_equal(np_(getattr(ft, f)),
                                      np_(getattr(fj, f)), err_msg=f)
    np.testing.assert_array_equal(
        TE.view_major_perm(ft.num_points, V, pb),
        E.view_major_perm(fj.num_points, V, pb))


def test_convert_refuses_what_the_port_lacks():
    import bench

    problem, state, _ = bench.build_problem(128, 6, 4, jnp.float64,
                                            num_cameras=2)
    with pytest.raises(NotImplementedError, match="single-camera"):
        convert.problem_to_torch(problem, CPU)
    problem, _, _ = bench.build_problem(128, 6, 4, jnp.float64)
    problem = problem._replace(dp_w=np.ones((128, 3)))
    with pytest.raises(NotImplementedError, match="dp_w"):
        convert.problem_to_torch(problem, CPU)
