"""The port's feature-major engine (plain PyTorch) against the JAX engine,
float64 on the CPU, same problem and lane order on both sides.

Tolerances are those of tests/test_engine_fm.py: Jacobian rows rtol 1e-12
(same closed forms, different op order), Omega and bp rtol 1e-10
(reductions), Hpp_inv rtol 1e-8 (an inverse), reduced-system outputs rtol
1e-9 and the 6x6 / GxG inverses rtol 1e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import build_pair, np_
from bundle_adjustment_tpu.parallel import engine as E
from bundle_adjustment_tpu_torch.parallel import engine as TE


@pytest.fixture(scope="module")
def pair():
    return build_pair(256, 12, 6, seed=3)


def test_linearize_matches_jax(pair):
    bj = E.linearize(pair.fj, pair.state_j, pair.spec, jnp.asarray(1e-3))
    bt = TE.linearize(pair.ft, pair.state_t, pair.spec, 1e-3)
    for name in ("Jp", "PJp", "Jc", "PJc", "Jg", "PJg", "w", "Pw"):
        for k, (a, b) in enumerate(zip(getattr(bj, name), getattr(bt, name))):
            np.testing.assert_allclose(np_(b), np_(a), rtol=1e-12, atol=0,
                                       err_msg=f"{name}[{k}]")
    np.testing.assert_allclose(float(bt.omega0), float(bj.omega0), rtol=1e-10)
    np.testing.assert_allclose(np_(torch.stack(bt.bp)),
                               np_(jnp.stack(bj.bp)), rtol=1e-10, atol=1e-12)
    for a, b in zip(bj.Hpp_inv, bt.Hpp_inv):
        np.testing.assert_allclose(np_(b), np_(a), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(np_(bt.bg), np_(bj.bg), rtol=1e-10)
    np.testing.assert_allclose(np_(bt.extra_g), np_(bj.extra_g), rtol=1e-10)


def test_linearize_hilo_state_matches_jax(pair):
    """The two-float (hi + lo) state path of the projection differences."""
    rng = np.random.default_rng(8)
    lo_np = [rng.normal(0, 1e-7, np.shape(a)) for a in pair.state_j]
    lo_j = type(pair.state_j)(*(jnp.asarray(a) for a in lo_np))
    lo_t = type(pair.state_t)(*(torch.as_tensor(a) for a in lo_np))
    bj = E.linearize(pair.fj, pair.state_j, pair.spec, jnp.asarray(1e-3),
                     state_lo=lo_j)
    bt = TE.linearize(pair.ft, pair.state_t, pair.spec, 1e-3, state_lo=lo_t)
    for a, b in zip(bj.w, bt.w):
        np.testing.assert_allclose(np_(b), np_(a), rtol=1e-12, atol=1e-16)


@pytest.mark.parametrize("couple", [True, False])
def test_prepare_matches_jax(pair, couple):
    lam = 1e-4
    bj, rcj, rgj, Mj = E.prepare(pair.fj, pair.state_j, pair.spec,
                                 jnp.asarray(lam), couple_global=couple)
    bt, rct, rgt, Mt = TE.prepare(pair.ft, pair.state_t, pair.spec, lam,
                                  couple_global=couple)
    np.testing.assert_allclose(np_(rct), np_(rcj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(rgt), np_(rgj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(bt.bc), np_(bj.bc), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(bt.extra_c), np_(bj.extra_c), rtol=1e-9)
    np.testing.assert_allclose(np_(Mt.Minv_c), np_(Mj.Minv_c), rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(np_(Mt.Minv_g), np_(Mj.Minv_g), rtol=1e-7,
                               atol=1e-10)
    if couple:
        np.testing.assert_allclose(np_(Mt.Scg), np_(Mj.Scg), rtol=1e-8,
                                   atol=1e-11)
        np.testing.assert_allclose(np_(Mt.Sghat_inv), np_(Mj.Sghat_inv),
                                   rtol=1e-7, atol=1e-10)
    else:
        assert Mt.Scg is None


def test_schur_matvec_and_back_substitution_match_jax(pair):
    lam = 1e-3
    bj, rcj, rgj, _ = E.prepare(pair.fj, pair.state_j, pair.spec,
                                jnp.asarray(lam))
    bt, rct, rgt, _ = TE.prepare(pair.ft, pair.state_t, pair.spec, lam)
    rng = np.random.default_rng(0)
    xc = rng.normal(size=np.shape(rcj))
    xg = rng.normal(size=np.shape(rgj))
    ocj, ogj = E.schur_matvec(pair.fj, bj, jnp.asarray(xc), jnp.asarray(xg))
    oct_, ogt = TE.schur_matvec(pair.ft, bt, torch.as_tensor(xc),
                                torch.as_tensor(xg))
    np.testing.assert_allclose(np_(oct_), np_(ocj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(ogt), np_(ogj), rtol=1e-9, atol=1e-12)
    dj = E.back_substitute_points(pair.fj, bj, jnp.asarray(xc),
                                  jnp.asarray(xg))
    dt = TE.back_substitute_points(pair.ft, bt, torch.as_tensor(xc),
                                   torch.as_tensor(xg))
    np.testing.assert_allclose(np_(dt), np_(dj), rtol=1e-9, atol=1e-12)
    dxp = 1e-3 * rng.normal(size=np.shape(dj))
    omj = E.omega_at(pair.fj, bj, jnp.asarray(dxp), jnp.asarray(xc) * 1e-6,
                     jnp.asarray(xg) * 1e-6)
    omt = TE.omega_at(pair.ft, bt, torch.as_tensor(dxp),
                      torch.as_tensor(xc) * 1e-6, torch.as_tensor(xg) * 1e-6)
    np.testing.assert_allclose(float(omt), float(omj), rtol=1e-10)


def test_layouts_reduce_alike(pair):
    """Point-major and view-major orders give the same reductions."""
    pm = pair.ft._replace(vm_pb=None)
    P, V = pair.ft.num_points, pair.ft.views
    perm = torch.as_tensor(TE.view_major_perm(P, V, pair.ft.vm_pb))
    row = torch.as_tensor(np.random.default_rng(2).normal(size=P * V))
    vm_row = row[perm]
    np.testing.assert_allclose(np_(TE._point_sum(pair.ft, vm_row)),
                               np_(TE._point_sum(pm, row)), rtol=1e-13)
    col = torch.arange(P, dtype=torch.float64)
    np.testing.assert_array_equal(np_(TE._point_expand(pair.ft, col)),
                                  np_(TE._point_expand(pm, col)[perm]))


def test_pad_problem_matches_jax():
    """engine.pad_problem: dummy points, the image layout and the state."""
    import bench
    from bundle_adjustment_tpu_torch import convert

    problem, state, _ = bench.build_problem(100, 5, 3, jnp.float64, seed=6)
    pj, sj, Pj = E.pad_problem(problem, state)
    pt, st, Pt = TE.pad_problem(
        convert.problem_to_torch(problem, torch.device("cpu"), torch.float64),
        convert.state_to_torch(state, torch.device("cpu"), torch.float64))
    assert Pt == Pj == 100 and pt.num_points == pj.num_points == 128
    for f in ("obs_point", "obs_image", "obs_xy", "obs_weight", "free_point",
              "img_perm", "img_block_starts"):
        np.testing.assert_array_equal(np_(getattr(pt, f)),
                                      np_(getattr(pj, f)), err_msg=f)
    np.testing.assert_array_equal(np_(st.points), np_(sj.points))
