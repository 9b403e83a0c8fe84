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
from _torch_threads import one_torch_thread  # noqa: F401


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


# ---------------------------------------------------------------------------
# diagonal direct observations and the free-network fields
# ---------------------------------------------------------------------------

def _direct_pair(f64=True, view_major=False):
    """A 200-point network with diagonal dp / de / dg observations, 2 bars
    and the inner-constraint datum, padded to 256 by the JAX
    `pad_problem`: (JAX FMProblem, JAX state, port RCSProblem, port
    FMProblem, port state, spec)."""
    import bench
    from bundle_adjustment_tpu_torch import convert, synthetic

    jdt, tdt = (jnp.float64, torch.float64) if f64 \
        else (jnp.float32, torch.float32)
    problem, state, spec = bench.build_problem(200, 12, 6, jdt, seed=9)
    problem = synthetic.free_network(problem, state, bars=2, seed=3,
                                     direct=dict(dp=20, de=4, dg=True))
    pj, sj, _ = E.pad_problem(problem, state)
    fj = E.fm_problem(pj)
    pt = convert.problem_to_torch(pj, torch.device("cpu"), tdt)
    ft = TE.fm_problem(pt)
    if view_major:
        fj, ft = E.to_view_major(fj, 128), TE.to_view_major(ft, 128)
    st = convert.state_to_torch(sj, torch.device("cpu"), tdt)
    return fj, sj, pt, ft, st, spec, problem, state


@pytest.mark.parametrize("f64,tol", [(True, 1e-10), (False, 2e-4)],
                         ids=["f64", "f32"])
def test_linearize_direct_observations_match_jax(f64, tol):
    """dp into bp, the Hpp diagonal (x (1 + damping)) and Omega; de into
    Omega; dg into extra_g, bg and Omega: f64 at rtol 1e-10 (1e-8 for the
    inverse), f32 within 2e-4 of each field's largest entry."""
    fj, sj, _, ft, st, spec, _, _ = _direct_pair(f64)
    assert ft.dp_w is not None and ft.de_w is not None and ft.dg_w is not None
    lam = 1e-3
    bj = E.linearize(fj, sj, spec, jnp.asarray(lam, sj.points.dtype))
    bt = TE.linearize(ft, st, spec, lam)
    plain = TE.linearize(ft._replace(dp_w=None, de_w=None, dg_w=None), st,
                         spec, lam)
    for name, a, b, c in (
            ("omega0", bj.omega0, bt.omega0, plain.omega0),
            ("bp", jnp.stack(bj.bp), torch.stack(bt.bp), torch.stack(plain.bp)),
            ("bg", bj.bg, bt.bg, plain.bg),
            ("extra_g", bj.extra_g, bt.extra_g, plain.extra_g),
            ("Hpp_inv", jnp.stack(bj.Hpp_inv), torch.stack(bt.Hpp_inv),
             torch.stack(plain.Hpp_inv))):
        a = np_(a)
        t = 1e-8 if (f64 and name == "Hpp_inv") else tol
        np.testing.assert_allclose(np_(b), a, rtol=t if f64 else 0,
                                   atol=t * np.abs(a).max(), err_msg=name)
        assert float((b - c).abs().max()) > 0, name  # the terms are there


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_finish_reduction_direct_eo_matches_jax(route):
    """The de_w * free_eo term in bc, rc, extra_c and the 6x6 blocks, on
    the plain reduction and on the K2 route (both end in
    `finish_reduction`)."""
    from bundle_adjustment_tpu_torch.parallel import kernels

    fj, sj, _, ft, st, spec, _, _ = _direct_pair(view_major=True)
    lam = 1e-4
    bj, rcj, rgj, Mj = E.prepare(fj, sj, spec, jnp.asarray(lam),
                                 couple_global=True)
    if route == "plain":
        bt, rct, rgt, Mt = TE.prepare(ft, st, spec, lam, couple_global=True)
    else:
        bt, rct, rgt, Mt, _ = kernels.prepare_kernels(ft, st, spec, lam)
    np.testing.assert_allclose(np_(rct), np_(rcj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(rgt), np_(rgj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(bt.bc), np_(bj.bc), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(bt.extra_c), np_(bj.extra_c), rtol=1e-9)
    np.testing.assert_allclose(np_(Mt.Minv_c), np_(Mj.Minv_c), rtol=1e-7,
                               atol=1e-10)
    we = ft.de_w * ft.free_eo
    assert float(we.sum()) > 0
    no_de = TE.prepare(ft._replace(de_w=None, de_val=None), st, spec, lam)[0]
    np.testing.assert_allclose(np_(bt.extra_c - no_de.extra_c),
                               np_(we * (1.0 + lam)), rtol=1e-9, atol=1e-12)


def test_pad_problem_pads_the_free_network_fields():
    """Dummy points get zero dp_w / dp_val / datum_mask_d rows, as in the
    JAX `pad_problem`; per-image and global fields stay as they are."""
    from bundle_adjustment_tpu_torch import convert

    _, _, pj, _, _, _, problem, state = _direct_pair()
    pt, st, P0 = TE.pad_problem(
        convert.problem_to_torch(problem, torch.device("cpu"), torch.float64),
        convert.state_to_torch(state, torch.device("cpu"), torch.float64))
    assert P0 == 200 and pt.num_points == 256
    for f in ("dp_w", "dp_val", "datum_mask_d", "free_point", "de_w",
              "de_val", "dg_w", "dg_val", "sb_a", "sb_b", "sb_length",
              "sb_weight", "img_perm"):
        np.testing.assert_array_equal(np_(getattr(pt, f)),
                                      np_(getattr(pj, f)), err_msg=f)
    assert float(pt.datum_mask_d[200:].abs().sum()) == 0.0
    assert float(pt.dp_w[200:].abs().sum()) == 0.0
    assert pt.defect_flags_d == pj.defect_flags_d and pt.has_extras
    fm = TE.fm_problem(pt)
    assert fm.has_extras and fm.dp_w is pt.dp_w
    vm = TE.to_view_major(fm, 32)
    assert vm.dp_w is pt.dp_w and vm.de_w is pt.de_w and vm.has_extras


def test_point_ops_index_points_by_id_on_both_layouts():
    """`point_ops` on the view-major FMProblem takes and returns the same
    point-id-indexed [P, 3] arrays as on the point-major one (`freenet`
    indexes points by id), and `hinv` takes a batch."""
    _, _, _, fpm, st, spec, _, _ = _direct_pair()
    fvm = TE.to_view_major(fpm, 32)
    ops_p = TE.point_ops(fpm, TE.linearize(fpm, st, spec, 1e-3))
    ops_v = TE.point_ops(fvm, TE.linearize(fvm, st, spec, 1e-3))
    rng = np.random.default_rng(1)
    v = torch.as_tensor(rng.normal(size=(3, 256, 3)))
    xc = torch.as_tensor(rng.normal(size=(12, 6)))
    xg = torch.as_tensor(rng.normal(size=10))
    idx = torch.as_tensor([0, 31, 32, 199, 255])
    pairs = [(ops_p.hinv(v), ops_v.hinv(v)),
             (ops_p.hinv_at(idx), ops_v.hinv_at(idx)),
             (ops_p.hpx(xc, xg), ops_v.hpx(xc, xg)),
             *zip(ops_p.hxp(v[0]), ops_v.hxp(v[0]))]
    for a, b in pairs:
        np.testing.assert_allclose(np_(b), np_(a), rtol=1e-11,
                                   atol=1e-12 * float(a.abs().max()))
    np.testing.assert_array_equal(np_(ops_v.hinv(v)[1]),
                                  np_(ops_v.hinv(v[1])))
